"""Atomic, async checkpointing of train state + the SchalaDB store: the
reference's ``repro/checkpoint/checkpointer.py`` with its on-disk protocol.

Layout (one directory per step):
  <root>/step_<n>.tmp/ -> fsync'd -> rename to <root>/step_<n>/
    manifest.json      step, leaf index, content hashes, wall time
    arrays.npz         flattened train-state leaves (path-keyed)
    store.npz          column store snapshot + txn-log offset
    store_<s>.npz      (sharded runs) one store cut per shard; the
                       manifest carries the full version VECTOR

The tmp+rename protocol makes partially written checkpoints invisible;
restore picks the newest COMPLETE manifest (torn directories — truncated
manifest, missing array or store file — are skipped, falling back to the
previous complete step). Sharded runs cut one store-lock-consistent
snapshot per shard and publish them with the version vector in a single
manifest, so a restore resumes every shard at ``[v0..vN-1]`` or none at
all: there is no torn vector. Async mode copies the state to the host
synchronously — a consistent cut — then writes on a daemon thread
(double-buffered): the card never waits on disk.

The port's train state holds a module of per-layer tensors, so its leaves
are keyed by the state's path and the module's parameter names
(``params/layers.0.attn.q.weight``, ``opt/inner/m/layers.0.attn.q.weight``,
``opt/step``); bf16 leaves are stored as their 16-bit patterns, with their
dtype in the manifest. The store files are the reference's format, which
the reference's ``Checkpointer`` reads, sharded or not.
"""
from __future__ import annotations

import copy
import hashlib
import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch.core.store import ColumnStore
from repro_torch.core.workqueue import WorkQueue


def _leaves(tree, prefix=""):
    """(key, tensor) of every tensor in a state of dicts and modules."""
    if isinstance(tree, nn.Module):
        for name, t in tree.state_dict().items():
            yield f"{prefix}{name}", t
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, torch.Tensor):
        yield prefix[:-1], tree
    else:
        raise TypeError(f"checkpoint: unsupported leaf {type(tree)} at "
                        f"{prefix[:-1]!r}")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:           # numpy has no bf16: its bits
        return t.view(torch.int16).numpy().view(np.uint16).copy()
    return t.numpy().copy()


def _from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a)).to(like.dtype)
    return t.reshape(like.shape).to(like.device)


def _flatten(tree) -> Dict[str, np.ndarray]:
    return {k: _to_numpy(t) for k, t in _leaves(tree)}


def _dtypes(tree) -> Dict[str, str]:
    return {k: str(t.dtype).replace("torch.", "") for k, t in _leaves(tree)}


def _unflatten_into(tree, flat: Dict[str, np.ndarray], prefix=""):
    """A new state shaped like ``tree`` (dicts and modules of tensors) with
    the values of ``flat``, on the template's devices; a module is copied
    parameter by parameter (the template is left as it is)."""
    if isinstance(tree, nn.Module):
        memo = {id(p): nn.Parameter(_from_numpy(flat[f"{prefix}{n}"], p),
                                    requires_grad=p.requires_grad)
                for n, p in tree.named_parameters()}
        return copy.deepcopy(tree, memo)
    if isinstance(tree, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}{k}/")
                for k, v in tree.items()}
    return _from_numpy(flat[prefix[:-1]], tree)


class Checkpointer:
    def __init__(self, root: str, keep: int = 3, async_write: bool = True):
        self.root = pathlib.Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_write = async_write
        self._thread: Optional[threading.Thread] = None

    # ---------------------------------------------------------------- save
    def save(self, step: int, state: Any, wq: Optional[WorkQueue] = None,
             *, router=None) -> None:
        """Checkpoint ``state`` plus the store(s): pass ``wq`` for a
        single-primary run or ``router`` (a ``ShardRouter``) for a sharded
        run: one snapshot per shard, each cut under that shard's store
        lock, published with the version vector in the single atomic
        manifest."""
        if wq is not None and router is not None:
            raise ValueError("pass wq or router, not both")
        flat = _flatten(state)                       # consistent host cut
        dtypes = _dtypes(state)
        store_snaps: Optional[List[dict]] = None
        log_acks: List[tuple] = []
        queues = [wq] if wq is not None else \
            [sh.wq for sh in router.shards] if router is not None else []
        if queues:
            store_snaps = []
            for q in queues:
                with q.store.txn():  # snapshot + log length: ONE atomic cut
                    snap = q.store.snapshot()        # (log appends happen
                    log_len = len(q.log)             # inside this lock)
                store_snaps.append(
                    {"n_rows": snap["n_rows"], "version": snap["version"],
                     "log_len": log_len, "num_workers": q.num_workers,
                     **{f"col__{k}": v for k, v in snap["cols"].items()}})
                # the checkpoint persists the store through log offset
                # log_len; the consumer registration/ack happens only AFTER
                # the atomic publish in _write — compaction must never be
                # justified by a checkpoint that did not become durable
                log_acks.append((q.log, log_len))
        if self._thread is not None:
            self._thread.join()                      # one write in flight
        sharded = router is not None
        if self.async_write:
            self._thread = threading.Thread(
                target=self._write,
                args=(step, flat, dtypes, store_snaps, log_acks, sharded),
                daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, dtypes, store_snaps, log_acks, sharded)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, flat, dtypes, store_snaps, log_acks=(),
               sharded: bool = False):
        tmp = self.root / f"step_{step:08d}.tmp"
        final = self.root / f"step_{step:08d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        np.savez(tmp / "arrays.npz", **flat)
        store_files: List[str] = []
        for i, snap in enumerate(store_snaps or []):
            name = f"store_{i}.npz" if sharded else "store.npz"
            store_files.append(name)
            np.savez(tmp / name,
                     **{k: v for k, v in snap.items()
                        if isinstance(v, np.ndarray)},
                     __meta__=np.asarray(json.dumps(
                         {k: int(v) for k, v in snap.items()
                          if not isinstance(v, np.ndarray)})))
        manifest = {
            "step": step,
            "time": time.time(),
            "leaves": {k: [list(v.shape), dtypes[k],
                           hashlib.sha1(v.tobytes()).hexdigest()[:16]]
                       for k, v in flat.items()},
            "has_store": bool(store_snaps),
        }
        if sharded:
            # the version VECTOR and the per-shard files ride ONE manifest:
            # either every shard's cut becomes restorable together, or (on
            # a torn write) none does
            manifest["store_files"] = store_files
            manifest["version_vector"] = [int(s["version"])
                                          for s in store_snaps or []]
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():                           # re-save of same step
            shutil.rmtree(final)
        os.replace(tmp, final)                       # atomic publish
        for log, offset in log_acks:                 # durable: safe to let
            if not log.ack("checkpointer", offset):  # compaction pass us;
                log.register_consumer("checkpointer", offset)  # 1st save
        self._gc()

    def _gc(self):
        done = sorted(p for p in self.root.iterdir()
                      if p.is_dir() and not p.name.endswith(".tmp"))
        for p in done[: -self.keep]:
            shutil.rmtree(p)

    # ------------------------------------------------------------- restore
    @staticmethod
    def _complete(d: pathlib.Path) -> bool:
        """True iff the checkpoint directory is restorable: manifest
        parses, the array file exists, and every store file the manifest
        names is present. A torn directory (truncated manifest, missing
        npz) is skipped by latest_step/restore rather than raised on."""
        try:
            manifest = json.loads((d / "manifest.json").read_text())
        except (OSError, json.JSONDecodeError):
            return False
        if not (d / "arrays.npz").exists():
            return False
        if manifest.get("has_store"):
            files = manifest.get("store_files") or ["store.npz"]
            if not all((d / f).exists() for f in files):
                return False
        return True

    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.root.iterdir()
                 if p.is_dir() and not p.name.endswith(".tmp")
                 and self._complete(p)]
        return max(steps) if steps else None

    def restore(self, state_template: Any, step: Optional[int] = None,
                *, router_kw: Optional[dict] = None
                ) -> Tuple[int, Any, object]:
        """Restore the newest COMPLETE checkpoint (or ``step``) into a new
        state shaped like ``state_template`` (on its devices). Returns
        ``(step, state, wq_or_router)``: a ``WorkQueue`` for a
        single-primary checkpoint, a ``ShardRouter`` for a sharded one
        (rebuilt shard by shard: stores, log offsets and compaction
        horizons pinned at the persisted version vector, the
        ``checkpointer`` consumer re-registered per shard, replicators and
        the claim device from ``router_kw``, e.g. ``{"replicate": "delta",
        "device": "cpu"}``)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.root}")
        d = self.root / f"step_{step:08d}"
        if not self._complete(d):
            raise IOError(f"checkpoint {d.name} is torn/incomplete "
                          f"(explicitly requested step {step})")
        manifest = json.loads((d / "manifest.json").read_text())
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        for k, (shape, dtype, sha) in manifest["leaves"].items():
            got = hashlib.sha1(flat[k].tobytes()).hexdigest()[:16]
            if got != sha:
                raise IOError(f"checkpoint corruption at leaf {k}")
        state = _unflatten_into(state_template, flat)
        if not manifest.get("has_store"):
            return step, state, None
        if manifest.get("store_files"):              # sharded checkpoint
            from repro_torch.core.sharding_router import ShardRouter
            shard_states = [self._load_store(d / f)
                            for f in manifest["store_files"]]
            router = ShardRouter.from_checkpoint(shard_states,
                                                 **(router_kw or {}))
            for sh, (_, meta) in zip(router.shards, shard_states):
                # the checkpoint IS this log's consumer floor: re-register
                # it at the resumed base so compaction never outruns the
                # next durable save
                sh.wq.log.register_consumer("checkpointer",
                                            int(meta["log_len"]))
            return step, state, router
        store, meta = self._load_store(d / "store.npz")
        wq = WorkQueue(meta["num_workers"], store=store)
        wq._next_task_id = int(store.col("task_id").max() + 1) \
            if store.n_rows else 0
        # the pre-crash log records are gone: resume absolute offsets at
        # the persisted log length and put the compaction horizon at the
        # checkpoint version, so consumer offsets stay meaningful and
        # time-travel below the checkpoint raises LogCompactedError
        # instead of silently replaying an empty delta
        if meta.get("log_len"):
            wq.log.base = int(meta["log_len"])
            wq.log.horizon_version = int(meta["version"])
        return step, state, wq

    @staticmethod
    def _load_store(path: pathlib.Path) -> Tuple[ColumnStore, dict]:
        with np.load(path) as z:
            meta = json.loads(str(z["__meta__"]))
            cols = {k[len("col__"):]: z[k] for k in z.files
                    if k.startswith("col__")}
        snap = {"n_rows": meta["n_rows"], "version": meta["version"],
                "cols": cols, "blobs": {}}
        return ColumnStore.restore(snap), meta
