"""WQ-driven executors: the paper's architecture running real ML work.

TrainExecutor — the supervisor's workflow of train-step tasks; each
scheduler tick claims the next task per worker partition from the WQ (one
vectorized ``claim_all``: the ``wq_claim`` semantics, through the claim
kernel when ``flags.device_claims()`` is on), runs the train step with the
task's knobs (lr scale, data shard), and commits provenance (loss, grad
norm, seconds) back to the SAME store the steering engine queries, whose
sweeps run on store snapshots on an analyst thread meanwhile. The loop is
the reference's (``repro/runtime/executor.py``); on a CUDA device every
family runs attention and the SSD and RG-LRU scans forward and backward in
the hand-written kernels (the MoE experts' products in torch, as the
reference computes them in XLA). The replica / remote analysts and the sharded topology need
the replication and sharding modules (ROADMAP Queue 1, the rest of the
control plane) and raise.

ServeExecutor — continuous batching: requests are WQ rows; decode slots claim
requests from their partition; per-token progress/results are store updates.
The loop is the reference's: claim, prefill with the fp32 master params,
decode in ``cfg.dtype`` against a ``cfg.dtype`` cache (the SSM family: the
O(1) recurrent state; the hybrid: RG-LRU states and a ring of
``min(window, max_len)`` K/V slots), finish with the output written back to
the store. On a CUDA device the hand-written kernels run prefill and decode
attention (dense, MoE, hybrid), the prefill's SSD scan (SSM) and its RG-LRU
scan (hybrid). Like the reference's, it prefills a request's token prompt
alone, so the VLM and enc-dec families, whose prefill needs patch
embeddings or frames, fail at the first admission (a KeyError), as they do
there; their model bundles serve them.
"""
from __future__ import annotations

import concurrent.futures
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.risers_workflow import WorkflowConfig
from repro_torch.core.steering import SteeringEngine
from repro_torch.core.supervisor import SecondarySupervisor, Supervisor
from repro_torch.core.workqueue import WorkQueue
from repro_torch.data.pipeline import DataConfig, batch_for
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (cast_params, init_train_state,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.registry import build_model

CONTROL_PLANE_ITEM = ("needs the replication and sharding modules: ROADMAP "
                      "Queue 1, the rest of the control plane")


class TrainExecutor:
    """Train-step tasks in the store. A task's domain columns: in0 = lr
    scale, in1 = data shard, in2 = sweep member id; its outputs: out0 =
    loss, out1 = grad norm, out2 = seconds of the step."""

    def __init__(self, cfg: ModelConfig, *, num_workers: int = 1,
                 base_lr: float = 3e-4, data_cfg: Optional[DataConfig] = None,
                 checkpointer=None, checkpoint_every: int = 50,
                 steer_every: int = 0, seed: int = 0,
                 analyst: str = "snapshot", shards: int = 1,
                 lease_s: Optional[float] = None, device="cuda"):
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if shards > 1:
            raise NotImplementedError(f"shards={shards}: the sharded "
                                      f"topology {CONTROL_PLANE_ITEM}")
        if analyst not in ("snapshot", "replica", "remote"):
            raise ValueError(f"unknown analyst mode {analyst!r}")
        if analyst != "snapshot":
            raise NotImplementedError(f"analyst={analyst!r} "
                                      f"{CONTROL_PLANE_ITEM}")
        self.cfg = cfg
        self.num_workers = num_workers
        self.base_lr = base_lr
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=cfg.vocab_size, seq_len=128, batch_size=8)
        self.device = resolve_device(device)
        self.workflow = WorkflowConfig(name="train-sweep",
                                       activities=("train_step",))
        self.wq = WorkQueue(num_workers=num_workers, lease_s=lease_s,
                            device=self.device)
        self.supervisor = Supervisor(self.wq, self.workflow)
        self.secondary = SecondarySupervisor(self.supervisor)
        self.steering = SteeringEngine(self.wq)
        self.analyst = analyst
        self.checkpointer = checkpointer
        self.checkpoint_every = checkpoint_every
        self.steer_every = steer_every
        # steering sweeps run on an analyst thread against a store snapshot,
        # concurrent with the claim/train/commit loop (HTAP, paper Exp. 7)
        self._steer_pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="steering")
        self._steer_future: Optional[concurrent.futures.Future] = None
        self.last_steering: Optional[Dict[str, object]] = None
        self.step_fn = make_train_step(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.state = init_train_state(cfg, gen)
        self.step = 0
        self.reaped_total = 0
        self.history: List[Dict[str, float]] = []

    def resume(self, step: int, state: Dict[str, Any],
               wq: Optional[WorkQueue]) -> None:
        """Continue from a checkpoint (``Checkpointer.restore``): its state
        and step, and its queue when it has one, which the supervisor, its
        shadow and the steering engine then read. The reference's
        ``launch/train.py`` swaps only the queue, so its steering keeps
        reading the old one and ``run`` stops at once."""
        self.state, self.step = state, step
        if wq is not None:
            self.wq = wq
            self.supervisor = Supervisor(wq, self.workflow)
            self.secondary = SecondarySupervisor(self.supervisor)
            self.steering = SteeringEngine(wq)

    # ------------------------------------------------------------- seeding
    def submit_steps(self, n: int, *, lr_scale: float = 1.0,
                     sweep_id: int = 0) -> np.ndarray:
        dom = np.stack([
            np.full(n, lr_scale),
            np.arange(self.step, self.step + n) % (1 << 20),
            np.full(n, sweep_id),
        ], axis=1)
        return self.wq.add_tasks(0, n, domain_in=dom, now=time.time())

    # ---------------------------------------------------------------- tick
    def tick(self) -> Dict[str, float]:
        """One scheduler tick: claim -> execute -> commit provenance."""
        claims = self.wq.claim_all(k=1, now=time.time()).values()
        metrics_out: Dict[str, float] = {}
        for rows in claims:
            for row in rows:
                lr_scale = self.wq.store.col("in0")[row]
                shard = int(self.wq.store.col("in1")[row])
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch_for(self.cfg, self.data_cfg,
                                               shard).items()}
                knobs = {"lr": float(np.float32(self.base_lr * lr_scale))}
                t0 = time.time()
                self.state, metrics = self.step_fn(self.state, batch, knobs)
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                dt_s = time.time() - t0
                self.wq.finish(np.asarray([row]), now=time.time(),
                               domain_out=np.asarray([[loss, gnorm, dt_s]]))
                self.step += 1
                rec = {"step": self.step, "loss": loss, "grad_norm": gnorm,
                       "s_per_step": dt_s}
                self.history.append(rec)
                metrics_out = rec
        if self.checkpointer and self.checkpoint_every \
                and self.step and self.step % self.checkpoint_every == 0:
            self.checkpointer.save(self.step, self.state, self.wq)
            self._maybe_compact_log()
        if self._steer_future is not None and self._steer_future.done():
            self.last_steering = self._steer_future.result()
            metrics_out["steering"] = self.last_steering
            self._steer_future = None
        if self.steer_every and self.step % self.steer_every == 0 \
                and self._steer_future is None:
            # the steering tick doubles as the lease sweep: requeue every
            # expired RUNNING claim before analyzing, so the sweep sees the
            # recovered backlog; the sweep reads a COW view of the live
            # store at this tick's commits while the next ticks claim
            self.reaped_total += self.reap(now=time.time())
            self._steer_future = self._steer_pool.submit(
                self.steering.run_all, time.time(),
                self.wq.store.snapshot_view())
        return metrics_out

    def _maybe_compact_log(self) -> None:
        """Compact the txn log only once a DURABLE checkpoint has acked an
        offset: truncation is then 'since last checkpoint' by construction.
        Without a checkpoint consumer the log is left whole."""
        if self.wq.log.has_consumer("checkpointer"):
            self.wq.compact_log()

    def run(self, max_ticks: int = 10_000) -> List[Dict[str, float]]:
        for _ in range(max_ticks):
            if self.steering.q4_tasks_left() == 0:
                break
            self.tick()
        self._drain_steering()
        return self.history

    def _drain_steering(self) -> None:
        """Harvest an in-flight sweep; record it on the latest history entry
        so short runs still surface their final (paid-for) sweep."""
        if self._steer_future is not None:
            self.last_steering = self._steer_future.result()
            self._steer_future = None
            if self.history:
                self.history[-1].setdefault("steering", self.last_steering)

    def close(self) -> None:
        """Release the steering analyst thread (ticks after close raise)."""
        self._drain_steering()
        self._steer_pool.shutdown(wait=True)

    def __del__(self):
        pool = getattr(self, "_steer_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    # -------------------------------------------------------------- fault
    def reap(self, *, now: Optional[float] = None,
             max_trials: int = 3) -> int:
        """Requeue expired-lease RUNNING rows (``WorkQueue.reap_expired``).
        Runs automatically on the steering tick."""
        now = time.time() if now is None else now
        return self.wq.reap_expired(now=now, max_trials=max_trials)

    def fail_worker(self, worker_id: int) -> int:
        """Simulate a node failure: requeue its RUNNING tasks elsewhere."""
        return self.wq.requeue_worker(worker_id)

    def promote_secondary(self) -> None:
        """Fail the supervisor over to its shadow: the promoted supervisor
        gets a bumped generation and resumes expansion exactly via the
        store's ``expanded`` column."""
        self.supervisor.crash()
        self.supervisor = self.secondary.promote()
        self.secondary = SecondarySupervisor(self.supervisor)


class ServeExecutor:
    """Continuous batching driven by the store: requests are WQ rows."""

    def __init__(self, cfg: ModelConfig, *, slots: int = 4,
                 max_len: int = 128, seed: int = 0, device="cuda"):
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len
        self.device = resolve_device(device)
        self.wq = WorkQueue(num_workers=slots, device=self.device)
        self.model = build_model(cfg)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.set_params(self.model.init(gen))
        self.serve_fn = make_serve_step(cfg)
        # prefill takes the master params uncast, as the reference does
        self.prefill_fn = make_prefill_step(cfg, self.max_len)
        self.slot_row: Dict[int, int] = {}
        self.slot_tokens: Dict[int, List[int]] = {}
        self.slot_budget: Dict[int, int] = {}
        self._caches: Dict[int, Dict[str, Any]] = {}
        self._last: Dict[int, torch.Tensor] = {}   # last token, on device
        self.rng = torch.Generator(device=self.device).manual_seed(seed)

    def set_params(self, params: torch.nn.Module) -> None:
        """Serve ``params`` (master dtype); decode uses one copy of them in
        ``cfg.dtype``, made here once instead of a cast on every step."""
        self.params = params.to(self.device).requires_grad_(False)
        self.decode_params = cast_params(self.params, self.cfg.dtype)

    def submit(self, prompts: np.ndarray, max_new: int = 16) -> np.ndarray:
        n = prompts.shape[0]
        dom = np.stack([np.full(n, max_new), np.zeros(n), np.zeros(n)],
                       axis=1)
        ids = self.wq.add_tasks(0, n, domain_in=dom, now=time.time())
        for tid, p in zip(ids, prompts):
            self.wq.store.blobs[int(tid)] = {"prompt": p}
        return ids

    def _admit(self) -> None:
        """Claim queued requests into free slots (continuous batching)."""
        free = [s for s in range(self.slots) if s not in self.slot_row]
        if not free:
            return
        for s in free:
            rows = self.wq.claim(s, k=1, now=time.time(), allow_steal=True)
            if len(rows) == 0:
                continue
            row = int(rows[0])
            tid = int(self.wq.store.col("task_id")[row])
            prompt = self.wq.store.blobs[tid]["prompt"]
            batch = {"tokens": torch.as_tensor(
                prompt[None, :].astype(np.int32), device=self.device)}
            nxt, cache = self.prefill_fn(self.params, batch)
            self.slot_row[s] = row
            self.slot_tokens[s] = [int(nxt[0, 0])]
            self.slot_budget[s] = int(self.wq.store.col("in0")[row])
            self._caches[s] = cache
            self._last[s] = nxt

    def step_decode(self) -> int:
        """One decode step across active slots; returns #finished."""
        self._admit()
        finished = 0
        for s in list(self.slot_row):
            nxt, cache, _ = self.serve_fn(self.decode_params, self._last[s],
                                          self._caches[s], self.rng)
            self._caches[s] = cache
            self._last[s] = nxt
            self.slot_tokens[s].append(int(nxt[0, 0]))
            if len(self.slot_tokens[s]) >= self.slot_budget[s] \
                    or int(cache["idx"]) >= self.max_len - 1:
                row = self.slot_row.pop(s)
                toks = self.slot_tokens.pop(s)
                del self._caches[s], self._last[s]
                tid = int(self.wq.store.col("task_id")[row])
                self.wq.store.blobs[tid]["output"] = np.asarray(toks)
                self.wq.finish(np.asarray([row]), now=time.time(),
                               domain_out=np.asarray(
                                   [[float(len(toks)), 0.0, 0.0]]))
                finished += 1
        return finished

    def drain(self, max_steps: int = 10_000) -> int:
        total = 0
        for _ in range(max_steps):
            left = SteeringEngine(self.wq).q4_tasks_left()
            if left == 0 and not self.slot_row:
                break
            total += self.step_decode()
        return total
