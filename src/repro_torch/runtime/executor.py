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
reference computes them in XLA). Sweeps read COW snapshots of the live
store (``analyst="snapshot"``), an in-process delta replica
(``"replica"``) or replica processes fed over the wire (``"remote"``);
``shards > 1`` splits the workers across full primaries behind a
``ShardRouter`` whose every shard queue claims on the executor's device.

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
from repro_torch.core.replication import make_replicator
from repro_torch.core.sharding_router import ShardRouter
from repro_torch.core.steering import SteeringEngine
from repro_torch.core.supervisor import SecondarySupervisor, Supervisor
from repro_torch.core.workqueue import WorkQueue
from repro_torch.data.pipeline import DataConfig, batch_for
from repro_torch.device import resolve_device
from repro_torch.flags import wq_device_claim
from repro_torch.launch.steps import (cast_params, init_train_state,
                                      make_prefill_step, make_serve_step,
                                      make_train_step)
from repro_torch.models.registry import build_model


class TrainExecutor:
    """Train-step tasks in the store. A task's domain columns: in0 = lr
    scale, in1 = data shard, in2 = sweep member id; its outputs: out0 =
    loss, out1 = grad norm, out2 = seconds of the step."""

    def __init__(self, cfg: ModelConfig, *, num_workers: int = 1,
                 base_lr: float = 3e-4, data_cfg: Optional[DataConfig] = None,
                 checkpointer=None, checkpoint_every: int = 50,
                 steer_every: int = 0, seed: int = 0,
                 analyst: str = "snapshot", replicas: int = 1,
                 shards: int = 1, lease_s: Optional[float] = None,
                 device="cuda"):
        # shards > 1: num_workers partitions split across `shards` full
        # primaries behind a ShardRouter; claims, replication and compaction
        # run per shard, steering is the router's scatter-gather sweep, and
        # drained shards pull work from rich siblings each tick
        if shards < 1:
            raise ValueError("shards must be >= 1")
        if shards > 1 and num_workers % shards:
            raise ValueError(f"num_workers={num_workers} must divide "
                             f"evenly across shards={shards}")
        # analyst="snapshot": sweeps read COW snapshot views of the live
        # store; "replica": a delta-caught-up replica store fed only by the
        # txn log; "remote": replicas in separate OS processes fed
        # wire-encoded deltas, where the sweeps run (``replicas`` > 1 fans
        # out to an N-member ReplicaGroup)
        if analyst not in ("snapshot", "replica", "remote"):
            raise ValueError(f"unknown analyst mode {analyst!r}")
        self.cfg = cfg
        self.num_workers = num_workers
        self.base_lr = base_lr
        self.data_cfg = data_cfg or DataConfig(
            vocab_size=cfg.vocab_size, seq_len=128, batch_size=8)
        self.device = resolve_device(device)
        self.workflow = WorkflowConfig(name="train-sweep",
                                       activities=("train_step",))
        self.router: Optional[ShardRouter] = None
        self.analyst = analyst
        self.replicas = replicas
        self.replica = None
        if shards > 1:
            # every shard queue claims on this device, with the device
            # claim flag sampled here, so a promoted shard claims as its
            # siblings do; each shard gets a Supervisor +
            # SecondarySupervisor so expansion state survives a
            # promote_shard
            self.router = ShardRouter(
                shards, num_workers // shards,
                replicate=None if analyst == "snapshot" else analyst,
                replicas=replicas, lease_s=lease_s,
                device_claim=wq_device_claim(), device=self.device)
            self.router.attach_supervision(self.workflow)
            self._adopt_router(self.router)
        else:
            self.wq = WorkQueue(num_workers=num_workers, lease_s=lease_s,
                                device=self.device)
            self._adopt_queue(self.wq)
            if analyst != "snapshot":
                # "replica": the in-process delta arm (nothing ships, so
                # the wire-size accounting is skipped); "remote": a
                # pipelined replica group fed over the wire
                self.replica = make_replicator(
                    self.wq, analyst, replicas=replicas,
                    account_encoded=False)
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

    def _adopt_queue(self, wq: WorkQueue) -> None:
        """Drive ``wq``: the supervisor, its shadow and the steering engine
        read it."""
        self.wq = wq
        self.supervisor = Supervisor(wq, self.workflow)
        self.secondary = SecondarySupervisor(self.supervisor)
        self.steering = SteeringEngine(wq)

    def _adopt_router(self, router: ShardRouter) -> None:
        """Drive ``router``: supervision is per shard, steering the
        router's sweep; ``self.wq`` is shard 0's queue (a primary
        handle)."""
        self.router = router
        self.wq = router.shards[0].wq
        self.supervisor = self.secondary = self.steering = None

    def resume(self, step: int, state: Dict[str, Any], wq) -> None:
        """Continue from a checkpoint (``Checkpointer.restore``): its state
        and step, and its queue (a ``WorkQueue``) or router (a sharded
        checkpoint's ``ShardRouter``) when it has one, which the
        supervisors and the steering then read. The reference's
        ``launch/train.py`` swaps only the queue, so its steering keeps
        reading the old one and ``run`` stops at once. A sharded
        executor takes only a router, an unsharded one only a queue."""
        if wq is not None and isinstance(wq, ShardRouter) != (
                self.router is not None):
            raise ValueError(
                f"cannot resume a {'sharded' if self.router else 'unsharded'}"
                f" executor from a {type(wq).__name__} checkpoint")
        self.state, self.step = state, step
        if isinstance(wq, ShardRouter):
            if self.router is not None:
                self.router.close()
            wq.attach_supervision(self.workflow)
            self._adopt_router(wq)
        elif wq is not None:
            if self.replica is not None:
                self.replica.close()
                self.replica = make_replicator(
                    wq, self.analyst, replicas=self.replicas,
                    account_encoded=False)
            self._adopt_queue(wq)

    # ------------------------------------------------------------- seeding
    def submit_steps(self, n: int, *, lr_scale: float = 1.0,
                     sweep_id: int = 0) -> np.ndarray:
        dom = np.stack([
            np.full(n, lr_scale),
            np.arange(self.step, self.step + n) % (1 << 20),
            np.full(n, sweep_id),
        ], axis=1)
        if self.router is not None:
            return self.router.add_tasks(0, n, domain_in=dom,
                                         now=time.time())
        return self.wq.add_tasks(0, n, domain_in=dom, now=time.time())

    # ---------------------------------------------------------------- tick
    def tick(self) -> Dict[str, float]:
        """One scheduler tick: claim -> execute -> commit provenance."""
        now = time.time()
        if self.router is not None:
            # any drained shard refills from the richest sibling BEFORE
            # claiming: the cross-shard stealing path
            if (self.router.ready_counts()
                    .reshape(self.router.num_shards, -1).sum(1) == 0).any():
                self.router.rebalance(now=now)
            claims = [(self.router.shards[s].wq, rows)
                      for s, rows in self.router.claim_all(
                          k=1, now=now).values()]
        else:
            claims = [(self.wq, rows)
                      for rows in self.wq.claim_all(k=1, now=now).values()]
        metrics_out: Dict[str, float] = {}
        for wq, rows in claims:
            for row in rows:
                lr_scale = wq.store.col("in0")[row]
                shard = int(wq.store.col("in1")[row])
                batch = {k: torch.as_tensor(v, device=self.device)
                         for k, v in batch_for(self.cfg, self.data_cfg,
                                               shard).items()}
                knobs = {"lr": float(np.float32(self.base_lr * lr_scale))}
                t0 = time.time()
                self.state, metrics = self.step_fn(self.state, batch, knobs)
                loss = float(metrics["loss"])
                gnorm = float(metrics["grad_norm"])
                dt_s = time.time() - t0
                wq.finish(np.asarray([row]), now=time.time(),
                          domain_out=np.asarray([[loss, gnorm, dt_s]]))
                self.step += 1
                rec = {"step": self.step, "loss": loss, "grad_norm": gnorm,
                       "s_per_step": dt_s}
                self.history.append(rec)
                metrics_out = rec
        if self.checkpointer and self.checkpoint_every \
                and self.step and self.step % self.checkpoint_every == 0:
            if self.router is not None:
                self.router.sync_secondaries()
                self.checkpointer.save(self.step, self.state,
                                       router=self.router)
            else:
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
            # recovered backlog (sharded runs reap per shard and the
            # reclaimed rows feed rebalance)
            self.reaped_total += self.reap(now=time.time())
            if self.router is not None:
                self._steer_future = self._submit_sharded_sweep()
                return metrics_out
            if self.replica is not None:
                # catch the replica up to this tick's commits (a wire ship
                # for "remote", in-process log replay for "replica"); the
                # sync acked the replica's consumer offset, so compaction
                # follows once a durable checkpoint anchors history
                self.replica.sync()
                self._maybe_compact_log()
            if self.analyst == "remote":
                # the sweep runs IN the replica process: the analyst
                # thread only waits on the result pipe
                self._steer_future = self._steer_pool.submit(
                    self.replica.remote_sweep, time.time())
            else:
                # replica: sweep the caught-up shadow store; snapshot: a
                # COW view of the live store at this tick's commits, read
                # while the next ticks claim
                view = self.replica.snapshot_view() \
                    if self.replica is not None \
                    else self.wq.store.snapshot_view()
                self._steer_future = self._steer_pool.submit(
                    self.steering.run_all, time.time(), view)
        return metrics_out

    def _submit_sharded_sweep(self) -> concurrent.futures.Future:
        """The router's scatter-gather sweep, pinned at one version vector
        on THIS thread (at this tick's commits) and merged on the analyst
        thread; "remote" settles every shard's replica at the vector here
        and runs the partial sweeps inside the replica processes."""
        if self.analyst == "remote":
            vec = self.router.sync_replicas()
            return self._steer_pool.submit(
                self.router.remote_sweep, time.time(), versions=vec,
                sync=False)
        views = (self.router.replica_vector() if self.analyst == "replica"
                 else self.router.snapshot_vector())
        return self._steer_pool.submit(self.router.run_all, time.time(),
                                       views)

    def _maybe_compact_log(self) -> None:
        """Compact the txn log only once a DURABLE checkpoint has acked an
        offset: truncation is then 'since last checkpoint' by construction,
        so ``SteeringEngine.at_version`` keeps its base-snapshot path.
        Without a checkpoint consumer the log is left whole."""
        if self.router is not None:
            for sh in self.router.shards:
                if sh.alive and sh.wq.log.has_consumer("checkpointer"):
                    sh.wq.compact_log()
            return
        if self.wq.log.has_consumer("checkpointer"):
            self.wq.compact_log()

    def run(self, max_ticks: int = 10_000) -> List[Dict[str, float]]:
        for _ in range(max_ticks):
            left = (self.router.tasks_left() if self.router is not None
                    else self.steering.q4_tasks_left())
            if left == 0:
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
        """Release the steering analyst thread (ticks after close raise),
        the replicas and the router's steal pipe."""
        self._drain_steering()
        self._steer_pool.shutdown(wait=True)
        if self.replica is not None:
            self.replica.close()     # stop pinning the log compaction floor
        if self.router is not None:
            self.router.close()      # per-shard replicators + steal pipe

    def __del__(self):
        pool = getattr(self, "_steer_pool", None)
        if pool is not None:
            pool.shutdown(wait=False)

    # -------------------------------------------------------------- fault
    def reap(self, *, now: Optional[float] = None,
             max_trials: int = 3) -> int:
        """Requeue expired-lease RUNNING rows (``WorkQueue.reap_expired``),
        across every shard when sharded. Runs automatically on the
        steering tick."""
        now = time.time() if now is None else now
        if self.router is not None:
            return self.router.reap_expired(now=now, max_trials=max_trials)
        return self.wq.reap_expired(now=now, max_trials=max_trials)

    def fail_worker(self, worker_id: int) -> int:
        """Simulate a node failure: requeue its RUNNING tasks elsewhere
        (sharded: within the shard owning that global worker)."""
        if self.router is not None:
            L = self.router.workers_per_shard
            sh = self.router.shards[worker_id // L]
            return sh.wq.requeue_worker(worker_id % L)
        return self.wq.requeue_worker(worker_id)

    def promote_secondary(self, shard: Optional[int] = None) -> None:
        """Fail the supervisor over to its shadow: the promoted supervisor
        gets a bumped generation and resumes expansion exactly via the
        store's ``expanded`` column. Sharded runs promote per shard
        (``shard=None``: every shard's secondary)."""
        if self.router is not None:
            shards = (range(self.router.num_shards) if shard is None
                      else [shard])
            for s in shards:
                sh = self.router.shards[s]
                if sh.secondary is None:
                    raise ValueError(f"shard {s} has no supervision "
                                     "attached")
                sh.supervisor.crash()
                sh.supervisor = sh.secondary.promote()
                sh.secondary = SecondarySupervisor(sh.supervisor)
            return
        self.supervisor.crash()
        self.supervisor = self.secondary.promote()
        self.secondary = SecondarySupervisor(self.supervisor)

    def fail_shard(self, shard: int) -> None:
        """Kill a shard primary mid-run (sharded executors only)."""
        if self.router is None:
            raise ValueError("fail_shard requires a sharded executor")
        self.router.fail_shard(shard)

    def promote_shard(self, shard: int) -> WorkQueue:
        """Fail a dead shard over onto its most-caught-up replica; the
        promoted queue claims on the executor's device, and ``self.wq``
        follows shard 0's."""
        if self.router is None:
            raise ValueError("promote_shard requires a sharded executor")
        wq = self.router.promote_shard(shard)
        if shard == 0:
            self.wq = wq
        return wq


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
        self.prefill_fn = make_prefill_step(cfg, None, self.max_len)
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
