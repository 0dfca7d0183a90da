"""The ``sweep`` traffic kind: a parameter sweep of train-step tasks in the
store, driven through the port's ``TrainExecutor.tick``.

Set-up builds one executor (its model, its AdamW state, its store and
steering engine) at the configuration's sizes, loads the benchmark's
weights into it, inserts the mix's backlog and runs ``WARMUP_TICKS``
ticks through the same call and feed as the window. Those first steps
are the ones the plain reference follows afterwards: each step's loss,
the first gradient as AdamW took it (read from its first moment) and each
parameter's change over the checked steps (read as step
``CHECKED_STEPS + 1`` finds them). The window then ticks for ``seconds``.
Once it closes, the store, a sample of the steering sweeps and the
checked steps are held against their references.

The mix gives the deployment (rows, sequence length, the backlog, workers,
steering); what the comparison reads is fixed here, since the cells'
limits were set at these values.
"""
from __future__ import annotations

import dataclasses
import gc
import time
import types
import typing
from typing import Any, Dict, List

import numpy as np
import torch

from benchlib import cells, checks, program_trace, traffic, weights
from benchlib.trace import Recorder, read_profile
from plainref import steering as ref_steering
from plainref.common import B1, Numerics, full_precision, train_steps

WARMUP_TICKS = 2      # set-up's ticks: 2 tasks each, as the window's
CHECKED_STEPS = 3     # the first steps the reference follows
STEER_CHECKS = 4      # steering sweeps drawn from the seed and checked
TRACE_SECONDS = 8.0   # the traced part of a --trace 1 window


def model_config(m: Dict[str, Any]):
    """The port's ``ModelConfig`` of a configuration file's ``model``, its
    nested configurations (``moe``, ``ssm``, ``rglru``, any the port has)
    built as their dataclasses."""
    from repro_torch.configs.base import ModelConfig
    return _as_type(ModelConfig, m)


def _as_type(hint, value):
    """JSON ``value`` as the type ``hint`` names: a dict as the dataclass,
    field by field; a list as a tuple where the type is one; an Optional's
    value as its type."""
    if typing.get_origin(hint) in (typing.Union, types.UnionType):
        hint = next(a for a in typing.get_args(hint) if a is not type(None))
    if dataclasses.is_dataclass(hint) and isinstance(value, dict):
        hints = typing.get_type_hints(hint)
        return hint(**{k: _as_type(hints.get(k, Any), v)
                       for k, v in value.items()})
    if typing.get_origin(hint) is tuple and isinstance(value, list):
        args = typing.get_args(hint)
        if len(args) == 2 and args[1] is Ellipsis:
            args = (args[0],) * len(value)
        return tuple(_as_type(a, v) for a, v in zip(args, value))
    return value


def _leaf_norms(tensors: Dict[str, torch.Tensor], scale: float = 1.0
                ) -> Dict[str, float]:
    names = list(tensors)
    norms = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                         for n in names]).double().cpu() * scale
    return dict(zip(names, norms.tolist()))


class SweepRun:
    """One run of a sweep cell on ``device``."""

    def __init__(self, cell, seed: int, device: str, trace: bool):
        self.cell, self.seed, self.device, self.trace = cell, seed, device, \
            trace
        self.mix, self.m = cell.mix, cell.model
        self.ref = cell.reference()
        self.spec = self.ref.param_spec(self.m)
        self.rec = Recorder()
        self.steps: List[Any] = []         # each step's returned loss
        # (row, loss written, t, the store's end time), as finished
        self.finished: List[tuple] = []
        self.claims: List[tuple] = []      # (row, worker, start time)
        self.sweeps = 0
        self.kept_sweeps: List[tuple] = []
        self.readings: Dict[str, Any] = {}
        self._patched: List[tuple] = []
        self._records: list = []           # the port's spans, traced part
        self.entries = cells.op_entries() if trace else {}
        self.tokens = self.mix["rows"] * self.mix["seq_len"]

    # ----------------------------------------------------------- set-up
    def setup(self) -> None:
        t = [time.perf_counter()]
        from repro_torch.data.pipeline import DataConfig
        from repro_torch.flags import device_claims
        from repro_torch.runtime import executor as X
        t.append(time.perf_counter())
        mix, m = self.mix, self.m
        cfg = model_config(m)
        with device_claims(bool(mix["device_claim"])):
            ex = X.TrainExecutor(
                cfg, num_workers=mix["workers"], base_lr=mix["base_lr"],
                data_cfg=DataConfig(vocab_size=m["vocab_size"],
                                    seq_len=mix["seq_len"],
                                    batch_size=mix["rows"],
                                    seed=traffic.data_seed(self.seed)),
                steer_every=mix["steer_every"], seed=self.seed,
                analyst=mix["analyst"], device=self.device)
        self.ex = ex
        self._sync()
        t.append(time.perf_counter())
        weights.load_into(ex.state["params"], self.spec, self.seed)
        self._sync()
        t.append(time.perf_counter())
        self.backlog = traffic.sweep_backlog(mix, self.seed)
        ids = ex.wq.add_tasks(0, len(self.backlog), domain_in=self.backlog,
                              now=time.time())
        # the backlog position of each store row's task
        pos = np.full(int(ids.max()) + 1, -1, np.int64)
        pos[ids] = np.arange(len(ids))
        self.task_pos = pos
        self.row_pos = pos[ex.wq.store.col("task_id")[:len(ids)]]
        self._instrument(X)
        t.append(time.perf_counter())
        for _ in range(WARMUP_TICKS):
            ex.tick()
        if len(self.steps) <= CHECKED_STEPS:
            raise RuntimeError(
                f"set-up ran {len(self.steps)} steps; the checks need "
                f"{CHECKED_STEPS + 1}")
        self._sync()
        t.append(time.perf_counter())
        self.setup_split = dict(zip(
            ("import_port_s", "executor_s", "weights_s", "backlog_s",
             "warmup_ticks_s"), np.diff(t).tolist()))

    def _sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def _instrument(self, X) -> None:
        """Wrap the calls into each layer: the step (the checks' readings),
        the queue's claim and finish, the steering sweep, the data feed,
        and in a traced run the op entries the kernel files declare."""
        ex, rec = self.ex, self.rec
        inner_step = ex.step_fn

        def step(state, batch, knobs):
            n = len(self.steps) + 1
            if n == CHECKED_STEPS + 1:
                self.readings["change"] = self._change(state["params"])
            with rec.span("step"):
                state, metrics = inner_step(state, batch, knobs)
            if n == 1:
                self.readings["grad"] = _leaf_norms(
                    state["opt"]["inner"]["m"], 1.0 / (1.0 - B1))
            self.steps.append(metrics["loss"].detach())
            return state, metrics

        ex.step_fn = step
        self._wrap_queue(ex.wq)
        inner_sweep = ex.steering.run_all
        keep = np.random.default_rng(self.seed ^ 0x5EE7)

        def sweep(now, view=None):
            with rec.span("steer"):
                out = inner_sweep(now, view)
            self.sweeps += 1
            # a reservoir of sweeps drawn from the seed
            k = STEER_CHECKS
            if len(self.kept_sweeps) < k:
                self.kept_sweeps.append((now, view, out))
            elif keep.integers(0, self.sweeps) < k:
                self.kept_sweeps[keep.integers(0, k)] = (now, view, out)
            return out

        ex.steering.run_all = sweep
        self._patch(X, "batch_for", rec.wrap("batch", X.batch_for))
        if self.entries:
            from repro_torch.kernels import ops as kops
            for label, e in self.entries.items():
                self._patch(kops, e.op, rec.wrap_op(
                    label, getattr(kops, e.op), e.shape))

    def _patch(self, module, name: str, fn) -> None:
        """Put ``fn`` in place of ``module.name`` until the program is
        closed."""
        self._patched.append((module, name, getattr(module, name)))
        setattr(module, name, fn)

    def _wrap_queue(self, wq) -> None:
        rec = self.rec
        inner_claim, inner_finish = wq.claim_all, wq.finish

        def claim_all(*a, now=0.0, **k):
            with rec.span("claim"):
                out = inner_claim(*a, now=now, **k)
            for worker, rows in out.items():
                self.claims += [(int(r), int(worker), now) for r in rows]
            return out

        def finish(idx, *, now=0.0, domain_out=None):
            with rec.span("commit"):
                inner_finish(idx, now=now, domain_out=domain_out)
            t = time.perf_counter()
            for i, row in enumerate(np.asarray(idx)):
                self.finished.append((int(row), float(domain_out[i, 0]), t,
                                      now))

        wq.claim_all, wq.finish = claim_all, finish

    def _change(self, params) -> Dict[str, float]:
        """Each parameter's distance from the weights it started from."""
        named = dict(params.named_parameters())
        with torch.no_grad():
            diffs = {n: named[n].detach() - t for n, t in
                     weights.leaves(self.spec, self.seed,
                                    next(params.parameters()).device)}
            return _leaf_norms(diffs)

    # ----------------------------------------------------------- window
    def window(self, seconds: float) -> Dict[str, Any]:
        """Tick for ``seconds``; in a traced run, the profiler, the
        benchmark's spans and the port's own (its tracer on) cover its
        first ``TRACE_SECONDS``."""
        ex, rec = self.ex, self.rec
        n_before = len(self.finished)
        prof, t_trace = None, None
        if self.trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
            program_trace.switch(True)
            prof.__enter__()
            rec.active = True
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ex.tick()
            if rec.active and \
                    time.perf_counter() - t0 >= TRACE_SECONDS:
                t_trace = self._stop_trace(prof)
        if rec.active:
            t_trace = self._stop_trace(prof)
        t_end = t0 + seconds
        done = [f for f in self.finished[n_before:] if f[2] <= t_end]
        ran = self.finished[n_before:]
        out = {"t0": t0, "tasks": len(done), "ran": len(ran),
               "nonfinite": sum(not np.isfinite(f[1]) for f in ran),
               "tokens_per_s": len(done) * self.tokens / (done[-1][2] - t0)
               if done else None}
        if prof is not None:
            traced = [f for f in self.finished[n_before:] if f[2] <= t_trace]
            obs = read_profile(prof, t_trace - t0, self.entries)
            obs.update(spans=dict(rec.spans), span_cpu=dict(rec.cpu),
                       shapes=dict(rec.shapes),
                       tasks=len(traced),
                       task_window_s=(traced[-1][2] - t0) if traced else None,
                       step_flops=cells.train_step_flops(
                           self.m, self.mix["rows"], self.mix["seq_len"]),
                       program=program_trace.read_program(prof,
                                                          self._records))
            out["obs"] = obs
        return out

    def _stop_trace(self, prof) -> float:
        """Close the traced part of the window: the device drained, the
        spans and the port's tracer off, the profiler stopped. Returns its
        end on the host."""
        self._sync()
        t = time.perf_counter()
        self.rec.active = False
        self._records = program_trace.switch(False)
        prof.__exit__(None, None, None)
        return t

    # ----------------------------------------------------------- checks
    def close_program(self) -> None:
        """Free the program's state before the reference runs."""
        self.ex.close()
        self.final_out0 = self.ex.wq.store.col("out0").copy()
        self.final_status = self.ex.wq.store.col("status").copy()
        del self.ex
        for module, name, fn in reversed(self._patched):
            setattr(module, name, fn)
        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> Dict[str, Any]:
        """Every number compared, with its value (the limits apply in
        :mod:`benchlib.checks`)."""
        t = time.perf_counter()
        found = {}
        found.update(self._check_store())
        found.update(self._check_steering())
        found.update(self.check_training())
        self.check_s = time.perf_counter() - t
        return found

    def _check_store(self) -> Dict[str, float]:
        claimed = np.asarray([c[0] for c in self.claims], np.int64)
        rows = np.asarray([f[0] for f in self.finished])
        written = np.asarray([f[1] for f in self.finished])
        returned = np.asarray([float(x) for x in self.steps])
        bad = len(claimed) - len(np.unique(claimed))          # claimed twice
        bad += len(rows) - len(np.unique(rows))                # finished twice
        bad += int(np.sum(~np.isin(rows, claimed)))            # never claimed
        bad += abs(len(rows) - len(returned))
        n = min(len(rows), len(returned))
        bad += int(np.sum(_differ(written[:n], returned[:n])))  # not its loss
        bad += int(np.sum(_differ(self.final_out0[rows], written)))  # lost
        bad += int(np.sum(self.final_status[rows] != ref_steering.FINISHED))
        return {"store_faults": float(bad)}

    def _check_steering(self) -> Dict[str, float]:
        """Each sampled sweep's answers against a plain sweep of its
        snapshot, and the snapshot against what the benchmark put into the
        store and saw come out of it (``snapshot_faults``, counted in
        ``steer_faults`` too)."""
        bad = snap = 0
        for now, view, got in self.kept_sweeps:
            want = ref_steering.sweep(view.col, self.mix["workers"], now)
            bad += len(ref_steering.mismatches(
                got, want, self.cell.limits["steer_q6_rel"]))
            snap += self._snapshot_faults(view, now)
        if not self.kept_sweeps:
            bad += 1
        return {"steer_faults": float(bad + snap),
                "snapshot_faults": float(snap)}

    def _snapshot_faults(self, view, now: float) -> int:
        """The rows of a snapshot that the benchmark's own record does not
        account for. Its record: the backlog as inserted (each task's id and
        domain inputs), every claim as the queue returned it (row, worker,
        the time the claim was made at) and every finish (row, loss, time)
        in order. A snapshot taken between ticks holds the backlog with a
        prefix of those claims and of those finishes applied, and nothing
        else: no failure, no other activity, no unclaimed row started in the
        sweep's horizon. A claimed row is in its claiming worker's partition:
        a sweep's partitions hold tens of thousands of rows each, so no
        claim in a run steals."""
        col, n = view.col, len(self.backlog)
        if view.n_rows != n:
            return abs(view.n_rows - n) or 1
        tid = col("task_id")
        pos = np.full(n, -1, np.int64)
        known = (tid >= 0) & (tid < len(self.task_pos))
        pos[known] = self.task_pos[tid[known]]
        bad = int(np.sum(pos < 0)) + n - len(np.unique(pos[pos >= 0]))
        ok = pos >= 0
        dom = np.stack([col(f"in{i}") for i in range(self.backlog.shape[1])],
                       axis=1)
        bad += int(np.sum(np.any(dom[ok] != self.backlog[pos[ok]], axis=1)))
        bad += int(np.sum(col("activity_id") != 0))
        bad += int(np.sum(col("fail_trials") != 0))
        wid = col("worker_id")
        bad += int(np.sum((wid < 0) | (wid >= self.mix["workers"])))
        st = col("status")
        bad += int(np.sum(~np.isin(st, (ref_steering.READY,
                                        ref_steering.RUNNING,
                                        ref_steering.FINISHED))))
        ready = st == ref_steering.READY
        bad += int(np.sum(col("start_time")[ready]
                          >= now - ref_steering.HORIZON_S))

        def prefix(rows, log, cols):
            """Faults of ``rows`` against the first len(rows) entries of
            ``log`` ((row, *values) each), ``cols`` naming the values."""
            head = log[:len(rows)]
            k = len(rows) - len(head)
            seen = np.asarray([e[0] for e in head], np.int64)
            k += len(np.setxor1d(rows, seen))
            inside = np.isin(seen, rows)
            for j, name in enumerate(cols, start=1):
                want = np.asarray([e[j] for e in head])[inside]
                k += int(np.sum(_differ(col(name)[seen[inside]], want)))
            return k

        started = np.flatnonzero(st != ref_steering.READY)
        done = np.flatnonzero(st == ref_steering.FINISHED)
        bad += prefix(started, self.claims, ("worker_id", "start_time"))
        bad += prefix(done, [(f[0], f[1], f[3]) for f in self.finished],
                      ("out0", "end_time"))
        return bad

    def check_training(self) -> Dict[str, float]:
        k = CHECKED_STEPS
        dom = [self.backlog[self.row_pos[f[0]]] for f in self.finished[:k]]
        ref = reference_steps(self.ref, self.m, self.spec, self.seed,
                              self.device, self.mix, dom)
        prog = {"losses": [float(x) for x in self.steps[:k]],
                "grad": self.readings["grad"],
                "change": self.readings["change"]}
        self.reference_readings = ref
        gaps = checks.train_gaps(prog, ref)
        self.train_info = {k: gaps.pop(k) for k in
                           ("loss_gap_steps", "grad_worst", "change_worst")}
        return gaps


    # ---------------------------------------------------------- results
    def end_to_end(self, win) -> Dict[str, float]:
        return {"train_tokens_per_s": win["tokens_per_s"]}

    def attempted(self, win) -> int:
        return win["ran"]

    def failed(self, win) -> int:
        return win["nonfinite"]

    def info(self, win) -> Dict[str, Any]:
        return {"tasks_in_window": win["tasks"], "sweeps": self.sweeps,
                **span_walls(win.get("obs")),
                **program_trace.info(win.get("obs")),
                "steer_checked": len(self.kept_sweeps),
                "check_s": getattr(self, "check_s", None),
                **getattr(self, "train_info", {}),
                **getattr(self, "setup_split", {}),
                "tokens_per_task": self.tokens}


Run = SweepRun


def reference_steps(ref, m, spec, seed, device, mix, dom,
                    numerics: str = "fp32", half_batch: bool = False):
    """The plain reference's readings of the checked steps: the same
    weights, the same batches (``dom``: each step's lr scale and shard)."""
    full_precision()
    w = dict(weights.leaves(spec, seed, device))
    batches, lrs = [], []
    for lr_scale, shard, _ in dom:
        b = traffic.shard_batch(m["vocab_size"], mix["seq_len"], mix["rows"],
                                traffic.data_seed(seed), int(shard))
        if half_batch:
            b = {k: v[:mix["rows"] // 2] for k, v in b.items()}
        batches.append({k: torch.as_tensor(v, device=device)
                        for k, v in b.items()})
        lrs.append(float(np.float32(mix["base_lr"] * lr_scale)))
    num = Numerics(numerics)
    return train_steps(lambda p, b: ref.loss(num, m, p, b), w, batches, lrs)


def span_walls(obs) -> Dict[str, float]:
    """Of a traced window: the mean wall ms of a claim and of a sweep, and
    how much of it each waited for the interpreter lock (wall less its
    thread's CPU time; the per-layer metrics read the CPU time)."""
    out: Dict[str, float] = {}
    for name in ("claim", "steer") if obs else ():
        wall, cpu = obs["spans"].get(name), obs["span_cpu"].get(name)
        if wall:
            out[f"{name}_wall_ms"] = 1e3 * sum(wall) / len(wall)
            out[f"{name}_lock_wait_ms"] = 1e3 * (sum(wall) - sum(cpu)) \
                / len(wall)
    return out


def _differ(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise a != b, a NaN equal to a NaN."""
    return ~((a == b) | (np.isnan(a) & np.isnan(b)))

