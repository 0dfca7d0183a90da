"""WQ-driven serving: the paper's architecture running real ML work.

ServeExecutor — continuous batching: requests are WQ rows; decode slots claim
requests from their partition; per-token progress/results are store updates.
The loop is the reference's (``repro/runtime/executor.py``): claim, prefill
with the fp32 master params, decode in ``cfg.dtype`` against a ``cfg.dtype``
cache (the SSM family: the O(1) recurrent state; the hybrid: RG-LRU states
and a ring of ``min(window, max_len)`` K/V slots), finish with the output
written back to the store. On a CUDA device the hand-written kernels run
prefill and decode attention (dense, hybrid), the prefill's SSD scan (SSM)
and its RG-LRU scan (hybrid). The training executor comes with the
training slice.
"""
from __future__ import annotations

import time
from typing import Any, Dict, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.steering import SteeringEngine
from repro_torch.core.workqueue import WorkQueue
from repro_torch.device import resolve_device
from repro_torch.launch.steps import (cast_params, make_prefill_step,
                                      make_serve_step)
from repro_torch.models.registry import build_model


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
