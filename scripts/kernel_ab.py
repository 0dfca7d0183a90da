#!/usr/bin/env python3
"""Times the decode attention and SSD scan kernels of one checkout at the
serve path's shapes, so that two checkouts can be compared on one card.

    python scripts/kernel_ab.py --root DIR [--label NAME]

Loads ``DIR/chip_smoke.py``, which puts ``DIR/src`` first on the import
path, and times that checkout's ``decode_attention_fwd`` (bf16: qwen2-0.5b's
cache at kv_len 1000; recurrentgemma-9b's ring of 2048 at kv_len 1001 and
full; a linear cache of 4096 at kv_len 3000 with window 2048) and
``ssd_scan_fwd`` (mamba2-1.3b's prefill: S 1000 fp32, ragged S 1031, bf16,
slow decay at S 4096). Each case prints one JSON line: CUDA-event ms over
back-to-back calls, and the kernels' device time (torch.profiler) back to
back (warm: inputs stay in L2) and with L2 flushed before each call (cold).
Run one checkout per process (the package is imported once), in turns:
parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import time

import numpy as np
import torch

DECODE = [  # (case, smax, hq, hkv, dh, kv_len, window)
    ("qwen2 kv_len 1000", 4096, 14, 2, 64, 1000, 0),
    ("ring kv_len 1001", 2048, 16, 1, 256, 1001, 0),
    ("ring full", 2048, 16, 1, 256, 2048, 0),
    ("linear kv_len 3000 window 2048", 4096, 16, 1, 256, 3000, 2048),
]
SSD = [  # (case, seq, dtype, slow decay)
    ("main", 1000, torch.float32, False),
    ("ragged", 1031, torch.float32, False),
    ("bf16", 1000, torch.bfloat16, False),
    ("slow_decay", 4096, torch.float32, True),
]


def load(root: str):
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def profiled_ms(mod, fn, iters: int, cold: bool) -> float:
    """Mean device ms per call of ``fn``'s kernels; ``cold``: each call
    after the checkout's L2 flush, whose own kernels are left out."""
    from torch.profiler import ProfilerActivity, profile

    def run(body):   # a profile without device activity is taken again
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                body()
                torch.cuda.synchronize()
            found = mod._device_kernel_us(prof)
            if found:
                return found
        return found

    def body():
        for _ in range(iters):
            if cold:
                mod.flush_l2()
            fn()

    fn()
    torch.cuda.synchronize()
    flush = set(run(mod.flush_l2)) if cold else set()
    return sum(us for k, us in run(body).items()
               if not (cold and (k in flush or "reduce_kernel" in k))) \
        / iters / 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", required=True)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    mod = load(args.root)
    dev = torch.device("cuda", 0)
    # two seconds of matrix products first, so that the clocks have risen
    # before the first case is timed
    a = torch.randn(4096, 4096, device=dev)
    t_end = time.perf_counter() + 2.0
    while time.perf_counter() < t_end:
        a @ a
        torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    label = args.label or os.path.abspath(args.root)
    for case, smax, hq, hkv, dh, kv_len, window in DECODE:
        q = torch.as_tensor(rng.standard_normal((1, 1, hq, dh)),
                            dtype=torch.float32, device=dev).bfloat16()
        k, v = (torch.as_tensor(rng.standard_normal((1, smax, hkv, dh)),
                                dtype=torch.float32, device=dev).bfloat16()
                for _ in range(2))
        kvl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)

        def fn():
            return mod.decode_attention_fwd(q, k, v, kvl, window)

        err = float((fn().float() - mod.decode_attention_ref(
            q, k, v, kvl, window).float()).abs().max())
        print(json.dumps({"label": label, "kernel": "decode_attention",
                          "case": case, "max_abs_err": err,
                          "ms": mod.time_ms(fn, 200),
                          "device_ms": profiled_ms(mod, fn, 50, False),
                          "device_ms_cold": profiled_ms(mod, fn, 50, True)}),
              flush=True)
    for case, s, dtype, slow in SSD:
        xs = mod.ssd_inputs(rng, 64, s, 64, 128, 64, slow=slow, dtype=dtype,
                            device=dev)

        def fn():
            return mod.ssd_scan_fwd(*xs, chunk=256, heads_per_bc=64)

        print(json.dumps({"label": label, "kernel": "ssd_scan", "case": case,
                          "ms": mod.time_ms(fn, 20),
                          "device_ms": profiled_ms(mod, fn, 20, False),
                          "device_ms_cold": profiled_ms(mod, fn, 20, True)}),
              flush=True)


if __name__ == "__main__":
    main()
