#!/usr/bin/env python3
"""Shows how ``chip_smoke.py`` reads a kernel's device time when the
profiler loses records, on a card.

    python scripts/profiler_records.py [--kernels 40000]

Times the flash attention kernel at the serve path's fp32 prefills
(qwen2-0.5b's q [1,1000,14,64], recurrentgemma-9b's q [1,4096,16,256]
against one KV head, window 2048) and at qwen2's in bf16, first in a fresh
process and then after one profile of ``--kernels`` small kernels. For
each it prints one JSON line: CUDA-event ms over 20 back-to-back calls;
for four profiles of 20 calls, the kernel's records and its summed device
time over 20 (the reading before the records were counted); and
``chip_smoke.device_ms``, which counts them (``per_call_us``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402

CASES = [  # (case, s, hq, hkv, dh, dtype, window)
    ("qwen2 fp32", 1000, 14, 2, 64, torch.float32, 0),
    ("recurrentgemma fp32 S 4096", 4096, 16, 1, 256, torch.float32, 2048),
    ("qwen2 bf16", 1000, 14, 2, 64, torch.bfloat16, 0),
]


def readings(tag: str, fns, iters: int = 20) -> None:
    for case, fn in fns:
        fn()
        torch.cuda.synchronize()

        def body():
            for _ in range(iters):
                fn()

        profiles = [chip_smoke._profile(body) for _ in range(4)]
        print(json.dumps({
            "after": tag, "case": case,
            "event_ms": chip_smoke.time_ms(fn, iters),
            "records": [sum(n for _, n in p.values()) for p in profiles],
            "summed_ms": [sum(us for us, _ in p.values()) / iters / 1e3
                          for p in profiles],
            "device_ms": chip_smoke.device_ms(fn, iters)}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels", type=int, default=40_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profiler_records.py needs a CUDA card")
    dev = torch.device("cuda", 0)
    a = torch.randn(4096, 4096, device=dev)   # raise the clocks first
    t_end = time.perf_counter() + 2.0
    while time.perf_counter() < t_end:
        a @ a
        torch.cuda.synchronize()
    rng = np.random.default_rng(0)
    fns = []
    for case, s, hq, hkv, dh, dtype, window in CASES:
        q, k, v = (torch.as_tensor(rng.standard_normal((1, s, h, dh)),
                                   dtype=torch.float32, device=dev).to(dtype)
                   for h in (hq, hkv, hkv))
        fns.append((case, lambda q=q, k=k, v=v, w=window:
                    chip_smoke.flash_attention_fwd(q, k, v, causal=True,
                                                   window=w)))
    readings("nothing", fns)
    x = torch.randn(1024, device=dev)

    def many():
        y = x
        for _ in range(args.kernels // 2):
            y = y * 1.0001 + 0.0
    chip_smoke._profile(many)
    readings(f"a profile of {args.kernels} kernels", fns)


if __name__ == "__main__":
    main()
