#!/usr/bin/env python3
"""Times the flash attention, decode attention, SSD scan, RG-LRU scan and
claim kernels of one checkout at the serve path's shapes, and the flash
backward at the train path's, so that two checkouts can be compared on one
card.

    python scripts/kernel_ab.py --root DIR [--label NAME] [--only K1,K2]
                                [--save FILE]
    python scripts/kernel_ab.py --same FILE1 FILE2

Loads ``DIR/chip_smoke.py``, which puts ``DIR/src`` first on the import
path, and times that checkout's ``flash_attention_fwd`` (causal prefill:
qwen2-0.5b's q [1,1000,14,64] in fp32 and in bf16, the bf16 row with
SDPA's device time beside it; recurrentgemma-9b's q [1,S,16,256] against
one KV head, fp32, window 2048, at S 1000 and at S 4096 where the window
bites), ``decode_attention_fwd`` (bf16: qwen2-0.5b's
cache at kv_len 1000; recurrentgemma-9b's ring of 2048 at kv_len 1001 and
full; a linear cache of 4096 at kv_len 3000 with window 2048) and
``ssd_scan_fwd`` (mamba2-1.3b's prefill: S 1000 fp32, ragged S 1031, bf16,
slow decay at S 4096), ``rglru_scan_fwd`` (recurrentgemma-9b's prefill,
a and u [1,S,4096]: S 1000 fp32, ragged S 1031, bf16, slow decay at S 4096)
``wq_claim_fwd`` (N 100,000 and 2^18 rows, W 64 and 936 workers, k 1
and 4) and ``flash_attention_bwd`` (causal: qwen2-0.5b's train shape q
[8,2048,14,64] against 2 KV heads in bf16; the same heads at B 1, S 1031 in
fp32; glm4-9b's heads q [1,1024,32,128] against 2 KV heads in bf16; S 2048,
window 700 in fp32; each on the checkout's own forward output and LSE, with
dq, dk and dv held against the checkout's plain backward, the device time
split by kernel, and SDPA's backward beside the bf16 rows), and the train
paths' backward kernels of the SSM and hybrid families: ``ssd_scan_bwd``
(mamba2-1.3b's train shape, x [512,2048,64] with B/C shared by 64 heads,
fp32, and at batch 1 a ragged S 1031 and slow decay, each held against
the plain backward one batch row at a time, with its device time by
launch), ``rglru_scan_bwd`` (a, h, g
[1,S,4096] fp32: S 4096, ragged S 1031, slow decay at S 4096) and
``flash_attention_bwd_256`` (recurrentgemma-9b's heads q [1,S,16,256]
against one KV head, window 2048: S 4096 in bf16 beside SDPA's backward,
ragged S 1031 in fp32). ``--only`` keeps the kernels named (e.g.
``rglru_scan,wq_claim``); a checkout older than a kernel's first PR has no
rows for it, so name the kernels both checkouts have.
Each case prints one JSON line: CUDA-event ms over back-to-back calls (the
RG-LRU rows' also with L2 flushed before each call), and the kernels'
device time (torch.profiler) back to back (warm: inputs stay in L2) and
with L2 flushed before each call (cold; not for the claim rows, whose
1.6-4 MB the flush would not change).
``--save FILE`` also keeps each flash, SSD and RG-LRU row's outputs (the
same seeded inputs in every checkout), and ``--same FILE1 FILE2`` prints,
per row, whether two checkouts' outputs are equal to the bit.
Both are read by the timers of the ``chip_smoke.py`` beside this script,
whichever checkout is timed, so that two checkouts are read alike; the
flash rows' error against the plain version is the timed checkout's own
check. Run one checkout per process (the package is imported once), in
turns: parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

import numpy as np
import torch

FLASH = [  # (case, s, hq, hkv, dh, dtype, window)
    ("qwen2 fp32", 1000, 14, 2, 64, torch.float32, 0),
    ("recurrentgemma fp32 S 1000", 1000, 16, 1, 256, torch.float32, 2048),
    ("recurrentgemma fp32 S 4096 window biting", 4096, 16, 1, 256,
     torch.float32, 2048),
    ("qwen2 bf16", 1000, 14, 2, 64, torch.bfloat16, 0),
]
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
RGLRU = [  # (case, seq, dtype, slow decay), lru width 4096
    ("main", 1000, torch.float32, False),
    ("ragged", 1031, torch.float32, False),
    ("bf16", 1000, torch.bfloat16, False),
    ("slow_decay", 4096, torch.float32, True),
]
CLAIM = [(n, w, k) for n in (100_000, 1 << 18) for w in (64, 936)
         for k in (1, 4)]
FLASH_BWD = [  # (case, b, s, hq, hkv, dh, dtype, window), causal
    ("qwen2 train bf16", 8, 2048, 14, 2, 64, torch.bfloat16, 0),
    ("ragged S 1031 fp32", 1, 1031, 14, 2, 64, torch.float32, 0),
    ("glm4 heads bf16", 1, 1024, 32, 2, 128, torch.bfloat16, 0),
    ("S 2048 window 700 fp32", 1, 2048, 14, 2, 64, torch.float32, 700),
]
FLASH_BWD_256 = [  # (case, b, s, hq, hkv, dh, dtype, window), causal
    ("recurrentgemma train bf16", 1, 4096, 16, 1, 256, torch.bfloat16, 2048),
    ("recurrentgemma ragged S 1031 fp32", 1, 1031, 16, 1, 256, torch.float32,
     2048),
]
SSD_BWD = [  # (case, batch, seq, slow decay), 64 heads, P 64, N 128, fp32
    ("train", 8, 2048, False),
    ("ragged", 1, 1031, False),
    ("slow_decay", 1, 2048, True),
]
RGLRU_BWD = [  # (case, seq, slow decay), lru width 4096, fp32
    ("train", 4096, False),
    ("ragged", 1031, False),
    ("slow_decay", 4096, True),
]
KERNELS = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan",
           "wq_claim", "flash_attention_bwd", "ssd_scan_bwd",
           "rglru_scan_bwd", "flash_attention_bwd_256")


HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(root: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_checkout(root: str):
    """(the checkout's chip_smoke module, this one's for its timers). The
    timers use no part of the package, which is then imported anew from
    ``root``."""
    timer = load(HERE, "chip_smoke_timer")
    if os.path.realpath(root) == os.path.realpath(HERE):
        return timer, timer
    for name in [m for m in sys.modules
                 if m == "repro_torch" or m.startswith("repro_torch.")]:
        del sys.modules[name]
    return load(root, "chip_smoke_ab"), timer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root")
    ap.add_argument("--label", default="")
    ap.add_argument("--only", default=",".join(KERNELS))
    ap.add_argument("--save", default="")
    ap.add_argument("--same", nargs=2, default=None)
    args = ap.parse_args()
    if args.same:
        a, b = (torch.load(f) for f in args.same)
        for key in a:
            print(json.dumps({"case": key, "bit_identical": key in b and all(
                torch.equal(x, y) for x, y in zip(a[key], b[key]))}))
        return
    if not args.root:
        ap.error("--root is required (or --same FILE1 FILE2)")
    saved = {}
    only = set(args.only.split(","))
    mod, timer = load_checkout(args.root)
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
    for case, s, hq, hkv, dh, dtype, window in (
            FLASH if "flash_attention" in only else []):
        q, k, v = (torch.as_tensor(rng.standard_normal((1, s, h, dh)),
                                   dtype=torch.float32, device=dev).to(dtype)
                   for h in (hq, hkv, hkv))

        def fa():
            return mod.flash_attention_fwd(q, k, v, causal=True,
                                           window=window)

        ref = mod.flash_attention_ref(q, k, v, causal=True, window=window)
        saved[f"flash_attention {case}"] = [fa().cpu()]
        err = mod._attn_error(fa(), ref, f"flash {case}")
        row = {"label": label, "kernel": "flash_attention", "case": case,
               "err_over_tol": err["err_over_tol"],
               "ms": timer.time_ms(fa, 50),
               "device_ms": timer.device_ms(fa, 20)}
        if dtype == torch.bfloat16:   # the yardstick: SDPA, causal, GQA
            qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            row["library_device_ms"] = timer.device_ms(
                lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True),
                20)
        print(json.dumps(row), flush=True)
    for case, smax, hq, hkv, dh, kv_len, window in (
            DECODE if "decode_attention" in only else []):
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
                          "ms": timer.time_ms(fn, 200),
                          "device_ms": timer.device_ms(fn, 50),
                          "device_ms_cold": timer.device_ms(fn, 50,
                                                            cold=True)}),
              flush=True)
    for case, s, dtype, slow in SSD if "ssd_scan" in only else []:
        xs = mod.ssd_inputs(rng, 64, s, 64, 128, 64, slow=slow, dtype=dtype,
                            device=dev)

        def fn():
            return mod.ssd_scan_fwd(*xs, chunk=256, heads_per_bc=64)

        saved[f"ssd_scan {case}"] = [t.cpu() for t in fn()]
        print(json.dumps({"label": label, "kernel": "ssd_scan", "case": case,
                          "ms": timer.time_ms(fn, 20),
                          "device_ms": timer.device_ms(fn, 20),
                          "device_ms_cold": timer.device_ms(fn, 20,
                                                            cold=True)}),
              flush=True)
    for case, s, dtype, slow in RGLRU if "rglru_scan" in only else []:
        a, u = timer.rglru_inputs(rng, 1, s, 4096, slow=slow, dtype=dtype,
                                  device=dev)

        def fn():
            return mod.rglru_scan_fwd(a, u)

        saved[f"rglru_scan {case}"] = [fn().cpu()]
        err = timer.rglru_error(fn(), mod.rglru_scan_ref(a, u))
        print(json.dumps({"label": label, "kernel": "rglru_scan",
                          "case": case, "err_over_tol": err["err_over_tol"],
                          "ms": timer.time_ms(fn, 100),
                          "ms_cold": timer.time_ms(fn, 100, cold=True),
                          "device_ms": timer.device_ms(fn, 20),
                          "device_ms_cold": timer.device_ms(fn, 20,
                                                            cold=True)}),
              flush=True)
    for n, w, k in CLAIM if "wq_claim" in only else []:
        status = torch.as_tensor(rng.choice(
            [0, 2, 3, 4], n, p=[.1, .5, .2, .2]).astype(np.int32), device=dev)
        worker = torch.as_tensor(rng.integers(0, w, n).astype(np.int32),
                                 device=dev)

        def fn():
            return mod.wq_claim_fwd(status, worker, num_workers=w, k=k)

        got = fn()
        want = mod.wq_claim_ref(status, worker, num_workers=w, k=k)
        equal = bool(torch.equal(got[0], want[0])
                     and torch.equal(got[1], want[1]))
        print(json.dumps({"label": label, "kernel": "wq_claim", "n": n,
                          "workers": w, "k": k, "equal_to_plain": equal,
                          "ms": timer.time_ms(fn, 200),
                          "device_ms": timer.device_ms(fn, 20)}),
              flush=True)
    flash_bwd = (FLASH_BWD if "flash_attention_bwd" in only else []) + (
        FLASH_BWD_256 if "flash_attention_bwd_256" in only else [])
    for case, b, s, hq, hkv, dh, dtype, window in flash_bwd:
        q, k, v, do = (torch.as_tensor(rng.standard_normal((b, s, h, dh)),
                                       dtype=torch.float32,
                                       device=dev).to(dtype)
                       for h in (hq, hkv, hkv, hq))
        o, lse = mod.flash_attention_fwd(q, k, v, causal=True, window=window,
                                         return_lse=True)

        def bwd():
            return mod.flash_attention_bwd(q, k, v, o, lse, do, causal=True,
                                           window=window)

        ref = mod.flash_attention_bwd_ref(q, k, v, o, lse, do, causal=True,
                                          window=window)
        saved[f"flash_attention_bwd {case}"] = [t.cpu() for t in (o, lse,
                                                                  *bwd())]
        errs = [mod._grad_error(g, r, f"flash bwd {case} {name}")
                for name, g, r in zip(("dq", "dk", "dv"), bwd(), ref)]
        del ref
        row = {"label": label, "kernel": "flash_attention_bwd", "case": case,
               "err_over_tol": max(e["err_over_tol"] for e in errs),
               "ms": timer.time_ms(bwd, 10),
               "device_ms": timer.device_ms(bwd, 5),
               "device_ms_by_kernel": {
                   name[:40]: us / 1e3 for name, us in timer.per_call_us(
                       timer._profile(lambda: [bwd() for _ in range(5)]),
                       5).items()}}
        if dtype == torch.bfloat16:   # the yardstick: SDPA's backward
            lib, inputs = timer._sdpa_call(q, k, v, window, grad=True)
            with torch.enable_grad():
                out = lib()
            dot = do.transpose(1, 2).contiguous()
            row["library_device_ms"] = timer.device_ms(
                lambda: torch.autograd.grad(out, inputs, dot,
                                            retain_graph=True), 5)
            del out, inputs
        print(json.dumps(row), flush=True)
    for case, b, s, slow in SSD_BWD if "ssd_scan_bwd" in only else []:
        xs = mod.ssd_inputs(rng, b * 64, s, 64, 128, 64, slow=slow,
                            device=dev)
        dy = torch.as_tensor(rng.standard_normal((b * 64, s, 64)),
                             dtype=torch.float32, device=dev)
        y, _, work = mod.ssd_scan_fwd(*xs, chunk=256, heads_per_bc=64,
                                      return_work=True)

        def fn():
            return mod.ssd_scan_bwd(*xs, y, work, dy, chunk=256,
                                    heads_per_bc=64)

        row = {"label": label, "kernel": "ssd_scan_bwd", "case": case,
               "ms": timer.time_ms(fn, 10), "device_ms": timer.device_ms(fn, 5),
               "device_ms_by_kernel": {
                   name[:40]: us / 1e3 for name, us in timer.per_call_us(
                       timer._profile(lambda: [fn() for _ in range(5)]),
                       5).items()}}
        errs, _ = timer.ssd_bwd_against_plain(xs, dy, None, fn(), 64,
                                              mod.ssd_scan_bwd_ref)
        row["err_over_tol"] = max(e["err_over_tol"] for e in errs.values())
        print(json.dumps(row), flush=True)
    for case, s, slow in RGLRU_BWD if "rglru_scan_bwd" in only else []:
        a, u = timer.rglru_inputs(rng, 1, s, 4096, slow=slow, device=dev)
        g = torch.as_tensor(rng.standard_normal((1, s, 4096)),
                            dtype=torch.float32, device=dev)
        h = mod.rglru_scan_fwd(a, u)

        def fn():
            return mod.rglru_scan_bwd(a, h, g)

        err = max(timer.rglru_error(x, r)["err_over_tol"] for x, r in
                  zip(fn(), mod.rglru_scan_bwd_ref(a, h, g)))
        print(json.dumps({"label": label, "kernel": "rglru_scan_bwd",
                          "case": case, "err_over_tol": err,
                          "ms": timer.time_ms(fn, 50),
                          "ms_cold": timer.time_ms(fn, 50, cold=True),
                          "device_ms": timer.device_ms(fn, 20),
                          "device_ms_cold": timer.device_ms(fn, 20,
                                                            cold=True)}),
              flush=True)
    if args.save:
        torch.save(saved, args.save)


if __name__ == "__main__":
    main()
