#!/usr/bin/env python3
"""Where the decode attention kernel's time goes, stage by stage, on the card.

    python scripts/decode_stages.py

Builds variants of ``src/repro_torch/csrc/decode_attention.cu`` (nvcc, into
``build/decode_stages/``) that stop after each stage of the one launch:
  1. the splits (each block's tiles of K/V, its online softmax and P.V);
  2. the merge inside each cluster, through distributed shared memory, and
     the write of the cluster partials;
  3. the arrival counter that finds the last cluster;
  4. the whole kernel (the last cluster's merge of the cluster partials).
Their device times (torch.profiler) at the serve path's decode shapes, for
the splits the port chooses and for fewer, print one JSON line each. The
variants' outputs are not used; stage 4 is the kernel as built for the port.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke  # noqa: E402
from repro_torch.kernels import library  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import num_splits  # noqa: E402

SRC = ROOT / "src" / "repro_torch" / "csrc" / "decode_attention.cu"
OUT = ROOT / "build" / "decode_stages"
# (text in the kernel, text put in its place): a run-time stage number
# `stop` ends the kernel after stage 1, 2 or 3
EDITS = [
    ('#include "common.cuh"', f'#include "{SRC.parent / "common.cuh"}"'),
    ("int ngroups, int window, float scale, int vec) {",
     "int ngroups, int window, float scale, int vec, int stop) {"),
    ("  // this block's partial (m, l, acc) in shared memory; an empty split",
     "  if (stop == 1) {\n    if (tid == 0) o[blockIdx.x] = "
     "repro::from_float<T>(m + l + acc[0][0]);\n    return;\n  }\n"
     "  // this block's partial (m, l, acc) in shared memory; an empty split"),
    ("  fence_acq_rel();\n  cluster.sync();   // every partial written",
     "  if (stop == 2) {\n    cluster.sync();\n    return;\n  }\n"
     "  fence_acq_rel();\n  cluster.sync();   // every partial written"),
    ("  if (!*flag) return;\n", "  if (!*flag) return;\n  if (stop == 3) return;\n"),
    ("smax, hq, hkv, dh, nsplit, ngroups, window, scale, vec);",
     "smax, hq, hkv, dh, nsplit, ngroups, window, scale, vec, g_stop);"),
    ("namespace {\n", "namespace {\nint g_stop = 0;\n"),
    ('extern "C" int decode_attention_rows',
     'extern "C" void set_stop(int s) { g_stop = s; }\n'
     'extern "C" int decode_attention_rows'),
]
CASES = [  # (name, smax, hq, hkv, dh, kv_len)
    ("qwen2-0.5b kv_len 1000", 4096, 14, 2, 64, 1000),
    ("recurrentgemma-9b ring kv_len 1001", 2048, 16, 1, 256, 1001),
]


def build() -> ctypes.CDLL:
    text = SRC.read_text()
    for old, new in EDITS:
        if text.count(old) != 1:
            raise RuntimeError(f"decode_stages: kernel text changed: {old!r}")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "decode_stages.cu").write_text(text)
    so = OUT / "libdecode_stages.so"
    done = subprocess.run([library._nvcc(), *library.NVCC_FLAGS, "-shared",
                           "-o", str(so), str(OUT / "decode_stages.cu")],
                          capture_output=True, text=True)
    if done.returncode:
        raise RuntimeError(f"nvcc failed:\n{done.stdout}{done.stderr}")
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.decode_attention_launch.argtypes = [p] * 7 + [i] * 7 + [f, i, p]
    lib.decode_attention_scratch_floats.argtypes = [i] * 5
    lib.decode_attention_scratch_floats.restype = ctypes.c_longlong
    lib.set_stop.argtypes = [i]
    return lib


def device_us(fn, iters: int = 50) -> float:
    """Mean device us per call of the kernel (chip_smoke's profiling)."""
    def body():
        for _ in range(iters):
            fn()

    return sum(us for name, us in chip_smoke.per_call_us(
        chip_smoke._profile(body), iters).items() if "dec_fwd" in name)


def main() -> None:
    lib = build()
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    a = torch.randn(4096, 4096, device=dev)   # raise the clocks first
    t_end = time.perf_counter() + 2.0
    while time.perf_counter() < t_end:
        a @ a
        torch.cuda.synchronize()
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, smax, hq, hkv, dh, kv_len in CASES:
        q = torch.randn(1, 1, hq, dh, device=dev, generator=gen).bfloat16()
        k, v = (torch.randn(1, smax, hkv, dh, device=dev,
                            generator=gen).bfloat16() for _ in range(2))
        kvl = torch.tensor([kv_len], dtype=torch.int32, device=dev)
        out = torch.empty(4096, dtype=torch.bfloat16, device=dev)
        for nsplit in sorted({num_splits(sms, 1, hkv, smax), 8, 32, 64}):
            part = torch.empty(lib.decode_attention_scratch_floats(
                1, hq, hkv, dh, nsplit), device=dev)
            counters = torch.zeros(64, dtype=torch.int32, device=dev)

            def fn():
                err = lib.decode_attention_launch(
                    q.data_ptr(), k.data_ptr(), v.data_ptr(), kvl.data_ptr(),
                    out.data_ptr(), part.data_ptr(), counters.data_ptr(), 1,
                    smax, hq, hkv, dh, nsplit, 0, dh ** -0.5, 1,
                    torch.cuda.current_stream().cuda_stream)
                if err:
                    raise RuntimeError(f"launch failed: {err}")

            us = {}
            for stop in (1, 2, 3, 0):
                lib.set_stop(stop)
                fn()
                torch.cuda.synchronize()
                us[f"stage{stop or 4}"] = device_us(fn)
            print(json.dumps({"case": name, "nsplit": nsplit,
                              "device_us_to_end_of": us}), flush=True)


if __name__ == "__main__":
    main()
