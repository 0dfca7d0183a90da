#!/usr/bin/env python3
"""How the SSD scan backward's time splits between staging, barriers and
``mma.sync``, launch by launch, on the card.

    python scripts/ssd_bwd_stages.py [--root DIR] [--batch 8]

Builds variants of ``DIR/src/repro_torch/csrc/ssd_scan_bwd.cu`` and the
headers it includes (nvcc, into ``build/ssd_bwd_stages/``), each with one
part of the product loop taken out:
  - ``built``: the kernel as the port builds it;
  - ``no_split``: every operand value goes to the tensor cores as it was
    read, with no TF32 high part and remainder made (the products then
    run on a zero remainder);
  - ``one_mma``: one TF32 product a fragment pair instead of 3xTF32's three;
  - ``no_barrier``: the block barriers of the product loop removed (the
    results are wrong: this only times the loop without its waits);
and, of the redesign's ring only:
  - ``no_copy``: no ``cp.async`` issued (the stages keep stale values);
  - ``dx_no_decay``: ``ssd_bwd_dx`` leaves the scores undecayed;
  - ``w_no_epilogue``: ``ssd_bwd_w`` sums each head's products as they
    are, with no decay and no column sums.
Outputs of every variant but ``built`` are wrong; only their times count.
Each variant's launches are timed with torch.profiler at mamba2-1.3b's
train shape (x [64 B, 2048, 64], B/C [B, 2048, 128] shared by 64 heads,
chunk 256, fp32), on the checkout's own forward output, and print one JSON
line: device ms by kernel and in all. The variants' outputs are not used.
Edits are found by their text; a variant whose text the checkout's sources
do not hold (the parent's product loop and the redesigned one differ) is
reported as skipped. ``--root`` names the checkout (default: this one).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE / "scripts"))

import kernel_ab  # noqa: E402

OUT = HERE / "build" / "ssd_bwd_stages"
FILES = ("common.cuh", "ssd_common.cuh", "ssd_scan_bwd.cu")
# variant: alternatives, each a list of (file, text in it, text put in its
# place); the first alternative whose texts are all found once is built.
# The ring's come first: the forward keeps the first design's helper, which
# the redesigned backward does not call.
VARIANTS = {
    "built": [[]],
    "no_split": [
        [("ssd_common.cuh",   # the ring: split at fragment load
          "  repro::split_a(bits, hi, lo);\n",
          "#pragma unroll\n  for (int i = 0; i < N; ++i) {\n"
          "    hi[i] = bits[i];\n    lo[i] = 0u;\n  }\n")],
        [("ssd_common.cuh",   # the first design: split when staged
          "    const unsigned h = tf32(v);\n    p.hi[at_] = h;\n"
          "    p.lo[at_] = tf32(v - __uint_as_float(h));\n",
          "    p.hi[at_] = __float_as_uint(v);\n    p.lo[at_] = 0u;\n")]],
    "one_mma": [
        [("ssd_common.cuh",
          "        mma_tf32(acc[mt][nt], al[mt], bh[nt]);\n"
          "        mma_tf32(acc[mt][nt], ah[mt], bl[nt]);\n", "")],
        [("ssd_common.cuh",
          "      mma_tf32(acc[t], al, bh);\n      mma_tf32(acc[t], ah, bl);\n",
          "")]],
    "no_barrier": [
        [("ssd_common.cuh",
          "    __syncthreads();   // slab s visible; stage s - 1 free\n", "")],
        [("ssd_common.cuh",
          "    __syncthreads();   // the previous products are done with the "
          "planes\n", ""),
         ("ssd_common.cuh",
          "    __syncthreads();\n    if (sl + 1 < nslab) fetch(sl + 1);\n",
          "    if (sl + 1 < nslab) fetch(sl + 1);\n")]],
    "no_copy": [[("ssd_common.cuh", f"  asm volatile(\"cp.async.{c}.shared.global "
                  f"[%0], [%1], {n}, %2;\\n\" ::\"r\"(\n                   "
                  "repro::smem_u32(dst)), \"l\"(src), \"r\"(bytes));",
                  "  (void)dst, (void)src, (void)bytes;")
                 for c, n in (("cg", 16), ("ca", 4), ("ca", 8))]],
    "dx_no_decay": [[("ssd_scan_bwd.cu", "if (r < na2) return;", "return;")]],
    "w_no_epilogue": [[("ssd_scan_bwd.cu", "        if (!last) return;\n",
                        "        for (int mt = 0; mt < 2; ++mt)\n"
                        "          for (int nt = 0; nt < 4; ++nt)\n"
                        "            for (int e = 0; e < 4; ++e) {\n"
                        "              wacc[mt][nt][e] += acc[mt][nt][e];\n"
                        "              acc[mt][nt][e] = 0.f;\n"
                        "            }\n        if (true) return;\n")]],
}


def edited(src: Path, alternatives) -> dict | None:
    """The variant's sources (file name -> text), or None when no
    alternative's texts are all found once in the checkout's."""
    texts = {f: (src / f).read_text() for f in FILES}
    for edits in alternatives:
        out = dict(texts)
        if all(out[f].count(old) == 1 for f, old, _ in edits):
            for f, old, new in edits:
                out[f] = out[f].replace(old, new)
            return out
    return None


def build(root: Path, nvcc_flags, nvcc: str) -> dict:
    """Start one nvcc a variant, all together; returns variant -> library
    path (or None when skipped)."""
    src = root / "src" / "repro_torch" / "csrc"
    shutil.rmtree(OUT, ignore_errors=True)
    procs, libs = {}, {}
    for name, alts in VARIANTS.items():
        texts = edited(src, alts)
        if texts is None:
            libs[name] = None
            continue
        d = OUT / name
        d.mkdir(parents=True)
        for f, t in texts.items():
            (d / f).write_text(t)
        libs[name] = d / f"libssd_bwd_{name}.so"
        procs[name] = subprocess.Popen(
            [nvcc, *nvcc_flags, "-shared", "-I", str(d), "-o",
             str(libs[name]), str(d / "ssd_scan_bwd.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{log}")
        (OUT / name / "build.log").write_text(log)
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    mod, timer = kernel_ab.load_checkout(str(root))
    lib_mod = sys.modules["repro_torch.kernels.library"]
    t0 = time.perf_counter()
    libs = build(root, lib_mod.NVCC_FLAGS, lib_mod._nvcc())
    print(json.dumps({"root": str(root), "build_s": time.perf_counter() - t0,
                      "skipped": [n for n, v in libs.items() if v is None]}),
          flush=True)
    dev = torch.device("cuda", 0)
    a = torch.randn(4096, 4096, device=dev)   # raise the clocks first
    t_end = time.perf_counter() + 2.0
    while time.perf_counter() < t_end:
        a @ a
        torch.cuda.synchronize()
    h, s, p, n, chunk = 64, 2048, 64, 128, 256
    bh = args.batch * h
    rng = np.random.default_rng(0)
    xs = mod.ssd_inputs(rng, bh, s, p, n, h, device=dev)
    dy = torch.as_tensor(rng.standard_normal((bh, s, p)), dtype=torch.float32,
                         device=dev)
    y, _, work = mod.ssd_scan_fwd(*xs, chunk=chunk, heads_per_bc=h,
                                  return_work=True)
    outs = [torch.empty_like(t) for t in xs]
    vp, vi = ctypes.c_void_p, ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    for name, path in libs.items():
        if path is None:
            continue
        lib = ctypes.CDLL(str(path))
        lib.ssd_scan_bwd_launch.argtypes = [vp] * 15 + [vi] * 7 + [vp]
        lib.ssd_scan_bwd_launch.restype = vi
        lib.ssd_scan_bwd_scratch_floats.argtypes = [vi] * 6
        lib.ssd_scan_bwd_scratch_floats.restype = ctypes.c_longlong
        scratch = torch.empty(lib.ssd_scan_bwd_scratch_floats(
            bh, s, p, n, chunk, h), dtype=torch.float32, device=dev)

        def fn():
            err = lib.ssd_scan_bwd_launch(
                *(t.data_ptr() for t in (*xs, y, dy)), None,
                work.data_ptr(), scratch.data_ptr(),
                *(t.data_ptr() for t in outs), bh, s, p, n, chunk, h, 0,
                stream)
            if err:
                raise RuntimeError(f"variant {name}: launch failed ({err})")

        fn()
        torch.cuda.synchronize()
        by = timer.per_call_us(timer._profile(lambda: [fn() for _ in
                                                       range(5)]), 5)
        print(json.dumps({"variant": name, "batch": args.batch,
                          "device_ms": sum(by.values()) / 1e3,
                          "device_ms_by_kernel": {
                              k[:40]: v / 1e3 for k, v in by.items()}}),
              flush=True)
        del scratch


if __name__ == "__main__":
    main()
