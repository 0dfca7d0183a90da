#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device and build: the card's name and power limit (nvidia-smi), then
     the kernels' build from ``src/repro_torch/csrc`` and its seconds;
  2. serve: ``ServeExecutor`` on qwen2-0.5b at full width (24 layers,
     d 896, 14/2 heads, vocab 151936, random weights from a seed) answers 8
     requests of 1,000-token prompts, 32 new tokens each, through the
     store-driven claim / prefill / decode / finish loop; the launch counts
     of the flash and decode kernels are read from this run alone, and a
     short request's logits on the card are held against the same model on
     the CPU (plain versions);
  3. claim: a 936-worker work queue of 100,000 tasks claims through the
     ``wq_claim`` kernel, and must return the claim dicts of the host path;
  4. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes, with its error, its time and its bound, then
     one ``{"kernels": [...]}`` line.
The last line is ``{"ok": true, "device": {...}}``. Any failed check raises:
the script then exits non-zero and does not print that line. Without a CUDA
card it refuses to run.
"""
from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SteeringEngine, WorkQueue  # noqa: E402
from repro_torch.kernels import launch_counts, library, reset_launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.wq_claim.kernel import wq_claim_fwd  # noqa: E402
from repro_torch.kernels.wq_claim.ref import wq_claim_ref  # noqa: E402
from repro_torch.runtime.executor import ServeExecutor  # noqa: E402

# limit of an attention kernel against its plain version, per element: fp32
# sums over 1,000+ keys in another order than the plain einsum (1e-4, looser
# than the unit tests' 2e-5 at S <= 512); in bf16 both sides compute in fp32
# and round the output once, so an element may also differ by one bf16 step
# of its value (2**-7 * |ref|), far less than a key dropped or added at a
# ragged kv_len moves it
FP32_TOL = 1e-4
BF16_STEP = 2.0 ** -7
# full-width serve check, card vs CPU logits: fp32 prefill differs by
# summation order only; bf16 decode rounds every layer's activations to
# 8 bits on both sides, at different places (scaled by the logits' size)
SERVE_TOL = {torch.float32: 1e-3, torch.bfloat16: 5e-2}
# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int32: 67e12}

SRC = {"wq_claim": "src/repro_torch/csrc/wq_claim.cu",
       "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
       "decode_attention": "src/repro_torch/csrc/decode_attention.cu"}
REPLACES = {"wq_claim": "src/repro/kernels/wq_claim/kernel.py:32",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:25",
            "decode_attention": "src/repro/kernels/decode_attention/kernel.py:21"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


# --------------------------------------------------------------- phase 1
def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    path = library.build()
    library.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": os.path.relpath(path), "ptxas_log":
          os.path.relpath(path.with_suffix(".log"))})
    return smi


# --------------------------------------------------------------- phase 2
def phase_serve(cfg, device, *, requests=8, prompt_len=1000, max_new=32,
                slots=4, max_len=4096, seed=0) -> dict:
    """Serve ``requests`` prompts through the store-driven executor; the
    launch counts are those of this run alone."""
    ex = ServeExecutor(cfg, slots=slots, max_len=max_len, seed=seed,
                       device=device)
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (requests, prompt_len)).astype(np.int32)
    if ex.device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(ex.device)
    sync(ex.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    ids = ex.submit(prompts, max_new=max_new)
    finished = ex.drain()
    sync(ex.device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    outs = [ex.wq.store.blobs[int(t)]["output"] for t in ids]
    tokens = int(sum(len(o) for o in outs))
    check(finished == requests == ex.wq.counts()["FINISHED"],
          f"finished {finished} of {requests}")
    check(all(len(o) == max_new for o in outs), "output lengths")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
          "token ids out of range")
    steer = SteeringEngine(ex.wq).run_all(time.time())
    check(steer["q4"] == 0, f"q4 {steer['q4']} tasks left")
    res = {"phase": "serve", "arch": cfg.name, "device": str(ex.device),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "vocab": cfg.vocab_size, "requests": requests,
           "prompt_len": prompt_len, "finished": finished,
           "tokens_generated": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(ex.device)
                              if ex.device.type == "cuda" else None),
           "launches": {"flash_attention": counts["flash_attention"],
                        "decode_attention": counts["decode_attention"]},
           "q4": steer["q4"]}
    if ex.device.type == "cuda":
        # one flash launch per layer and prefill, one decode launch per
        # layer and decode step (the first token comes from the prefill)
        want_fa = cfg.num_layers * requests
        want_dec = cfg.num_layers * requests * (max_new - 1)
        check(counts["flash_attention"] == want_fa,
              f"flash launches {counts['flash_attention']} != {want_fa}")
        check(counts["decode_attention"] == want_dec,
              f"decode launches {counts['decode_attention']} != {want_dec}")
    emit(res)
    return {"result": res, "executor": ex}


def _logits_run(model, params, dparams, tokens, steps, device, feed=None):
    """Prefill ``tokens`` with ``params``, then ``steps`` decode steps with
    ``dparams``, fed ``feed`` or the greedy tokens. Returns the logits of
    every step (fp32, on the CPU) and the tokens fed."""
    with torch.no_grad():
        lg, cache = model.prefill(params, {"tokens": tokens.to(device)},
                                  tokens.shape[1] + steps + 1)
        out, fed = [lg.float().cpu()], []
        for s in range(steps):
            tok = feed[s] if feed is not None else \
                torch.argmax(out[-1][0, -1]).reshape(1, 1).to(torch.int32)
            fed.append(tok)
            lg, cache = model.decode_step(dparams, tok.to(device), cache)
            out.append(lg.float().cpu())
    return out, fed


def phase_serve_check(ex, *, prompt_len=37, steps=3, seed=1) -> dict:
    """The executor's model on its device against a CPU copy of the same
    weights (plain attention), on the same tokens: prefill logits in the
    master dtype, then ``steps`` decode steps in ``cfg.dtype``."""
    cfg = ex.cfg
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int32))
    ref, fed = _logits_run(ex.model, copy.deepcopy(ex.params).to("cpu"),
                           copy.deepcopy(ex.decode_params).to("cpu"), tokens,
                           steps, "cpu")
    got, _ = _logits_run(ex.model, ex.params, ex.decode_params, tokens,
                         steps, ex.device, feed=fed)
    errs = []
    for i, (a, b) in enumerate(zip(got, ref)):
        dt = getattr(torch, cfg.param_dtype if i == 0 else cfg.dtype)
        err = float((a - b).abs().max())
        tol = SERVE_TOL[dt] * max(1.0, float(b.abs().max()))
        errs.append({"step": i, "dtype": str(dt).replace("torch.", ""),
                     "max_abs_err": err, "tol": tol})
        check(a.shape == (1, 1, cfg.vocab_size), f"logits shape {a.shape}")
        check(bool(torch.isfinite(a).all()), f"non-finite logits at {i}")
        check(err <= tol, f"logits step {i}: {err} > {tol}")
    res = {"phase": "serve_check", "prompt_len": prompt_len, "steps": errs}
    emit(res)
    return res


def phase_serve_profile(ex, *, prompt_len=1000, max_new=9, seed=2) -> dict:
    """One more request through the executor under torch.profiler (CUDA
    activity): wall time of its prefill and decode steps against the time
    the card was busy, and the kernels that took it."""
    from torch.profiler import ProfilerActivity, profile
    prompt = np.random.default_rng(seed).integers(
        0, ex.cfg.vocab_size, (1, prompt_len)).astype(np.int32)
    ex.submit(prompt, max_new=max_new)
    sync(ex.device)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ex.drain()
        sync(ex.device)
    wall = time.perf_counter() - t0
    by_name = _device_kernel_us(prof)
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    res = {"phase": "serve_profile", "prompt_len": prompt_len,
           "decode_steps": max_new - 1, "wall_s": wall,
           "device_busy_s": busy,
           "device_idle_share": (1.0 - busy / wall) if busy else None,
           "top_kernels_ms": [[name[:60], us / 1e3] for name, us in top]}
    emit(res)
    return res


# --------------------------------------------------------------- phase 3
def phase_claim(device, *, tasks=100_000, workers=936, rounds=3) -> dict:
    """Device-claim queue against the host-claim queue on the same inserts
    and claims (the host claim bench's store: one activity, round-robin
    partitions); the launch count is this phase's alone."""
    reset_launch_counts()
    claimed = 0
    for k in (1, 4):
        qs = [WorkQueue(num_workers=workers, capacity=2 * tasks,
                        device_claim=dc, device=device) for dc in (True, False)]
        for q in qs:
            q.add_tasks(0, tasks)
        for r in range(rounds):
            got, want = (q.claim_all(k=k, now=float(r)) for q in qs)
            check(got.keys() == want.keys(), "claim dict keys")
            check(all(np.array_equal(got[w], want[w]) for w in want),
                  f"claim dicts differ (k={k}, round {r})")
            claimed += sum(len(v) for v in got.values())
        check(np.array_equal(qs[0].store.col("status"),
                             qs[1].store.col("status")), "status columns")
        qs[0].check_invariants()
    launches = launch_counts()["wq_claim"]
    if torch.device(device).type == "cuda":
        check(launches == 2 * rounds,
              f"wq_claim launches {launches} != {2 * rounds}")
    res = {"phase": "claim", "tasks": tasks, "workers": workers,
           "rounds_per_k": rounds, "tasks_claimed": claimed,
           "equal_to_host_path": True, "launches": {"wq_claim": launches}}
    emit(res)
    return res


# --------------------------------------------------------------- phase 4
def time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls (CUDA
    events; inputs stay in L2 where they fit)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernel_us(prof) -> dict:
    """Device time (us) of every CUDA kernel / memory op a profile holds,
    by name (empty when the profiler recorded no device activity)."""
    return {e.key: e.self_device_time_total for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def device_ms(fn, iters: int = 20):
    """Mean device time per call of the work ``fn`` puts on the card
    (torch.profiler, CUDA activity only): the kernels' own time, without
    the host's launch overhead that back-to-back event timing includes.
    None when the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_kernel_us(prof).values())
    return total / iters / 1e3 if total else None


def _bound(nbytes: float, ops: float, dtype) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def _claim_case(dev, n, w, k, rng):
    status = torch.as_tensor(rng.choice(
        [0, 2, 3, 4], n, p=[.1, .5, .2, .2]).astype(np.int32), device=dev)
    worker = torch.as_tensor(rng.integers(0, w, n).astype(np.int32),
                             device=dev)
    gs, gc = wq_claim_fwd(status, worker, num_workers=w, k=k)
    rs, rc = wq_claim_ref(status, worker, num_workers=w, k=k)
    err = max(int((gs - rs).abs().max()), int((gc - rc).abs().max()))
    check(err == 0, f"wq_claim n={n} W={w} k={k} differs")
    row = {"kernel": "wq_claim", "n": n, "workers": w, "k": k,
           "max_abs_err": err, "tol": 0,
           "ms": time_ms(lambda: wq_claim_fwd(status, worker, num_workers=w,
                                              k=k), 100),
           "plain_ms": time_ms(lambda: wq_claim_ref(status, worker,
                                                    num_workers=w, k=k), 20),
           "library_ms": None}
    row["device_ms"] = device_ms(lambda: wq_claim_fwd(
        status, worker, num_workers=w, k=k))
    # two int32 columns in, two out; ~4 integer operations a row
    row.update(_bound(16.0 * n, 4.0 * n, torch.int32))
    return row


def _attn_error(got, ref, what: str) -> dict:
    """An attention kernel's max error against its plain version, and its
    largest ratio to the per-element limit; raises past the limit."""
    bf16 = ref.dtype == torch.bfloat16
    tol = FP32_TOL + (BF16_STEP * ref.float().abs() if bf16 else 0.0)
    diff = (got.float() - ref.float()).abs()
    ratio = float((diff / tol).max())
    check(got.dtype == ref.dtype and ratio <= 1.0,
          f"{what}: max error {float(diff.max())}, {ratio} of its limit")
    return {"max_abs_err": float(diff.max()), "err_over_tol": ratio,
            "tol": f"{FP32_TOL} + 2**-7 * |ref|" if bf16 else FP32_TOL}


def _flash_case(dev, s, hq, hkv, dh, dtype, rng):
    q, k, v = (torch.as_tensor(rng.standard_normal((1, s, h, dh)),
                               dtype=torch.float32, device=dev).to(dtype)
               for h in (hq, hkv, hkv))
    got = flash_attention_fwd(q, k, v, causal=True)
    ref = flash_attention_ref(q, k, v, causal=True)
    err = _attn_error(got, ref, f"flash {dtype}")
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"kernel": "flash_attention", "shape_q": list(q.shape),
           "shape_kv": list(k.shape), "dtype": str(dtype)[6:], **err,
           "ms": time_ms(lambda: flash_attention_fwd(q, k, v, causal=True),
                         50),
           "plain_ms": time_ms(lambda: flash_attention_ref(q, k, v,
                                                           causal=True), 10),
           "library_ms": time_ms(lambda: sdpa(qt, kt, vt, is_causal=True,
                                              enable_gqa=True), 50)}
    row["device_ms"] = device_ms(lambda: flash_attention_fwd(q, k, v,
                                                             causal=True))
    row["library_device_ms"] = device_ms(
        lambda: sdpa(qt, kt, vt, is_causal=True, enable_gqa=True))
    pairs = s * (s + 1) / 2                  # causal (query, key) pairs
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel())
    row.update(_bound(nbytes, 4.0 * pairs * dh * hq, dtype))
    return row


def _decode_case(dev, smax, hq, hkv, dh, kv_len, dtype, rng):
    q = torch.as_tensor(rng.standard_normal((1, 1, hq, dh)),
                        dtype=torch.float32, device=dev).to(dtype)
    k, v = (torch.as_tensor(rng.standard_normal((1, smax, hkv, dh)),
                            dtype=torch.float32, device=dev).to(dtype)
            for _ in range(2))
    kvl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    got = decode_attention_fwd(q, k, v, kvl)
    ref = decode_attention_ref(q, k, v, kvl)
    err = _attn_error(got, ref, f"decode {dtype} kv_len={kv_len}")
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t[:, :kv_len].transpose(1, 2).contiguous() for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"kernel": "decode_attention", "shape_q": list(q.shape),
           "shape_cache": list(k.shape), "kv_len": kv_len,
           "dtype": str(dtype)[6:], **err,
           "ms": time_ms(lambda: decode_attention_fwd(q, k, v, kvl), 200),
           "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, kvl),
                               50),
           "library_ms": time_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True),
                                 200)}
    row["device_ms"] = device_ms(lambda: decode_attention_fwd(q, k, v, kvl))
    row["library_device_ms"] = device_ms(lambda: sdpa(qt, kt, vt,
                                                      enable_gqa=True))
    # K and V below kv_len read once, q read and out written once
    nbytes = q.element_size() * (2 * kv_len * hkv * dh + 2 * q.numel()) + 4
    row.update(_bound(nbytes, 4.0 * kv_len * hq * dh, dtype))
    return row


def phase_kernels(cfg, device, launches: dict) -> dict:
    """Every kernel against its plain version at the main path's shapes;
    returns the ``{"kernels": [...]}`` record (one entry per kernel, at the
    shape named in ``main_shape``)."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = []
    for n in (100_000, 1 << 18):
        for w in (64, 936):
            for k in (1, 4):
                rows.append(_claim_case(dev, n, w, k, rng))
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(_flash_case(dev, 1000, hq, hkv, dh, dtype, rng))
    for kv_len in (1, 1000, 1031, 4096):
        rows.append(_decode_case(dev, 4096, hq, hkv, dh, kv_len,
                                 torch.bfloat16, rng))
    # the same ragged length in fp32, held to the fp32 limit
    rows.append(_decode_case(dev, 4096, hq, hkv, dh, 1031, torch.float32,
                             rng))
    for r in rows:
        emit(r)
    main_shape = {  # the shape each kernel sees on the main path
        "wq_claim": lambda r: r["n"] == 100_000 and r["workers"] == 936
        and r["k"] == 1,
        "flash_attention": lambda r: r["dtype"] == "float32",
        "decode_attention": lambda r: r["kv_len"] == 1000
        and r["dtype"] == "bfloat16"}
    out = []
    for name, pick in main_shape.items():
        r = next(r for r in rows if r["kernel"] == name and pick(r))
        out.append({"name": name, "route": "cuda", "source": SRC[name],
                    "replaces": REPLACES[name], "launches": launches[name],
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"]})
    return {"kernels": out}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_device()
    cfg = get_config("qwen2-0.5b")
    serve = phase_serve(cfg, dev)
    launches = dict(serve["result"]["launches"])
    phase_serve_check(serve["executor"])
    phase_serve_profile(serve["executor"])
    del serve
    torch.cuda.empty_cache()
    launches.update(phase_claim(dev)["launches"])
    kernels = phase_kernels(cfg, dev, launches)
    print(smi, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
