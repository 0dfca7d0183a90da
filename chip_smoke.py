#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (``repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines:
  1. device and build: the card's name and power limit (nvidia-smi), then
     the kernels' build from ``src/repro_torch/csrc`` and its seconds;
  2. serve, once per model family: ``ServeExecutor`` at full width, random
     weights from a seed, answers 8 requests of 1,000-token prompts, 32 new
     tokens each, through the store-driven claim / prefill / decode / finish
     loop; first qwen2-0.5b (24 layers, d 896, 14/2 heads, vocab 151936:
     the flash and decode attention kernels), then mamba2-1.3b (48 layers,
     d 2048, 64 heads of P 64, state 128, chunk 256, vocab 50280: the SSD
     scan kernel in every layer's prefill), then recurrentgemma-9b (38
     layers: 12 groups of (rec, rec, attn) and 2 tail rec layers, d 4096,
     16/1 heads of 256, d_ff 12288, lru width 4096, window 2048, vocab
     256000: the RG-LRU scan kernel in every rec layer's prefill, flash and
     decode attention, with a ring of 2048 K/V slots, in the attention
     layers). The launch counts are read from each run alone, and the peak
     device memory of building the executor (the bf16 decode copy included)
     and of the serve. For the first two, a short request's logits on the
     card are held against the same model on the CPU (plain versions); for
     recurrentgemma-9b that check runs on a 4-layer cut of it at full width
     (one group and one tail layer) with a 2,100-token prompt, so that the
     prefill's window bites and the ring wraps. Two more requests of each
     model run under the profiler, one after the other, their records
     counted (a lost record would read as idle time). Then the MoE, VLM and
     enc-dec families at full width and depth: granite-moe-3b-a800m (32
     layers, d 1536, 24/8 heads of 64, 40 experts top 8 stored as 48,
     vocab 49155) through the same executor; qwen2-vl-2b (28 layers, d
     1536, 12/2 heads of 128, M-RoPE, vocab 151936; each request 1,000
     patch embeddings with the t/h/w ids of a patch grid) and
     seamless-m4t-large-v2 (24 encoder and 24 decoder layers, d 1024, 16/16
     heads of 64, vocab 256206; 4,096 frames, one request with 2,500, and a
     64-token prompt) through the model bundle's prefill and decode_step
     (the reference's executor cannot serve these two); each with its
     exact launches, peak memory and a profile, and its card-vs-CPU check
     on a 2-layer cut at full width (enc-dec: 1,000 frames, so that its
     decode memory is zero-padded);
  3. claim: a 936-worker work queue of 100,000 tasks claims through the
     ``wq_claim`` kernel, and must return the claim dicts of the host path;
     each claim_all's wall ms, on the device path and the host path, and
     the kernel's device time in one more device claim_all;
  3b. control plane (``phase_control_plane``): the same 100,000 tasks and
     936 workers as 4 shards of 234 behind a ``ShardRouter``, every shard
     claiming through the ``wq_claim`` kernel, against one 936-worker
     queue claiming on the host: 3 claim_alls each at k 1 and k 4 equal
     to its claim dicts; a replica process per shard, synced across a log
     truncate, bit-identical to its shard; the remote sweep equal to the
     host queue's Q1-Q7; shard 0 killed with claims in flight and its
     replica promoted (no task lost, its claims then the host queue's); a
     sharded checkpoint restored at its version vector; a drained shard
     refilled by rebalance (live task ids conserved); the claim launches
     exact; then qwen2-0.5b at full width and depth trained by a sharded
     executor (2 shards of 2 workers, remote replicas, a checkpoint every
     3 steps, 6 steps of 2 x 2048, shard 1 failed and promoted after step
     3): every task FINISHED, exact launches. Wall ms of each claim_all on
     both paths, replica sync, remote sweep and rebalance ms, promote and
     checkpoint seconds, and the kernel's device time at a shard's
     shape (N 25,000, W 234);
  4. train: ``TrainExecutor`` trains qwen2-0.5b at full width and depth
     (bf16 compute, fp32 master params, remat, AdamW; batch 8 x 2048
     tokens) for 6 store-driven steps claimed by 2 workers through the
     claim kernel, with steering sweeps on snapshots; every task FINISHED,
     finite losses, the store's out0 the history's losses, exact launches
     of the flash forward (twice a layer and step: remat) and backward;
     s/step, tokens/s and peak memory. Then 2 more steps under the profiler
     (wall, card busy, idle share, top kernels, records counted), and one
     step of a 2-layer fp32 cut on the card against the same step on the
     CPU (loss, grad norm, every gradient, the new params of the embedding,
     an attention block and an MLP; every parameter's gradient nonzero).
     The same for mamba2-1.3b at full width and depth (batch 8 x 2048: the
     SSD scan forward, twice a layer with remat, and its backward kernel;
     the check a 2-layer fp32 cut, batch 2 x 256, one AdamW step) and for
     recurrentgemma-9b at full width with its depth cut to 8 layers (2
     groups of (rec, rec, attn) and 2 tail rec layers; the full 38 layers'
     8.6 B parameters with AdamW do not fit one card; batch 4 x 4096 in its
     4 microbatches, so the 2048 window bites: the RG-LRU scan and flash at
     width 256, forward and backward kernels; the check one group at full
     width, fp32, batch 1 x 256: loss, grad norm and every gradient); then
     granite-moe at full width with its depth cut (``MOE_TRAIN_LAYERS``;
     batch 8 x 2048 in its 4 microbatches, peak under 75 GB), qwen2-vl-2b
     and seamless at full width and depth (batch 8 x 2048; seamless: 2,048
     frames and 256 decoder tokens), each checked on a 2-layer fp32 cut
     with one AdamW step;
  5. kernels: each kernel against its plain PyTorch version on the card at
     the main path's shapes (``ssd_scan`` and ``rglru_scan`` also at a
     ragged length, in bf16, and in a slow-decay case where the state
     carried across chunks dominates the output; the attention kernels also
     at recurrentgemma-9b's shapes, windowed), with its error, its time and
     its bound (the RG-LRU scan's times with L2 flushed before each call, so
     that they are held against the HBM bound they are compared with, and
     back to back beside them; the claim kernel's beside an empty kernel
     launched as it is launched, the floor of one launch, with the
     operations a call puts on the card by the profiler: one kernel; the
     decode attention's and SSD scan's both back to back and flushed, beside
     SDPA's in the same two modes; the fp32 SSD scan and flash attention,
     forward and backward, held against three TF32 products per product,
     their route, with the fp32-FMA bound beside it; the flash forward with
     its row log-sum-exp and the flash backward at the train shape, the
     backward also at a ragged S in fp32, at glm4-9b's heads and windowed,
     each of dq, dk and dv within its limit and a repeat bit-identical,
     beside SDPA's backward and the function's bound; the backward kernels
     of the two scans and flash at width 256, the train paths' shapes: the
     SSD scan's backward timed at mamba2-1.3b's train shape, with its device
     time by launch, and held against its plain version over all 8 batch
     rows of it (one row a call), at a ragged S and in slow decay, the
     RG-LRU scan's at [1, 4096, 4096], ragged and slow, flash's
     forward with its LSE and backward at recurrentgemma-9b's heads, S 4096
     in bf16 beside SDPA's, and at a ragged S in fp32; the MoE, VLM and
     enc-dec paths' attention shapes: granite's and qwen2-vl's prefill and
     decode, seamless's encoder (not causal, 4,096 and 2,500 frames), its
     decoder's self-attention (64 prompt tokens at prefill, one query
     over ~80 cached keys at decode), its cross-attention (64 queries over
     4,096 or 2,500 frames at prefill, one over 4,096 at decode), and the
     train paths' forward with LSE and backward, seamless's at its
     encoder's 8 x 2,048, its decoder's 8 x 256 and its cross-attention's
     256 x 2,048 not causal), then one ``{"kernels": [...]}`` line: one
     entry per kernel, model and shape it runs there, with that run's
     launches at the shape (its share of the kernel's count, where the run
     gives it several shapes) and the device times of the kernel and of
     its library call.
Then a ``{"phase": "done"}`` line with the run's seconds (the build
included), the card's name and power limit again, the kernels line, and
last ``{"ok": true, "device": {...}}``. Any failed check raises:
the script then exits non-zero and does not print that line. Without a CUDA
card it refuses to run.
"""
from __future__ import annotations

import dataclasses
import fractions
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import SteeringEngine, WorkQueue  # noqa: E402
from repro_torch.core.schema import Status  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro_torch.flags import device_claims  # noqa: E402
from repro_torch.kernels import launch_counts, library, reset_launch_counts  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.decode_attention.ref import decode_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.rglru_scan.kernel import (  # noqa: E402
    rglru_scan_bwd, rglru_scan_fwd)
from repro_torch.kernels.rglru_scan.ref import (  # noqa: E402
    rglru_scan_bwd_ref, rglru_scan_ref)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import ssd_scan_bwd_ref, ssd_scan_ref  # noqa: E402
from repro_torch.kernels.wq_claim.kernel import empty_launch as wq_claim_empty_launch  # noqa: E402
from repro_torch.kernels.wq_claim.kernel import wq_claim_fwd  # noqa: E402
from repro_torch.kernels.wq_claim.ref import wq_claim_ref  # noqa: E402
from repro_torch.launch.steps import (cast_params, copy_params,  # noqa: E402
                                      init_train_state, loss_and_grads,
                                      make_train_step)
from repro_torch.models.moe import MoE  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.models.transformer import hybrid_counts  # noqa: E402
from repro_torch.optim import init_opt  # noqa: E402
from repro_torch.optim.clipping import global_norm  # noqa: E402
from repro_torch.runtime.executor import ServeExecutor, TrainExecutor  # noqa: E402

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
# limit of the SSD scan against its plain version (the sequential
# recurrence): the reference's own rule, max |got - ref| / max |ref| < 1e-4,
# per element of y and of the final state; bf16 outputs may also differ by
# one bf16 step of their value (2**-7 * |ref|), as for attention
SSD_REL_TOL = 1e-4
# the same rule for the RG-LRU scan against its plain version (the
# sequential recurrence): 1e-4 of max |ref| per element of h, plus one bf16
# step of the value for a bf16 h
RGLRU_REL_TOL = 1e-4
# recurrentgemma-9b's weights are 51.5 GB (34.3 GB fp32 master, 17.2 GB bf16
# decode copy); a second fp32 copy during the cast would pass this
HYBRID_MAX_PEAK_BYTES = 56e9
# recurrentgemma-9b's train run, depth cut to 8 layers (2.64 B parameters:
# ~48 GB of masters, gradients, AdamW and the bf16 cast before
# activations); past this the cut would have to go to 1 group + 1 tail
HYBRID_TRAIN_MAX_PEAK_BYTES = 75e9
HYBRID_TRAIN_LAYERS = 8
# granite-moe-3b-a800m's train run at full width: its 3.90 B stored
# parameters (the experts padded 40 -> 48) at ~18 bytes each with AdamW
# (fp32 params, gradients and two moments, the bf16 cast) are ~70 GB before
# activations and the microbatches' second set of gradients, so its depth
# is cut to what keeps the peak under the hybrid's 75 GB
MOE_TRAIN_MAX_PEAK_BYTES = 75e9
MOE_TRAIN_LAYERS = 21
# the flash backward against its plain version: fp32 sums of up to S x g
# terms in another order, 1e-4 of the gradient's largest element; bf16 also
# one bf16 step of the value (both sides round once from fp32). The row
# log-sum-exp the forward writes for it: 1e-4 absolute (it scales every P of
# its row by exp of its error)
BWD_REL_TOL = 1e-4
LSE_TOL = 1e-4
# train check, card against CPU, fp32, 2 layers at full width: the loss
# (sums of 151,936 logits a token in another order) 1e-5 relative, the
# grad norm 1e-4 relative, every gradient 1e-3 of its tensor's largest
# (the flash forward's 3xTF32 products, sums in another order); after one
# AdamW step, 1e-2 of the lr per element where the gradient is resolved (at
# least 100 times the tensor's largest card-vs-CPU gradient difference, so
# that its sign cannot flip), else the update's size, 2 lr: the first
# update is lr g / (|g| + 1e-8). The key bias's gradient is 0 in exact
# arithmetic (it shifts a row's logits uniformly): noise on both sides
TRAIN_LOSS_TOL = 1e-5
TRAIN_GNORM_TOL = 1e-4
TRAIN_GRAD_TOL = 1e-3
# the card-vs-CPU checks of the MoE family pin the CPU's routing to the
# card's (``RoutePin``) and count the tokens the CPU would have routed
# otherwise: near ties of two experts within the devices' rounding. Readings
# on an H100 (chip_smoke of the MoE port): 2 of 8,192 decisions in the
# 2-layer fp32 train check, 1 of 80 in the serve check (bf16 decode steps
# among them). Held to the larger of 2 tokens and 1e-3 of the decisions; a
# wrong router or top-k on the card would move most of them
ROUTE_FLIPS = {"min": 2, "share": 1e-3}
# mamba2's A_log gradient is a sum over the batch's positions of dda dt a,
# whose terms cancel 280-500x at this check's inputs (the CPU's plain
# backward); the chunked form's dda in fp32 (the card's kernel, and a model
# of it on the CPU with its fp64 cumsum) moves that sum by 2.3e-3 and
# 2.6e-3 of its largest element, though every dda is within 1e-4 of the
# plain version's largest (the kernel phase). Held to 1e-2 of its largest
TRAIN_GRAD_TOL_BY_NAME = {"mixer.A_log": 1e-2}
# published peaks of one H100 SXM (NVIDIA data sheet, dense, at 700 W);
# "tf32" is the tensor cores' TF32 rate, which the 3xTF32 products of the
# SSD scan and of the fp32 flash attention (forward and backward) run at
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {torch.float32: 67e12, torch.bfloat16: 989e12, torch.int32: 67e12,
            "tf32": 495e12}

SRC = {"wq_claim": "src/repro_torch/csrc/wq_claim.cu",
       "flash_attention": "src/repro_torch/csrc/flash_attention.cu",
       "flash_attention_bwd": "src/repro_torch/csrc/flash_attention_bwd.cu",
       "decode_attention": "src/repro_torch/csrc/decode_attention.cu",
       "ssd_scan": "src/repro_torch/csrc/ssd_scan.cu",
       "ssd_scan_bwd": "src/repro_torch/csrc/ssd_scan_bwd.cu",
       "rglru_scan": "src/repro_torch/csrc/rglru_scan.cu",
       "rglru_scan_bwd": "src/repro_torch/csrc/rglru_scan.cu"}
REPLACES = {"wq_claim": "src/repro/kernels/wq_claim/kernel.py:32",
            "flash_attention": "src/repro/kernels/flash_attention/kernel.py:25",
            # no Pallas backward: XLA differentiates the reference's sdpa_ref
            "flash_attention_bwd": "src/repro/models/attention.py:43",
            "decode_attention": "src/repro/kernels/decode_attention/kernel.py:21",
            "ssd_scan": "src/repro/kernels/ssd_scan/kernel.py:23",
            # no Pallas backward: XLA differentiates ssd_chunked and the
            # associative scan of _rglru_core
            "ssd_scan_bwd": "src/repro/models/ssm.py:81",
            "rglru_scan": "src/repro/kernels/rglru_scan/kernel.py:20",
            "rglru_scan_bwd": "src/repro/models/rglru.py:93"}


def layers_of(cfg, kind: str) -> int:
    """How many layers of ``kind`` ("attn", "rec", "ssm") a config has; the
    hybrid's are counted from its pattern (groups, then the tail's rec
    layers). For enc-dec, "attn" counts the attention calls of one forward:
    the encoder's self-attention, the decoder's self- and cross-attention."""
    if cfg.family == "encdec":
        return cfg.num_encoder_layers + 2 * cfg.num_layers \
            if kind == "attn" else 0
    if cfg.family == "hybrid":
        ng, nt = hybrid_counts(cfg)
        return ng * cfg.rglru.pattern.count(kind) + (nt if kind == "rec"
                                                     else 0)
    own = "ssm" if cfg.family == "ssm" else "attn"
    return cfg.num_layers if kind == own else 0


# kernels a serve run of each family launches (wq_claim runs in the claim
# phase), as functions of (config, requests, new tokens): one flash launch
# per attention layer and prefill, one decode launch per attention layer
# and decode step (the first token comes from the prefill), one SSD or
# RG-LRU scan per recurrent layer and prefill. Enc-dec: its prefill's
# attention calls (encoder, decoder self and cross) each a flash launch, its
# decode step's two a layer (self against the cache, cross against the
# cached encoder frames) each a decode launch
def _attention_launches(cfg, r, new):
    n = layers_of(cfg, "attn")
    per_step = 2 * cfg.num_layers if cfg.family == "encdec" else n
    return {"flash_attention": n * r,
            "decode_attention": per_step * r * (new - 1)}


SERVE_LAUNCHES = {
    "dense": _attention_launches,
    "moe": _attention_launches,
    "vlm": _attention_launches,
    "encdec": _attention_launches,
    "ssm": lambda cfg, r, new: {"ssd_scan": layers_of(cfg, "ssm") * r},
    "hybrid": lambda cfg, r, new: {"rglru_scan": layers_of(cfg, "rec") * r,
                                   **_attention_launches(cfg, r, new)},
}


def train_launches(cfg, steps: int, ticks: int) -> dict:
    """Kernels a train run launches: per step, microbatch and layer one
    forward of the layer's kernel (two with remat: the backward recomputes
    it) and one backward (flash for attention layers, the SSD scan for SSM
    layers, the RG-LRU scan for rec layers); one claim kernel per tick's
    claim_all (device claims on)."""
    per = steps * max(1, cfg.microbatches)
    out = {"wq_claim": ticks}
    for kind, name in (("attn", "flash_attention"), ("ssm", "ssd_scan"),
                       ("rec", "rglru_scan")):
        n = layers_of(cfg, kind) * per
        if n:
            out[name] = n * (2 if cfg.remat else 1)
            out[name + "_bwd"] = n
    return out


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
    launch counts are those of this run alone. Peak device memory is read
    twice: over building the executor (the params and their decode copy)
    and over the serve."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()    # the allocator's stats exist once it is set up
        torch.cuda.reset_peak_memory_stats(device)
    ex = ServeExecutor(cfg, slots=slots, max_len=max_len, seed=seed,
                       device=device)
    init_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    prompts = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (requests, prompt_len)).astype(np.int32)
    if on_card:
        torch.cuda.reset_peak_memory_stats(ex.device)
    sync(ex.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    ids = ex.submit(prompts, max_new=max_new)
    finished = ex.drain()
    sync(ex.device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = SERVE_LAUNCHES[cfg.family](cfg, requests, max_new)
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
           "init_peak_mem_bytes": init_peak,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(ex.device)
                              if on_card else None),
           "launches": {k: counts[k] for k in want},
           "q4": steer["q4"]}
    if on_card:
        # exactly the path's kernels, and none of the other families'
        for k, n in counts.items():
            if k != "wq_claim":
                check(n == want.get(k, 0), f"{k} launches {n} != "
                      f"{want.get(k, 0)} ({cfg.name})")
    emit(res)
    return {"result": res, "executor": ex}


def _prompt_len(batch) -> int:
    """The prompt's length: its tokens (enc-dec: the decoder's), or its
    patch embeddings."""
    return (batch["tokens"] if "tokens" in batch else batch["embeds"]).shape[1]


def _logits_run(model, params, dparams, batch, steps, device, feed=None):
    """Prefill ``batch`` (CPU tensors: tokens, or a VLM's embeds and M-RoPE
    ids, or an enc-dec's frames and tokens) with ``params``, then ``steps``
    decode steps with ``dparams``, fed ``feed`` or the greedy tokens.
    Returns the logits of every step (fp32, on the CPU) and the tokens
    fed."""
    with torch.no_grad():
        lg, cache = model.prefill(params, {k: v.to(device)
                                           for k, v in batch.items()},
                                  _prompt_len(batch) + steps + 1)
        out, fed = [lg.float().cpu()], []
        for s in range(steps):
            tok = feed[s] if feed is not None else \
                torch.argmax(out[-1][0, -1]).reshape(1, 1).to(torch.int32)
            fed.append(tok)
            lg, cache = model.decode_step(dparams, tok.to(device), cache)
            out.append(lg.float().cpu())
    return out, fed


class RoutePin:
    """Pins the MoE routing of a second run to that of a first one on the
    same inputs (the card's, recorded, against the CPU's), so that the two
    compute the same function. Top-k is discontinuous: where two experts'
    probabilities lie within the runs' rounding of each other (the fp32
    logits differ by ~1e-6 between the devices, more after a bf16 layer),
    the two runs can route a token to different experts, and its output and
    gradients then differ by far more than any limit. Set as each MoE
    layer's ``pin`` (``models/moe.py``) for a run: the first run records
    each router call's expert ids; the second, call by call in the same
    order, takes those ids, weighed by its own probabilities, and counts
    the tokens whose own choice (set or order) differed: ``differences`` of
    ``decisions``, held to :data:`ROUTE_FLIPS` (a card that routed by wrong
    probabilities or a wrong top-k would differ on most tokens). A config
    without experts runs as it is."""

    def __init__(self, cfg):
        self.moe = cfg.moe is not None
        self.calls, self.mode, self.at = [], None, 0
        self.differences, self.decisions = 0, 0

    def __call__(self, idx):
        if self.mode == "record":
            self.calls.append(idx.cpu())
            return idx
        want = self.calls[self.at].to(idx.device)
        self.at += 1
        self.differences += int((idx != want).any(-1).sum())
        self.decisions += idx.shape[0]
        return want

    def run(self, mode: str, params, fn, *args):
        """``fn(*args)`` with the MoE layers of the modules ``params``
        routing through the pin: their choice recorded ("record") or pinned
        to the recorded one ("replay")."""
        if not self.moe:
            return fn(*args)
        self.mode, self.at = mode, 0
        if mode == "record":
            self.calls = []
        layers = [m for p in params for m in p.modules()
                  if isinstance(m, MoE)]
        for m in layers:
            m.pin = self
        try:
            return fn(*args)
        finally:
            for m in layers:
                m.pin = None
            self.mode = None

    def check(self) -> None:
        """Fails past :data:`ROUTE_FLIPS` tokens routed otherwise."""
        limit = max(ROUTE_FLIPS["min"], ROUTE_FLIPS["share"] * self.decisions)
        check(self.differences <= limit,
              f"{self.differences} of {self.decisions} routing decisions "
              f"differ between the card and the CPU (limit {limit})")

    def summary(self) -> dict:
        return {"route_differences": self.differences,
                "route_decisions": self.decisions,
                "route_differences_limit": max(
                    ROUTE_FLIPS["min"], ROUTE_FLIPS["share"] *
                    self.decisions)} if self.moe else {}


def cpu_copy(module: torch.nn.Module) -> torch.nn.Module:
    """A copy of ``module`` on the CPU, made parameter by parameter (no
    second copy on the card)."""
    return copy_params(module, lambda t: t.to("cpu", copy=True))


def phase_serve_check(ex, *, prompt_len=37, steps=3, seed=1) -> dict:
    """The executor's model on its device against a CPU copy of the same
    weights (plain versions), on the same tokens: prefill logits in the
    master dtype, then ``steps`` decode steps in ``cfg.dtype``."""
    tokens = torch.as_tensor(np.random.default_rng(seed).integers(
        0, ex.cfg.vocab_size, (1, prompt_len)).astype(np.int32))
    return _serve_check(ex.cfg, ex.model, ex.params, ex.decode_params,
                        {"tokens": tokens}, steps, ex.device)


def _serve_check(cfg, model, params, dparams, batch, steps, device,
                 **extra) -> dict:
    """``model`` on ``device`` against a CPU copy of the same weights
    (plain versions) on the same ``batch``: prefill logits in the master
    dtype, then ``steps`` greedy decode steps in ``cfg.dtype``, each within
    ``SERVE_TOL`` of the logits' size."""
    pin = RoutePin(cfg)   # the CPU's routing pinned to the card's
    host, host_d = cpu_copy(params), cpu_copy(dparams)
    got, fed = pin.run("record", (params, dparams), _logits_run, model,
                       params, dparams, batch, steps, device)
    ref, _ = pin.run("replay", (host, host_d), functools.partial(
        _logits_run, feed=fed), model, host, host_d, batch, steps, "cpu")
    del host, host_d
    pin.check()
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
    res = {"phase": "serve_check", "arch": cfg.name,
           "layers": cfg.num_layers, "prompt_len": _prompt_len(batch),
           **extra, **pin.summary(), "steps": errs}
    emit(res)
    return res


def phase_hybrid_check(cfg, device, *, layers=4, prompt_len=2100, steps=3,
                       seed=1) -> dict:
    """The serve check on a cut of the hybrid at full width: ``layers``
    layers (4: one (rec, rec, attn) group and one tail rec layer), a prompt
    longer than the window, so that the flash kernel's window bites and the
    prefill's K/V wrap in the ring, then ``steps`` decode steps."""
    ex = ServeExecutor(dataclasses.replace(cfg, num_layers=layers), slots=1,
                       max_len=prompt_len + steps + 1, seed=seed,
                       device=device)
    res = phase_serve_check(ex, prompt_len=prompt_len, steps=steps,
                            seed=seed)
    del ex
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def grid_positions(s: int, width: int) -> np.ndarray:
    """[3,1,S] int32 M-RoPE ids of S patches in rows of ``width``: t
    constant, h the row, w the column (three distinct streams: with equal
    ones M-RoPE is RoPE, and its sections would go unchecked)."""
    i = np.arange(s)
    return np.stack([np.zeros(s), i // width, i % width])[:, None] \
        .astype(np.int32)


def request_inputs(cfg, rng, prompt_len: int, frames: int = 0) -> dict:
    """One request's prefill batch (batch 1, CPU tensors, made with numpy):
    a VLM's ``prompt_len`` patch embeddings (N(0, 0.1^2), as the data
    pipeline makes them) on a grid 40 patches wide; an enc-dec's ``frames``
    frame embeddings and a ``prompt_len``-token prompt; else tokens."""
    def emb(n):
        return torch.as_tensor((rng.standard_normal((1, n, cfg.d_model))
                                * 0.1).astype(np.float32))
    if cfg.family == "encdec":
        return {"frames": emb(frames), "tokens": torch.as_tensor(
            rng.integers(0, cfg.vocab_size, (1, prompt_len))
            .astype(np.int32))}
    if cfg.embed_stub:
        return {"embeds": emb(prompt_len), "mrope_positions":
                torch.as_tensor(grid_positions(prompt_len, 40))}
    return {"tokens": torch.as_tensor(rng.integers(
        0, cfg.vocab_size, (1, prompt_len)).astype(np.int32))}


def bundle(cfg, device, seed=0):
    """The model bundle and its params on ``device`` as ``ServeExecutor``
    holds them: the master params (``cfg.param_dtype``, no grad) and one
    copy in ``cfg.dtype`` for decode."""
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed))
    params.requires_grad_(False)
    return model, params, cast_params(params, cfg.dtype)


def phase_serve_bundle(cfg, device, *, requests=8, prompt_len=1000,
                       frames=(), max_new=32, max_len=4096, seed=0,
                       profile=True) -> dict:
    """Serve ``requests`` one after another through the model bundle (the
    reference's ``build_model`` API, which its own tests drive: its
    ``ServeExecutor`` feeds token prompts alone, so it cannot serve the VLM
    or enc-dec families, and neither can the port's), with the executor's
    split: prefill with the master params, ``max_new - 1`` greedy decode
    steps with the ``cfg.dtype`` copy against the ``cfg.dtype`` cache. A
    VLM request is ``prompt_len`` patch embeddings with M-RoPE ids of a
    patch grid; an enc-dec request ``frames[i]`` frames (``cross_kv_len``
    unless fewer are named) and a ``prompt_len``-token prompt. Launches,
    wall time and peak memory as :func:`phase_serve`; then, on the card, 2
    more requests (8 decode steps) under the profiler."""
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    model, params, dparams = bundle(cfg, device, seed)
    init_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    rng = np.random.default_rng(seed)
    n_frames = [(list(frames) + [cfg.cross_kv_len] * requests)[i]
                for i in range(requests)] if cfg.family == "encdec" else \
        [0] * requests
    batches = [request_inputs(cfg, rng, prompt_len, f) for f in n_frames]

    def serve(batch, new):
        with torch.no_grad():
            logits, cache = model.prefill(
                params, {k: v.to(device) for k, v in batch.items()}, max_len)
            out = [torch.argmax(logits[:, -1], -1)[:, None].to(torch.int32)]
            for _ in range(new - 1):
                logits, cache = model.decode_step(dparams, out[-1], cache)
                out.append(torch.argmax(logits[:, -1], -1)[:, None]
                           .to(torch.int32))
        return torch.cat(out, 1)[0].cpu().numpy()

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    outs = [serve(b, max_new) for b in batches]
    sync(device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    want = SERVE_LAUNCHES[cfg.family](cfg, requests, max_new)
    tokens = int(sum(len(o) for o in outs))
    check(all(len(o) == max_new for o in outs), "output lengths")
    check(all(((o >= 0) & (o < cfg.vocab_size)).all() for o in outs),
          "token ids out of range")
    res = {"phase": "serve", "arch": cfg.name, "device": str(device),
           "path": "model bundle (prefill / decode_step)",
           "layers": cfg.num_layers,
           "encoder_layers": cfg.num_encoder_layers or None,
           "d_model": cfg.d_model, "heads": [cfg.num_heads, cfg.num_kv_heads],
           "vocab": cfg.vocab_size, "requests": requests,
           "prompt_len": prompt_len,
           "frames": n_frames if cfg.family == "encdec" else None,
           "finished": len(outs), "tokens_generated": tokens, "wall_s": wall,
           "tokens_per_s": tokens / wall, "init_peak_mem_bytes": init_peak,
           "peak_mem_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
           "launches": {k: counts[k] for k in want}}
    if on_card:
        for k, n in counts.items():
            check(n == want.get(k, 0), f"{k} launches {n} != "
                  f"{want.get(k, 0)} ({cfg.name})")
    emit(res)
    if on_card and profile:
        sync(device)
        prof = {"phase": "serve_profile", "arch": cfg.name,
                "prompt_len": prompt_len, "decode_steps": 8, "requests": 2,
                **_profile_result(profile_calls(
                    lambda: serve(batches[0], 9), 2))}
        emit(prof)
    del model, params, dparams
    return res


def phase_family_check(cfg, device, *, layers=2, prompt_len=37, frames=0,
                       steps=3, seed=1) -> dict:
    """The serve check on a ``layers``-layer cut of ``cfg`` at full width
    (enc-dec: ``layers`` encoder and decoder layers): prefill and ``steps``
    greedy decode steps through the model bundle on the card against a CPU
    copy of the same weights (plain versions). The VLM's prompt is patch
    embeddings on a grid; the enc-dec's ``frames`` frames, fewer than
    ``cross_kv_len``, so that its decode memory is zero-padded."""
    c = dataclasses.replace(cfg, num_layers=layers, **(
        {"num_encoder_layers": layers} if cfg.family == "encdec" else {}))
    model, params, dparams = bundle(c, device, seed)
    batch = request_inputs(c, np.random.default_rng(seed), prompt_len, frames)
    res = _serve_check(c, model, params, dparams, batch, steps, device,
                       **({"frames": frames, "cross_kv_len": c.cross_kv_len}
                          if c.family == "encdec" else {}))
    del model, params, dparams
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


def profile_calls(body, calls: int = 2) -> dict:
    """``body`` run ``calls`` times under torch.profiler (CUDA activity):
    wall seconds per call, and each kernel's device us per call counted as
    :func:`device_ms` counts them (:func:`per_call_us`: every call runs each
    kernel equally often, so a kernel's records come in multiples of
    ``calls``; a profile that lost some reads whole), with the records lost
    by kernel."""
    from torch.profiler import ProfilerActivity, profile
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            body()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / calls
    kernels = _device_kernels(prof)
    return {"wall_s": wall, "per_call_us": per_call_us(kernels, calls),
            "records": sum(n for _, n in kernels.values()),
            "records_lost": records_lost(kernels, calls)}


def records_lost(kernels: dict, calls: int) -> dict:
    """Records a profile of ``calls`` equal calls lost, by kernel: a
    kernel's records come in multiples of ``calls``, and fewer than
    ``calls`` of them are lost (:func:`per_call_us`)."""
    return {name[:60]: calls * -(-n // calls) - n
            for name, (_, n) in kernels.items() if n % calls}


def _profile_result(prof: dict) -> dict:
    by_name = prof["per_call_us"]
    busy = sum(by_name.values()) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"wall_s": prof["wall_s"], "device_busy_s": busy,
            "device_idle_share": (1.0 - busy / prof["wall_s"]) if busy
            else None,
            "records": prof["records"], "records_lost": prof["records_lost"],
            "top_kernels_ms": [[name[:60], us / 1e3] for name, us in top]}


def phase_serve_profile(ex, *, prompt_len=1000, max_new=9, seed=2,
                        calls=2) -> dict:
    """``calls`` more requests of the same prompt through the executor, one
    after the other, under torch.profiler: per request, the wall time of
    its prefill and decode steps against the time the card was busy, and
    the kernels that took it (records counted, :func:`profile_calls`)."""
    prompt = np.random.default_rng(seed).integers(
        0, ex.cfg.vocab_size, (1, prompt_len)).astype(np.int32)

    def request():
        ex.submit(prompt, max_new=max_new)
        ex.drain()

    sync(ex.device)
    res = {"phase": "serve_profile", "arch": ex.cfg.name,
           "prompt_len": prompt_len, "decode_steps": max_new - 1,
           "requests": calls, **_profile_result(profile_calls(request, calls))}
    emit(res)
    return res


# ------------------------------------------------------------ phase train
def phase_train(cfg, device, *, steps=6, workers=2, seq_len=2048, batch=8,
                seed=0, reduced=None, max_peak=None) -> dict:
    """``TrainExecutor`` at ``cfg``'s full width (and its depth unless
    ``reduced`` names a cut): ``steps`` train-step tasks claimed by
    ``workers`` partitions through the claim kernel (device claims on), each
    step's loss, grad norm and seconds written back to the store, steering
    sweeps on snapshots every 2 steps. The launch counts are this run's
    alone; peak device memory is read over building the executor (master
    params, AdamW moments) and over the run, and held under ``max_peak``
    when given."""
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    if on_card:
        torch.cuda.init()
        torch.cuda.reset_peak_memory_stats(device)
    with device_claims(True):
        ex = TrainExecutor(cfg, num_workers=workers, steer_every=2, seed=seed,
                           data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                               seq_len=seq_len,
                                               batch_size=batch),
                           device=device)
    init_peak = torch.cuda.max_memory_allocated(device) if on_card else None
    ex.submit_steps(steps)
    sync(ex.device)
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    hist = ex.run()
    sync(ex.device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ticks = -(-steps // workers)
    want = train_launches(cfg, steps, ticks)
    losses = [h["loss"] for h in hist]
    check(ex.wq.device_claim, "the train queue does not claim on the device")
    check(len(hist) == steps == ex.wq.counts()["FINISHED"],
          f"finished {ex.wq.counts()['FINISHED']} of {steps}")
    check(bool(np.isfinite(losses).all()), f"losses {losses}")
    out0 = ex.wq.store.col("out0")[:steps]
    check(np.array_equal(np.sort(out0), np.sort(losses)),
          f"store out0 {out0} != history losses {losses}")
    check(ex.last_steering is not None, "no steering sweep ran")
    if on_card:
        for k, n in counts.items():
            check(n == want.get(k, 0),
                  f"{k} launches {n} != {want.get(k, 0)} (train)")
    peak = torch.cuda.max_memory_allocated(device) if on_card else None
    if max_peak is not None and on_card:
        for what, v in (("init", init_peak), ("run", peak)):
            check(v < max_peak, f"{cfg.name} train {what} peak {v} >= "
                  f"{max_peak}")
    steady = [h["s_per_step"] for h in hist[1:]] or [hist[0]["s_per_step"]]
    s_step = float(np.mean(steady))
    res = {"phase": "train", "arch": cfg.name, "device": str(ex.device),
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads],
           "vocab": cfg.vocab_size, "dtype": cfg.dtype,
           "param_dtype": cfg.param_dtype, "optimizer": cfg.optimizer,
           "param_count": sum(p.numel()
                              for p in ex.state["params"].parameters()),
           "reduced": reduced, "remat": cfg.remat, "seq_len": seq_len,
           "batch": batch, "microbatches": max(1, cfg.microbatches),
           "workers": workers, "steps": steps, "losses": losses,
           "grad_norms": [h["grad_norm"] for h in hist],
           "s_per_step": [h["s_per_step"] for h in hist],
           "steady_s_per_step": s_step,
           "tokens_per_s": batch * seq_len / s_step,
           "wall_s": wall, "init_peak_mem_bytes": init_peak,
           "peak_mem_bytes": peak,
           "launches": {k: counts[k] for k in want},
           "steering_q4": ex.last_steering["q4"],
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    return {"result": res, "executor": ex}


def phase_train_profile(ex, *, calls=2) -> dict:
    """``calls`` more train steps of the executor (one task and one tick
    each) under torch.profiler: per step, wall time against the time the
    card was busy, the idle share and the kernels that took it (records
    counted, :func:`profile_calls`)."""
    t_phase = time.perf_counter()

    def one_step():
        ex.submit_steps(1)
        ex.run()

    sync(ex.device)
    res = {"phase": "train_profile", "arch": ex.cfg.name,
           "steps": calls, **_profile_result(profile_calls(one_step, calls))}
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


def phase_train_check(cfg, device, *, layers=2, batch=2, seq_len=256, seed=3,
                      lr=3e-4, step=True,
                      prefixes=("layers.0.attn.", "layers.0.mlp.")) -> dict:
    """One train step on the card against the same step on the CPU (plain
    versions), from the same params and batch: a ``layers``-layer cut of
    ``cfg`` at full width in fp32. Every parameter must get a nonzero
    gradient on the card; the loss, the grad norm and every gradient are
    held to the limits above, and with ``step`` the new params of the
    embedding and of those named by ``prefixes`` after one optimizer step
    (without it, loss and grad norm are those of the gradients alone)."""
    t_phase = time.perf_counter()
    c = dataclasses.replace(cfg, num_layers=layers, dtype="float32", **(
        {"num_encoder_layers": layers} if cfg.family == "encdec" else {}))
    gen = torch.Generator(device=device).manual_seed(seed)
    if step:
        card = init_train_state(c, gen)
    else:
        card = {"params": build_model(c).init(gen).requires_grad_(True)}
    host_params = cpu_copy(card["params"]).requires_grad_(True)
    host = {"params": host_params}
    if step:
        host["opt"] = init_opt(c, host_params)
    tok = batch_for(c, DataConfig(vocab_size=c.vocab_size, seq_len=seq_len,
                                  batch_size=batch), seed)
    b_card = {k: torch.as_tensor(v, device=device) for k, v in tok.items()}
    b_host = {k: torch.as_tensor(v) for k, v in tok.items()}
    pin = RoutePin(c)     # the CPU's routing pinned to the card's
    l_card, _, g_card = pin.run("record", (card["params"],), loss_and_grads,
                                c, card["params"], b_card)
    zero = [n for n, g in g_card.items() if not bool((g != 0).any())]
    check(not zero, f"no gradient on the card for {zero}")
    l_host, _, g_host = pin.run("replay", (host["params"],), loss_and_grads,
                                c, host["params"], b_host)
    pin.check()
    grad_err, limits = {}, {}
    for n, g in g_host.items():
        if n.endswith("attn.k.bias"):
            continue
        gc_ = g_card[n].cpu()
        if ".moe." in n and n.rsplit(".", 1)[1] in ("up", "gate", "down"):
            # the padding experts get no tokens: no gradient on either side
            e = c.moe.num_experts
            check(not gc_[e:].any(), f"a padding expert of {n} has a "
                  f"gradient")
            g, gc_ = g[:e], gc_[:e]
        grad_err[n] = float((gc_ - g).abs().max()) / float(g.abs().max())
        limits[n] = next((t for k, t in TRAIN_GRAD_TOL_BY_NAME.items()
                          if n.endswith(k)), TRAIN_GRAD_TOL)
    top = sorted(grad_err.items(), key=lambda kv: -kv[1])[:4]
    for n, err in grad_err.items():
        check(err <= limits[n], f"gradient {n}: {err} of its largest (limit "
              f"{limits[n]}); the largest: {top}; {pin.summary()}")
    param_err = None
    if step:
        train_step = make_train_step(c)
        card, m_card = pin.run("record", (card["params"],), train_step,
                               card, b_card, {"lr": lr})
        host, m_host = pin.run("replay", (host["params"],), train_step,
                               host, b_host, {"lr": lr})
        pin.check()
        loss_c, loss_h = float(m_card["loss"]), float(m_host["loss"])
        gn_c, gn_h = float(m_card["grad_norm"]), float(m_host["grad_norm"])
    else:
        loss_c, loss_h = float(l_card), float(l_host)
        gn_c = float(global_norm(g_card))
        gn_h = float(global_norm(g_host))
    check(np.isfinite(loss_c) and abs(loss_c - loss_h) <=
          TRAIN_LOSS_TOL * abs(loss_h), f"loss {loss_c} vs {loss_h}")
    check(abs(gn_c - gn_h) <= TRAIN_GNORM_TOL * gn_h,
          f"grad norm {gn_c} vs {gn_h}")
    if step:
        new_card = dict(card["params"].named_parameters())
        param_err = {}
        for n, p in host["params"].named_parameters():
            if not (n == "embed.weight" or n.startswith(prefixes)):
                continue
            m = host["opt"]["inner"]["m"][n]      # 0.1 g, scaled, on both
            gap = (card["opt"]["inner"]["m"][n].cpu() - m).abs().max()
            tol = torch.where(m.abs() >= 100 * gap, 1e-2 * lr, 2 * lr)
            if n.endswith("attn.k.bias"):
                tol = torch.full_like(m, 2 * lr)
            diff = (new_card[n].detach().cpu() - p.detach()).abs()
            param_err[n] = {"max_abs_err": float(diff.max()),
                            "err_over_tol": float((diff / tol).max()),
                            "resolved_share": float((tol < 2 * lr).float()
                                                    .mean())}
            check(bool((diff <= tol).all()), f"new param {n}: "
                  f"{param_err[n]['err_over_tol']} of its limit")
    res = {"phase": "train_check", "arch": cfg.name, "layers": layers,
           "batch": batch, "seq_len": seq_len, "dtype": "float32",
           "param_count": sum(p.numel()
                              for p in host_params.parameters()),
           "optimizer_step": step,
           "loss": [loss_c, loss_h], "grad_norm": [gn_c, gn_h],
           "loss_tol": TRAIN_LOSS_TOL, "grad_norm_tol": TRAIN_GNORM_TOL,
           "max_grad_err_over_largest": max(grad_err.values()),
           "grad_tol": TRAIN_GRAD_TOL,
           "grad_tol_by_name": TRAIN_GRAD_TOL_BY_NAME,
           "grad_err_top": top,
           **pin.summary(), "params": param_err,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    del card, host, host_params, g_card, g_host
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return res


# --------------------------------------------------------------- phase 3
def phase_claim(device, *, tasks=100_000, workers=936, rounds=3) -> dict:
    """Device-claim queue against the host-claim queue on the same inserts
    and claims (the host claim bench's store: one activity, round-robin
    partitions); the launch count is this phase's alone."""
    on_card = torch.device(device).type == "cuda"
    reset_launch_counts()
    claimed = 0
    wall_ms = {"device": [], "host": []}   # claim_all, per round

    def timed(q, kind, k, now):
        t0 = time.perf_counter()
        out = q.claim_all(k=k, now=now)   # the device path ends in a copy
        wall_ms[kind].append((time.perf_counter() - t0) * 1e3)
        return out

    for k in (1, 4):
        qs = [WorkQueue(num_workers=workers, capacity=2 * tasks,
                        device_claim=dc, device=device) for dc in (True, False)]
        for q in qs:
            q.add_tasks(0, tasks)
        for r in range(rounds):
            got = timed(qs[0], "device", k, float(r))
            want = timed(qs[1], "host", k, float(r))
            check(got.keys() == want.keys(), "claim dict keys")
            check(all(np.array_equal(got[w], want[w]) for w in want),
                  f"claim dicts differ (k={k}, round {r})")
            claimed += sum(len(v) for v in got.values())
        check(np.array_equal(qs[0].store.col("status"),
                             qs[1].store.col("status")), "status columns")
        qs[0].check_invariants()
    launches = launch_counts()["wq_claim"]
    if on_card:
        check(launches == 2 * rounds,
              f"wq_claim launches {launches} != {2 * rounds}")
    res = {"phase": "claim", "tasks": tasks, "workers": workers,
           "rounds_per_k": rounds, "tasks_claimed": claimed,
           "equal_to_host_path": True, "launches": {"wq_claim": launches},
           "claim_all_wall_ms": wall_ms,
           "kernel_device_ms": claim_all_kernel_ms(tasks, workers, device)
           if on_card else None}
    emit(res)
    return res


def claim_all_kernel_ms(tasks: int, workers: int, device,
                        calls: int = 20) -> float:
    """Device ms of the claim kernel in one device-claim claim_all (a fresh
    queue of the phase's store, k 1, ``calls`` claim_alls under
    torch.profiler, each launching the kernel once), read after the
    phase's launch count. Records are counted (:func:`per_call_us`); a
    profile without any record of the kernel is taken again, and none in
    three raises."""
    q = WorkQueue(num_workers=workers, capacity=2 * tasks, device_claim=True,
                  device=device)
    q.add_tasks(0, tasks)
    q.claim_all(k=1, now=0.0)     # built and warm
    for _ in range(3):
        found = {name: rec for name, rec in _profile(
            lambda: [q.claim_all(k=1, now=1.0) for _ in range(calls)]
        ).items() if "claim" in name}
        if found:
            return sum(per_call_us(found, calls).values()) / 1e3
    raise AssertionError("no record of the claim kernel in three profiles")


# ------------------------------------------------------ phase control plane
CONTROL_PLANE = "control_plane"
CONTROL_PLANE_SHARDS = 4
SHARDED_TRAIN = "qwen2-0.5b train, 2 shards"
SHARDED_TRAIN_BATCH = 2
SHARDED_TRAIN_STEPS = 6


def _dom_in(ids: np.ndarray) -> np.ndarray:
    h = (ids * 2654435761) % (1 << 10)
    return np.stack([(h % 977) / 976.0, ((h * 3) % 911) / 910.0,
                     ((h * 7) % 1013) / 1012.0], 1)


def _dom_out(ids: np.ndarray) -> np.ndarray:
    # dyadic values (and dyadic clocks below): exact in float64, so the
    # merged sweeps' sums equal the oracle's bit for bit
    return np.stack([(ids % 7) / 8.0, (ids % 5) / 4.0, (ids % 3) / 2.0], 1)


def _shard_rows(router, ids: np.ndarray):
    """(shard, rows) of global task ids (shard stores hold ids ascending)."""
    owner = router.shard_of(ids)
    for s in range(router.num_shards):
        m = owner == s
        if m.any():
            tid = router.shards[s].wq.store.col("task_id")
            pos = np.searchsorted(tid, ids[m])
            check(np.array_equal(tid[pos], ids[m]), f"shard {s} ids")
            yield s, pos


def _launching_shards(router) -> int:
    """wq_claim launches the router's next claim_all makes: one per live
    shard that claims on the device and holds rows at or past its scan
    start (a queue with none left to scan launches nothing)."""
    return sum(1 for sh in router.shards
               if sh.alive and sh.wq.device_claim
               and sh.wq.store.n_rows > sh.wq.scan_start())


def _count_claim_launches(router, box: dict) -> None:
    """Make every ``router.claim_all`` add the launches it makes to
    ``box["want"]`` first."""
    inner = router.claim_all

    def claim_all(*args, **kw):
        box["want"] += _launching_shards(router)
        return inner(*args, **kw)
    router.claim_all = claim_all


def phase_control_plane(device, *, tasks=100_000, workers_per_shard=234,
                        rounds=3, train_cfg=None, train_seq_len=2048,
                        ckpt_dir=None) -> dict:
    """The sharded, replicated store at the claim phase's scale, every
    shard claiming through the claim kernel on ``device``, against one
    ``CONTROL_PLANE_SHARDS * workers_per_shard``-worker primary claiming
    on the host (the oracle), then the sharded executor. Raises at the
    first check that fails:

    - claims: ``rounds`` claim_alls at k 1 and at k 4 (no stealing), each
      claim dict equal to the oracle's id for id; the claimed tasks finish
      on both with the same outputs and dyadic clocks;
    - replicas: one replica process per shard over a pipe, synced, its
      log truncated, synced again at a pinned version vector: its columns
      bit-identical to its shard's; the remote sweep (Q1-Q7 partials in
      the replica processes, merged here) equal to the oracle's;
    - failover: shard 0's primary dies with claims in flight; the promoted
      replica claims on ``device`` through the kernel (the router's
      ``device_claim``), has no RUNNING row, loses no task, and the next
      claims (k 1, k 4) equal the oracle's, which requeued the same claims;
    - sharded checkpoint: saved and restored at its version vector, the
      merged sweep equal;
    - rebalance: shard 1 claimed dry, refilled by ``rebalance`` from its
      siblings, the live task ids unchanged;
    - the launches of the claim kernel, counted exactly on a card: one
      per shard per claim_all of the drill (every shard is live and has
      rows left at each), one per claim_all that drains shard 1;
    - train (``train_cfg``): ``TrainExecutor`` with 2 shards of 2 workers,
      remote replicas for the sweeps, a checkpoint every 3 steps,
      ``SHARDED_TRAIN_STEPS`` steps of ``SHARDED_TRAIN_BATCH`` sequences,
      shard 1 failed and promoted once step 3 has run: every task
      FINISHED with a finite loss, the shards' out0 the history's losses,
      the flash and claim kernels' launches exact.
    """
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.core import ShardRouter
    on_card = torch.device(device).type == "cuda"
    t_phase = time.perf_counter()
    shards = CONTROL_PLANE_SHARDS
    W, L = shards * workers_per_shard, workers_per_shard
    ckpt_dir = ckpt_dir or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "build",
        "chip_smoke_control_plane")
    router = ShardRouter(shards, L, capacity=2 * tasks // shards + 1024,
                         replicate="remote", device=device,
                         device_claim=True)
    oracle = WorkQueue(num_workers=W, capacity=2 * tasks, device="cpu",
                       device_claim=False)
    steer = SteeringEngine(oracle)
    ids = np.arange(tasks, dtype=np.int64)
    for q in (router, oracle):
        check(np.array_equal(q.add_tasks(0, tasks, domain_in=_dom_in(ids),
                                         duration_est=1.0, now=0.0), ids),
              "task ids")
    wall_ms = {"device_sharded": [], "host_oracle": []}
    clock = [1.0]

    def claim_round(k, *, finish=True, skip=None):
        t0 = time.perf_counter()
        got = router.claim_all(k=k, now=clock[0], steal=False)
        wall_ms["device_sharded"].append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        want = oracle.claim_all(k=k, now=clock[0], steal=False)
        wall_ms["host_oracle"].append((time.perf_counter() - t0) * 1e3)
        got = {g: np.sort(router.shards[s].wq.store.col("task_id")[rows])
               for g, (s, rows) in got.items() if len(rows)}
        want = {g: np.sort(oracle.store.col("task_id")[rows])
                for g, rows in want.items() if len(rows)}
        check(got.keys() == want.keys(), f"claim dict keys (k={k})")
        check(all(np.array_equal(got[g], want[g]) for g in want),
              f"claim dicts differ from the oracle's (k={k})")
        claimed = np.sort(np.concatenate(list(want.values())))
        done = claimed if finish else claimed[(claimed % W) // L != 0]
        oracle.finish(done, now=clock[0] + 1.0, domain_out=_dom_out(done))
        for s, pos in _shard_rows(router, done):
            wq = router.shards[s].wq
            wq.finish(pos, now=clock[0] + 1.0,
                      domain_out=_dom_out(wq.store.col("task_id")[pos]))
        clock[0] += 2.0
        return claimed

    def oracle_sweep():
        view = oracle.store.snapshot_view()
        return ShardRouter.oracle_normalize(
            steer.run_all(clock[0], view=view), view)

    res = {"phase": CONTROL_PLANE, "device": str(device), "tasks": tasks,
           "shards": shards, "workers_per_shard": L, "workers": W,
           "rounds_per_k": rounds, "replicate": "remote"}
    if on_card:
        reset_launch_counts()
    claimed = 0
    for k in (1, 4):
        for _ in range(rounds):
            claimed += len(claim_round(k))
        if k == 1:      # replicas acked, then every shard truncates its log
            t0 = time.perf_counter()
            router.sync_replicas()
            res["replica_sync_ms"] = (time.perf_counter() - t0) * 1e3
            res["log_records_truncated"] = router.compact()
            check(res["log_records_truncated"] > 0
                  and all(sh.wq.log.base > 0 for sh in router.shards),
                  "no shard's log was truncated")
    res["tasks_claimed"] = claimed
    t0 = time.perf_counter()
    vec = router.sync_replicas()
    res["replica_sync_pinned_ms"] = (time.perf_counter() - t0) * 1e3
    views = router.snapshot_vector()
    check(tuple(vec) == tuple(v.version for v in views), "pinned vector")
    for sh, view in zip(router.shards, views):
        for m in sh.replicator.members:
            cols = m.fetch_remote_state()["snapshot"]["cols"]
            check(all(np.array_equal(cols[n], view.col(n), equal_nan=True)
                      for n in sh.wq.store.cols),
                  f"shard {sh.index}: replica columns differ")
            check(m.remote_pid != os.getpid(), "replica in this process")
    t0 = time.perf_counter()
    swept = router.remote_sweep(clock[0], versions=vec, sync=False)
    res["remote_sweep_ms"] = (time.perf_counter() - t0) * 1e3
    check(json.dumps(ShardRouter.comparable(swept), sort_keys=True,
                     default=str)
          == json.dumps(oracle_sweep(), sort_keys=True, default=str),
          "remote merged sweep differs from the oracle's")
    res["version_vector"] = [int(v) for v in vec]

    # failover: shard 0 dies with claims in flight; its replica is promoted
    finished = set(oracle.store.col("task_id")[
        oracle.store.col("status") == int(Status.FINISHED)].tolist())
    in_flight = claim_round(1, finish=False)
    stranded = in_flight[(in_flight % W) // L == 0]
    check(len(stranded) > 0, "no claim in flight on shard 0")
    router.fail_shard(0)
    t0 = time.perf_counter()
    wq0 = router.promote_shard(0)
    res["promote_s"] = time.perf_counter() - t0
    check(wq0.device_claim and str(wq0.device) == str(device),
          f"promoted queue claims on {wq0.device} "
          f"(device claims {wq0.device_claim})")
    check(not (wq0.store.col("status") == int(Status.RUNNING)).any(),
          "RUNNING rows on the promoted shard")
    tid, st = oracle.store.col("task_id"), oracle.store.col("status")
    rows = np.nonzero((st == int(Status.RUNNING)) & ((tid % W) // L == 0))[0]
    check(np.array_equal(np.sort(tid[rows]), np.sort(stranded)),
          "stranded claims")
    oracle.store.update(rows, status=int(Status.READY))
    oracle.invalidate_cursors(rows)
    check(np.array_equal(router.live_task_ids(), ids), "tasks lost")
    fin_now = np.concatenate([sh.wq.store.col("task_id")[
        sh.wq.store.col("status") == int(Status.FINISHED)]
        for sh in router.shards])
    check(finished <= set(fin_now.tolist()), "a committed finish was lost")
    for k in (1, 4):
        claimed_after = claim_round(k)
        check(((claimed_after % W) // L == 0).any(),
              "the promoted shard claims nothing")
    res["stranded_claims_requeued"] = int(len(stranded))

    # the sharded checkpoint, restored at its version vector
    ck = Checkpointer(ckpt_dir, keep=1, async_write=False)
    vec = [int(v) for v in router.version_vector()]
    before = json.dumps(ShardRouter.comparable(
        router.run_all(clock[0], views=router.snapshot_vector())),
        sort_keys=True, default=str)
    t0 = time.perf_counter()
    ck.save(1, {"step": torch.zeros((), dtype=torch.int64)}, router=router)
    res["checkpoint_save_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, _, restored = ck.restore({"step": torch.zeros((), dtype=torch.int64)},
                                router_kw={"device": device,
                                           "device_claim": True})
    res["checkpoint_restore_s"] = time.perf_counter() - t0
    check([int(v) for v in restored.version_vector()] == vec,
          "restored version vector")
    check(json.dumps(ShardRouter.comparable(restored.run_all(
        clock[0], views=restored.snapshot_vector())), sort_keys=True,
        default=str) == before, "restored merged sweep")
    restored.close()

    # rebalance: shard 1 claimed dry, then refilled from its siblings
    sh1 = router.shards[1]
    drain_calls = 0
    while int(sh1.wq.ready_counts().sum()):
        drain_calls += 1
        got = sh1.wq.claim_all(k=64, now=clock[0])
        sh1.wq.finish(np.concatenate([v for v in got.values() if len(v)]),
                      now=clock[0] + 1.0)
    live = router.live_task_ids()
    t0 = time.perf_counter()
    moved = router.rebalance(now=clock[0])
    res["rebalance_ms"] = (time.perf_counter() - t0) * 1e3
    check(moved > 0 and int(sh1.wq.ready_counts().sum()) > 0,
          "rebalance moved nothing into the drained shard")
    check(np.array_equal(router.live_task_ids(), live),
          "rebalance changed the live task ids")
    res["rebalanced_tasks"] = int(moved)
    router.check_invariants()
    router.close()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    counts = launch_counts()
    want = shards * len(wall_ms["device_sharded"]) + drain_calls
    if on_card:
        check(counts["wq_claim"] == want,
              f"wq_claim launches {counts['wq_claim']} != {want} "
              f"(control plane)")
    res["launches"] = {"wq_claim": counts["wq_claim"]}
    res["claim_all_wall_ms"] = wall_ms
    res["kernel_device_ms"] = claim_all_kernel_ms(
        tasks // shards, L, device) if on_card else None
    if train_cfg is not None:
        res["train"] = _sharded_train(train_cfg, device, seq_len=train_seq_len,
                                      ckpt_dir=ckpt_dir)
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return res


def _sharded_train(cfg, device, *, seq_len, ckpt_dir) -> dict:
    """The control-plane phase's train run (:func:`phase_control_plane`)."""
    from repro_torch.checkpoint import Checkpointer
    on_card = torch.device(device).type == "cuda"
    batch, steps = SHARDED_TRAIN_BATCH, SHARDED_TRAIN_STEPS
    ck = Checkpointer(ckpt_dir, keep=1)
    with device_claims(True):
        ex = TrainExecutor(cfg, num_workers=4, shards=2, analyst="remote",
                           steer_every=2, checkpointer=ck,
                           checkpoint_every=3,
                           data_cfg=DataConfig(vocab_size=cfg.vocab_size,
                                               seq_len=seq_len,
                                               batch_size=batch),
                           device=device)
    launches = {"want": 0}
    _count_claim_launches(ex.router, launches)
    ex.submit_steps(steps)
    sync(ex.device)
    reset_launch_counts()
    t0 = time.perf_counter()
    while ex.step < 3:
        ex.tick()
    ex.fail_shard(1)
    t1 = time.perf_counter()
    wq1 = ex.promote_shard(1)
    promote_s = time.perf_counter() - t1
    check(wq1.device_claim and str(wq1.device) == str(ex.device),
          "the promoted train shard does not claim on the device")
    hist = ex.run()
    sync(ex.device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    ck.wait()
    losses = [h["loss"] for h in hist]
    shards_ = ex.router.shards
    finished = sum(int(sh.wq.counts()["FINISHED"]) for sh in shards_)
    check(len(hist) == steps == finished and ex.router.tasks_left() == 0,
          f"sharded train finished {finished} of {steps}")
    check(bool(np.isfinite(losses).all()), f"losses {losses}")
    out0 = np.concatenate([sh.wq.store.col("out0")[
        sh.wq.store.col("status") == int(Status.FINISHED)] for sh in shards_])
    check(np.array_equal(np.sort(out0), np.sort(losses)),
          f"store out0 {out0} != history losses {losses}")
    check(ex.last_steering is not None
          and isinstance(ex.last_steering["version"], list),
          "no scatter-gather sweep ran")
    check(ck.latest_step() == steps, f"checkpoint {ck.latest_step()}")
    want = train_launches(cfg, steps, 0)
    want["wq_claim"] = launches["want"]
    if on_card:
        for k, n in counts.items():
            check(n == want.get(k, 0),
                  f"{k} launches {n} != {want.get(k, 0)} (sharded train)")
    ex.close()
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"arch": cfg.name, "layers": cfg.num_layers, "shards": 2,
            "workers": 4, "analyst": "remote", "seq_len": seq_len,
            "batch": batch, "steps": steps, "losses": losses,
            "failed_and_promoted_shard": 1, "promote_s": promote_s,
            "wall_s": wall, "launches": {k: counts[k] for k in want}}


# --------------------------------------------------------------- phase 4
_FLUSH = []


def flush_l2() -> None:
    """Read 256 MB, five times the H100's 50 MB L2, so that the next kernel
    reads its inputs from HBM. A read, not a write: a written buffer would
    leave 50 MB of dirty lines whose write-back lands on the next kernel."""
    if not _FLUSH:
        _FLUSH.append(torch.zeros(64 << 20, dtype=torch.float32,
                                  device="cuda"))
    _FLUSH[0].amax()


def time_ms(fn, iters: int, warmup: int = 3, cold: bool = False) -> float:
    """Mean milliseconds per call (CUDA events). By default over ``iters``
    back-to-back calls, inputs staying in L2 where they fit; ``cold``: each
    call after :func:`flush_l2`, timed by its own pair of events (the flush
    keeps the card busy while the host launches the call)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    if cold:
        pairs = []
        for _ in range(iters):
            flush_l2()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn()
            ev[1].record()
            pairs.append(ev)
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in pairs) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_kernels(prof) -> dict:
    """Device time (us) and record count of every CUDA kernel / memory op a
    profile holds, by name (empty when the profiler recorded no device
    activity)."""
    return {e.key: (e.self_device_time_total, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and e.self_device_time_total > 0}


def _profile(body, tries: int = 3) -> dict:
    """:func:`_device_kernels` of ``body`` under torch.profiler; a profile
    that came back without any device activity is taken again (up to
    ``tries`` times in all), as that happens now and then on the card."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            body()
            torch.cuda.synchronize()
        found = _device_kernels(prof)
        if found:
            break
    return found


def per_call_us(kernels: dict, calls: int) -> dict:
    """Device us per call of each kernel in :func:`_profile` of ``calls``
    calls: its mean record times the records one call makes. A profile
    taken after others in the same process can lack a few of a kernel's
    records (one of 20 after a profile of 40,000 kernels, about five of 20
    late in this script, on an H100), while the records it holds are
    whole; summing them read up to a quarter low. Each kernel runs the same
    number of times every call, and fewer than ``calls`` of its records
    are lost."""
    return {name: us / n * -(-n // calls)
            for name, (us, n) in kernels.items()}


def device_ms(fn, iters: int = 20, cold: bool = False):
    """Mean device time per call of the work ``fn`` puts on the card
    (torch.profiler, CUDA activity only): the kernels' own time, without
    the host's launch overhead that back-to-back event timing includes.
    ``cold``: each call after :func:`flush_l2`, whose own kernels (those of
    a flush profiled alone, and any reduction: the flush is an ``amax``)
    are left out of the sum. None when the profiler records no device
    activity."""
    fn()
    torch.cuda.synchronize()
    flush = set(_profile(flush_l2)) if cold else set()

    def body():
        for _ in range(iters):
            if cold:
                flush_l2()
            fn()

    # the median of three profiles
    totals = sorted(
        sum(us for name, us in per_call_us(_profile(body), iters).items()
            if not (cold and (name in flush or "reduce_kernel" in name)))
        for _ in range(3))
    return totals[1] / 1e3 if totals[1] else None


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
    # what a call puts on the card, by the profiler's records: the claim
    # kernel once, and no memset or copy
    calls = 20
    ops = _profile(lambda: [wq_claim_fwd(status, worker, num_workers=w, k=k)
                            for _ in range(calls)])
    row["device_ops_per_call"] = {name: n / calls
                                  for name, (_, n) in ops.items()}
    check(len(ops) == 1 and "claim_fused" in next(iter(ops)),
          f"wq_claim puts {sorted(ops)} on the card")
    # what one launch can reach: an empty kernel launched as this one is
    row["empty_launch_device_ms"] = device_ms(
        lambda: wq_claim_empty_launch(status, w))
    row["empty_launch_ms"] = time_ms(
        lambda: wq_claim_empty_launch(status, w), 100)
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


def flash_pairs(s: int, window: int = 0, skv: int = 0,
                causal: bool = True) -> int:
    """(query, key) pairs an attention of S queries over ``skv`` keys (S by
    default) computes: causal, query i sees keys up to i; windowed, the
    last ``window`` of those; neither, all of them."""
    skv = skv or s
    if not causal and not window:
        return s * skv
    if causal and skv == s and (not window or window >= s):
        return s * (s + 1) // 2
    i = np.arange(s)
    hi = np.minimum(i + 1, skv) if causal else np.full(s, skv)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def _sdpa_call(q, k, v, window, grad=False, causal=True):
    """SDPA of the same function on [B,H,S,dh] copies of q, k, v (causal
    unless ``causal`` is false, the window as a mask), the yardstick only;
    with ``grad`` the copies require grad."""
    s = q.shape[1]
    qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_(grad)
                  for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if not causal and not window:
        return functools.partial(sdpa, qt, kt, vt, enable_gqa=True), \
            (qt, kt, vt)
    if window and window < s:      # the same function: the window as a mask
        i = torch.arange(s, device=q.device)
        mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
        return functools.partial(sdpa, qt, kt, vt, attn_mask=mask,
                                 enable_gqa=True), (qt, kt, vt)
    return functools.partial(sdpa, qt, kt, vt, is_causal=True,
                             enable_gqa=True), (qt, kt, vt)


def _flash_case(dev, s, hq, hkv, dh, dtype, rng, window=0, arch=None, b=1,
                lse=False, skv=0, causal=True):
    """The forward against its plain version; with ``lse`` it also writes
    the row log-sum-exp (the train path's variant), held against
    :func:`flash_attention_lse_ref`. ``skv`` keys (S by default) and
    ``causal``: the encoder's and the cross-attention's shapes."""
    skv = skv or s
    q = torch.as_tensor(rng.standard_normal((b, s, hq, dh)),
                        dtype=torch.float32, device=dev).to(dtype)
    k, v = (torch.as_tensor(rng.standard_normal((b, skv, hkv, dh)),
                            dtype=torch.float32, device=dev).to(dtype)
            for _ in range(2))
    fa = functools.partial(flash_attention_fwd, q, k, v, causal=causal,
                           window=window, return_lse=lse)
    got = fa()
    ref = flash_attention_ref(q, k, v, causal=causal, window=window)
    err = _attn_error(got[0] if lse else got, ref,
                      f"flash {dtype} S={s} Skv={skv} causal={causal} "
                      f"window={window}")
    if lse:
        want = flash_attention_lse_ref(q, k, causal=causal, window=window)
        err["lse_max_abs_err"] = float((got[1] - want).abs().max())
        err["lse_tol"] = LSE_TOL
        check(err["lse_max_abs_err"] <= LSE_TOL,
              f"flash lse {dtype} S={s}: {err['lse_max_abs_err']}")
    del ref
    lib, _ = _sdpa_call(q, k, v, window, causal=causal)
    row = {"kernel": "flash_attention", "arch": arch,
           "shape_q": list(q.shape), "shape_kv": list(k.shape),
           "causal": causal, "window": window, "dtype": str(dtype)[6:],
           "lse": lse, **err,
           "ms": time_ms(fa, 50),
           "plain_ms": time_ms(lambda: flash_attention_ref(
               q, k, v, causal=causal, window=window), 10 if b == 1 else 3),
           "library_ms": time_ms(lib, 50)}
    row["device_ms"] = device_ms(fa)
    row["library_device_ms"] = device_ms(lib)
    row.update(flash_bound(s, hq, hkv, dh, dtype, window, b=b, skv=skv,
                           causal=causal))
    if lse:    # the lse written once: 4 bytes a row
        row.update(_bound(row["bytes"] + 4.0 * b * hq * s, row["ops"],
                          "tf32" if dtype == torch.float32 else dtype))
    return row


def flash_bound(s, hq, hkv, dh, dtype, window=0, b=1, skv=0,
                causal=True) -> dict:
    """Bound of a flash attention of S queries over ``skv`` keys (S by
    default; batch b): 4 dh Hq operations per visible (query, key) pair
    (:func:`flash_pairs`); q, k, v read and o written once. fp32 runs on
    the kernel's route, three TF32 products per product at the tensor
    cores' TF32 rate, with the bound of the same work on fp32 FMAs beside
    it (``bound_before_ms``, what earlier readings were held against); bf16
    at its tensor rate."""
    skv = skv or s
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * 2 * b * dh * (s * hq + skv * hkv)
    ops = 4.0 * b * flash_pairs(s, window, skv, causal) * dh * hq
    if dtype != torch.float32:
        return _bound(nbytes, ops, dtype)
    return {**_bound(nbytes, 3.0 * ops, "tf32"), "useful_ops": ops,
            "bound_before_ms": _bound(nbytes, ops, dtype)["bound_ms"]}


def flash_bwd_bound(b, s, hq, hkv, dh, dtype, window=0, skv=0,
                    causal=True) -> dict:
    """Bound of the attention backward (the function, not the kernel's
    recompute): 10 dh Hq operations per visible (query, key) pair and batch
    row (S = Q K^T, dP = dO V^T, dV, dK, dQ), against q, k, v, o and dO read
    and dq, dk, dv written once. fp32 runs on the kernel's route, three
    TF32 products per product at the tensor cores' TF32 rate, with the
    bound of the same work on fp32 FMAs beside it (``bound_before_ms``,
    what earlier readings were held against); bf16 at its tensor rate.
    ``skv`` keys (S by default) and ``causal`` as :func:`flash_bound`."""
    skv = skv or s
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * b * dh * 4 * (s * hq + skv * hkv)
    ops = 10.0 * b * flash_pairs(s, window, skv, causal) * dh * hq
    if dtype != torch.float32:
        return _bound(nbytes, ops, dtype)
    return {**_bound(nbytes, 3.0 * ops, "tf32"), "useful_ops": ops,
            "bound_before_ms": _bound(nbytes, ops, dtype)["bound_ms"]}


def _grad_error(got, ref, what: str) -> dict:
    """A backward output's max error against the plain backward, and its
    largest ratio to the per-element limit; raises past the limit."""
    tol = BWD_REL_TOL * max(1.0, float(ref.float().abs().max()))
    if ref.dtype == torch.bfloat16:
        tol = tol + BF16_STEP * ref.float().abs()
    diff = (got.float() - ref.float()).abs()
    ratio = float((diff / tol).max())
    check(got.dtype == ref.dtype and got.shape == ref.shape and ratio <= 1.0,
          f"{what}: max error {float(diff.max())}, {ratio} of its limit")
    return {"max_abs_err": float(diff.max()), "err_over_tol": ratio}


def _flash_bwd_case(dev, b, s, hq, hkv, dh, dtype, rng, window=0, arch=None,
                    skv=0, causal=True):
    """The backward kernels against the plain backward on the forward
    kernel's own output and lse: dq, dk and dv each within its limit, a
    repeat bit-identical; timed beside SDPA's backward of the same function
    (its graph kept, the backward alone timed). ``skv`` keys (S by default)
    and ``causal``: the cross-attention's training shape."""
    skv = skv or s
    q, do = (torch.as_tensor(rng.standard_normal((b, s, hq, dh)),
                             dtype=torch.float32, device=dev).to(dtype)
             for _ in range(2))
    k, v = (torch.as_tensor(rng.standard_normal((b, skv, hkv, dh)),
                            dtype=torch.float32, device=dev).to(dtype)
            for _ in range(2))
    o, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                 return_lse=True)
    fn = functools.partial(flash_attention_bwd, q, k, v, o, lse, do,
                           causal=causal, window=window)
    got = fn()
    ref = flash_attention_bwd_ref(q, k, v, o, lse, do, causal=causal,
                                  window=window)
    what = f"flash bwd {dtype} {b}x{s}x{skv} {hq}/{hkv}x{dh} " \
        f"causal={causal} window={window}"
    errs = {name: _grad_error(g, r, f"{what} {name}")
            for name, g, r in zip(("dq", "dk", "dv"), got, ref)}
    check(all(torch.equal(a, c) for a, c in zip(got, fn())),
          f"{what}: a repeat differs")
    del ref
    lib, inputs = _sdpa_call(q, k, v, window, grad=True, causal=causal)
    with torch.enable_grad():
        out = lib()
    dot = do.transpose(1, 2).contiguous()

    def lib_bwd():
        return torch.autograd.grad(out, inputs, dot, retain_graph=True)

    row = {"kernel": "flash_attention_bwd", "arch": arch,
           "shape_q": list(q.shape), "shape_kv": list(k.shape),
           "causal": causal, "window": window, "dtype": str(dtype)[6:],
           "errors": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "err_over_tol": max(e["err_over_tol"] for e in errs.values()),
           "tol": f"{BWD_REL_TOL} * max|ref|" + (
               " + 2**-7 * |ref|" if dtype == torch.bfloat16 else ""),
           "ms": time_ms(fn, 10),
           "plain_ms": time_ms(lambda: flash_attention_bwd_ref(
               q, k, v, o, lse, do, causal=causal, window=window), 3),
           "library_ms": time_ms(lib_bwd, 10)}
    row["device_ms"] = device_ms(fn, iters=5)
    row["device_ms_by_kernel"] = {
        name[:40]: us / 1e3 for name, us in per_call_us(
            _profile(lambda: [fn() for _ in range(5)]), 5).items()}
    row["library_device_ms"] = device_ms(lib_bwd, iters=5)
    row.update(flash_bwd_bound(b, s, hq, hkv, dh, dtype, window, skv=skv,
                               causal=causal))
    del out, inputs
    return row


def _decode_case(dev, smax, hq, hkv, dh, kv_len, dtype, rng, window=0,
                 arch=None):
    q = torch.as_tensor(rng.standard_normal((1, 1, hq, dh)),
                        dtype=torch.float32, device=dev).to(dtype)
    k, v = (torch.as_tensor(rng.standard_normal((1, smax, hkv, dh)),
                            dtype=torch.float32, device=dev).to(dtype)
            for _ in range(2))
    kvl = torch.full((1,), kv_len, dtype=torch.int32, device=dev)
    dec = functools.partial(decode_attention_fwd, q, k, v, kvl, window)
    got = dec()
    ref = decode_attention_ref(q, k, v, kvl, window)
    err = _attn_error(got, ref, f"decode {dtype} kv_len={kv_len} "
                      f"window={window}")
    lo = max(0, kv_len - window) if window else 0      # first visible key
    qt = q.transpose(1, 2).contiguous()
    kt, vt = (t[:, lo:kv_len].transpose(1, 2).contiguous() for t in (k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    row = {"kernel": "decode_attention", "arch": arch,
           "shape_q": list(q.shape), "shape_cache": list(k.shape),
           "kv_len": kv_len, "window": window, "dtype": str(dtype)[6:],
           **err, "ms": time_ms(dec, 200),
           "plain_ms": time_ms(lambda: decode_attention_ref(q, k, v, kvl,
                                                            window), 50),
           "library_ms": time_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True),
                                 200),
           "timing": "ms, device_ms, library_device_ms: back to back, warm "
                     "in L2; *_cold: L2 flushed before each call"}
    lib = functools.partial(sdpa, qt, kt, vt, enable_gqa=True)
    row["ms_cold"] = time_ms(dec, 100, cold=True)
    row["device_ms"] = device_ms(dec)
    row["device_ms_cold"] = device_ms(dec, cold=True)
    row["library_device_ms"] = device_ms(lib)
    row["library_device_ms_cold"] = device_ms(lib, cold=True)
    # the visible K and V read once, q read and out written once
    live = kv_len - lo
    nbytes = q.element_size() * (2 * live * hkv * dh + 2 * q.numel()) + 4
    row.update(_bound(nbytes, 4.0 * live * hq * dh, dtype))
    return row


def ssd_inputs(rng, bh, s, p, n, heads_per_bc, *, slow=False,
               dtype=torch.float32, device="cpu"):
    """Inputs of the SSD scan, made with numpy: x ~ N(0, 1), B and C ~
    N(0, 0.5^2) with one row per ``heads_per_bc`` heads. The serve path's
    regime: dt = softplus(N(0, 1)) and a = -linspace(1, 16) over the heads
    (the model's A_log init), so da runs from -0.3 to -30 a step and the
    in-chunk cumsum reaches thousands. The slow-decay case: dt ~ 0.01 and
    |a| <= 1, so the state carried across chunk boundaries dominates y."""
    rows = bh // heads_per_bc
    x = rng.standard_normal((bh, s, p))
    bmat = rng.standard_normal((rows, s, n)) * 0.5
    cmat = rng.standard_normal((rows, s, n)) * 0.5
    if slow:
        dt = 0.01 * np.exp(0.1 * rng.standard_normal((bh, s)))
        a = -rng.uniform(0.1, 1.0, (bh, 1))
    else:
        dt = np.log1p(np.exp(rng.standard_normal((bh, s))))
        a = -np.resize(np.linspace(1.0, 16.0, heads_per_bc), bh)[:, None]
    return [torch.as_tensor(v, dtype=torch.float32, device=device).to(dtype)
            for v in (x, bmat, cmat, dt, dt * a)]


def ssd_error(got, ref) -> dict:
    """The SSD scan's error against its plain version: y and the final
    state, each as its largest ratio to the per-element limit
    (``SSD_REL_TOL`` of the largest |ref|, plus one bf16 step of the value
    for a bf16 y)."""
    (y, st), (ry, rst) = got, ref
    out = {}
    for name, g, r in (("y_err", y, ry), ("state_err", st, rst)):
        tol = SSD_REL_TOL * float(r.float().abs().max())
        if r.dtype == torch.bfloat16:
            tol = tol + BF16_STEP * r.float().abs()
        diff = (g.float() - r.float()).abs()
        out[name] = {"max_abs_err": float(diff.max()),
                     "rel_err": float(diff.max() / r.float().abs().max()),
                     "err_over_tol": float((diff / tol).max())}
    out["err_over_tol"] = max(out["y_err"]["err_over_tol"],
                              out["state_err"]["err_over_tol"])
    out["max_abs_err"] = out["y_err"]["max_abs_err"]
    return out


def ssd_ops_bytes(bh, s, p, n, chunk, heads_per_bc, dtype):
    """Operations and bytes the SSD scan needs on these shapes: per chunk
    the lower triangle of C.B^T (once per B/C row), its product with dt x,
    C.S^T from the second chunk on, and the state update; each input read
    and each output written once."""
    rows, pairs, carry, upd = bh // heads_per_bc, 0, 0, 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs += q * (q + 1) // 2
        carry += q if c0 else 0
        upd += q
    ops = 2.0 * (rows * pairs * n + bh * pairs * p + bh * (carry + upd) * n * p)
    elt = torch.tensor([], dtype=dtype).element_size()
    nbytes = elt * (2 * bh * s * p + 2 * rows * s * n + 2 * bh * s) \
        + 4 * bh * p * n
    return ops, nbytes


def _ssd_case(dev, case, b, h, s, p, n, chunk, dtype, slow, rng):
    args = ssd_inputs(rng, b * h, s, p, n, h, slow=slow, dtype=dtype,
                      device=dev)
    kw = {"heads_per_bc": h}
    got = ssd_scan_fwd(*args, chunk=chunk, **kw)
    ref = ssd_scan_ref(*args, **kw)
    err = ssd_error(got, ref)
    check(got[0].dtype == dtype and err["err_over_tol"] <= 1.0,
          f"ssd_scan {case}: {err}")
    row = {"kernel": "ssd_scan", "case": case, "batch": b, "heads": h,
           "seq": s, "head_dim": p, "state_dim": n, "chunk": chunk,
           "dtype": str(dtype)[6:], **err, "tol": f"{SSD_REL_TOL} * max|ref|"
           + (" + 2**-7 * |ref|" if dtype == torch.bfloat16 else ""),
           "ms": time_ms(lambda: ssd_scan_fwd(*args, chunk=chunk, **kw), 20),
           "timing": "ms, device_ms: back to back, warm in L2; *_cold: L2 "
                     "flushed before each call",
           "plain_ms": time_ms(lambda: ssd_scan_ref(*args, **kw), 2, 1),
           "library_ms": None}
    scan = functools.partial(ssd_scan_fwd, *args, chunk=chunk, **kw)
    row["ms_cold"] = time_ms(scan, 20, cold=True)
    row["device_ms"] = device_ms(scan)
    row["device_ms_cold"] = device_ms(scan, cold=True)
    ops, nbytes = ssd_ops_bytes(b * h, s, p, n, chunk, h, dtype)
    # the kernel's route: every product as three TF32 products on the tensor
    # cores; the bound of the same work on fp32 FMAs (bf16: on its tensor
    # cores), as earlier readings were held against, beside it
    row["bound_before_ms"] = _bound(nbytes, ops, dtype)["bound_ms"]
    row.update(_bound(nbytes, 3.0 * ops, "tf32"))
    row["useful_ops"] = ops
    return row


def rglru_inputs(rng, b, s, c, *, slow=False, dtype=torch.float32,
                 device="cpu"):
    """Inputs of the RG-LRU scan as the model makes them, with numpy: a =
    base**r with base over linspace(0.9, 0.999) across the channels (the
    Lambda init) and r = sigmoid(N(0, 1)); u = sqrt(1 - a^2) i x with i =
    sigmoid(N(0, 1)), x ~ N(0, 1). The slow-decay case: a = 1 - 1e-3 *
    exp(0.1 N(0, 1)), about 0.999, so h remembers ~1000 steps and the part
    carried across the kernel's time chunks dominates it."""
    shape = (b, s, c)
    if slow:
        a = 1.0 - 1e-3 * np.exp(0.1 * rng.standard_normal(shape))
    else:
        r = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
        a = np.linspace(0.9, 0.999, c) ** r
    gate = 1.0 / (1.0 + np.exp(-rng.standard_normal(shape)))
    u = np.sqrt(1.0 - a * a) * gate * rng.standard_normal(shape)
    return [torch.as_tensor(v, dtype=torch.float32, device=device).to(dtype)
            for v in (a, u)]


def rglru_error(got, ref) -> dict:
    """The RG-LRU scan's error against its plain version, and its largest
    ratio to the per-element limit (``RGLRU_REL_TOL`` of the largest |ref|,
    plus one bf16 step of the value for a bf16 h)."""
    tol = RGLRU_REL_TOL * float(ref.float().abs().max())
    if ref.dtype == torch.bfloat16:
        tol = tol + BF16_STEP * ref.float().abs()
    diff = (got.float() - ref.float()).abs()
    return {"max_abs_err": float(diff.max()),
            "rel_err": float(diff.max() / ref.float().abs().max()),
            "err_over_tol": float((diff / tol).max())}


def rglru_ops_bytes(b, s, c, dtype):
    """One FMA (2 operations) per element; a and u read and h written
    once."""
    n = b * s * c
    elt = torch.tensor([], dtype=dtype).element_size()
    return 2.0 * n, 3.0 * elt * n


def _rglru_case(dev, case, b, s, c, dtype, slow, rng):
    a, u = rglru_inputs(rng, b, s, c, slow=slow, dtype=dtype, device=dev)
    got = rglru_scan_fwd(a, u)
    ref = rglru_scan_ref(a, u)
    err = rglru_error(got, ref)
    check(got.dtype == dtype and err["err_over_tol"] <= 1.0,
          f"rglru_scan {case}: {err}")
    row = {"kernel": "rglru_scan", "case": case, "batch": b, "seq": s,
           "channels": c, "dtype": str(dtype)[6:], **err,
           "tol": f"{RGLRU_REL_TOL} * max|ref|"
           + (" + 2**-7 * |ref|" if dtype == torch.bfloat16 else ""),
           "timing": "ms, device_ms: L2 flushed before each call; "
                     "*_warm: back to back, inputs in L2 where they fit",
           "ms": time_ms(lambda: rglru_scan_fwd(a, u), 100, cold=True),
           "ms_warm": time_ms(lambda: rglru_scan_fwd(a, u), 100),
           "plain_ms": time_ms(lambda: rglru_scan_ref(a, u), 3, 1),
           "library_ms": None}
    row["device_ms"] = device_ms(lambda: rglru_scan_fwd(a, u), cold=True)
    row["device_ms_warm"] = device_ms(lambda: rglru_scan_fwd(a, u))
    ops, nbytes = rglru_ops_bytes(b, s, c, dtype)
    row.update(_bound(nbytes, ops, dtype))
    return row


def ssd_bwd_ops_bytes(bh, s, p, n, chunk, heads_per_bc):
    """Operations and bytes the SSD scan's backward needs on these shapes,
    in the chunked form its kernel computes (the source note of
    csrc/ssd_scan_bwd.cu): per chunk and B/C row the scores C.B^T and the
    products W B and W^T C on the lower triangle; per chunk and head the
    lower-triangle products M^T dy and dy x^T and five [Q, P] x [P, N]
    products (the state entering the chunk, the chunk's dH term, dH B, and
    the state terms of dC and dB). x, B, C, dt, da and dy read and the five
    gradients written once, fp32."""
    rows, pairs, steps = bh // heads_per_bc, 0, 0
    for c0 in range(0, s, chunk):
        q = min(chunk, s - c0)
        pairs += q * (q + 1) // 2
        steps += q
    ops = 2.0 * (3 * rows * pairs * n + bh * (2 * pairs * p + 5 * steps * p
                                              * n))
    nbytes = 4 * (3 * bh * s * p + 4 * rows * s * n + 4 * bh * s)
    return ops, nbytes


def ssd_bwd_against_plain(args, dy, dst, got, h, ref_fn=None):
    """The SSD scan's backward outputs ``got`` (dx, dB, dC, ddt, dda) held
    against the plain backward ``ref_fn`` one batch row at a time: the
    ``h`` heads of a row and their B/C row are independent of the other
    rows', so this is the whole comparison, within the memory of a plain
    version that keeps every state (4.3 GB a row of mamba2's train shape,
    34 GB at its batch 8). Returns the errors by output (max |got - ref|,
    and its ratio to ``SSD_REL_TOL`` of the largest |ref| over all rows)
    and the plain version's ms, its rows' CUDA-event times summed."""
    ref_fn = ref_fn or ssd_scan_bwd_ref
    x, bmat, cmat, dt, da = args
    names = ("dx", "dB", "dC", "ddt", "dda")
    diff, top, ms = dict.fromkeys(names, 0.0), dict.fromkeys(names, 0.0), 0.0
    for r in range(bmat.shape[0]):
        hs, bs = slice(r * h, (r + 1) * h), slice(r, r + 1)
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        ref = ref_fn(x[hs], bmat[bs], cmat[bs], dt[hs], da[hs], dy[hs],
                     None if dst is None else dst[hs], heads_per_bc=h)
        ev[1].record()
        torch.cuda.synchronize()
        ms += ev[0].elapsed_time(ev[1])
        for name, g, want, sl in zip(names, got, ref, (hs, bs, bs, hs, hs)):
            diff[name] = max(diff[name], float((g[sl] - want).abs().max()))
            top[name] = max(top[name], float(want.abs().max()))
        del ref
    errs = {name: {"max_abs_err": diff[name],
                   "err_over_tol": diff[name] / (SSD_REL_TOL * top[name])}
            for name in names}
    return errs, ms


def _ssd_bwd_case(dev, case, b, h, s, p, n, chunk, slow, rng, *,
                  state=False):
    """The SSD scan's backward kernel on the forward kernel's own y and
    work buffer: each of dx, dB, dC, ddt and dda held against the plain
    backward (``SSD_REL_TOL`` of its largest element, by batch row:
    :func:`ssd_bwd_against_plain`) and a repeat bit-identical; timed, with
    its device time by kernel, against the bound of
    :func:`ssd_bwd_ops_bytes` on the kernel's route (3xTF32)."""
    args = ssd_inputs(rng, b * h, s, p, n, h, slow=slow, device=dev)
    dy = torch.as_tensor(rng.standard_normal((b * h, s, p)),
                         dtype=torch.float32, device=dev)
    dst = torch.as_tensor(rng.standard_normal((b * h, p, n)),
                          dtype=torch.float32, device=dev) if state else None
    y, _, work = ssd_scan_fwd(*args, chunk=chunk, heads_per_bc=h,
                              return_work=True)
    fn = functools.partial(ssd_scan_bwd, *args, y, work, dy, dst,
                           chunk=chunk, heads_per_bc=h)
    got = fn()
    errs, plain_ms = ssd_bwd_against_plain(args, dy, dst, got, h)
    for name, e in errs.items():
        check(e["err_over_tol"] <= 1.0, f"ssd_scan_bwd {case} {name}: {e}")
    check(all(torch.equal(a, c) for a, c in zip(got, fn())),
          f"ssd_scan_bwd {case}: a repeat differs")
    del got
    row = {"kernel": "ssd_scan_bwd", "case": case, "batch": b, "heads": h,
           "seq": s, "head_dim": p, "state_dim": n, "chunk": chunk,
           "dtype": "float32", "final_state_grad": state, "errors": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "err_over_tol": max(e["err_over_tol"] for e in errs.values()),
           "tol": f"{SSD_REL_TOL} * max|ref|", "plain_ms": plain_ms,
           "plain": "one batch row a call, rows summed", "library_ms": None}
    row["ms"] = time_ms(fn, 10)
    row["device_ms"] = device_ms(fn, iters=5)
    row["device_ms_by_kernel"] = {
        name[:40]: us / 1e3 for name, us in per_call_us(
            _profile(lambda: [fn() for _ in range(5)]), 5).items()}
    ops, nbytes = ssd_bwd_ops_bytes(b * h, s, p, n, chunk, h)
    row["bound_before_ms"] = _bound(nbytes, ops, torch.float32)["bound_ms"]
    row.update(_bound(nbytes, 3.0 * ops, "tf32"))
    row["useful_ops"] = ops
    return row


def rglru_bwd_ops_bytes(b, s, c):
    """An FMA and a multiply (3 operations) per element; a, h and g read,
    da and du written once, fp32."""
    n = b * s * c
    return 3.0 * n, 5.0 * 4 * n


def _rglru_bwd_case(dev, case, b, s, c, slow, rng):
    """The RG-LRU scan's backward kernel against the plain backward (da and
    du each within ``RGLRU_REL_TOL`` of its largest element, a repeat
    bit-identical), on the forward kernel's own h; timed with L2 flushed
    before each call and back to back, as the forward."""
    a, u = rglru_inputs(rng, b, s, c, slow=slow, device=dev)
    g = torch.as_tensor(rng.standard_normal((b, s, c)), dtype=torch.float32,
                        device=dev)
    h = rglru_scan_fwd(a, u)
    fn = functools.partial(rglru_scan_bwd, a, h, g)
    got = fn()
    ref = rglru_scan_bwd_ref(a, h, g)
    errs = {name: rglru_error(x, r) for name, x, r in zip(("da", "du"), got,
                                                            ref)}
    for name, e in errs.items():
        check(e["err_over_tol"] <= 1.0, f"rglru_scan_bwd {case} {name}: {e}")
    check(all(torch.equal(x, y) for x, y in zip(got, fn())),
          f"rglru_scan_bwd {case}: a repeat differs")
    row = {"kernel": "rglru_scan_bwd", "case": case, "batch": b, "seq": s,
           "channels": c, "dtype": "float32", "errors": errs,
           "max_abs_err": max(e["max_abs_err"] for e in errs.values()),
           "err_over_tol": max(e["err_over_tol"] for e in errs.values()),
           "tol": f"{RGLRU_REL_TOL} * max|ref|",
           "timing": "ms, device_ms: L2 flushed before each call; "
                     "*_warm: back to back",
           "ms": time_ms(fn, 50, cold=True), "ms_warm": time_ms(fn, 50),
           "plain_ms": time_ms(lambda: rglru_scan_bwd_ref(a, h, g), 1, 0),
           "library_ms": None}
    row["device_ms"] = device_ms(fn, cold=True)
    row["device_ms_warm"] = device_ms(fn)
    ops, nbytes = rglru_bwd_ops_bytes(b, s, c)
    row.update(_bound(nbytes, ops, torch.float32))
    return row


def _earlier_rows(dev, rng, cfg, scfg, hcfg) -> list:
    """The rows of the dense, SSM and hybrid paths (``phase_kernels``)."""
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    rows = []
    for n in (100_000, 1 << 18):
        for w in (64, 936):
            for k in (1, 4):
                rows.append(_claim_case(dev, n, w, k, rng))
    for dtype in (torch.float32, torch.bfloat16):
        rows.append(_flash_case(dev, 1000, hq, hkv, dh, dtype, rng,
                                arch=cfg.name))
    # the train path (qwen2-0.5b, bf16, batch 8 x 2048): the forward with
    # its lse, the backward, and the backward at a ragged S in fp32, at
    # glm4-9b's heads (32/2 of 128) and windowed; the claim kernel at the
    # train run's queue (6 tasks, 2 workers)
    train = f"{cfg.name} train"
    rows.append(_flash_case(dev, 2048, hq, hkv, dh, torch.bfloat16, rng,
                            arch=train, b=8, lse=True))
    for b, s, bhq, bhkv, bdh, dtype, win in (
            (8, 2048, hq, hkv, dh, torch.bfloat16, 0),
            (1, 1031, hq, hkv, dh, torch.float32, 0),
            (1, 1024, 32, 2, 128, torch.bfloat16, 0),
            (1, 2048, hq, hkv, dh, torch.float32, 700)):
        rows.append(_flash_bwd_case(dev, b, s, bhq, bhkv, bdh, dtype, rng,
                                    window=win, arch=train if b == 8
                                    else None))
    rows.append({**_claim_case(dev, 6, 2, 1, rng), "arch": train})
    for kv_len in (1, 1000, 1031, 4096):
        rows.append(_decode_case(dev, 4096, hq, hkv, dh, kv_len,
                                 torch.bfloat16, rng, arch=cfg.name))
    # the same ragged length in fp32, held to the fp32 limit
    rows.append(_decode_case(dev, 4096, hq, hkv, dh, 1031, torch.float32,
                             rng, arch=cfg.name))
    # recurrentgemma-9b: fp32 prefill at dh 256, 16 query heads over 1 KV
    # head, window 2048 (not biting at S 1000, biting at S 4096); bf16
    # decode against the ring of 2048 slots, and a linear cache windowed
    hhq, hhkv, hdh = hcfg.num_heads, hcfg.num_kv_heads, \
        hcfg.resolved_head_dim
    win = hcfg.rglru.window
    for s in (1000, 4096):
        rows.append(_flash_case(dev, s, hhq, hhkv, hdh, torch.float32, rng,
                                window=win, arch=hcfg.name))
    for kv_len in (1001, win):
        rows.append(_decode_case(dev, win, hhq, hhkv, hdh, kv_len,
                                 torch.bfloat16, rng, arch=hcfg.name))
    rows.append(_decode_case(dev, 4096, hhq, hhkv, hdh, 3000, torch.bfloat16,
                             rng, window=win, arch=hcfg.name))
    ss = scfg.ssm
    nh, p, n = scfg.num_heads, ss.head_dim, ss.state_dim
    for case, s, dtype, slow in (("main", 1000, torch.float32, False),
                                 ("ragged", 1031, torch.float32, False),
                                 ("bf16", 1000, torch.bfloat16, False),
                                 ("slow_decay", 4096, torch.float32, True)):
        rows.append(_ssd_case(dev, case, 1, nh, s, p, n, ss.chunk, dtype,
                              slow, rng))
    lw = hcfg.rglru.lru_width or hcfg.d_model
    for case, s, dtype, slow in (("main", 1000, torch.float32, False),
                                 ("ragged", 1031, torch.float32, False),
                                 ("bf16", 1000, torch.bfloat16, False),
                                 ("slow_decay", 4096, torch.float32, True)):
        rows.append(_rglru_case(dev, case, 1, s, lw, dtype, slow, rng))
    # the SSM and hybrid train paths: mamba2-1.3b's SSD scan at its train
    # shape (batch 8 x 2048, 64 heads over one B/C row, fp32) forward and
    # backward, the backward held against its plain version one batch row
    # at a time, and at batch 1 at a ragged S and in slow decay with a
    # final-state gradient; the RG-LRU
    # scan at recurrentgemma-9b's microbatch [1, 4096, 4096] fp32, forward
    # and backward, the backward also ragged and in slow decay; flash at its
    # heads of 256, S 4096, window 2048: the forward with its LSE and the
    # backward in bf16, and both at a ragged S in fp32
    s_train, h_train = f"{scfg.name} train", f"{hcfg.name} train"
    rows.append(_ssd_case(dev, "train", 8, nh, 2048, p, n, ss.chunk,
                          torch.float32, False, rng))
    rows.append(_ssd_bwd_case(dev, "train", 8, nh, 2048, p, n, ss.chunk,
                              False, rng))
    for case, s, slow, state in (("ragged", 1031, False, True),
                                 ("slow_decay", 2048, True, True)):
        rows.append(_ssd_bwd_case(dev, case, 1, nh, s, p, n, ss.chunk, slow,
                                  rng, state=state))
    rows.append(_rglru_case(dev, "train", 1, 4096, lw, torch.float32, False,
                            rng))
    for case, s, slow in (("train", 4096, False), ("ragged", 1031, False),
                          ("slow_decay", 4096, True)):
        rows.append(_rglru_bwd_case(dev, case, 1, s, lw, slow, rng))
    rows.append(_flash_case(dev, 4096, hhq, hhkv, hdh, torch.bfloat16, rng,
                            window=win, arch=h_train, lse=True))
    rows.append(_flash_bwd_case(dev, 1, 4096, hhq, hhkv, hdh, torch.bfloat16,
                                rng, window=win, arch=h_train))
    rows.append(_flash_case(dev, 1031, hhq, hhkv, hdh, torch.float32, rng,
                            window=win, lse=True))
    rows.append(_flash_bwd_case(dev, 1, 1031, hhq, hhkv, hdh, torch.float32,
                                rng, window=win))
    return rows


def _control_plane_rows(dev, rng, cfg) -> list:
    """The control-plane phase's shapes: the claim kernel at one shard's
    queue (N 25,000, W 234) and at the sharded train run's (a shard's 4
    tasks, 2 workers), and flash forward with LSE and backward at that
    run's batch of 2 x 2048."""
    hq, hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    return [{**_claim_case(dev, 25_000, 234, 1, rng), "arch": CONTROL_PLANE},
            {**_claim_case(dev, 4, 2, 1, rng), "arch": SHARDED_TRAIN},
            _flash_case(dev, 2048, hq, hkv, dh, torch.bfloat16, rng,
                        arch=SHARDED_TRAIN, b=2, lse=True),
            _flash_bwd_case(dev, 2, 2048, hq, hkv, dh, torch.bfloat16, rng,
                            arch=SHARDED_TRAIN)]


def phase_kernels(cfg, scfg, hcfg, fams, device, launches: dict) -> dict:
    """Every kernel against its plain version at the main path's shapes
    (``cfg`` the dense model, ``scfg`` the SSM model, ``hcfg`` the hybrid,
    ``fams`` the MoE, VLM and enc-dec models; ``launches`` by arch, the
    claim phase's under None, the train run's under "<arch> train"); each
    row printed, then the ``{"kernels": [...]}`` record
    (:func:`kernels_line`)."""
    dev = torch.device(device)
    rng = np.random.default_rng(0)
    rows = _earlier_rows(dev, rng, cfg, scfg, hcfg)
    rows += _control_plane_rows(dev, rng, cfg)
    extra = _family_rows(dev, rng, fams)
    for r in rows + [r for r, _, _ in extra]:
        emit(r)
    return kernels_line(cfg, scfg, hcfg, fams, rows, extra, launches)


def kernels_line(cfg, scfg, hcfg, fams, rows, extra, launches) -> dict:
    """The ``{"kernels": [...]}`` record of the kernel phase's ``rows`` (the
    dense, SSM and hybrid paths') and ``extra`` (:func:`_family_rows`): one
    entry per kernel, model and shape it gives the kernel there, with the
    time and bound of that shape and its launches: the run's count of the
    kernel, times the share of them that run at this shape where the run
    gives it several (the shares of one kernel and run sum to 1)."""
    train = f"{cfg.name} train"
    s_train, h_train = f"{scfg.name} train", f"{hcfg.name} train"
    one = fractions.Fraction(1)
    main_shape = [  # (kernel, arch, the row of the shape it sees there)
        ("wq_claim", None, lambda r: r["n"] == 100_000
         and r["workers"] == 936 and r["k"] == 1),
        ("wq_claim", train, lambda r: r.get("arch") == train),
        ("flash_attention", train, lambda r: r["arch"] == train),
        ("flash_attention_bwd", train, lambda r: r["arch"] == train),
        ("flash_attention", cfg.name, lambda r: r["arch"] == cfg.name
         and r["dtype"] == "float32"),
        ("flash_attention", hcfg.name, lambda r: r["arch"] == hcfg.name
         and r["shape_q"][1] == 1000),
        ("decode_attention", cfg.name, lambda r: r["arch"] == cfg.name
         and r["kv_len"] == 1000 and r["dtype"] == "bfloat16"),
        ("decode_attention", hcfg.name, lambda r: r["arch"] == hcfg.name
         and r["kv_len"] == 1001 and not r["window"]),
        ("ssd_scan", scfg.name, lambda r: r["case"] == "main"),
        ("rglru_scan", hcfg.name, lambda r: r["case"] == "main"),
        ("wq_claim", s_train, lambda r: r.get("arch") == train),
        ("ssd_scan", s_train, lambda r: r["case"] == "train"),
        ("ssd_scan_bwd", s_train, lambda r: r["case"] == "train"),
        ("wq_claim", h_train, lambda r: r.get("arch") == train),
        ("rglru_scan", h_train, lambda r: r["case"] == "train"),
        ("rglru_scan_bwd", h_train, lambda r: r["case"] == "train"),
        ("flash_attention", h_train, lambda r: r["arch"] == h_train),
        ("flash_attention_bwd", h_train, lambda r: r["arch"] == h_train),
        ("wq_claim", CONTROL_PLANE, lambda r: r.get("arch") == CONTROL_PLANE),
        ("wq_claim", SHARDED_TRAIN, lambda r: r.get("arch") == SHARDED_TRAIN),
        ("flash_attention", SHARDED_TRAIN,
         lambda r: r["arch"] == SHARDED_TRAIN),
        ("flash_attention_bwd", SHARDED_TRAIN,
         lambda r: r["arch"] == SHARDED_TRAIN)]
    # the MoE, VLM and enc-dec train runs' queue is qwen2's (6 tasks, 2
    # workers)
    main_shape += [("wq_claim", f"{c.name} train",
                    lambda r: r.get("arch") == train) for c in fams]
    main_shape = [(k, a, next(r for r in rows if r["kernel"] == k
                              and pick(r)), one)
                  for k, a, pick in main_shape]
    # the MoE, VLM and enc-dec rows, each the shape of its share of the
    # (kernel, arch) it names
    main_shape += [(r["kernel"], arch, r, share)
                   for r, arch, share in extra if arch is not None]
    total = {}
    for name, arch, _, share in main_shape:
        total[name, arch] = total.get((name, arch), 0) + share
    check(all(t == 1 for t in total.values()),
          f"launch shares do not sum to 1: {total}")
    out = []
    for name, arch, r, share in main_shape:
        n = launches[arch][name] * share
        check(n.denominator == 1, f"{name} {arch}: {share} of "
              f"{launches[arch][name]} launches")
        out.append({"name": name, "arch": arch, "route": "cuda",
                    "source": SRC[name], "replaces": REPLACES[name],
                    "launches": int(n),
                    **({"launches_share": str(share),
                        "launches_of_kernel": launches[arch][name]}
                       if share != 1 else {}),
                    "shape": {k: r[k] for k in _SHAPE_KEYS if k in r},
                    "max_abs_err": r["max_abs_err"], "ms": r["ms"],
                    "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                    "bound_by": r["bound_by"],
                    "library_ms": r["library_ms"],
                    "device_ms": r["device_ms"],
                    "library_device_ms": r.get("library_device_ms")})
    return {"kernels": out}


_SHAPE_KEYS = ("shape_q", "shape_kv", "shape_cache", "kv_len", "causal",
               "window", "dtype", "lse", "case", "n", "workers", "k")
# the enc-dec serve: 7 requests of cross_kv_len (4096) frames and one of
# fewer, whose decode memory is zero-padded; a prompt of
# prefill_input_specs' max(64, s // 8) tokens
ENCDEC_SHORT_FRAMES = 2500
ENCDEC_PROMPT = 64


def encdec_serve_frames(cfg, requests: int = 8) -> list:
    return [cfg.cross_kv_len] * (requests - 1) + [ENCDEC_SHORT_FRAMES]


def family_shapes(fams) -> list:
    """The attention kernels' shapes on the MoE, VLM and enc-dec paths, as
    (kernel, arch whose run gives the kernel this shape or None, the share
    of that run's launches of the kernel at it, the case's arguments).
    Serve: prefill fp32 at S 1000 (granite's 24/8 heads of 64, qwen2-vl's
    12/2 of 128) and their bf16 decode at kv_len 1000 (1000 to 1030 in the
    run); seamless's prefill (a third of its flash launches each: per layer
    the encoder, S 4096 or 2500 not causal, the decoder's self-attention
    over the 64-token prompt, causal, and its cross-attention, those 64
    queries over the frames) and decode (half its launches each: the
    self-attention against the cache, kv_len 65 to 95, and the
    cross-attention, one query over kv_len 4096). Train, bf16 forward with
    LSE and backward: granite's microbatch 2 x 2048, qwen2-vl's 8 x 2048;
    seamless's thirds at 8 x 2048 (encoder, not causal), 8 x 256 (decoder,
    causal) and 256 x 2048 (cross, not causal)."""
    gcfg, vcfg, ecfg = fams
    f32, bf16 = torch.float32, torch.bfloat16
    F = fractions.Fraction
    out = []
    for c in (gcfg, vcfg):
        hd = dict(hq=c.num_heads, hkv=c.num_kv_heads, dh=c.resolved_head_dim)
        out.append(("flash_attention", c.name, F(1),
                    dict(hd, s=1000, dtype=f32, arch=c.name)))
        out.append(("decode_attention", c.name, F(1),
                    dict(hd, smax=4096, kv_len=1000, dtype=bf16,
                         arch=c.name)))
    hd = dict(hq=ecfg.num_heads, hkv=ecfg.num_kv_heads,
              dh=ecfg.resolved_head_dim)
    e, frames = ecfg.name, encdec_serve_frames(ecfg)
    third = F(1, 3 * len(frames))        # one request's share of a third
    for n in sorted(set(frames), reverse=True):
        share = third * frames.count(n)
        out.append(("flash_attention", e, share,
                    dict(hd, s=n, dtype=f32, arch=e, causal=False)))
        out.append(("flash_attention", e, share,
                    dict(hd, s=ENCDEC_PROMPT, dtype=f32, arch=f"{e} cross",
                         skv=n, causal=False)))
    out.append(("flash_attention", e, F(1, 3),
                dict(hd, s=ENCDEC_PROMPT, dtype=f32, arch=f"{e} decoder")))
    out.append(("decode_attention", e, F(1, 2),
                dict(hd, smax=4096, kv_len=ENCDEC_PROMPT + 16, dtype=bf16,
                     arch=f"{e} decoder")))
    out.append(("decode_attention", e, F(1, 2),
                dict(hd, smax=ecfg.cross_kv_len, kv_len=ecfg.cross_kv_len,
                     dtype=bf16, arch=f"{e} cross")))
    for c, b, s, skv, causal, share, part in (
            (gcfg, 2, 2048, 0, True, F(1), ""),
            (vcfg, 8, 2048, 0, True, F(1), ""),
            (ecfg, 8, 2048, 0, False, F(1, 3), ""),
            (ecfg, 8, 256, 0, True, F(1, 3), " decoder"),
            (ecfg, 8, 256, 2048, False, F(1, 3), " cross")):
        kw = dict(hq=c.num_heads, hkv=c.num_kv_heads,
                  dh=c.resolved_head_dim, b=b, s=s, dtype=bf16,
                  arch=f"{c.name} train{part}", skv=skv, causal=causal)
        out.append(("flash_attention", f"{c.name} train", share,
                    dict(kw, lse=True)))
        out.append(("flash_attention_bwd", f"{c.name} train", share, kw))
    return out


def _family_rows(dev, rng, fams) -> list:
    """:func:`family_shapes`' cases run, each held against its plain
    version with SDPA beside it, as (row, arch, share)."""
    case = {"flash_attention": _flash_case,
            "flash_attention_bwd": _flash_bwd_case,
            "decode_attention": _decode_case}
    return [(case[k](dev, rng=rng, **kw), arch, share)
            for k, arch, share, kw in family_shapes(fams)]


def _free() -> None:
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA card; none is available")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = phase_device()
    cfg, scfg, hcfg = (get_config(a) for a in
                       ("qwen2-0.5b", "mamba2-1.3b", "recurrentgemma-9b"))
    gcfg, vcfg, ecfg = (get_config(a) for a in
                        ("granite-moe-3b-a800m", "qwen2-vl-2b",
                         "seamless-m4t-large-v2"))
    launches = {}
    for c in (cfg, scfg, hcfg):
        serve = phase_serve(c, dev)
        res = serve["result"]
        launches[c.name] = res["launches"]
        if c is hcfg:    # too large for a CPU copy: checked cut, below
            for key in ("init_peak_mem_bytes", "peak_mem_bytes"):
                check(res[key] < HYBRID_MAX_PEAK_BYTES,
                      f"{c.name} {key} {res[key]} >= "
                      f"{HYBRID_MAX_PEAK_BYTES}")
        else:
            phase_serve_check(serve["executor"])
        phase_serve_profile(serve["executor"])
        del serve, res   # free one model before the next is built
        _free()
    phase_hybrid_check(hcfg, dev)
    # the MoE family through the store-driven executor; the VLM and enc-dec
    # families through the model bundle (no executor serves them: they need
    # more than a token prompt). Each checked on a 2-layer cut at full width
    serve = phase_serve(gcfg, dev)
    launches[gcfg.name] = serve["result"]["launches"]
    phase_serve_profile(serve["executor"])
    del serve
    _free()
    phase_family_check(gcfg, dev)
    launches[vcfg.name] = phase_serve_bundle(vcfg, dev)["launches"]
    _free()
    phase_family_check(vcfg, dev)
    launches[ecfg.name] = phase_serve_bundle(
        ecfg, dev, prompt_len=ENCDEC_PROMPT,
        frames=encdec_serve_frames(ecfg))["launches"]
    _free()
    phase_family_check(ecfg, dev, prompt_len=16, frames=1000)
    launches[None] = phase_claim(dev)["launches"]
    cp = phase_control_plane(dev, train_cfg=cfg)
    launches[CONTROL_PLANE] = cp["launches"]
    launches[SHARDED_TRAIN] = cp["train"]["launches"]
    del cp
    _free()
    train = phase_train(cfg, dev)
    launches[f"{cfg.name} train"] = train["result"]["launches"]
    phase_train_profile(train["executor"])
    train["executor"].close()
    del train
    _free()
    phase_train_check(cfg, dev)
    # the SSM and hybrid families: mamba2-1.3b at full width and depth;
    # recurrentgemma-9b at full width, its depth cut (the record says so);
    # the MoE, VLM and enc-dec families: qwen2-vl-2b and seamless at full
    # width and depth, granite at full width, its depth cut
    hcut = dataclasses.replace(hcfg, num_layers=HYBRID_TRAIN_LAYERS)
    gcut = dataclasses.replace(gcfg, num_layers=MOE_TRAIN_LAYERS)
    ng, nt = hybrid_counts(hcut)
    for c, kw, check_kw in (
            (scfg, {}, {"prefixes": ("layers.0.mixer.",)}),
            (hcut, {"seq_len": 4096, "batch": 4,
                    "max_peak": HYBRID_TRAIN_MAX_PEAK_BYTES,
                    "reduced": f"depth {hcfg.num_layers} -> "
                               f"{HYBRID_TRAIN_LAYERS} layers ({ng} groups + "
                               f"{nt} tail): the full depth's parameters "
                               f"with AdamW do not fit one card"},
             {"layers": len(hcfg.rglru.pattern), "batch": 1, "step": False}),
            (gcut, {"max_peak": MOE_TRAIN_MAX_PEAK_BYTES,
                    "reduced": f"depth {gcfg.num_layers} -> "
                               f"{MOE_TRAIN_LAYERS} layers: the full depth's "
                               f"3.90 B stored parameters with AdamW peak "
                               f"past {MOE_TRAIN_MAX_PEAK_BYTES / 1e9:.0f} "
                               f"GB"},
             {"prefixes": ("layers.0.attn.", "layers.0.moe."),
              "batch": 4}),    # one row to each of its 4 microbatches
            (vcfg, {}, {}),
            (ecfg, {}, {"prefixes": ("encoder.0.", "decoder.0.")})):
        train = phase_train(c, dev, **kw)
        launches[f"{c.name} train"] = train["result"]["launches"]
        phase_train_profile(train["executor"])
        train["executor"].close()
        del train
        _free()
        phase_train_check(c, dev, **check_kw)
    kernels = phase_kernels(cfg, scfg, hcfg, (gcfg, vcfg, ecfg), dev,
                            launches)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit(kernels)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
