"""Pieces the plain reference models share: fp32 with TF32 off, the
emulated lower precision of the control, RMSNorm, the chunked
cross-entropy, and three train steps with AdamW.

Plain PyTorch only. Nothing here imports the program under test, JAX or
the JAX package, and nothing takes a tensor the program made: the
benchmark hands the reference the same weights and batches it handed the
program.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

# AdamW as the port's configurations state it (the reference's formula: eps
# added to sqrt(v_hat), weight decay added to the update before the lr
# scales it) and the gradient clipped to a global norm of 1.
B1, B2, EPS, WD, CLIP = 0.9, 0.95, 1e-8, 0.1, 1.0
NORM_EPS = 1e-6
FP8_MAX = 448.0      # largest finite float8_e4m3fn


def full_precision() -> None:
    """fp32 products stay fp32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8_e4m3fn with one scale for the tensor (its
    largest magnitude to the format's largest), back in fp32; the gradient
    passes straight through."""
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale
    return t + (q - t).detach()


def _tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (fp32) rounded to TF32's 10 mantissa bits, to nearest; the
    gradient passes straight through."""
    bits = t.detach().contiguous().view(torch.int32)
    q = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return t + (q - t).detach()


class Numerics:
    """How the model computes: ``"fp32"`` (the reference) or ``"fp8"`` (the
    control, in the precision below the configurations' bf16: every
    product's operands and result, and every activation the program keeps
    in bf16 (embeddings, norm outputs, the residual stream, the mixer's
    branches), rounded to fp8 e4m3, one scale a tensor; the products of a
    scan the configuration states in fp32 with their operands rounded to
    TF32, the step below it)."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown numerics {kind!r}")
        self.kind = kind

    def q(self, t: torch.Tensor) -> torch.Tensor:
        return _fp8(t) if self.kind == "fp8" else t

    def linear(self, x, w, b=None):
        y = self.q(x) @ self.q(w).T
        return self.q(y if b is None else y + b)

    def einsum(self, eq: str, a, b):
        return self.q(torch.einsum(eq, self.q(a), self.q(b)))

    def scan_einsum(self, eq: str, a, b):
        if self.kind == "fp8":
            a, b = _tf32(a), _tf32(b)
        return torch.einsum(eq, a, b)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + NORM_EPS) \
        * scale


def _xent_block(num: Numerics, x, table, labels):
    logits = num.linear(x, table)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return torch.sum(torch.logsumexp(logits, -1) - gold)


def mean_xent(num: Numerics, x: torch.Tensor, table: torch.Tensor,
              labels: torch.Tensor, chunk: int = 256) -> torch.Tensor:
    """Mean next-token cross-entropy of [B,S,D] states against the [V,D]
    head, ``chunk`` positions at a time (each block recomputed in the
    backward), so that no [B,S,V] logits are ever held."""
    b, s, _ = x.shape
    tot = x.new_zeros(())
    for c in range(0, s, chunk):
        tot = tot + checkpoint(_xent_block, num, x[:, c:c + chunk], table,
                               labels[:, c:c + chunk], use_reentrant=False)
    return tot / (b * s)


def _leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in tensors.items()}


def train_steps(loss_fn: Callable, weights: Dict[str, torch.Tensor],
                batches: Sequence[Dict[str, torch.Tensor]],
                lrs: Sequence[float]) -> Dict[str, object]:
    """``len(batches)`` AdamW steps of ``loss_fn(params, batch)`` from
    ``weights`` (fp32, updated in place): each step's loss, the first
    step's gradient by leaf as the optimizer takes it (clipped to a global
    norm of 1) and as computed, and each leaf's change over all the
    steps."""
    params = {n: w.detach().requires_grad_(True) for n, w in weights.items()}
    start = {n: w.detach().clone() for n, w in params.items()}
    m = {n: torch.zeros_like(w) for n, w in params.items()}
    v = {n: torch.zeros_like(w) for n, w in params.items()}
    losses: List[float] = []
    out: Dict[str, object] = {}
    for step, (batch, lr) in enumerate(zip(batches, lrs), start=1):
        loss = loss_fn(params, batch)
        grads = dict(zip(params, torch.autograd.grad(
            loss, list(params.values()))))
        losses.append(float(loss.detach()))
        del loss
        with torch.no_grad():
            gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2)
                                   for g in grads.values()))
            gscale = float(min(1.0, CLIP / max(float(gnorm), 1e-12)))
            if step == 1:
                out["grad_raw"] = _leaf_norms(grads)
                out["grad"] = {n: x * gscale
                               for n, x in out["grad_raw"].items()}
            bc1, bc2 = 1.0 - B1 ** step, 1.0 - B2 ** step
            for n, p in params.items():
                gi = grads[n] * gscale
                m[n].mul_(B1).add_(gi, alpha=1 - B1)
                v[n].mul_(B2).addcmul_(gi, gi, value=1 - B2)
                upd = (m[n] / bc1) / (torch.sqrt(v[n] / bc2) + EPS) + WD * p
                p.sub_(lr * upd)
        del grads
    with torch.no_grad():
        out["change"] = _leaf_norms({n: params[n] - start[n]
                                     for n in params})
    out["losses"] = losses
    return out
