"""The flash-attention backward: its plain version against autograd through
the plain forward and against ``jax.grad`` of the reference's ``sdpa_ref``
(which the reference trains through), the row log-sum-exp it starts from,
the grad guard of the forward-only launchers, and (marked ``gpu``, skipped
without a card) the CUDA kernels against their plain versions.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_flash_bwd.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.models.attention import sdpa_ref as jax_sdpa_ref  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.decode_attention.kernel import decode_attention_fwd  # noqa: E402
from repro_torch.kernels.flash_attention.kernel import (  # noqa: E402
    flash_attention_bwd, flash_attention_fwd)
from repro_torch.kernels.flash_attention.ops import FlashAttentionFn  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_lse_ref, flash_attention_ref)
from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd,  # noqa: E402
                                                   rglru_scan_fwd)
from repro_torch.kernels.ssd_scan.kernel import ssd_scan_bwd, ssd_scan_fwd  # noqa: E402

# the plain backward against autograd / jax.grad, all in fp32 on the CPU:
# the same sums in another order (einsum contractions over <= 131 keys or
# rows), so 2e-5 of the gradient's largest element
CPU_REL_TOL = 2e-5

CASES = [  # b, s, hq, hkv, dh, causal, window
    (2, 67, 14, 2, 16, True, 0),      # qwen2's g = 7, ragged against 64
    (1, 131, 4, 1, 8, True, 0),       # MQA, ragged
    (1, 96, 6, 2, 8, True, 17),       # windowed
    (1, 50, 4, 4, 8, False, 9),       # windowed, not causal
]


def _inputs(b, s, hq, hkv, dh, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    k, v = (rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
            for _ in range(2))
    do = rng.standard_normal((b, s, hq, dh)).astype(np.float32)
    return q, k, v, do


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tol = rel * max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window", CASES)
def test_plain_backward_matches_autograd_and_jax_grad(b, s, hq, hkv, dh,
                                                      causal, window):
    q, k, v, do = _inputs(b, s, hq, hkv, dh, seed=s)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    out = flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    auto = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
    lse = flash_attention_lse_ref(tq.detach(), tk.detach(), causal=causal,
                                  window=window)
    mine = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                   out.detach(), lse, torch.tensor(do),
                                   causal=causal, window=window)

    def f(q_, k_, v_):
        o = jax_sdpa_ref(q_, k_, v_, causal=causal, window=window)
        return jnp.sum(o * do)

    ref = jax.jit(jax.grad(f, argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for a, m, r in zip(auto, mine, ref):
        assert m.shape == a.shape and m.dtype == torch.float32
        _close(m.numpy(), a.numpy(), CPU_REL_TOL)
        _close(m.numpy(), np.asarray(r), CPU_REL_TOL)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_lse_is_the_natural_log_sum_exp_of_the_scaled_logits(causal, window):
    """lse[b, h, i] = log sum_j exp(dh**-0.5 q_i.k_j) over the keys row i
    sees (natural log, scale applied), so exp(s - lse) sums to 1 a row."""
    q, k, _, _ = _inputs(1, 23, 4, 2, 8, seed=5)
    lse = flash_attention_lse_ref(torch.tensor(q), torch.tensor(k),
                                  causal=causal, window=window).numpy()
    assert lse.shape == (1, 4, 23)
    for h in range(4):
        s = (q[0, :, h].astype(np.float64) @ k[0, :, h // 2].T.astype(
            np.float64)) / np.sqrt(8)
        for i in range(23):
            seen = [j for j in range(23) if (not causal or j <= i)
                    and (not window or j > i - window)]
            want = np.log(np.exp(s[i, seen]).sum())
            assert abs(lse[0, h, i] - want) <= 1e-5 * max(1.0, abs(want))


def test_lse_of_a_row_that_sees_no_key_is_inf():
    """With more queries than keys and a window of 2, rows 4.. see none of
    keys 0..2: +inf, so the backward's exp(s - lse) is 0 there."""
    q, k, _, _ = _inputs(1, 8, 2, 2, 4, seed=1)
    lse = flash_attention_lse_ref(torch.tensor(q), torch.tensor(k[:, :3]),
                                  causal=True, window=2)
    assert torch.isinf(lse[0, :, 4:]).all() and torch.isfinite(
        lse[0, :, :4]).all()


def test_cpu_dispatch_is_differentiable():
    """On the CPU ``kernels.ops.flash_attention`` is the plain version, and
    plain autograd gives its gradient (the reference's training path)."""
    q, k, v, do = _inputs(1, 33, 4, 2, 8, seed=2)
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    got = torch.autograd.grad(kops.flash_attention(tq, tk, tv),
                              (tq, tk, tv), torch.tensor(do))
    lse = flash_attention_lse_ref(tq.detach(), tk.detach())
    out = flash_attention_ref(tq.detach(), tk.detach(), tv.detach())
    want = flash_attention_bwd_ref(tq.detach(), tk.detach(), tv.detach(),
                                   out, lse, torch.tensor(do))
    for a, b in zip(got, want):
        _close(a.numpy(), b.numpy(), CPU_REL_TOL)


def test_forward_only_launchers_refuse_inputs_that_require_grad():
    """A launcher's output has no gradient path: with grad enabled and an
    input that requires grad it raises (before looking for a card), naming
    where the gradient comes from instead; without grad it goes on to its
    device check."""
    x = torch.zeros((2, 8, 4), requires_grad=True)
    q = torch.zeros((1, 8, 2, 8), requires_grad=True)
    w = torch.zeros(16)
    calls = [
        (lambda: ssd_scan_fwd(x, x, x, x[..., 0], x[..., 0]), "SSDScanFn"),
        (lambda: rglru_scan_fwd(x, x), "RGLRUScanFn"),
        (lambda: decode_attention_fwd(q[:, :1], q, q, kv_len=torch.tensor(
            [3], dtype=torch.int32)), "serve-only; train through kernels.ops"),
        (lambda: flash_attention_fwd(q, q, q), "kernels.ops.flash_attention"),
        (lambda: flash_attention_bwd(q, q, q, q, q[:, 0].transpose(1, 2), q),
         "double backward"),
        (lambda: ssd_scan_bwd(x, x, x, x[..., 0], x[..., 0], x, w, x),
         "double backward"),
        (lambda: rglru_scan_bwd(x, x, x), "double backward"),
    ]
    for call, item in calls:
        with pytest.raises(RuntimeError, match=item):
            call()
        with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
            call()


# ------------------------------------------------------------------ card
# the kernels against their plain versions on the card. fp32: sums of up to
# S x g terms (14,336 at qwen2's train shape) in another order, so 1e-4 of
# the gradient's largest element; bf16: both sides compute in fp32 from the
# same bf16 inputs and round once, so an element may also differ by one
# bf16 step of its value (2**-7 |ref|)
GPU_REL_TOL = 1e-4
LSE_TOL = 1e-4       # absolute: moves every P of the row by that factor


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _card(arrs, dtype, dev):
    return [torch.as_tensor(a, device=dev).to(dtype) for a in arrs]


def _assert_grad_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = GPU_REL_TOL * max(1.0, float(want.float().abs().max()))
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), float(diff.max())


GPU_CASES = [  # b, s, hq, hkv, dh, causal, window, dtype
    (2, 512, 14, 2, 64, True, 0, torch.bfloat16),    # qwen2's heads
    (1, 1031, 14, 2, 64, True, 0, torch.float32),    # ragged S
    (1, 1024, 32, 2, 128, True, 0, torch.bfloat16),  # glm4's heads
    (1, 700, 8, 2, 64, True, 256, torch.float32),    # windowed
    (1, 300, 4, 4, 50, True, 0, torch.float32),      # dh 50: padded dims
    (1, 200, 6, 3, 128, False, 0, torch.float32),    # not causal
    (1, 1, 4, 2, 64, True, 0, torch.float32),        # one row
    # the dK/dV kernel's runs of query heads: qwen2's g = 7 at B 1 in runs
    # of 2, 2, 2, 1 (bwd_heads_per_split), and at B 2 in runs of 3, 3, 1
    (1, 2048, 14, 2, 64, True, 0, torch.bfloat16),
    (2, 2048, 14, 2, 64, True, 0, torch.bfloat16),   # every diagonal tile
    (1, 512, 8, 8, 64, True, 0, torch.bfloat16),     # g = 1 (hq = hkv)
    (1, 1100, 16, 2, 128, True, 333, torch.bfloat16),  # window edge in tiles
    (1, 300, 4, 2, 64, False, 100, torch.float32),   # windowed, not causal
    # width 256, two blocks an output row (recurrentgemma-9b: 16 query heads
    # over one KV head, window 2048); fp32 in tiles of 32 rows
    (1, 4096, 16, 1, 256, True, 2048, torch.bfloat16),  # its train shape
    (1, 1031, 16, 1, 256, True, 2048, torch.float32),   # ragged S
    (1, 2100, 16, 1, 256, True, 2048, torch.float32),   # window biting
    (2, 200, 8, 1, 200, True, 50, torch.bfloat16),      # dh 200: padded
    (1, 300, 4, 2, 256, False, 0, torch.float32),       # not causal
]


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window,dtype", GPU_CASES)
def test_backward_kernel_equals_plain(dev, b, s, hq, hkv, dh, causal, window,
                                      dtype):
    q, k, v, do = _card(_inputs(b, s, hq, hkv, dh, seed=s), dtype, dev)
    out, lse = flash_attention_fwd(q, k, v, causal=causal, window=window,
                                   return_lse=True)
    want_lse = flash_attention_lse_ref(q, k, causal=causal, window=window)
    assert float((lse - want_lse).abs().max()) <= LSE_TOL
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                              window=window)
    want = flash_attention_bwd_ref(q, k, v, out, lse, do, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _assert_grad_close(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,hkv,dh", [(14, 2, 64), (16, 1, 256)])
def test_backward_kernel_repeats_bit_identical(dev, dtype, hq, hkv, dh):
    """No atomics: 10 back-to-back calls give the same bits."""
    q, k, v, do = _card(_inputs(2, 700, hq, hkv, dh, seed=9), dtype, dev)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    first = flash_attention_bwd(q, k, v, out, lse, do)
    for _ in range(10):
        again = flash_attention_bwd(q, k, v, out, lse, do)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hkv,dh,window", [(14, 2, 64, 0),
                                              (16, 1, 256, 700)])
def test_lse_output_leaves_the_forward_unchanged(dev, hq, hkv, dh, window):
    """The serve path passes no lse buffer: the output is the same bits
    with and without it."""
    q, k, v, _ = _card(_inputs(1, 1000, hq, hkv, dh, seed=4), torch.bfloat16,
                       dev)
    plain = flash_attention_fwd(q, k, v, window=window)
    out, _ = flash_attention_fwd(q, k, v, window=window, return_lse=True)
    assert torch.equal(plain, out)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_function_gradients_on_card(dev, dtype):
    """``kernels.ops.flash_attention`` with inputs that require grad runs
    the forward kernel with its lse and the backward kernel: one launch
    each. The gradients are those of the plain backward from the kernel's
    own output, and in fp32 those of autograd through the plain forward. In
    bf16 autograd differs by more than the limit: it never rounds the
    output, while the backward's D = rowsum(dO o O) reads O rounded to bf16
    (the saved output, as FlashAttention-2 does)."""
    arrs = _inputs(2, 300, 14, 2, 64, seed=6)
    q, k, v = (t.requires_grad_() for t in _card(arrs[:3], dtype, dev))
    do = _card(arrs[3:], dtype, dev)[0]
    reset_launch_counts()
    out = kops.flash_attention(q, k, v)
    got = torch.autograd.grad(out, (q, k, v), do)
    counts = launch_counts()
    assert counts["flash_attention"] == 1 and \
        counts["flash_attention_bwd"] == 1
    with torch.no_grad():
        lse = flash_attention_lse_ref(q, k)
        want = flash_attention_bwd_ref(q, k, v, out, lse, do)
    for g, w in zip(got, want):
        _assert_grad_close(g, w)
    if dtype == torch.float32:
        want = torch.autograd.grad(flash_attention_ref(q, k, v), (q, k, v),
                                   do)
        for g, w in zip(got, want):
            _assert_grad_close(g, w)
    # the direct call is still forward-only
    with pytest.raises(RuntimeError):
        flash_attention_fwd(q, k, v)
    with torch.no_grad():
        assert kops.flash_attention(q, k, v).grad_fn is None
    assert FlashAttentionFn.apply(q, k, v, True, 0).grad_fn is not None
