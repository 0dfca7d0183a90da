"""The RG-LRU scan's backward: the plain reverse recurrence
(``rglru_scan_bwd_ref``) and plain autograd through ``rglru_scan_ref`` (the
CPU's training path) on the CPU against ``jax.grad``
of the reference's associative scan (its kernel oracle, and the scan inside
``_rglru_core``, whose gradient XLA derives: the reference has no backward
of its own), on the same numpy inputs; and (marked ``gpu``, skipped without
a card) the backward kernel against the plain backward on the card.

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_rglru_scan_bwd.py

Limits: on the CPU 1e-5 of each gradient's largest element (fp32, sums of
at most S terms in another order); on the card the forward's rule, 1e-4 of
the largest element, plus one bf16 step of the value for bf16 outputs."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.kernels import launch_counts, reset_launch_counts  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.rglru_scan.kernel import (rglru_scan_bwd,  # noqa: E402
                                                   rglru_scan_fwd)
from repro_torch.kernels.rglru_scan.ref import (rglru_scan_bwd_ref,  # noqa: E402
                                                rglru_scan_ref)

CPU_REL_TOL = 1e-5


def _inputs(b, s, c, seed, slow=False):
    """a in (0, 0.95) as the reference's kernel test draws it, or about
    0.999 (slow decay: the gradient carried back over ~1000 steps dominates);
    u and the output gradient g ~ N(0, 1)."""
    rng = np.random.default_rng(seed)
    if slow:
        a = 1.0 - 1e-3 * np.exp(0.1 * rng.standard_normal((b, s, c)))
    else:
        a = 0.95 / (1.0 + np.exp(-rng.standard_normal((b, s, c))))
    u = rng.standard_normal((b, s, c))
    g = rng.standard_normal((b, s, c))
    return [x.astype(np.float32) for x in (a, u, g)]


def _close(got, want, rel):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * float(np.abs(want).max())


@pytest.fixture(scope="module")
def jax_vjp():
    """jax.grad of <g, scan(a, u)> through the reference's associative
    scan, compiled once."""
    def f(a, u, g):
        return jnp.sum(jax_rglru_ref(a, u) * g)
    return jax.jit(jax.grad(f, argnums=(0, 1)))


@pytest.mark.parametrize("b,s,c,slow", [
    (2, 64, 128, False), (1, 200, 96, True), (3, 37, 40, False),
    (1, 1, 8, False)])
def test_plain_backward_and_autograd_match_jax_grad(jax_vjp, b, s, c, slow):
    a, u, g = _inputs(b, s, c, seed=s + c, slow=slow)
    want = jax_vjp(jnp.asarray(a), jnp.asarray(u), jnp.asarray(g))
    ta, tu, tg = (torch.as_tensor(x) for x in (a, u, g))
    h = rglru_scan_ref(ta, tu)
    da, du = rglru_scan_bwd_ref(ta, h, tg)
    assert da.dtype == du.dtype == torch.float32
    _close(da, want[0], CPU_REL_TOL)
    _close(du, want[1], CPU_REL_TOL)
    # plain autograd through the plain forward, as training on the CPU
    la, lu = (t.clone().requires_grad_(True) for t in (ta, tu))
    kops.rglru_scan(la, lu).backward(tg)
    _close(la.grad, want[0], CPU_REL_TOL)
    _close(lu.grad, want[1], CPU_REL_TOL)


def test_function_takes_cuda_tensors_only():
    """RGLRUScanFn pairs the two kernels: on CPU tensors it raises, and the
    dispatcher leaves CPU calls to plain autograd through rglru_scan_ref."""
    from repro_torch.kernels.rglru_scan.ops import RGLRUScanFn
    a = torch.full((1, 4, 8), 0.5, requires_grad=True)
    with pytest.raises(ValueError, match="CUDA"):
        RGLRUScanFn.apply(a, a)
    h = kops.rglru_scan(a, a)
    assert h.grad_fn is not None and "RGLRUScanFn" not in type(
        h.grad_fn).__name__


def test_plain_backward_matches_autograd_in_bf16():
    """bf16 inputs are computed in fp32 and the gradients rounded to bf16
    once: within one bf16 step of autograd through the fp32 scan."""
    a, u, g = _inputs(2, 50, 64, seed=5)
    ta, tu = (torch.as_tensor(x).to(torch.bfloat16).float().requires_grad_()
              for x in (a, u))
    h = rglru_scan_ref(ta, tu)
    want = torch.autograd.grad(h, (ta, tu), torch.as_tensor(g))
    got = rglru_scan_bwd_ref(ta.detach().to(torch.bfloat16),
                             h.detach().to(torch.bfloat16),
                             torch.as_tensor(g).to(torch.bfloat16))
    for x, w in zip(got, want):
        assert x.dtype == torch.bfloat16
        tol = 1e-2 * float(w.abs().max()) + 2.0 ** -7 * w.abs()
        assert bool(((x.float() - w).abs() <= tol).all())


class _PlainBackwardScan(torch.autograd.Function):
    """The plain scan whose gradient is the plain backward's, as the card's
    Function pairs the two kernels."""

    @staticmethod
    def forward(ctx, a, u):
        h = rglru_scan_ref(a, u)
        ctx.save_for_backward(a, h)
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        return rglru_scan_bwd_ref(a, h, g.contiguous())


@pytest.mark.parametrize("scan", ["autograd", "plain_backward"])
def test_rglru_core_gradient_matches_jax_grad(scan):
    """The reference's ``_rglru_core`` (recurrentgemma smoke params, its
    gates and its associative scan) differentiated by jax.grad with respect
    to its input, against the port's ``_rglru_core`` from the same params
    and input: its scan differentiated by plain autograd (the CPU's
    training path), or by ``rglru_scan_bwd_ref``."""
    from repro_torch.configs import smoke_config
    from repro_torch.interop import params_from_jax
    from repro_torch.models import rglru as R
    from repro_torch.models.registry import build_model

    jcfg = jax_smoke_config("recurrentgemma-9b")
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda t: t[0], params["groups"]["pos0"]["mixer"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 29, 64)).astype(np.float32)
    gy = rng.standard_normal((2, 29, 64)).astype(np.float32)

    def f(v):
        return jnp.sum(JR._rglru_core(lp, v, None)[0] * gy)
    want = jax.jit(jax.grad(f))(jnp.asarray(x))

    cfg = smoke_config("recurrentgemma-9b")
    model = build_model(cfg).init(torch.Generator().manual_seed(0))
    flat = params_from_jax(jax.tree.map(np.asarray, params))
    model.load_state_dict({k: torch.as_tensor(np.array(v))
                           for k, v in flat.items()})
    mixer = model.groups[0]["pos0"].mixer
    tx = torch.as_tensor(x).requires_grad_(True)
    orig = kops.rglru_scan
    try:
        if scan == "plain_backward":
            kops.rglru_scan = _PlainBackwardScan.apply
        y, _ = R._rglru_core(mixer, tx, None)
    finally:
        kops.rglru_scan = orig
    (got,) = torch.autograd.grad(y, tx, torch.as_tensor(gy))
    _close(got, want, 1e-5)


# ------------------------------------------------------------------ card
def _card_inputs(rng, b, s, c, dtype, dev, slow):
    """The chip check's inputs (a as the model's Lambda init gives it, or
    about 0.999), u and g ~ N(0, 1)."""
    if slow:
        a = 1.0 - 1e-3 * np.exp(0.1 * rng.standard_normal((b, s, c)))
    else:
        a = np.linspace(0.9, 0.999, c) ** (
            1.0 / (1.0 + np.exp(-rng.standard_normal((b, s, c)))))
    u = np.sqrt(1.0 - a * a) * rng.standard_normal((b, s, c))
    g = rng.standard_normal((b, s, c))
    return [torch.as_tensor(x, dtype=torch.float32, device=dev).to(dtype)
            for x in (a, u, g)]


def _assert_card_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = 1e-4 * float(want.float().abs().max())
    if want.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -7 * want.float().abs()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= tol).all()), float(diff.max())


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("b,s,c,dtype,slow", [
    (1, 4096, 4096, torch.float32, False),   # recurrentgemma-9b's train shape
    (1, 4096, 4096, torch.float32, True),    # carry dominates
    (1, 1031, 4096, torch.float32, False),   # ragged
    (1, 1000, 4096, torch.bfloat16, False),
    (3, 1031, 200, torch.float32, True),     # B > 1, ragged S and C
    (2, 300, 100, torch.bfloat16, True),     # C not a multiple of 32
    (1, 1, 33, torch.float32, False),
    (1, 128, 64, torch.float32, False),      # one tile exactly
    (1, 129, 64, torch.float32, True),       # a step past it
    (1, 7, 4096, torch.float32, True),
])
def test_rglru_scan_bwd_kernel_equals_plain(dev, b, s, c, dtype, slow):
    a, u, g = _card_inputs(np.random.default_rng(s + c), b, s, c, dtype,
                           dev, slow)
    h = rglru_scan_fwd(a, u)
    got = rglru_scan_bwd(a, h, g)
    want = rglru_scan_bwd_ref(a, h, g)
    torch.cuda.synchronize()
    for x, w in zip(got, want):
        _assert_card_close(x, w)
    again = rglru_scan_bwd(a, h, g)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.gpu
def test_dispatch_goes_through_the_kernels_when_grad_is_needed(dev):
    a, u, g = _card_inputs(np.random.default_rng(1), 2, 300, 256,
                           torch.float32, dev, False)
    a.requires_grad_(True)
    u.requires_grad_(True)
    reset_launch_counts()
    h = kops.rglru_scan(a, u)
    h.backward(g)
    counts = launch_counts()
    assert counts["rglru_scan"] == 1 and counts["rglru_scan_bwd"] == 1
    with torch.no_grad():
        want = rglru_scan_bwd_ref(a, rglru_scan_ref(a, u), g)
    _assert_card_close(a.grad, want[0])
    _assert_card_close(u.grad, want[1])
    with pytest.raises(RuntimeError):
        rglru_scan_fwd(a, u)          # the direct call stays forward-only
    with torch.no_grad():
        assert kops.rglru_scan(a, u).grad_fn is None
