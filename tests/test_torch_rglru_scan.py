"""The port's RG-LRU scan (the plain version, reached through
``ops.rglru_scan`` on CPU tensors) against the reference's Pallas kernel in
interpret mode, its associative-scan oracle and the scan inside the
reference model's ``_rglru_core``, on the same numpy inputs. Tolerance: the
reference's own kernel test, max |got - ref| < 1e-4 in fp32. Also: the chip
check's limit rejects a scan that drops the state carried across time
blocks, and the bound of the serve shape."""
import importlib.util
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.rglru_scan.ops import rglru_scan as jax_rglru_scan  # noqa: E402
from repro.kernels.rglru_scan.ref import rglru_scan_ref as jax_rglru_ref  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels.rglru_scan.ref import rglru_scan_ref  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TOL = 1e-4


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _kernel_test_inputs(b, s, c, seed=0):
    """The distributions of the reference's kernel test, made with numpy."""
    rng = np.random.default_rng(seed)
    a = 0.95 / (1.0 + np.exp(-rng.standard_normal((b, s, c))))
    u = 0.3 * rng.standard_normal((b, s, c))
    return a.astype(np.float32), u.astype(np.float32)


@pytest.mark.parametrize("b,s,c", [(2, 64, 128), (1, 256, 512),
                                   (1, 100, 64)])
def test_rglru_scan_matches_pallas_and_oracle(b, s, c):
    a, u = _kernel_test_inputs(b, s, c)
    h = kops.rglru_scan(torch.as_tensor(a), torch.as_tensor(u))
    assert h.shape == (b, s, c) and h.dtype == torch.float32
    ja, ju = jnp.asarray(a), jnp.asarray(u)
    assert _err(h, jax_rglru_ref(ja, ju)) < TOL
    assert _err(h, jax_rglru_scan(ja, ju, interpret=True)) < TOL


@pytest.mark.parametrize("b,s,c", [(2, 200, 96), (3, 1031, 40)])
def test_rglru_scan_ragged_lengths_match_oracle(b, s, c):
    """Lengths that are not a multiple of the Pallas time block (128): held
    against the oracle only (the Pallas grid floor-divides S and never
    writes the tail)."""
    a, u = _kernel_test_inputs(b, s, c, seed=s)
    h = kops.rglru_scan(torch.as_tensor(a), torch.as_tensor(u))
    assert _err(h, jax_rglru_ref(jnp.asarray(a), jnp.asarray(u))) < TOL


def test_rglru_scan_bf16_returns_a_dtype():
    """bf16 inputs are computed in fp32 and h is rounded to bf16 once, as
    the oracle does: equal within one bf16 step of each value."""
    a, u = _kernel_test_inputs(2, 64, 128, seed=3)
    ta, tu = (torch.as_tensor(x).to(torch.bfloat16) for x in (a, u))
    h = kops.rglru_scan(ta, tu)
    assert h.dtype == torch.bfloat16
    want = np.asarray(jax_rglru_ref(jnp.asarray(a).astype(jnp.bfloat16),
                                    jnp.asarray(u).astype(jnp.bfloat16)),
                      np.float32)
    assert np.all(np.abs(h.float().numpy() - want)
                  <= TOL + 2.0 ** -7 * np.abs(want))


@pytest.mark.parametrize("seq", [5, 33])
def test_rglru_scan_matches_the_scan_in_rglru_core(seq):
    """The gates of the reference's ``_rglru_core`` (recurrentgemma smoke
    params) computed with numpy, scanned by the port's op: equal to the
    reference's associative scan inside ``_rglru_core``, final state
    included."""
    cfg = jax_smoke_config("recurrentgemma-9b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    p = jax.tree.map(lambda t: np.asarray(t[0], np.float64),
                     params["groups"]["pos0"]["mixer"])
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, 64)).astype(np.float32)

    def blockdiag(q, v):
        nb, c, _ = q["w"].shape
        y = np.einsum("bsnc,ncd->bsnd", v.reshape(2, seq, nb, c), q["w"])
        return (y + q["b"]).reshape(2, seq, -1)

    def sigmoid(v):
        return 1.0 / (1.0 + np.exp(-v))

    log_a = -8.0 * np.logaddexp(p["lam"], 0.0) * sigmoid(blockdiag(p["wa"],
                                                                   x))
    beta = np.sqrt(np.clip(1.0 - np.exp(2.0 * log_a), 1e-12, 1.0))
    u = beta * sigmoid(blockdiag(p["wx"], x)) * x
    h = kops.rglru_scan(torch.as_tensor(np.exp(log_a), dtype=torch.float32),
                        torch.as_tensor(u, dtype=torch.float32))
    lp = jax.tree.map(lambda t: t[0], params["groups"]["pos0"]["mixer"])
    jy, jh = jax.jit(JR._rglru_core)(lp, jnp.asarray(x), None)
    assert _err(h, jy) < TOL
    assert _err(h[:, -1], jh) < TOL


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reset_per_time_block(a, u, block=128):
    """A stand-in for a kernel that drops the carry: each time block (the
    TPU kernel's 128 steps) starts from h = 0."""
    return torch.cat([rglru_scan_ref(a[:, t:t + block], u[:, t:t + block])
                      for t in range(0, a.shape[1], block)], dim=1)


def test_chip_limit_rejects_a_scan_without_carry(chip_smoke):
    """The chip check's slow-decay case, cut to a CPU size (C 64, S 1024):
    the plain version passes its limit, a scan that resets h at each time
    block misses it by more than 100x."""
    a, u = chip_smoke.rglru_inputs(np.random.default_rng(3), 1, 1024, 64,
                                   slow=True)
    ref = rglru_scan_ref(a, u)
    assert chip_smoke.rglru_error(ref, ref)["err_over_tol"] == 0.0
    assert chip_smoke.rglru_error(_reset_per_time_block(a, u),
                                  ref)["err_over_tol"] > 100


def test_serve_regime_inputs_match_oracle(chip_smoke):
    """The chip check's main inputs (a from the Lambda init's range, u
    normalised by sqrt(1 - a^2)), cut to a CPU size: within its limit of
    the oracle."""
    a, u = chip_smoke.rglru_inputs(np.random.default_rng(4), 1, 300, 128)
    assert float(a.min()) > 0.9 - 1e-6 and float(a.max()) < 1.0
    h = kops.rglru_scan(a, u)
    want = jax_rglru_ref(jnp.asarray(a.numpy()), jnp.asarray(u.numpy()))
    assert _err(h, want) < TOL


def test_bound_of_the_serve_shape(chip_smoke):
    """a and u read, h written, fp32 [1, 1000, 4096]: 49.2 MB, 0.0147 ms at
    3.35 TB/s; bytes bind."""
    ops, nbytes = chip_smoke.rglru_ops_bytes(1, 1000, 4096, torch.float32)
    assert nbytes == 3 * 4 * 1000 * 4096 and ops == 2.0 * 1000 * 4096
    bound = chip_smoke._bound(nbytes, ops, torch.float32)
    assert bound["bound_by"] == "bytes"
    assert abs(bound["bound_ms"] - 0.014672) < 1e-6
