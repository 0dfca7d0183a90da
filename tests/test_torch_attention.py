"""The port's plain flash and decode attention (CPU) against the reference's
Pallas kernels in interpret mode and their oracles, on the same numpy inputs.
Tolerances are those of the reference's own kernel tests: 2e-5 in fp32,
2e-2 in bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models.attention import sdpa_ref  # noqa: E402


def _inputs(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


def _t(x, dtype):
    return torch.as_tensor(x).to(dtype)


def _j(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float32)
                               - np.asarray(b, np.float32))))


@pytest.mark.parametrize("b,s,hq,hkv,dh,causal,window,dtype", [
    (1, 512, 4, 2, 64, True, 0, "float32"),
    (2, 256, 4, 4, 128, False, 0, "float32"),
    (1, 512, 2, 1, 112, True, 128, "float32"),
    (1, 256, 4, 2, 64, True, 0, "bfloat16"),
])
def test_flash_matches_pallas_and_oracle(b, s, hq, hkv, dh, causal, window,
                                         dtype):
    q, k, v = _inputs(0, (b, s, hq, dh), (b, s, hkv, dh), (b, s, hkv, dh))
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = kops.flash_attention(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                               causal=causal, window=window)
    assert got.dtype == tdt and got.shape == (b, s, hq, dh)
    got = got.float().numpy()
    jq, jk, jv = _j(q, jdt), _j(k, jdt), _j(v, jdt)
    tol = 2e-5 if dtype == "float32" else 2e-2
    assert _err(got, jax_flash(jq, jk, jv, causal=causal, window=window,
                               interpret=True)) < tol
    assert _err(got, jax_flash_ref(jq, jk, jv, causal=causal,
                                   window=window)) < tol


@pytest.mark.parametrize("s,window", [(200, 0), (333, 0), (333, 96)])
def test_flash_ragged_lengths_match_oracle(s, window):
    """Lengths that are not a multiple of any block: held against the oracle
    only (the Pallas grid floor-divides and never writes the tail)."""
    q, k, v = _inputs(1, (1, s, 4, 64), (1, s, 2, 64), (1, s, 2, 64))
    got = kops.flash_attention(_t(q, torch.float32), _t(k, torch.float32),
                               _t(v, torch.float32), causal=True,
                               window=window).numpy()
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=True, window=window)
    assert _err(got, want) < 2e-5


@pytest.mark.parametrize("b,smax,hq,hkv,dh,kvlen", [
    (2, 1024, 4, 2, 64, 700),
    (1, 2048, 8, 1, 128, 2048),
    (2, 1024, 4, 4, 112, 513),
])
def test_decode_matches_pallas_and_oracle(b, smax, hq, hkv, dh, kvlen):
    q, k, v = _inputs(2, (b, 1, hq, dh), (b, smax, hkv, dh),
                      (b, smax, hkv, dh))
    got = kops.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v),
                                kv_len=torch.tensor([kvlen],
                                                    dtype=torch.int32))
    assert got.shape == (b, 1, hq, dh)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    assert _err(got, jax_decode(jq, jk, jv, kv_len=kvlen,
                                interpret=True)) < 2e-5
    assert _err(got, jax_decode_ref(jq, jk, jv, kvlen)) < 2e-5


@pytest.mark.parametrize("smax,kvlen", [(200, 77), (333, 77), (333, 333)])
def test_decode_ragged_lengths_match_oracle(smax, kvlen):
    q, k, v = _inputs(3, (1, 1, 14, 64), (1, smax, 2, 64), (1, smax, 2, 64))
    got = kops.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v),
                                kv_len=torch.tensor([kvlen],
                                                    dtype=torch.int32))
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          kvlen)
    assert _err(got, want) < 2e-5


def test_sdpa_ref_cache_tail_equals_decode_oracle():
    """The model's reference attention at a cache offset (the CPU decode
    path) computes the decode oracle's function."""
    q, k, v = _inputs(4, (1, 1, 4, 32), (1, 64, 2, 32), (1, 64, 2, 32))
    idx = torch.tensor(40, dtype=torch.int32)
    got = sdpa_ref(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                   causal=True, q_offset=idx, kv_len=idx + 1)
    want = jax_decode_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 41)
    assert _err(got, want) < 2e-5
