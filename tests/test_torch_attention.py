"""The port's plain flash and decode attention (CPU) against the reference's
Pallas kernels in interpret mode and their oracles, on the same numpy inputs,
and the attention layer's ring-buffer branch against the reference's.
Tolerances are those of the reference's own kernel tests: 2e-5 in fp32,
2e-2 in bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.kernels.decode_attention.ops import decode_attention as jax_decode  # noqa: E402
from repro.kernels.decode_attention.ref import decode_attention_ref as jax_decode_ref  # noqa: E402
from repro.kernels.flash_attention.ops import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import flash_attention_ref as jax_flash_ref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.models import attention as TA  # noqa: E402
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


@pytest.mark.parametrize("b,smax,hq,hkv,kvlen,window", [
    (1, 64, 4, 1, 50, 16),     # the window bites
    (2, 64, 4, 2, 10, 16),     # fewer keys than the window
    (1, 300, 8, 1, 300, 256),  # dh 256's head count, a full cache
])
def test_windowed_decode_matches_sdpa_ref(b, smax, hq, hkv, kvlen, window):
    """The decode op's window against the reference's oracle for a 1-token
    query at position kv_len - 1 (the reference's Pallas decode drops the
    window; the port follows the oracle)."""
    q, k, v = _inputs(5, (b, 1, hq, 32), (b, smax, hkv, 32),
                      (b, smax, hkv, 32))
    got = kops.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v),
                                kv_len=torch.tensor([kvlen],
                                                    dtype=torch.int32),
                                window=window)
    want = JA.sdpa_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                       causal=True, window=window, q_offset=kvlen - 1,
                       kv_len=kvlen)
    assert _err(got, want) < 2e-5
    if kvlen > window:      # the window changes the result
        assert _err(got, jax_decode_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), kvlen)) > 1e-3


@pytest.mark.parametrize("t", [0, 3, 7, 8, 13, 21])
def test_ring_buffer_branch_matches_reference(t):
    """Sliding-window decode against a ring of exactly ``window`` slots
    (recurrentgemma smoke: window 8, 4 query heads over 1 KV head): the
    token at absolute position t goes to slot t % 8, and the output, the
    written slot and the untouched slots equal the reference's."""
    cfg = jax_smoke_config("recurrentgemma-9b")
    tcfg = smoke_config("recurrentgemma-9b")
    w, d = cfg.rglru.window, cfg.d_model
    hd, hkv = cfg.resolved_head_dim, cfg.num_kv_heads
    rng = np.random.default_rng(t)
    p = {name: {"w": (rng.standard_normal(shape) * d ** -0.5)
                .astype(np.float32)}
         for name, shape in (("q", (d, cfg.num_heads * hd)),
                             ("k", (d, hkv * hd)), ("v", (d, hkv * hd)),
                             ("o", (cfg.num_heads * hd, d)))}
    mod = TA.Attention(torch.Generator().manual_seed(0), tcfg, torch.float32)
    with torch.no_grad():
        for name in p:
            getattr(mod, name).weight.copy_(torch.as_tensor(p[name]["w"].T))
    x = rng.standard_normal((2, 1, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, w, hkv, hd)).astype(np.float32)
              for _ in range(2))
    pos = np.full((2, 1), t, np.int32)
    jout, (jk, jv) = jax.jit(JA.attention, static_argnums=2,
                             static_argnames=("window",))(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x), cfg,
        positions=jnp.asarray(pos), window=w,
        cache_kv=(jnp.asarray(ck), jnp.asarray(cv)),
        cache_idx=jnp.asarray(t, jnp.int32))
    tk, tv = torch.as_tensor(ck), torch.as_tensor(cv)
    with torch.no_grad():
        tout, (rk, rv) = TA.attention(
            mod, torch.as_tensor(x), tcfg, positions=torch.as_tensor(pos),
            window=w, cache_kv=(tk, tv),
            cache_idx=torch.tensor(t, dtype=torch.int32))
    assert rk is tk and rv is tv                     # written in place
    assert _err(tout, jout) < 2e-5
    assert _err(rk, jk) < 2e-5 and _err(rv, jv) < 2e-5
    others = [s for s in range(w) if s != t % w]
    assert np.array_equal(rk.numpy()[:, others], ck[:, others])
