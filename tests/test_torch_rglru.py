"""The port's hybrid family (recurrentgemma: RG-LRU blocks and local
attention) against the reference's on converted params, on the
recurrentgemma-9b smoke config (one (rec, rec, attn) group, d 64, 4 query
heads over 1 KV head, lru width 64, window 8), and on a 5-layer variant
with two tail rec layers: the RG-LRU block's output and state, the model's
prefill logits and cache, then decode steps past the window, so that the
ring of K/V wraps, within 1e-4 in fp32 (the reference scans with
``associative_scan``, the port's plain version sequentially: the
difference is summation order).

bf16: the reference cannot decode in bf16 from its own prefill cache (its
conv state and K/V come back in the fp32 of the master params, and the
bf16 decode's layer scan then changes its carry's dtype). The port writes
its prefill states into a cache in ``init_cache``'s dtypes; one test pins
the reference's failure, another holds the port's bf16 decode against the
reference's fed the same cast cache."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.steps import _cast_tree  # noqa: E402
from repro.models import rglru as JR  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import load_jax_params  # noqa: E402
from repro_torch.launch.steps import cast_params  # noqa: E402
from repro_torch.models import rglru as TR  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

ARCH = "recurrentgemma-9b"
TOL = 1e-4
_prefill = jax.jit(JT.prefill, static_argnums=(0, 3))
_decode = jax.jit(JT.decode_step, static_argnums=0)
# bf16 decode: both sides round activations and projections to bf16 at
# different places (torch's and XLA's bf16 kernels), so the logits (|logits|
# ~ 0.5 here) differ by several bf16 steps and the fp32 lru state (|h| <
# 0.8), fed by bf16 activations, by under 1% of its size. The limits are
# about twice the largest error seen over four prompts (0.018 and 0.0039);
# the dtypes are pinned exactly.
BF16_LOGITS_TOL = 3.5e-2
BF16_STATE_TOL = 8e-3


def _pair(layers=3, dtype="float32"):
    cfg = dataclasses.replace(jax_smoke_config(ARCH), num_layers=layers,
                              dtype=dtype)
    params = jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(smoke_config(ARCH), num_layers=layers,
                               dtype=dtype)
    model = TT.init_params(tcfg, torch.Generator().manual_seed(1))
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg, params, tcfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


@pytest.fixture(scope="module")
def pair5():
    return _pair(layers=5)


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def _greedy(logits):
    return np.argmax(np.asarray(logits, np.float32)[:, -1],
                     -1)[:, None].astype(np.int32)


def test_params_carry_across(pair5):
    _, params, tcfg, model = pair5
    assert TT.hybrid_counts(tcfg) == (1, 2)
    assert TT.hybrid_counts(smoke_config(ARCH)) == (1, 0)
    mixer = params["groups"]["pos1"]["mixer"]
    got = model.groups[0]["pos1"].mixer
    # dense [in, out] weights arrive transposed; the block-diagonal gates'
    # [nb, c, c], conv_w [W, lw] and lam [lw] as they are
    assert np.array_equal(got.in_proj.weight.detach().numpy(),
                          np.asarray(mixer["in"]["w"][0]).T)
    assert np.array_equal(got.wa.weight.detach().numpy(),
                          np.asarray(mixer["wa"]["w"][0]))
    assert np.array_equal(got.wx.bias.detach().numpy(),
                          np.asarray(mixer["wx"]["b"][0]))
    assert np.array_equal(got.conv_w.detach().numpy(),
                          np.asarray(mixer["conv_w"][0]))
    assert got.lam.dtype == torch.float32
    assert np.array_equal(got.lam.detach().numpy(),
                          np.asarray(mixer["lam"][0]))
    tail = params["tail"]["mlp"]["up"]["w"]
    assert len(model.tail) == tail.shape[0] == 2
    assert np.array_equal(model.tail[1].mlp.up.weight.detach().numpy(),
                          np.asarray(tail[1]).T)
    attn = params["groups"]["pos2"]["attn"]["k"]["w"]
    assert np.array_equal(model.groups[0]["pos2"].attn.k.weight.detach()
                          .numpy(), np.asarray(attn[0]).T)


def test_lam_init_matches_reference_formula(pair):
    """The port's own init draws other numbers than the reference, but Lambda
    is a formula, not a draw."""
    cfg, params, tcfg, _ = pair
    fresh = TR.RGLRU(torch.Generator().manual_seed(5), tcfg, torch.float32)
    want = np.asarray(params["groups"]["pos0"]["mixer"]["lam"][0])
    assert np.allclose(fresh.lam.detach().numpy(), want, rtol=1e-5)


@pytest.mark.parametrize("seq", [5, 16])
def test_rglru_block_matches_reference(pair, seq):
    """Prefill (the scan) at S 5 and 16, then one decode step from the state
    it returned (the O(1) update)."""
    cfg, params, tcfg, model = pair
    lp = jax.tree.map(lambda a: a[0], params["groups"]["pos0"]["mixer"])
    rng = np.random.default_rng(seq)
    x = rng.standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    x1 = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    block = jax.jit(JR.rglru_block, static_argnums=2)
    jy, jst = block(lp, jnp.asarray(x), cfg)
    jy1, jst1 = block(lp, jnp.asarray(x1), cfg, jst)
    mixer = model.groups[0]["pos0"].mixer
    with torch.no_grad():
        ty, tst = TR.rglru_block(mixer, torch.as_tensor(x), tcfg)
        ty1, tst1 = TR.rglru_block(mixer, torch.as_tensor(x1), tcfg, tst)
    assert ty.shape == (2, seq, cfg.d_model)
    assert _err(jy, ty) < TOL and _err(jy1, ty1) < TOL
    for name in ("conv", "lru"):
        assert tst[name].shape == jst[name].shape
        assert _err(jst[name], tst[name]) < TOL
        assert _err(jst1[name], tst1[name]) < TOL
    assert tst["lru"].dtype == torch.float32


def test_rglru_core_from_a_state_matches_reference(pair):
    """Several steps from a state: the scan from zero, then the state
    carried in as cumprod(a) * h0 (on no serve path)."""
    cfg, params, _, model = pair
    lp = jax.tree.map(lambda a: a[0], params["groups"]["pos1"]["mixer"])
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 6, 64)).astype(np.float32)
    h0 = rng.standard_normal((2, 64)).astype(np.float32)
    jy, jh = jax.jit(JR._rglru_core)(lp, jnp.asarray(x), jnp.asarray(h0))
    with torch.no_grad():
        ty, th = TR._rglru_core(model.groups[0]["pos1"].mixer,
                                torch.as_tensor(x), torch.as_tensor(h0))
    assert _err(jy, ty) < TOL and _err(jh, th) < TOL


@pytest.mark.parametrize("layers,max_len", [(3, 64), (5, 64), (5, 6)])
def test_init_cache_layout_matches_reference(layers, max_len):
    """A ring of min(window, max_len) slots; the tail only with tail
    layers; conv and K/V in cfg.dtype, lru in fp32."""
    for dtype in ("float32", "bfloat16"):
        cfg = dataclasses.replace(jax_smoke_config(ARCH), num_layers=layers,
                                  dtype=dtype)
        tcfg = dataclasses.replace(smoke_config(ARCH), num_layers=layers,
                                   dtype=dtype)
        jc = JT.init_cache(cfg, 3, max_len)["layers"]
        tc = TT.init_cache(tcfg, 3, max_len, "cpu")["layers"]
        jflat = jax.tree_util.tree_flatten_with_path(jc)[0]
        tflat = jax.tree_util.tree_flatten_with_path(tc)[0]
        assert [p for p, _ in jflat] == [p for p, _ in tflat]
        for (_, j), (_, t) in zip(jflat, tflat):
            assert tuple(t.shape) == j.shape
            assert str(t.dtype)[6:] == j.dtype.name
        assert (tc["tail"] is None) == (layers == 3)


@pytest.mark.parametrize("layers,prompt", [(3, 11), (5, 13), (3, 5)])
def test_prefill_and_decode_match_reference(request, layers, prompt):
    """Prompts longer than the window (the prefill's window bites and its
    K/V wrap into the ring) and one shorter; six decode steps each, so the
    ring wraps again during decode."""
    cfg, params, tcfg, model = request.getfixturevalue(
        "pair" if layers == 3 else "pair5")
    tokens = _tokens(cfg, 2, prompt, seed=prompt)
    jl, jc = _prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, 64)
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, model, {"tokens": torch.as_tensor(tokens)},
                            64)
    assert tl.shape == (2, 1, cfg.vocab_size)
    assert _err(jl, tl) < TOL
    jleaves = jax.tree.leaves(jc["layers"])
    tleaves = jax.tree.leaves(tc["layers"])
    assert len(jleaves) == len(tleaves) == (6 if layers == 3 else 8)
    for j, t in zip(jleaves, tleaves):
        assert tuple(t.shape) == j.shape and _err(j, t) < TOL
    assert int(tc["idx"]) == int(jc["idx"]) == prompt
    ring = tc["layers"]["groups"]["pos2"]["k"]
    for _ in range(6):
        nxt = _greedy(jl)
        jl, jc = _decode(cfg, params, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, model, torch.as_tensor(nxt), tc)
        assert _err(jl, tl) < TOL
    assert tc["layers"]["groups"]["pos2"]["k"] is ring     # written in place
    for j, t in zip(jax.tree.leaves(jc["layers"]),
                    jax.tree.leaves(tc["layers"])):
        assert _err(j, t) < TOL
    assert int(tc["idx"]) == int(jc["idx"]) == prompt + 6


def test_linear_cache_with_window_matches_reference(pair):
    """max_len 6 < window 8: the cache is linear (6 slots) and the window
    is applied by the mask, as in the reference's linear-cache branch."""
    cfg, params, tcfg, model = pair
    tokens = _tokens(cfg, 1, 3, seed=9)
    jl, jc = _prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, 6)
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, model, {"tokens": torch.as_tensor(tokens)},
                            6)
    assert tc["layers"]["groups"]["pos2"]["k"].shape[2] == 6
    for _ in range(2):
        nxt = _greedy(jl)
        jl, jc = _decode(cfg, params, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, model, torch.as_tensor(nxt), tc)
        assert _err(jl, tl) < TOL


def _cast_like_init_cache(cfg, cache, b, max_len):
    want = JT.init_cache(cfg, b, max_len)
    return {"layers": jax.tree.map(lambda c, z: c.astype(z.dtype),
                                   cache["layers"], want["layers"]),
            "idx": cache["idx"]}


def test_reference_bf16_decode_from_its_own_prefill_cache_raises():
    """The reference's limit that the port departs from: its hybrid prefill
    returns an fp32 conv state and ring (the master params' dtype), and its
    bf16 decode from that cache fails. If this test starts failing, the
    reference changed and the departure in the port's ``_hybrid_prefill``
    should be revisited."""
    cfg, params, _, _ = _pair(dtype="bfloat16")
    tokens = _tokens(cfg, 1, 5)
    _, jc = _prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, 40)
    assert jc["layers"]["groups"]["pos0"]["conv"].dtype == jnp.float32
    assert jc["layers"]["groups"]["pos2"]["k"].dtype == jnp.float32
    with pytest.raises(TypeError, match="carry"):
        _decode(cfg, _cast_tree(params, jnp.bfloat16),
                jnp.zeros((1, 1), jnp.int32), jc)


def test_bf16_decode_after_fp32_prefill_matches_reference():
    """The serve path's dtype split: prefill on the fp32 master params,
    decode on a bf16 copy (lam too, as ``_cast_tree`` casts it) against a
    cache in init_cache's dtypes, which the port's prefill writes and the
    reference's is cast to here. Prompt 12 > window 8."""
    cfg, params, tcfg, model = _pair(layers=5, dtype="bfloat16")
    dparams = _cast_tree(params, jnp.bfloat16)
    dmodel = cast_params(model, tcfg.dtype)
    tokens = _tokens(cfg, 1, 12, seed=4)
    jl, jc = _prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, 40)
    jc = _cast_like_init_cache(cfg, jc, 1, 40)
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, model, {"tokens": torch.as_tensor(tokens)},
                            40)
    assert _err(jl, tl) < TOL
    groups = tc["layers"]["groups"]
    assert groups["pos0"]["conv"].dtype == torch.bfloat16
    assert groups["pos2"]["k"].dtype == torch.bfloat16
    assert groups["pos1"]["lru"].dtype == torch.float32
    for j, t in zip(jax.tree.leaves(jc["layers"]),
                    jax.tree.leaves(tc["layers"])):
        # both round the same fp32 values (within 1e-4) to the cache dtype
        assert str(t.dtype)[6:] == j.dtype.name
        j = np.asarray(j, np.float32)
        assert np.all(np.abs(j - t.float().numpy())
                      <= TOL + 2.0 ** -7 * np.abs(j))
    for _ in range(5):
        nxt = _greedy(jl)
        jl, jc = _decode(cfg, dparams, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, dmodel, torch.as_tensor(nxt), tc)
        assert tl.dtype == torch.bfloat16
        assert _err(jl, tl.float()) < BF16_LOGITS_TOL
    groups = tc["layers"]["groups"]
    assert groups["pos0"]["conv"].dtype == torch.bfloat16
    assert tc["layers"]["tail"]["lru"].dtype == torch.float32
    assert _err(jc["layers"]["tail"]["lru"],
                tc["layers"]["tail"]["lru"]) < BF16_STATE_TOL


def test_cast_params_makes_no_second_master_copy(pair5):
    """The decode copy shares no storage with the master params and has
    every floating leaf in cfg.dtype, lam included."""
    _, _, _, model = pair5
    dmodel = cast_params(model, "bfloat16")
    master = {p.untyped_storage().data_ptr() for p in model.parameters()}
    for name, p in dmodel.named_parameters():
        assert p.dtype == torch.bfloat16, name
        assert p.untyped_storage().data_ptr() not in master, name
    assert model.groups[0]["pos0"].mixer.lam.dtype == torch.float32
    assert [n for n, _ in dmodel.named_parameters()] == \
        [n for n, _ in model.named_parameters()]
    # tied embeddings: one table serves embed and head in both copies
    assert dmodel.embed.weight.shape == model.embed.weight.shape
    assert cast_params(dmodel, torch.bfloat16) is dmodel
