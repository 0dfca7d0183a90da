"""The port's SSM family (mamba2) against the reference's on converted params,
on the mamba2-1.3b smoke config (2 layers, d 64, 16 heads of P 8, N 16,
chunk 16): the mixer's prefill output and state, the model's prefill logits
and cache, then five decode steps, within 1e-4 in fp32 (the reference
computes the scan in its chunked form, the port's plain version
sequentially: the difference is summation order). One case serves with
``dtype="bfloat16"``: fp32 master params prefill, bf16 params decode, as
both executors do."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.launch.steps import _cast_tree  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import load_jax_params  # noqa: E402
from repro_torch.launch.steps import cast_params  # noqa: E402
from repro_torch.models import ssm as TS  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402

TOL = 1e-4
_prefill = jax.jit(JT.prefill, static_argnums=(0, 3))
_decode = jax.jit(JT.decode_step, static_argnums=0)
# bf16 decode: both sides round every layer's activations and projections
# to bf16, at different places (torch's and XLA's bf16 kernels), so logits
# (|logits| < 0.5 here) differ by a few bf16 steps, and the fp32 state fed
# by bf16 activations by about 1% of its size (|state| ~ 1). The limits are
# about twice the largest error seen over four prompts; the dtypes of the
# decode params and of the conv state are pinned exactly.
BF16_LOGITS_TOL = 1.5e-2
BF16_STATE_TOL = 3e-2


def _pair(dtype="float32"):
    cfg = dataclasses.replace(jax_smoke_config("mamba2-1.3b"), dtype=dtype)
    params = jax.jit(JT.init_params, static_argnums=0)(
        cfg, jax.random.PRNGKey(0))
    tcfg = dataclasses.replace(smoke_config("mamba2-1.3b"), dtype=dtype)
    model = TT.init_params(tcfg, torch.Generator().manual_seed(1))
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return cfg, params, tcfg, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_params_carry_across(pair):
    _, params, _, model = pair
    mixer = params["layers"]["mixer"]
    got = model.layers[1].mixer
    # [in, out] dense weights arrive transposed; conv_w [W, C] does not
    assert np.array_equal(got.in_proj.weight.detach().numpy(),
                          np.asarray(mixer["in_proj"]["w"][1]).T)
    assert np.array_equal(got.conv_w.detach().numpy(),
                          np.asarray(mixer["conv_w"][1]))
    for name in ("A_log", "D", "dt_bias"):
        p = getattr(got, name)
        assert p.dtype == torch.float32 and isinstance(p, torch.nn.Parameter)
        assert np.array_equal(p.detach().numpy(), np.asarray(mixer[name][1]))


@pytest.mark.parametrize("seq", [16, 37])     # one chunk; a ragged tail
def test_mixer_prefill_matches_reference(pair, seq):
    cfg, params, tcfg, model = pair
    lp = jax.tree.map(lambda a: a[0], params["layers"]["mixer"])
    x = np.random.default_rng(seq).standard_normal(
        (2, seq, cfg.d_model)).astype(np.float32)
    jy, jst = jax.jit(JS.ssd_mixer, static_argnums=2)(lp, jnp.asarray(x),
                                                      cfg)
    with torch.no_grad():
        ty, tst = TS.ssd_mixer(model.layers[0].mixer, torch.as_tensor(x),
                               tcfg)
    assert ty.shape == (2, seq, cfg.d_model)
    assert _err(jy, ty) < TOL
    for name in ("conv", "ssm"):
        assert tst[name].shape == jst[name].shape
        assert _err(jst[name], tst[name]) < TOL


def test_init_cache_layout_matches_reference(pair):
    cfg, _, tcfg, _ = pair
    jc = JT.init_cache(cfg, 3, 32)
    tc = TT.init_cache(tcfg, 3, 32, "cpu")
    for name in ("conv", "ssm"):
        assert tuple(tc["layers"][name].shape) == jc["layers"][name].shape
        assert str(tc["layers"][name].dtype)[6:] == \
            jc["layers"][name].dtype.name
    assert tc["idx"].dtype == torch.int32 and int(tc["idx"]) == 0


def test_prefill_and_decode_match_reference(pair):
    cfg, params, tcfg, model = pair
    tokens = _tokens(cfg, 2, 37)
    jl, jc = _prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, 64)
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, model, {"tokens": torch.as_tensor(tokens)},
                            64)
    assert tl.shape == (2, 1, cfg.vocab_size)
    assert _err(jl, tl) < TOL
    for name in ("conv", "ssm"):
        assert tc["layers"][name].dtype == torch.float32
        assert _err(jc["layers"][name], tc["layers"][name]) < TOL
    assert int(tc["idx"]) == int(jc["idx"]) == 37
    conv = tc["layers"]["conv"]
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = _decode(cfg, params, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, model, torch.as_tensor(nxt), tc)
        assert _err(jl, tl) < TOL
    assert tc["layers"]["conv"] is conv        # written in place
    assert _err(jc["layers"]["ssm"], tc["layers"]["ssm"]) < TOL
    assert int(tc["idx"]) == int(jc["idx"]) == 42


def test_bf16_decode_after_fp32_prefill_matches_reference():
    """The reference's dtype split: prefill on the fp32 master params, decode
    on params cast to bf16 (A_log, D and dt_bias too), with the conv state
    the prefill left in fp32 (concatenation promotes bf16 inputs to it)."""
    cfg, params, tcfg, model = _pair("bfloat16")
    dparams = _cast_tree(params, jnp.bfloat16)
    dmodel = cast_params(model, tcfg.dtype)
    mixer = dmodel.layers[0].mixer
    assert {mixer.A_log.dtype, mixer.D.dtype, mixer.dt_bias.dtype,
            mixer.conv_w.dtype} == {torch.bfloat16}
    assert model.layers[0].mixer.A_log.dtype == torch.float32   # master kept
    tokens = _tokens(cfg, 1, 21, seed=4)
    jl, jc = _prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, 64)
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, model, {"tokens": torch.as_tensor(tokens)},
                            64)
    assert _err(jl, tl) < TOL
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = _decode(cfg, dparams, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, dmodel, torch.as_tensor(nxt), tc)
        assert tl.dtype == torch.bfloat16
        assert _err(jl, tl.float()) < BF16_LOGITS_TOL
    assert jc["layers"]["conv"].dtype == jnp.float32
    assert tc["layers"]["conv"].dtype == torch.float32
    assert _err(jc["layers"]["ssm"], tc["layers"]["ssm"]) < BF16_STATE_TOL
