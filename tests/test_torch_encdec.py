"""The port's enc-dec family (seamless-m4t-large-v2: frame-embedding stub,
bidirectional encoder, decoder with cross-attention) against the reference
on the CPU, on converted params and numpy inputs: the encoder; prefill with
fewer frames than ``cross_kv_len`` (the decode memory zero-padded, the pad
attended) and with more (cut), each followed by five decode steps; the
train loss; the loss and every gradient against ``jax.value_and_grad`` in
fp32 and bf16; one AdamW step, and one Adafactor step (LayerNorm biases
keyed as the reference keys them); the encoder on bf16 frames against fp32
master params (the serve path's split, which the reference's layer scan
refuses: held against its layers composed without the scan).

Limits, as ``test_torch_train_ssm_hybrid.py``: encoder outputs and logits
1e-4 (fp32, sums in another order); fp32 loss 1e-5 relative, every
gradient 1e-4 of its tensor's largest; bf16 (both sides cast every master
leaf and round activations at different places) loss 1e-4, gradients 5e-2
of their largest; after one step the params 1e-2 of the lr per element
where the gradient's sign is resolved, else the update's size (2 lr)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import (flatten, load_jax_params,  # noqa: E402
                                 params_from_jax, train_state_from_jax)
from repro_torch.launch.steps import (init_train_state,  # noqa: E402
                                      loss_and_grads, make_train_step)
from repro_torch.models import encdec as ED  # noqa: E402

ARCH = "seamless-m4t-large-v2"
LR = 3e-4
TOL = {"float32": (1e-5, 1e-4), "bfloat16": (1e-4, 5e-2)}  # loss, gradients


def _close(got, want, rel, what, atol=0.0):
    """|got - want| <= max(rel * max|want|, atol) per element."""
    got = torch.as_tensor(got).detach().double()
    want = torch.as_tensor(np.asarray(want, np.float64))
    assert got.shape == want.shape, what
    tol = torch.clamp(torch.as_tensor(atol, dtype=torch.float64),
                      min=max(rel * float(want.abs().max()), 1e-30))
    err = (got - want).abs()
    assert bool((err <= tol).all()), (what, float(err.max()))


def _pair(**upd):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **upd)
    cfg = dataclasses.replace(smoke_config(ARCH), **upd)
    params = JED.init_params(jcfg, jax.random.PRNGKey(0))
    model = ED.init_params(cfg, torch.Generator().manual_seed(1))
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, cfg, params, model


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _frames(cfg, n, b=2, seed=0):
    return (np.random.default_rng(seed).standard_normal(
        (b, n, cfg.d_model)) * 0.1).astype(np.float32)


def test_encode_matches_reference(pair):
    jcfg, cfg, params, model = pair
    f = _frames(cfg, 24)
    want = JED.encode(jcfg, params, jnp.asarray(f))
    with torch.no_grad():
        got = ED.encode(cfg, model, torch.as_tensor(f))
    _close(got, want, 0.0, "encode", atol=1e-4)


@pytest.mark.parametrize("frames", [10, 20])
def test_prefill_and_decode_match_reference(pair, frames):
    """10 frames: fewer than the smoke cross_kv_len of 16, so the decode
    memory is zero-padded and the pad attended; 20: cut to 16 for decode,
    while the prefill's cross-attention reads all 20."""
    jcfg, cfg, params, model = pair
    assert cfg.cross_kv_len == 16
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 9)).astype(np.int32)
    batch = {"frames": _frames(cfg, frames), "tokens": tokens}
    jl, jc = JED.prefill(jcfg, params, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, 24)
    with torch.no_grad():
        tl, tc = ED.prefill(cfg, model, {k: torch.as_tensor(v)
                                         for k, v in batch.items()}, 24)
    errs = [float(np.abs(np.asarray(jl) - tl.numpy()).max())]
    _close(tc["enc_out"], np.asarray(jc["enc_out"]), 0.0, "enc_out",
           atol=1e-4)
    if frames < cfg.cross_kv_len:
        assert not tc["enc_out"][:, frames:].any()
    for name in ("k", "v"):
        _close(tc["layers"][name], np.asarray(jc["layers"][name]), 0.0,
               name, atol=1e-4)
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = JED.decode_step(jcfg, params, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = ED.decode_step(cfg, model, torch.as_tensor(nxt), tc)
        errs.append(float(np.abs(np.asarray(jl) - tl.numpy()).max()))
    assert int(tc["idx"]) == int(jc["idx"]) == 14
    assert max(errs) < 1e-4, errs


def _batch(cfg, shard=3):
    """The reference's pipeline: 32 frames, 8 decoder tokens (s // 8)."""
    return batch_for(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     batch_size=4), shard)


def _tbatch(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def _states(jcfg, cfg):
    jstate = jax.tree.map(np.asarray, jsteps.init_train_state(
        jcfg, jax.random.PRNGKey(0)))
    state = init_train_state(cfg, torch.Generator().manual_seed(1))
    return jstate, train_state_from_jax(cfg, jstate, state["params"])


def test_train_loss_matches_reference(pair):
    jcfg, cfg, params, model = pair
    batch = _batch(jcfg)
    assert batch["frames"].shape == (4, 32, cfg.d_model)
    assert batch["tokens"].shape == (4, 8)
    want, jmet = JED.train_loss(jcfg, params, batch)
    got, met = ED.train_loss(cfg, model, _tbatch(batch))
    _close(got, want, 1e-5, "loss")
    assert float(met["aux_loss"]) == float(jmet["aux_loss"]) == 0.0


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_and_every_gradient_match_jax_value_and_grad(dtype, remat):
    jcfg, cfg = (dataclasses.replace(c, dtype=dtype, remat=remat) for c in
                 (jax_smoke_config(ARCH), smoke_config(ARCH)))
    batch = _batch(jcfg)
    jstate, state = _states(jcfg, cfg)

    def f(p):     # the reference's train step: cast every floating leaf
        return JED.train_loss(jcfg, jsteps._cast_tree(p, jnp.dtype(dtype)),
                              batch)[0]

    want_loss, want = jax.jit(jax.value_and_grad(f))(jstate["params"])
    loss, _, grads = loss_and_grads(cfg, state["params"], _tbatch(batch))
    loss_tol, grad_tol = TOL[dtype]
    _close(loss, want_loss, loss_tol, "loss")
    want = params_from_jax(jax.tree.map(lambda t: np.asarray(t, np.float32),
                                        want))
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert g.dtype == torch.float32 and bool((g != 0).any()), n
        # the key biases' gradients are 0 in exact arithmetic (a uniform
        # shift of a row's logits): noise, held to the query bias's limit
        atol = grad_tol * float(np.abs(want[n.replace(
            "k.bias", "q.bias")]).max()) if n.endswith("k.bias") else 0.0
        _close(g, want[n], grad_tol, f"grad {n}", atol=atol)


@pytest.mark.parametrize("optimizer", ["adamw", "adafactor"])
def test_train_step_matches_reference(optimizer):
    """One step of each optimizer; Adafactor's state is keyed by the
    reference's leaves, the LayerNorm biases by their own name (``bias``,
    where a dense layer's is ``b``)."""
    jcfg, cfg = (dataclasses.replace(c, optimizer=optimizer) for c in
                 (jax_smoke_config(ARCH), smoke_config(ARCH)))
    batch = _batch(jcfg)
    jstate, state = _states(jcfg, cfg)
    jnew, jmet = jax.jit(jsteps.make_train_step(jcfg))(
        jax.tree.map(jnp.asarray, jstate), jax.tree.map(jnp.asarray, batch),
        {"lr": jnp.asarray(LR, jnp.float32)})
    new, met = make_train_step(cfg)(state, _tbatch(batch), {"lr": LR})
    jnew = jax.tree.map(np.asarray, jnew)
    _close(met["loss"], jmet["loss"], 1e-5, "loss")
    _close(met["grad_norm"], jmet["grad_norm"], 1e-5, "grad_norm")
    want = params_from_jax(jnew["params"])
    if optimizer == "adafactor":
        keys = set(flatten(jnew["opt"]["inner"]))
        assert "encoder/ln1/bias/v" in keys or "encoder/ln1/bias/vr" in keys
        for key, arr in flatten(jnew["opt"]["inner"]).items():
            leaf, stat = key.rsplit("/", 1)
            _close(new["opt"]["inner"][leaf][stat], arr, 1e-4, key)
        m_ref = {}
    else:
        m_ref = params_from_jax(jnew["opt"]["inner"]["m"])
    for n, p in new["params"].named_parameters():
        tol = 1e-2 * LR
        if n in m_ref:
            m = torch.as_tensor(m_ref[n]).abs()
            tol = torch.where(m >= 1e-4 * m.max(), 1e-2 * LR,
                              2.0 * LR).double()
        if n.endswith("k.bias"):
            tol = 2.0 * LR
        _close(p, want[n], 0.0, f"params {n}", atol=tol)


def test_bf16_frames_against_fp32_params_match_the_reference_layers():
    """The serve path's split: cfg.dtype bf16, fp32 master params. The
    reference's encoder scan raises (its carry enters as the bf16 frames
    and leaves as fp32), so the port's encoder is held against the
    reference's layers composed without the scan: the frames and the first
    norm's output rounded to bf16, then bf16 @ fp32 promoted to fp32."""
    jcfg, cfg, params, model = _pair(dtype="bfloat16")
    f = _frames(cfg, 12)
    tokens = np.ones((2, 4), np.int32)
    with pytest.raises(TypeError, match="carry"):
        JED.prefill(jcfg, params, {"frames": jnp.asarray(f),
                                   "tokens": jnp.asarray(tokens)}, 8)
    x = jnp.asarray(f).astype(jnp.bfloat16)
    pos = jnp.arange(x.shape[1])[None, :]
    for i in range(jcfg.num_encoder_layers):
        lp = jax.tree.map(lambda a: a[i], params["encoder"])
        out, _ = JA.attention(lp["attn"], JL.apply_norm(lp["ln1"], x,
                                                        jcfg.norm),
                              jcfg, positions=pos, causal=False)
        x = x + out
        x = x + JL.mlp(lp["mlp"], JL.apply_norm(lp["ln2"], x, jcfg.norm),
                       jcfg.act, jcfg.glu)
    want = JL.apply_norm(params["enc_norm"], x, jcfg.norm)
    with torch.no_grad():
        got = ED.encode(cfg, model, torch.as_tensor(f))
        logits, cache = ED.prefill(cfg, model, {
            "frames": torch.as_tensor(f), "tokens": torch.as_tensor(tokens)},
            8)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, np.asarray(want), 0.0, "encode", atol=1e-4)
    assert logits.dtype == torch.float32
    assert cache["enc_out"].dtype == torch.bfloat16
