"""The port's VLM family (qwen2-vl-2b: patch-embedding stub, M-RoPE) against
the reference on the CPU, on converted params and numpy inputs: M-RoPE with
distinct t/h/w streams (a patch grid: t constant, h the row, w the column;
with three equal streams M-RoPE is RoPE and the section split would go
unchecked), prefill and five decode steps, the prefill with bf16 embeddings
against fp32 master params (the serve path's dtype split, which the
reference's scan refuses: held against its blocks layer by layer), the
microbatch
split of ``mrope_positions`` [3,B,S] along the batch (dim 1), and the loss
and every gradient against ``jax.value_and_grad``.

Limits: M-RoPE 1e-6 (fp32 rotations of the same angles); logits 1e-4
(fp32, sums in another order); the loss 1e-5 relative, every gradient 1e-4
of its tensor's largest, as ``test_torch_train.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import (load_jax_params, params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.launch.steps import (_micro, init_train_state,  # noqa: E402
                                      loss_and_grads, make_train_step)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ARCH = "qwen2-vl-2b"
LR = 3e-4


def _close(got, want, rel, what, atol=0.0):
    """|got - want| <= max(rel * max|want|, atol) per element."""
    got = torch.as_tensor(got).detach().double()
    want = torch.as_tensor(np.asarray(want, np.float64))
    assert got.shape == want.shape, what
    tol = torch.clamp(torch.as_tensor(atol, dtype=torch.float64),
                      min=max(rel * float(want.abs().max()), 1e-30))
    err = (got - want).abs()
    assert bool((err <= tol).all()), (what, float(err.max()))


def grid_positions(b: int, s: int, width: int, t0: int = 0) -> np.ndarray:
    """[3,B,S] int32 M-RoPE ids of S patches in rows of ``width``: t
    constant, h the row, w the column."""
    i = np.arange(s)
    pos = np.stack([np.full(s, t0), i // width, i % width])
    return np.ascontiguousarray(
        np.broadcast_to(pos[:, None], (3, b, s))).astype(np.int32)


@pytest.mark.parametrize("dh", [16, 128])
def test_apply_mrope_matches_reference(dh):
    """The reference's sections at the attention's call, (22, 21, 21) at
    qwen2-vl's width of 128."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 24, 3, dh)).astype(np.float32)
    pos = grid_positions(2, 24, 5)
    pos[:, 1] += 7                       # the batch rows differ too
    sec = (dh // 2 - 2 * (dh // 6), dh // 6, dh // 6)
    want = JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sec)
    got = L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6, sec)
    _close(got, want, 0.0, "mrope", atol=1e-6)
    # three equal streams: RoPE; distinct ones rotate otherwise
    same = np.broadcast_to(pos[1:2], pos.shape).copy()
    rope = L.apply_rope(torch.as_tensor(x), torch.as_tensor(pos[1]), 1e6)
    assert torch.allclose(L.apply_mrope(torch.as_tensor(x),
                                        torch.as_tensor(same), 1e6, sec),
                          rope, atol=1e-6)
    assert not torch.allclose(got, rope, atol=1e-3)
    with pytest.raises(ValueError, match="sum"):
        L.apply_mrope(torch.as_tensor(x), torch.as_tensor(pos), 1e6,
                      (1, 2, 3))


def _pair(**upd):
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **upd)
    cfg = dataclasses.replace(smoke_config(ARCH), **upd)
    params = JT.init_params(jcfg, jax.random.PRNGKey(0))
    model = T.init_params(cfg, torch.Generator().manual_seed(1))
    load_jax_params(model, jax.tree.map(np.asarray, params))
    return jcfg, cfg, params, model


def _prompt(cfg, b=2, s=15, seed=0):
    emb = (np.random.default_rng(seed).standard_normal((b, s, cfg.d_model))
           * 0.1).astype(np.float32)
    return {"embeds": emb, "mrope_positions": grid_positions(b, s, 4)}


def _decode_run(jcfg, cfg, jparams, model, batch, steps=5, tparams=None):
    """Prefill then ``steps`` greedy decode steps on both sides (decode
    with ``tparams`` when given); returns the max logit error per step."""
    tparams = tparams if tparams is not None else model
    jl, jc = JT.prefill(jcfg, jparams, {k: jnp.asarray(v)
                                        for k, v in batch.items()}, 32)
    with torch.no_grad():
        tl, tc = T.prefill(cfg, model, {k: torch.as_tensor(v)
                                        for k, v in batch.items()}, 32)
    errs = [float(np.abs(np.asarray(jl, np.float32) - tl.float().numpy())
                  .max())]
    for name in ("k", "v"):
        _close(tc["layers"][name].float(), np.asarray(
            jc["layers"][name], np.float32), 0.0, name, atol=1e-4)
    s = batch["embeds"].shape[1]
    for _ in range(steps):
        nxt = np.argmax(np.asarray(jl, np.float32)[:, -1], -1)[:, None] \
            .astype(np.int32)
        jl, jc = JT.decode_step(jcfg, jparams, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = T.decode_step(cfg, tparams, torch.as_tensor(nxt), tc)
        errs.append(float(np.abs(np.asarray(jl, np.float32)
                                 - tl.float().numpy()).max()))
    assert int(tc["idx"]) == int(jc["idx"]) == s + steps
    return errs


def test_prefill_and_decode_match_reference():
    jcfg, cfg, params, model = _pair()
    errs = _decode_run(jcfg, cfg, params, model, _prompt(cfg))
    assert max(errs) < 1e-4, errs


def test_bf16_embeds_against_fp32_params_match_the_reference_blocks():
    """The serve path's split: cfg.dtype bf16, fp32 master params. The
    reference's prefill raises here (its layer scan's carry enters as the
    bf16 embeddings and leaves as fp32: a TypeError), so the port is held
    against the reference's own blocks run layer by layer without the scan:
    both round the patch embeddings to bf16 and the first norm's output
    with them, then JAX promotes bf16 @ fp32 to fp32, and so does the port
    (``L.dense``) where ``nn.Linear`` would refuse the mix."""
    jcfg, cfg, params, model = _pair(dtype="bfloat16")
    batch = _prompt(cfg)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    with pytest.raises(TypeError, match="carry"):
        JT.prefill(jcfg, params, jb, 32)
    x = JT._embed_inputs(jcfg, params, jb)
    assert x.dtype == jnp.bfloat16
    pos = jnp.arange(x.shape[1])[None, :]
    for i in range(jcfg.num_layers):
        lp = jax.tree.map(lambda a: a[i], params["layers"])
        x, _, _ = JT._attn_block(lp, x, jcfg, positions=pos,
                                 mrope=jb["mrope_positions"])
    x = JL.apply_norm(params["final_norm"], x, jcfg.norm)
    want = x[:, -1:] @ JT._head_table(jcfg, params).T
    with torch.no_grad():
        tl, cache = T.prefill(cfg, model, {k: torch.as_tensor(v)
                                           for k, v in batch.items()}, 32)
    assert want.dtype == jnp.float32 and tl.dtype == torch.float32
    assert cache["layers"]["k"].dtype == torch.bfloat16
    _close(tl, np.asarray(want), 0.0, "logits", atol=1e-4)


def test_microbatches_split_mrope_positions_along_the_batch():
    """[3,B,S] splits at dim 1, as the reference's _split_micro does; a
    train step at 2 microbatches equals the reference's."""
    jcfg, cfg = (dataclasses.replace(c, microbatches=2) for c in
                 (jax_smoke_config(ARCH), smoke_config(ARCH)))
    batch = batch_for(jcfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                       batch_size=4), 3)
    batch["mrope_positions"] = grid_positions(4, 16, 4)
    batch["mrope_positions"][:, 2:] += 3       # the halves differ
    split = jsteps._split_micro(batch, 2)
    tb = {k: torch.as_tensor(np.array(v)) for k, v in batch.items()}
    for i in range(2):
        part = _micro(tb, 2, i)
        assert part["mrope_positions"].shape == (3, 2, 16)
        for k in batch:
            assert np.array_equal(part[k].numpy(), np.asarray(split[k][i])), k
    jstate = jax.tree.map(np.asarray, jsteps.init_train_state(
        jcfg, jax.random.PRNGKey(0)))
    state = train_state_from_jax(cfg, jstate, init_train_state(
        cfg, torch.Generator().manual_seed(1))["params"])
    _, jmet = jax.jit(jsteps.make_train_step(jcfg))(
        jax.tree.map(jnp.asarray, jstate), jax.tree.map(jnp.asarray, batch),
        {"lr": jnp.asarray(LR, jnp.float32)})
    _, met = make_train_step(cfg)(state, tb, {"lr": LR})
    _close(met["loss"], jmet["loss"], 1e-5, "loss")
    _close(met["grad_norm"], jmet["grad_norm"], 1e-5, "grad_norm")


def test_vlm_loss_and_every_gradient_match_jax_value_and_grad():
    jcfg, cfg = jax_smoke_config(ARCH), smoke_config(ARCH)
    batch = batch_for(jcfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                       batch_size=4), 3)
    batch["mrope_positions"] = grid_positions(4, 32, 8)
    jstate = jax.tree.map(np.asarray, jsteps.init_train_state(
        jcfg, jax.random.PRNGKey(0)))
    state = train_state_from_jax(cfg, jstate, init_train_state(
        cfg, torch.Generator().manual_seed(1))["params"])

    def f(p):
        return JT.train_loss(jcfg, p, batch)[0]

    want_loss, want = jax.jit(jax.value_and_grad(f))(jstate["params"])
    loss, _, grads = loss_and_grads(cfg, state["params"], {
        k: torch.as_tensor(np.array(v)) for k, v in batch.items()})
    _close(loss, want_loss, 1e-5, "loss")
    want = params_from_jax(jax.tree.map(np.asarray, want))
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert bool((g != 0).any()), n
        # the key bias's gradient is 0 in exact arithmetic (it shifts a
        # row's logits uniformly): rounding noise on both sides, held to
        # the limit of the query bias's gradient beside it
        atol = 1e-4 * float(np.abs(want[n.replace("k.bias", "q.bias")])
                            .max()) if n.endswith("attn.k.bias") else 0.0
        _close(g, want[n], 1e-4, f"grad {n}", atol=atol)
