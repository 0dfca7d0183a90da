"""Twins of the reference's per-arch smoke tests (``tests/test_models_smoke.py``)
and of ``tests/test_models_consistency.py::test_decode_matches_full_forward``
for the port, over every ``ARCH_IDS`` entry, on the CPU at the smoke
configs. Beyond the reference's shape and finiteness checks, each arch's
loss and its prefill and decode logits are held against the reference's on
the same (converted) params and inputs, which covers every family and the
dense configs no other port test serves (starcoder2-7b's LayerNorm, plain
GELU MLP and untied head, glm4-9b, command-r-plus).

Limits: the loss 1e-5 relative and the logits 1e-4 (fp32, sums in another
order); decode against the full forward 2e-3, the reference's own limit."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import ARCH_IDS, smoke_config  # noqa: E402
from repro_torch.interop import load_jax_params  # noqa: E402
from repro_torch.launch.steps import init_train_state, make_train_step  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

B, S = 2, 32


def _batch(cfg, seed=1):
    """The reference smoke test's batch, made with numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": (rng.standard_normal((B, 24, cfg.d_model)) * 0.1)
                .astype(np.float32),
                "tokens": np.ones((B, 16), np.int32),
                "labels": np.ones((B, 16), np.int32)}
    batch = {"labels": np.ones((B, S), np.int32)}
    if cfg.embed_stub:
        batch["embeds"] = (rng.standard_normal((B, S, cfg.d_model)) * 0.1) \
            .astype(np.float32)
    else:
        batch["tokens"] = np.ones((B, S), np.int32)
    if cfg.mrope:
        batch["mrope_positions"] = np.broadcast_to(
            np.arange(S, dtype=np.int32)[None, None], (3, B, S)).copy()
    return batch


def _tbatch(b):
    return {k: torch.as_tensor(v) for k, v in b.items()}


def _pair(arch):
    jcfg, cfg = jax_smoke_config(arch), smoke_config(arch)
    jm, m = jax_build_model(jcfg), build_model(cfg)
    jp = jm.init(jax.random.PRNGKey(0))
    params = m.init(torch.Generator().manual_seed(0))
    load_jax_params(params, jax.tree.map(np.asarray, jp))
    return jm, jp, m, params


def _close(got, want, atol, what):
    err = float(np.abs(np.asarray(want, np.float32)
                       - got.detach().float().numpy()).max())
    assert err < atol, (what, err)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_forward_and_train_step(arch):
    cfg = smoke_config(arch)
    jm, jp, m, params = _pair(arch)
    batch = _batch(cfg)
    want, _ = jax.jit(jm.train_loss)(jp, batch)
    loss, metrics = m.train_loss(params, _tbatch(batch))
    assert loss.shape == () and bool(torch.isfinite(loss)), (arch, loss)
    assert abs(float(loss) - float(want)) <= 1e-5 * abs(float(want))
    # one full train step (grads + optimizer)
    state = init_train_state(cfg, torch.Generator().manual_seed(0))
    before = [p.detach().clone() for p in state["params"].parameters()]
    state, met = make_train_step(cfg)(state, _tbatch(batch), {"lr": 1e-3})
    assert bool(torch.isfinite(met["loss"]))
    assert bool(torch.isfinite(met["grad_norm"])) and \
        float(met["grad_norm"]) > 0
    delta = sum(float((a - b).abs().sum()) for a, b in
                zip(before, state["params"].parameters()))
    assert delta > 0


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_prefill_decode(arch):
    cfg = smoke_config(arch)
    jm, jp, m, params = _pair(arch)
    batch = _batch(cfg)
    batch.pop("labels")
    jl, jc = jax.jit(lambda p, b: jm.prefill(p, b, S + 8))(jp, batch)
    with torch.no_grad():
        logits, cache = m.prefill(params, _tbatch(batch), S + 8)
    assert logits.shape[-1] == cfg.vocab_size
    assert bool(torch.isfinite(logits).all())
    _close(logits, jl, 1e-4, "prefill")
    nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
    jl2, jc2 = jax.jit(jm.decode_step)(jp, jnp.asarray(nxt), jc)
    idx = int(cache["idx"])
    with torch.no_grad():
        logits2, cache2 = m.decode_step(params, torch.as_tensor(nxt), cache)
    assert logits2.shape == (B, 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits2).all())
    assert int(cache2["idx"]) == idx + 1 == int(jc2["idx"])
    _close(logits2, jl2, 1e-4, "decode")


DECODER_ARCHS = [a for a in ARCH_IDS if smoke_config(a).family != "encdec"]


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decode_matches_full_forward(arch):
    """Twin of the reference's test of the same name (MoE at the dense
    dispatch: the sort's capacity depends on the token count), here for
    every decoder-only arch."""
    cfg = smoke_config(arch)
    if cfg.moe:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch="dense"))
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0))
    b, s = 2, 16
    rng = np.random.default_rng(1)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (b, s + 1))
                             .astype(np.int32))
    if cfg.embed_stub:
        emb = torch.as_tensor(rng.standard_normal((b, s + 1, cfg.d_model))
                              .astype(np.float32) * 0.1)
        full, pre = {"embeds": emb}, {"embeds": emb[:, :s]}
        if cfg.mrope:
            mp = torch.arange(s + 1, dtype=torch.int32)[None, None].expand(
                3, b, s + 1)
            full["mrope_positions"], pre["mrope_positions"] = mp, mp[:, :, :s]
        last = emb[:, s:s + 1]
    else:
        full, pre = {"tokens": tokens}, {"tokens": tokens[:, :s]}
        last = tokens[:, s:s + 1]
    with torch.no_grad():
        x = T._embed_inputs(cfg, params, full)
        pos = torch.arange(s + 1)[None, :]
        x, _ = T._run_stack_train(cfg, params, x, positions=pos,
                                  mrope=full.get("mrope_positions"))
        x = params.final_norm(x)
        ref = x[:, -1] @ T._head_table(cfg, params).weight.T
        _, cache = m.prefill(params, pre, s + 4)
        got, _ = m.decode_step(params, last, cache)
    assert float((got[:, 0] - ref).abs().max()) < 2e-3
