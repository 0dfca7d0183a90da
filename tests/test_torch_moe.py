"""The port's MoE FFN (``repro_torch/models/moe.py``) against the
reference's (``repro/models/moe.py``) on the CPU, on the same params and
inputs from numpy seeds: the router's expert ids exactly and its weights
and aux loss within 1e-6; the sort and dense dispatches within 1e-4 in
fp32; at a capacity that drops tokens, the dropped set identical to the
reference's (``jnp.argsort`` is stable, so ``torch.argsort`` must be); the
twins of the reference's two MoE consistency tests; the padded expert
layout; the MoE family's loss, aux loss and every gradient against
``jax.value_and_grad``; and one Adafactor step on the smoke kimi-k2 (its
4-D expert leaves, factored per layer and expert) against the
reference's.

Limits: route weights and aux 1e-6 (fp32 softmax of the same logits); the
FFN outputs 1e-4 (fp32 products in another order); the loss 1e-5 relative,
every gradient 1e-4 of its tensor's largest, as ``test_torch_train.py``."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import moe as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.interop import (flatten, params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.launch.steps import (abstract_train_state,  # noqa: E402
                                      init_train_state, loss_and_grads,
                                      make_train_step)
from repro_torch.models import moe as M  # noqa: E402

ARCH = "granite-moe-3b-a800m"
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


def _moe_pair(cfg, seed=3):
    """The reference's ``moe_init`` params and the port's MoE module
    holding them."""
    p = jax.tree.map(np.asarray, JM.moe_init(jax.random.PRNGKey(seed), cfg,
                                             jnp.float32))
    mod = M.MoE(torch.Generator().manual_seed(0), smoke_config(ARCH),
                torch.float32)
    with torch.no_grad():
        for name, arr in p.items():
            getattr(mod, name).copy_(torch.as_tensor(np.array(arr)))
    return p, mod


def _x(cfg, scale=0.5, b=2, s=32, seed=4):
    return (np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)) * scale).astype(np.float32)


@pytest.fixture(scope="module")
def granite():
    cfg = jax_smoke_config(ARCH)
    p, mod = _moe_pair(cfg)
    return cfg, smoke_config(ARCH), p, mod


def test_route_matches_reference(granite):
    jcfg, cfg, p, mod = granite
    x2d = _x(jcfg).reshape(-1, jcfg.d_model)
    jw, jidx, jaux = JM.route(p, jnp.asarray(x2d), jcfg)
    w, idx, aux = M.route(mod, torch.as_tensor(x2d), cfg)
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    _close(w, jw, 0.0, "weights", atol=1e-6)
    _close(aux, jaux, 0.0, "aux", atol=1e-6)


@pytest.mark.parametrize("dispatch", ["sort", "dense"])
def test_dispatch_matches_reference(granite, dispatch):
    jcfg, cfg, p, mod = granite
    x = _x(jcfg)
    jfn = {"sort": JM.moe_ffn_sort, "dense": JM.moe_ffn_dense}[dispatch]
    fn = {"sort": M.moe_ffn_sort, "dense": M.moe_ffn_dense}[dispatch]
    jy, jaux = jfn(p, jnp.asarray(x), jcfg)
    y, aux = fn(mod, torch.as_tensor(x), cfg)
    _close(y, jy, 0.0, dispatch, atol=1e-4)
    _close(aux, jaux, 0.0, "aux", atol=1e-6)
    # moe_ffn picks by cfg.moe.dispatch (no mesh: no expert parallelism)
    c = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                         dispatch=dispatch))
    assert torch.equal(M.moe_ffn(mod, torch.as_tensor(x), c)[0], y)


def _reference_ranks(idx, num_e):
    """The reference's ranks, one top-k slot at a time with its running
    counts: [T,k]."""
    counts = jnp.zeros(num_e, jnp.int32)
    ranks = []
    for kk in range(idx.shape[1]):
        rank, counts = JM._rank_in_expert(jnp.asarray(idx[:, kk], jnp.int32),
                                          counts, num_e)
        ranks.append(np.asarray(rank))
    return np.stack(ranks, 1)


def test_capacity_drops_the_same_tokens_as_the_reference(granite):
    """At capacity factor 0.25 most assignments are dropped: the ranks
    (the port's all-slot stable sort against the reference's slot-by-slot
    one), the kept (token, slot) set they decide and the outputs equal the
    reference's. Ties in expert id are the rule here, so an unstable sort
    would rank (and drop) other tokens."""
    jcfg, cfg, p, mod = granite
    x = _x(jcfg, scale=1.0)
    _, idx, _ = M.route(mod, torch.as_tensor(x.reshape(-1, jcfg.d_model)),
                        cfg)
    e, k = cfg.moe.num_experts, cfg.moe.top_k
    cap = M.capacity(idx.shape[0], cfg, 0.25)
    assert cap == int(max(1, (idx.shape[0] * k * 0.25) // e))
    ranks = _reference_ranks(idx.numpy(), e)
    assert np.array_equal(M._rank_in_expert(idx).numpy(), ranks)
    want = ranks < cap
    assert 0 < want.sum() < want.size          # drops happen, not all
    jy, _ = JM.moe_ffn_sort(p, jnp.asarray(x), jcfg, capacity_factor=0.25)
    y, _ = M.moe_ffn_sort(mod, torch.as_tensor(x), cfg, capacity_factor=0.25)
    _close(y, jy, 0.0, "dropped dispatch", atol=1e-4)
    # a dropped token's slot adds nothing: rows whose every slot was
    # dropped are zero on both sides
    none = ~want.any(1)
    assert none.any() and not y.reshape(-1, cfg.d_model)[none].any()
    assert not np.asarray(jy).reshape(-1, cfg.d_model)[none].any()


@pytest.mark.parametrize("t,k,e", [(1, 8, 40), (7, 2, 4), (300, 8, 40)])
def test_ranks_equal_the_reference_slot_by_slot(t, k, e):
    """Random routings, one token (the decode step) included."""
    rng = np.random.default_rng(t)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(t)])
    got = M._rank_in_expert(torch.as_tensor(idx))
    assert np.array_equal(got.numpy(), _reference_ranks(idx, e))


def test_moe_sort_matches_dense_oracle(granite):
    """Twin of test_models_consistency.py::test_moe_sort_matches_dense_oracle:
    with capacity for every token, sort equals the all-experts oracle."""
    _, cfg, _, mod = granite
    x = torch.as_tensor(_x(cfg))
    with torch.no_grad():
        yd, auxd = M.moe_ffn_dense(mod, x, cfg)
        ys, auxs = M.moe_ffn_sort(mod, x, cfg, capacity_factor=8.0)
    assert float((ys - yd).abs().max()) < 1e-4
    assert abs(float(auxd) - float(auxs)) < 1e-6


def test_moe_capacity_drops_tokens_but_stays_finite(granite):
    """Twin of the reference's test of the same name."""
    _, cfg, _, mod = granite
    y, _ = M.moe_ffn_sort(mod, torch.as_tensor(_x(cfg, scale=1.0)), cfg,
                          capacity_factor=0.25)
    assert bool(torch.isfinite(y).all())


def test_padded_expert_layout():
    """granite's 40 experts are stored as 48 (a multiple of EP_SHARDS), as
    the reference stores them; the router has the 40 true logits only; one
    decode token has capacity 1; the full config's stored params are the
    reference's count with the padding (no allocation: meta tensors)."""
    cfg = get_config(ARCH)
    assert M._epad(cfg.moe.num_experts) == 48
    assert M.capacity(1, cfg) == 1
    params = abstract_train_state(cfg)["params"]
    moe = params.layers[0].moe
    assert tuple(moe.up.shape) == (48, cfg.d_model, cfg.moe.expert_ff)
    assert tuple(moe.down.shape) == (48, cfg.moe.expert_ff, cfg.d_model)
    assert tuple(moe.router.shape) == (cfg.d_model, 40)
    assert moe.router.dtype == torch.float32
    jparams = jax.eval_shape(lambda: JT.init_params(
        jax_get_config(ARCH), jax.random.PRNGKey(0)))
    want = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(jparams))
    assert sum(p.numel() for p in params.parameters()) == want


# ------------------------------------------------------------- training
def _batch(cfg, shard=3):
    return batch_for(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     batch_size=4), shard)


def _tbatch(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def _states(jcfg, cfg):
    jstate = jax.tree.map(np.asarray, jsteps.init_train_state(
        jcfg, jax.random.PRNGKey(0)))
    state = init_train_state(cfg, torch.Generator().manual_seed(1))
    return jstate, train_state_from_jax(cfg, jstate, state["params"])


@pytest.mark.parametrize("remat", [False, True])
def test_moe_loss_aux_and_every_gradient_match_jax_value_and_grad(remat):
    """The loss with its aux term, the aux loss summed over the layers,
    and every gradient (the router's through the aux loss and the gates);
    with remat the aux loss leaves each layer's checkpoint too."""
    jcfg = jax_smoke_config(ARCH)
    cfg = dataclasses.replace(smoke_config(ARCH), remat=remat)
    batch = _batch(jcfg)
    jstate, state = _states(jcfg, cfg)

    def f(p):
        return JT.train_loss(jcfg, p, batch)

    (want_loss, jmet), want = jax.jit(jax.value_and_grad(f, has_aux=True))(
        jstate["params"])
    loss, met, grads = loss_and_grads(cfg, state["params"], _tbatch(batch))
    _close(loss, want_loss, 1e-5, "loss")
    _close(met["aux_loss"], jmet["aux_loss"], 1e-5, "aux_loss")
    assert float(met["aux_loss"]) > 0
    want = params_from_jax(jax.tree.map(np.asarray, want))
    assert set(grads) == set(want)
    for n, g in grads.items():
        if ".moe." in n and n.split(".")[-1] in ("up", "gate", "down"):
            # the padding experts get no tokens, so no gradient
            assert not bool(g[cfg.moe.num_experts:].any()), n
            g, w = g[:cfg.moe.num_experts], want[n][:cfg.moe.num_experts]
        else:
            w = want[n]
        assert bool((g != 0).any()), n
        _close(g, w, 1e-4, f"grad {n}")


def test_adafactor_step_on_expert_leaves_matches_reference():
    """kimi-k2 selects Adafactor, and so does its smoke config: its stacked
    4-D expert leaves [L, E_pad, d, f] are factored over (d, f) for each
    layer and expert, as the reference factors them."""
    jcfg, cfg = jax_smoke_config("kimi-k2-1t-a32b"), \
        smoke_config("kimi-k2-1t-a32b")
    assert cfg.optimizer == "adafactor" and cfg.moe is not None
    batch = _batch(jcfg)
    jstate, state = _states(jcfg, cfg)
    jnew, jmet = jax.jit(jsteps.make_train_step(jcfg))(
        jax.tree.map(jnp.asarray, jstate), jax.tree.map(jnp.asarray, batch),
        {"lr": jnp.asarray(LR, jnp.float32)})
    new, met = make_train_step(cfg)(state, _tbatch(batch), {"lr": LR})
    jnew = jax.tree.map(np.asarray, jnew)
    _close(met["loss"], jmet["loss"], 1e-5, "loss")
    _close(met["grad_norm"], jmet["grad_norm"], 1e-5, "grad_norm")
    vr = new["opt"]["inner"]["layers/moe/up"]["vr"]
    assert tuple(vr.shape) == jnew["opt"]["inner"]["layers"]["moe"]["up"][
        "vr"].shape == (cfg.num_layers, 16, cfg.d_model)
    for key, arr in flatten(jnew["opt"]["inner"]).items():
        leaf, stat = key.rsplit("/", 1)
        _close(new["opt"]["inner"][leaf][stat], arr, 1e-4, key)
    want = params_from_jax(jnew["params"])
    for n, p in new["params"].named_parameters():
        _close(p, want[n], 0.0, f"params {n}", atol=1e-2 * LR)
