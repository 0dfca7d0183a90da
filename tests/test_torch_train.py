"""The port's training path against the reference's on the CPU: the smoke
qwen2-0.5b (fp32) with the reference's params carried over through
``interop``, on a batch of the reference's data pipeline. The loss
(``chunked_xent``, ``train_loss``), every gradient (``jax.value_and_grad``
of the reference's cast-then-loss), and one ``make_train_step`` for AdamW,
Adafactor (the smoke command-r-plus, which selects it) and int8 gradient
compression; then microbatching and remat against the plain step, and a
loss and every gradient of the SSM and hybrid families.

Limits: the loss 1e-5 (relative; fp32, sums in another order); gradients
1e-4 of each tensor's largest magnitude; the moments 1e-4 of their largest
(they carry the gradients' error); the grad norm 1e-5; after one step the
params 1e-2 of the lr per element, where the gradient is resolved. AdamW's
first update is lr g / (|g| + 1e-8), about lr sign(g): an element whose
gradient is below the gradients' limit (1e-4 of its tensor's largest) has
no resolved sign, and is held to the update's size, 2 lr, only; so is the
key projection's bias, whose gradient is 0 in exact arithmetic (it shifts a
row's logits uniformly) and so rounding noise on both sides."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.data.pipeline import DataConfig, batch_for  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import (flatten, params_from_jax,  # noqa: E402
                                 train_state_from_jax)
from repro_torch.launch.steps import (abstract_train_state,  # noqa: E402
                                      init_train_state, loss_and_grads,
                                      make_train_step)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

LR = 3e-4
PARAM_TOL = 1e-2 * LR


def _param_tol(name, m_ref=None):
    """Per-element limit on a param after one step; ``m_ref`` the
    reference's first moment (0.1 g, scaled) when the optimizer is AdamW."""
    if name.endswith("attn.k.bias"):
        return 2.0 * LR
    if m_ref is None:
        return PARAM_TOL
    m = torch.as_tensor(m_ref).abs()
    return torch.where(m >= 1e-4 * m.max(), PARAM_TOL, 2.0 * LR).double()


def _batch(cfg, shard=3):
    return batch_for(cfg, DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     batch_size=4), shard)


def _pair(arch, **upd):
    jcfg = dataclasses.replace(jax_smoke_config(arch), **upd)
    cfg = dataclasses.replace(smoke_config(arch), **upd)
    return jcfg, cfg


def _tbatch(b):
    return {k: torch.as_tensor(np.array(v)) for k, v in b.items()}


def _states(jcfg, cfg, grad_compression=False):
    """The reference's initial train state and the port's copy of it."""
    jstate = jax.tree.map(np.asarray, jsteps.init_train_state(
        jcfg, jax.random.PRNGKey(0), grad_compression=grad_compression))
    state = init_train_state(cfg, torch.Generator().manual_seed(1),
                             grad_compression=grad_compression)
    return jstate, train_state_from_jax(cfg, jstate, state["params"])


def _close(got, want, rel, what, atol=0.0):
    """|got - want| <= max(rel * max|want|, atol) per element (atol may be
    a tensor of per-element limits)."""
    got = torch.as_tensor(got).detach().double()
    want = torch.as_tensor(np.asarray(want.detach() if isinstance(
        want, torch.Tensor) else want)).double()
    assert got.shape == want.shape, what
    tol = torch.clamp(torch.as_tensor(atol, dtype=torch.float64),
                      min=max(rel * float(want.abs().max()), 1e-30))
    err = (got - want).abs()
    assert bool((err <= tol).all()), (what, float(err.max()))


@pytest.fixture(scope="module")
def qwen():
    jcfg, cfg = _pair("qwen2-0.5b")
    return jcfg, cfg, _batch(jcfg)


def test_chunked_xent_and_train_loss_match_reference(qwen):
    jcfg, cfg, batch = qwen
    jcfg, cfg = (dataclasses.replace(c, loss_chunk=8) for c in (jcfg, cfg))
    jstate, state = _states(jcfg, cfg)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((4, 32, cfg.d_model)).astype(np.float32)
    table = jstate["params"]["embed"]["table"]
    want = jax.jit(lambda *a: JT.chunked_xent(jcfg, *a))(
        jnp.asarray(x), jnp.asarray(table), jnp.asarray(batch["labels"]))
    table = np.array(table)
    got = T.chunked_xent(cfg, torch.as_tensor(x), torch.as_tensor(table),
                         torch.as_tensor(batch["labels"]))
    _close(got, want, 1e-5, "chunked_xent")
    with pytest.raises(ValueError, match="multiple"):
        T.chunked_xent(dataclasses.replace(cfg, loss_chunk=5),
                       torch.as_tensor(x), torch.as_tensor(table),
                       torch.as_tensor(batch["labels"]))
    want, _ = jax.jit(lambda p, b: JT.train_loss(jcfg, p, b))(
        jstate["params"], batch)
    got, metrics = T.train_loss(cfg, state["params"], _tbatch(batch))
    _close(got, want, 1e-5, "train_loss")
    assert float(metrics["aux_loss"]) == 0.0


def test_every_gradient_matches_jax_value_and_grad(qwen):
    jcfg, cfg, batch = qwen
    jstate, state = _states(jcfg, cfg)

    def f(p):
        return JT.train_loss(jcfg, p, batch)[0]

    want_loss, want = jax.jit(jax.value_and_grad(f))(jstate["params"])
    loss, _, grads = loss_and_grads(cfg, state["params"], _tbatch(batch))
    _close(loss, want_loss, 1e-5, "loss")
    want = params_from_jax(jax.tree.map(np.asarray, want))
    assert set(grads) == set(want)
    for n, g in grads.items():
        assert bool((g != 0).any()), n
        _close(g, want[n], 1e-4, f"grad {n}")


def _one_step(jcfg, cfg, batch, grad_compression=False):
    jstate, state = _states(jcfg, cfg, grad_compression)
    jstep = jax.jit(jsteps.make_train_step(
        jcfg, grad_compression=grad_compression))
    jnew, jmet = jstep(jax.tree.map(jnp.asarray, jstate),
                       jax.tree.map(jnp.asarray, batch),
                       {"lr": jnp.asarray(LR, jnp.float32)})
    new, met = make_train_step(cfg, grad_compression=grad_compression)(
        state, _tbatch(batch), {"lr": LR})
    jnew = jax.tree.map(np.asarray, jnew)
    _close(met["loss"], jmet["loss"], 1e-5, "loss")
    _close(met["grad_norm"], jmet["grad_norm"], 1e-5, "grad_norm")
    want = params_from_jax(jnew["params"])
    m_ref = params_from_jax(jnew["opt"]["inner"]["m"]) \
        if cfg.optimizer == "adamw" else {}
    for n, p in new["params"].named_parameters():
        _close(p, want[n], 0.0, f"params {n}",
               atol=_param_tol(n, m_ref.get(n)))
    assert int(new["opt"]["step"]) == int(jnew["opt"]["step"]) == 1
    return jnew, new


def test_train_step_adamw_matches_reference(qwen):
    jcfg, cfg, batch = qwen
    jnew, new = _one_step(jcfg, cfg, batch)
    for mom in ("m", "v"):
        want = params_from_jax(jnew["opt"]["inner"][mom])
        for n, t in new["opt"]["inner"][mom].items():
            _close(t, want[n], 1e-4, f"{mom} {n}")


def test_train_step_adafactor_matches_reference():
    """command-r-plus selects Adafactor, and so does its smoke config."""
    jcfg, cfg = _pair("command-r-plus-104b")
    assert cfg.optimizer == "adafactor"
    jnew, new = _one_step(jcfg, cfg, _batch(jcfg))
    for key, arr in flatten(jnew["opt"]["inner"]).items():
        leaf, stat = key.rsplit("/", 1)
        _close(new["opt"]["inner"][leaf][stat], arr, 1e-4, key)


def test_train_step_with_grad_compression_matches_reference(qwen):
    jcfg, cfg, batch = qwen
    jnew, new = _one_step(jcfg, cfg, batch, grad_compression=True)
    want = params_from_jax(jnew["err"])
    for n, t in new["err"].items():
        # the error feedback is the quantization residual: one int8 code
        # step of the leaf's scale where a rounding tie goes the other way
        _close(t, want[n], 1e-2, f"err {n}")


def test_microbatches_accumulate_to_the_full_batch(qwen):
    """cfg.microbatches = 2 on the same batch: the mean of the two halves'
    gradients is the whole batch's gradient, so the step is the same."""
    _, cfg, batch = qwen
    outs = []
    for mb in (1, 2):
        c = dataclasses.replace(cfg, microbatches=mb)
        state = init_train_state(c, torch.Generator().manual_seed(0))
        outs.append(make_train_step(c)(state, _tbatch(batch), {"lr": LR}))
    (s1, m1), (s2, m2) = outs
    _close(m2["loss"], m1["loss"], 1e-5, "loss")
    _close(m2["grad_norm"], m1["grad_norm"], 1e-5, "grad_norm")
    p1 = dict(s1["params"].named_parameters())
    for n, p in s2["params"].named_parameters():
        _close(p, p1[n], 0.0, n, atol=_param_tol(n))


def test_remat_recomputes_the_same_gradients(qwen):
    """cfg.remat: each layer under torch.utils.checkpoint, its activations
    recomputed in the backward: the same loss and gradients, bit for bit
    on the CPU (the same operations in the same order)."""
    _, cfg, batch = qwen
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = init_train_state(c, torch.Generator().manual_seed(0))
        out.append(loss_and_grads(c, state["params"], _tbatch(batch)))
    (l0, _, g0), (l1, _, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_ssm_and_hybrid_training_give_a_loss_and_every_gradient():
    """The SSM and hybrid families train (held against the reference in
    tests/test_torch_train_ssm_hybrid.py): a finite loss through the
    registry's train_loss and a nonzero gradient for every parameter."""
    for arch in ("mamba2-1.3b", "recurrentgemma-9b"):
        cfg = smoke_config(arch)
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0))
        batch = _tbatch(_batch(cfg))
        loss, metrics = model.train_loss(params, batch)
        assert bool(torch.isfinite(loss)) and float(metrics["aux_loss"]) == 0
        _, _, grads = loss_and_grads(cfg, params, batch)
        assert set(grads) == {n for n, _ in params.named_parameters()}
        assert all(bool((g != 0).any()) for g in grads.values())


def test_abstract_train_state_allocates_nothing():
    from repro_torch.configs import get_config
    cfg = get_config("qwen2-0.5b")
    state = abstract_train_state(cfg)
    params = list(state["params"].parameters())
    assert all(p.device.type == "meta" for p in params)
    assert sum(p.numel() for p in params) == 494_032_768
    assert all(t.device.type == "meta" and t.dtype == torch.float32
               for t in state["opt"]["inner"]["m"].values())
