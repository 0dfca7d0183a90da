"""Training of the SSM (mamba2-1.3b) and hybrid (recurrentgemma-9b) families
on the CPU, against the reference: the smoke configs with the reference's
params carried over through ``interop``, on a batch of its data pipeline
(S 32, above the hybrid's smoke window of 8, so the window bites). The loss
and every gradient against ``jax.value_and_grad`` of the reference's
cast-then-loss in fp32 and in bf16; one AdamW step; microbatches and remat
against the plain step; the window.

Limits. fp32: the loss 1e-5 (relative; sums in another order), every
gradient 1e-4 of its tensor's largest (the reference's chunked SSD and
associative RG-LRU scan against the port's sequential ones; 1.3e-5 when
this test was written), the grad norm 1e-5, after one AdamW step the params
1e-2 of the lr per element where the gradient's sign is resolved, else the
update's size (2 lr). bf16: both train steps cast every floating master
leaf to bf16 (A_log, D, dt_bias and lam included) and round the activations
to 8 bits, but at different places in the two frameworks: the loss 1e-4
relative, every gradient 5e-2 of its tensor's largest (4.4e-5 and 3.5e-2
when this test was written)."""
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
from repro_torch.interop import params_from_jax, train_state_from_jax  # noqa: E402
from repro_torch.launch.steps import (copy_params, init_train_state,  # noqa: E402
                                      loss_and_grads, make_train_step)
from repro_torch.models import transformer as T  # noqa: E402

ARCHS = ("mamba2-1.3b", "recurrentgemma-9b")
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


def _pair(arch, **upd):
    return (dataclasses.replace(jax_smoke_config(arch), **upd),
            dataclasses.replace(smoke_config(arch), **upd))


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_match_jax_value_and_grad(arch, dtype):
    jcfg, cfg = _pair(arch, dtype=dtype)
    batch = _batch(jcfg)
    jstate, state = _states(jcfg, cfg)

    def f(p):     # the reference's train step: cast every floating leaf
        return JT.train_loss(jcfg, jsteps._cast_tree(p, jnp.dtype(dtype)),
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
        _close(g, want[n], grad_tol, f"grad {n}")


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_adamw_matches_reference(arch):
    jcfg, cfg = _pair(arch)
    assert cfg.optimizer == "adamw"
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
    m_ref = params_from_jax(jnew["opt"]["inner"]["m"])
    for n, p in new["params"].named_parameters():
        m = torch.as_tensor(m_ref[n]).abs()
        tol = torch.where(m >= 1e-4 * m.max(), 1e-2 * LR, 2.0 * LR).double()
        _close(p, want[n], 0.0, f"params {n}", atol=tol)
    for mom in ("m", "v"):
        ref = params_from_jax(jnew["opt"]["inner"][mom])
        for n, t in new["opt"]["inner"][mom].items():
            _close(t, ref[n], 1e-4, f"{mom} {n}")
    assert int(new["opt"]["step"]) == 1


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatches_accumulate_to_the_full_batch(arch):
    """cfg.microbatches = 2 on the same batch: the mean of the two halves'
    gradients is the whole batch's, so the step is the same."""
    _, cfg = _pair(arch)
    batch = _tbatch(_batch(cfg))
    outs = []
    for mb in (1, 2):
        c = dataclasses.replace(cfg, microbatches=mb)
        state = init_train_state(c, torch.Generator().manual_seed(0))
        outs.append(make_train_step(c)(state, batch, {"lr": LR}))
    (s1, m1), (s2, m2) = outs
    _close(m2["loss"], m1["loss"], 1e-5, "loss")
    _close(m2["grad_norm"], m1["grad_norm"], 1e-5, "grad_norm")
    p1 = dict(s1["params"].named_parameters())
    for n, p in s2["params"].named_parameters():
        m = s1["opt"]["inner"]["m"][n].abs()
        tol = torch.where(m >= 1e-4 * m.max(), 1e-2 * LR, 2.0 * LR).double()
        _close(p, p1[n].detach(), 0.0, n, atol=tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_recomputes_the_same_gradients(arch):
    """cfg.remat: one torch.utils.checkpoint per scan body (an SSM layer; a
    hybrid group of (rec, rec, attn), then each tail layer), recomputed in
    the backward: the same loss and gradients, bit for bit on the CPU."""
    _, cfg = _pair(arch)
    if arch == "recurrentgemma-9b":     # one group and one tail layer
        cfg = dataclasses.replace(cfg, num_layers=4)
        assert T.hybrid_counts(cfg) == (1, 1)
    batch = _tbatch(_batch(cfg))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(cfg, remat=remat)
        state = init_train_state(c, torch.Generator().manual_seed(0))
        out.append(loss_and_grads(c, state["params"], batch))
    (l0, _, g0), (l1, _, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(g0[n], g1[n]) for n in g0)


def test_hybrid_window_bites_in_training():
    """S 32 against the smoke window of 8: the loss and the attention
    layer's gradients change when the window is lifted, so the window
    reaches the train path's attention (the value itself is held against
    the reference above)."""
    _, cfg = _pair("recurrentgemma-9b")
    assert cfg.rglru.window == 8
    batch = _tbatch(_batch(cfg))
    out = []
    for window in (8, 32):
        c = dataclasses.replace(cfg, rglru=dataclasses.replace(
            cfg.rglru, window=window))
        state = init_train_state(c, torch.Generator().manual_seed(0))
        out.append(loss_and_grads(c, state["params"], batch))
    (l8, _, g8), (l32, _, g32) = out
    assert abs(float(l8) - float(l32)) > 1e-4
    name = "groups.0.pos2.attn.q.weight"
    assert float((g8[name] - g32[name]).abs().max()) > \
        1e-2 * float(g32[name].abs().max())


# ------------------------------------------------------------------ card
@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ARCHS)
def test_train_gradients_on_card_match_cpu(dev, arch):
    """The smoke configs in fp32 with remat on the card, whose scans and
    attention differentiate through the backward kernels, against the same
    params on the CPU (plain versions): the loss 1e-5 relative, every
    gradient 1e-3 of its tensor's largest (chip_smoke.py's train check;
    A_log 1e-2, a sum over positions that cancels, as there); exactly one
    backward launch per layer of each kind."""
    from repro_torch.kernels import launch_counts, reset_launch_counts

    _, cfg = _pair(arch, remat=True)
    batch = _tbatch(_batch(cfg))
    host = init_train_state(cfg, torch.Generator().manual_seed(0))["params"]
    card_params = copy_params(host, lambda t: t.to(dev, copy=True))
    reset_launch_counts()
    l_card, _, g_card = loss_and_grads(
        cfg, card_params, {k: v.to(dev) for k, v in batch.items()})
    counts = launch_counts()
    l_host, _, g_host = loss_and_grads(cfg, host, batch)
    _close(l_card.cpu(), l_host, 1e-5, "loss")
    for n, g in g_host.items():
        assert bool((g_card[n] != 0).any()), n
        _close(g_card[n].cpu(), g, 1e-2 if n.endswith("A_log") else 1e-3, n)
    kinds = ({"ssd_scan_bwd": cfg.num_layers} if arch == "mamba2-1.3b" else
             {"rglru_scan_bwd": 2, "flash_attention_bwd": 1})
    for name, n in kinds.items():
        assert counts[name] == n, (name, counts[name])
