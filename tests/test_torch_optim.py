"""The port's optimizers against the reference's (``repro/optim``), over 3
steps, on the reference's layer-stacked param tree and the port's
per-layer split of it (params, grads and state cross over through
``interop``). The tree is a 2-layer dense decoder at d_model 1024, d_ff
2048, so that it has stacked ``[L, d]`` leaves (norm scales, q/k/v
biases), stacked leaves below ``2**22`` elements (attention) and at it
(the MLP's ``[2, 1024, 2048]``, which the reference updates layer by layer),
and leaves that are not stacked (the table, the final norm).

Limit: 1e-6 of each tensor's largest magnitude. Both sides compute in fp32;
the means and norms over a leaf sum in another order."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models.registry import build_model as jax_build_model  # noqa: E402
from repro.optim import adafactor as jadafactor  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.optim import clipping as jclipping  # noqa: E402
from repro.optim import compression as jcompression  # noqa: E402
from repro.optim.schedule import cosine_warmup as jax_cosine_warmup  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.interop import (flatten, load_jax_params,  # noqa: E402
                                 opt_state_from_jax, params_from_jax,
                                 reference_leaves)
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.optim.adafactor import _STACK_MAP_MIN, adafactor_init  # noqa: E402
from repro_torch.optim.adafactor import adafactor_update  # noqa: E402
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: E402
from repro_torch.optim.clipping import clip_by_global_norm  # noqa: E402
from repro_torch.optim.compression import compress_grads, init_error  # noqa: E402
from repro_torch.optim.schedule import cosine_warmup  # noqa: E402

REL_TOL = 1e-6
STEPS = 3


def _cfgs():
    upd = dict(d_model=1024, d_ff=2048, vocab_size=64, glu=False)
    return (dataclasses.replace(jax_smoke_config("qwen2-0.5b"), **upd),
            dataclasses.replace(smoke_config("qwen2-0.5b"), **upd))


@pytest.fixture(scope="module")
def tree():
    jcfg, cfg = _cfgs()
    jparams = jax.tree.map(np.asarray,
                           jax.jit(jax_build_model(jcfg).init)(
                               jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    grads = [jax.tree.map(lambda p: rng.standard_normal(
        p.shape, dtype=np.float32) * np.float32(10.0 ** rng.uniform(-3, 0)),
        jparams) for _ in range(STEPS)]
    return cfg, jparams, grads


def _port(cfg, jparams):
    mod = build_model(cfg).init(torch.Generator().manual_seed(1))
    return load_jax_params(mod, jparams)


def _close(got: torch.Tensor, want, what):
    want = torch.as_tensor(np.array(want))
    got = got.detach()
    assert got.shape == want.shape, what
    tol = REL_TOL * max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max())
    assert err <= tol, (what, err, tol)


def _close_params(mod, jtree, what):
    want = params_from_jax(jax.tree.map(np.asarray, jtree))
    for n, p in mod.named_parameters():
        _close(p, want[n].numpy(), f"{what} {n}")


def test_the_tree_has_every_kind_of_leaf(tree):
    cfg, jparams, _ = tree
    flat = flatten(jparams)
    assert flat["layers/ln1/scale"].shape == (2, 1024)         # [L, d]
    assert flat["layers/attn/q/b"].ndim == 2                    # [L, out]
    assert flat["layers/attn/q/w"].size < _STACK_MAP_MIN        # below
    assert flat["layers/mlp/up/w"].size >= _STACK_MAP_MIN       # at 2**22
    groups = reference_leaves(_port(cfg, jparams))
    assert groups["layers/mlp/up/w"] == [("layers.0.mlp.up.weight", True),
                                         ("layers.1.mlp.up.weight", True)]
    assert groups["embed/table"] == [("embed.weight", False)]


def test_adamw_matches_reference(tree):
    cfg, jparams, grads = tree
    mod = _port(cfg, jparams)
    state = adamw_init(mod)
    jp, js = jparams, jadamw.adamw_init(jparams)
    for i, g in enumerate(grads):
        step = jnp.asarray(i + 1, jnp.int32)
        jp, js, _ = jax.jit(jadamw.adamw_update)(jp, g, js, step, 1e-2, 0.5)
        adamw_update(mod, params_from_jax(g), state,
                     torch.tensor(i + 1, dtype=torch.int32), 1e-2,
                     gscale=0.5)
        _close_params(mod, jp, f"step {i + 1} params")
        for mom in ("m", "v"):
            want = params_from_jax(jax.tree.map(np.asarray, js[mom]))
            for n, t in state[mom].items():
                _close(t, want[n].numpy(), f"step {i + 1} {mom} {n}")


def test_adafactor_matches_reference(tree):
    cfg, jparams, grads = tree
    mod = _port(cfg, jparams)
    state = adafactor_init(mod)
    jp, js = jparams, jadafactor.adafactor_init(jparams)
    # the factored [L, d] leaves: one row moment per layer, one column
    # moment shared by the layers
    assert state["layers/ln1/scale"]["vr"].shape == (2,)
    assert state["layers/ln1/scale"]["vc"].shape == (1024,)
    assert set(state["final_norm/scale"]) == {"v"}
    for i, g in enumerate(grads):
        step = jnp.asarray(i + 1, jnp.int32)
        jp, js, _ = jax.jit(jadafactor.adafactor_update)(jp, g, js, step,
                                                         1e-2, 0.5)
        _, state, _ = adafactor_update(mod, params_from_jax(g), state,
                                       torch.tensor(i + 1, dtype=torch.int32),
                                       1e-2, gscale=0.5)
        _close_params(mod, jp, f"step {i + 1} params")
        for key, arr in flatten(jax.tree.map(np.asarray, js)).items():
            leaf, stat = key.rsplit("/", 1)
            _close(state[leaf][stat], arr, f"step {i + 1} {key}")


def test_optimizer_state_crosses_over(tree):
    """``interop.opt_state_from_jax`` carries the reference's state into the
    port's layout, for both optimizers."""
    cfg, jparams, grads = tree
    mod = _port(cfg, jparams)
    for kind, init, update in (
            ("adamw", jadamw.adamw_init, jadamw.adamw_update),
            ("adafactor", jadafactor.adafactor_init,
             jadafactor.adafactor_update)):
        js = init(jparams)
        _, js, _ = jax.jit(update)(jparams, grads[0], js,
                                  jnp.asarray(1, jnp.int32), 1e-2)
        opt = {"step": np.asarray(1, np.int32), "inner": js}
        got = opt_state_from_jax(dataclasses.replace(cfg, optimizer=kind),
                                 jax.tree.map(np.asarray, opt), mod)
        assert int(got["step"]) == 1
        if kind == "adamw":
            want = params_from_jax(jax.tree.map(np.asarray, js["m"]))
            for n, t in got["inner"]["m"].items():
                assert torch.equal(t, want[n])
        else:
            for key, arr in flatten(jax.tree.map(np.asarray, js)).items():
                leaf, stat = key.rsplit("/", 1)
                assert np.array_equal(got["inner"][leaf][stat].numpy(), arr)


def test_clip_by_global_norm_matches_reference(tree):
    _, _, grads = tree
    for g in grads:
        jg, jnorm = jax.jit(jclipping.clip_by_global_norm)(g, 1.0)
        pg, pnorm = clip_by_global_norm(params_from_jax(g), max_norm=1.0)
        _close(pnorm, jnorm, "norm")
        want = params_from_jax(jax.tree.map(np.asarray, jg))
        for n, t in pg.items():
            _close(t, want[n].numpy(), f"clipped {n}")


def test_cosine_warmup_matches_reference():
    for step in (0, 1, 50, 99, 100, 101, 5000, 9999, 10_000, 20_000):
        for kw in ({}, dict(peak_lr=1e-3, warmup=10, total=200,
                            min_ratio=0.0)):
            _close(cosine_warmup(step, **kw), jax_cosine_warmup(step, **kw),
                   f"step {step} {kw}")


def test_compress_grads_matches_reference(tree):
    """int8 with error feedback over 3 steps: the scale is the max over the
    reference's stacked leaf, so over both layers' tensors."""
    cfg, jparams, grads = tree
    mod = _port(cfg, jparams)
    groups = reference_leaves(mod)
    err = init_error(mod)
    jerr = jcompression.init_error(jparams)
    for i, g in enumerate(grads):
        jg, jerr = jcompression.compress_grads(g, jerr)
        pg, err = compress_grads(params_from_jax(g), err, groups)
        for what, got, want in (("grads", pg, jg), ("error", err, jerr)):
            want = params_from_jax(jax.tree.map(np.asarray, want))
            for n, t in got.items():
                _close(t, want[n].numpy(), f"step {i + 1} {what} {n}")
