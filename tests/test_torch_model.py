"""The port's dense decoder against the reference's on converted params:
prefill logits and cache, then five decode steps, within 1e-4 (fp32 smoke
config; the difference is summation order)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import smoke_config as jax_smoke_config  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.configs import ARCH_IDS, get_config, smoke_config  # noqa: E402
from repro_torch.interop import flatten, load_jax_params, params_from_jax  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402

TOL = 1e-4


@pytest.fixture(scope="module")
def pair():
    cfg = jax_smoke_config("qwen2-0.5b")
    params = JT.init_params(cfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    tcfg = smoke_config("qwen2-0.5b")
    model = TT.init_params(tcfg, torch.Generator().manual_seed(1))
    load_jax_params(model, np_params)
    return cfg, params, tcfg, model, np_params


def test_configs_are_copied_unchanged():
    for arch in ("qwen2-0.5b", "glm4-9b", "mamba2-1.3b",
                 "recurrentgemma-9b", "granite-moe-3b-a800m", "qwen2-vl-2b",
                 "seamless-m4t-large-v2", "kimi-k2-1t-a32b"):
        assert repr(get_config(arch)) == repr(jax_get_config(arch))
    for arch in ("qwen2-0.5b", "mamba2-1.3b", "recurrentgemma-9b",
                 "granite-moe-3b-a800m", "qwen2-vl-2b",
                 "seamless-m4t-large-v2", "kimi-k2-1t-a32b"):
        assert repr(smoke_config(arch)) == repr(jax_smoke_config(arch))


def test_params_from_flat_and_nested_agree(pair):
    _, _, _, model, np_params = pair
    nested, flat = params_from_jax(np_params), params_from_jax(
        flatten(np_params))
    assert nested.keys() == flat.keys() == model.state_dict().keys()
    for key in nested:
        assert torch.equal(nested[key], flat[key])
    # [in, out] weights arrive transposed to nn.Linear's [out, in]
    assert np.array_equal(model.layers[1].attn.q.weight.detach().numpy(),
                          np_params["layers"]["attn"]["q"]["w"][1].T)


def test_prefill_and_decode_match_reference(pair):
    cfg, params, tcfg, model, _ = pair
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    jl, jc = JT.prefill(cfg, params, {"tokens": jnp.asarray(tokens)}, 32)
    with torch.no_grad():
        tl, tc = TT.prefill(tcfg, model, {"tokens": torch.as_tensor(tokens)},
                            32)
    assert tl.shape == (2, 1, cfg.vocab_size)
    assert np.abs(np.asarray(jl) - tl.numpy()).max() < TOL
    for name in ("k", "v"):
        assert np.abs(np.asarray(jc["layers"][name])
                      - tc["layers"][name].numpy()).max() < TOL
    assert int(tc["idx"]) == int(jc["idx"]) == 13
    for _ in range(5):
        nxt = np.argmax(np.asarray(jl)[:, -1], -1)[:, None].astype(np.int32)
        jl, jc = JT.decode_step(cfg, params, jnp.asarray(nxt), jc)
        with torch.no_grad():
            tl, tc = TT.decode_step(tcfg, model, torch.as_tensor(nxt), tc)
        assert np.abs(np.asarray(jl) - tl.numpy()).max() < TOL
    assert int(tc["idx"]) == int(jc["idx"]) == 18


def test_every_arch_builds():
    """Every family is ported: each ARCH_IDS entry's bundle initialises the
    reference's param tree (the same leaves, shapes and count) and its
    cache."""
    from repro.models import build_model as jax_build_model
    for arch in ARCH_IDS:
        cfg = smoke_config(arch)
        m = build_model(cfg)
        params = m.init(torch.Generator().manual_seed(0))
        want = params_from_jax(jax.tree.map(np.asarray, jax_build_model(
            jax_smoke_config(arch)).init(jax.random.PRNGKey(0))))
        sd = params.state_dict()
        assert sd.keys() == want.keys(), arch
        assert all(sd[k].shape == want[k].shape for k in want), arch
        cache = m.init_cache(2, 8, "cpu")
        assert int(cache["idx"]) == 0
