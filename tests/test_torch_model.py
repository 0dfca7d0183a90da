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
from repro_torch.configs import get_config, smoke_config  # noqa: E402
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
    for arch in ("qwen2-0.5b", "glm4-9b", "mamba2-1.3b"):
        assert repr(get_config(arch)) == repr(jax_get_config(arch))
    assert repr(smoke_config("qwen2-0.5b")) == \
        repr(jax_smoke_config("qwen2-0.5b"))


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


def test_other_families_name_their_roadmap_item():
    for arch in ("mamba2-1.3b", "recurrentgemma-9b", "granite-moe-3b-a800m"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            build_model(smoke_config(arch))
