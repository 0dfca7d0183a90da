"""The port's sharding rules (``repro_torch.launch.shardrules``) against the
reference's: twins of ``tests/test_sharding_rules.py``'s unit tests, and,
for every arch x shape x production mesh, every leaf's param, optimizer,
batch and cache spec of the port equal to the reference's, mapped through
the interop names (the layer axis of a stacked leaf dropped, a transposed
weight's two dims swapped). Both sides run on a fake mesh of the
production shape: no device is touched."""
import functools

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import ARCH_IDS as JARCH_IDS  # noqa: E402
from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.launch import shardrules as RSR  # noqa: E402
from repro.models import registry as RREG  # noqa: E402
from repro.optim import init_opt as jinit_opt  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.interop import flatten, is_stacked, jax_key  # noqa: E402
from repro_torch.launch import shardrules as SR  # noqa: E402
from repro_torch.launch.steps import abstract_train_state  # noqa: E402
from repro_torch.models.layers import Norm  # noqa: E402

MESHES = {"single_pod": {"data": 16, "model": 16},
          "multi_pod": {"pod": 2, "data": 16, "model": 16}}


class FakeMesh:
    """Just enough of the reference's Mesh for its rules."""

    def __init__(self, shape):
        self.axis_names = tuple(shape)
        self.shape = dict(shape)
        self.devices = np.empty(tuple(shape.values()), object)


class FakeDeviceMesh:
    """Just enough of a ``DeviceMesh`` for the port's rules."""

    def __init__(self, shape):
        self.mesh_dim_names = tuple(shape)
        self.shape = tuple(shape.values())


def test_fit_spec_drops_nondivisible_axes():
    mesh = FakeDeviceMesh({"data": 16, "model": 16})
    assert SR.fit_spec(mesh, ("model", "data"), (49155, 1536)) == \
        (None, "data")          # 49155 % 16 != 0 -> replicated dim
    assert SR.fit_spec(mesh, (("data", "model"), None), (256, 64)) == \
        (("data", "model"), None)
    assert SR.fit_spec(mesh, (("data", "model"), None), (128, 64)) == \
        (None, None)            # 128 % 256 != 0


def test_strategy_selection():
    assert SR.Strategy.for_arch(get_config("qwen2-0.5b")).dp_only
    assert SR.Strategy.for_arch(get_config("glm4-9b")).tp
    assert SR.Strategy.for_arch(get_config("glm4-9b")).fsdp
    st = SR.Strategy.for_arch(get_config("granite-moe-3b-a800m"))
    assert st.ep and st.tp
    st = SR.Strategy.for_arch(get_config("kimi-k2-1t-a32b"))
    assert st.ep and st.tp and st.fsdp


def test_kv_replication_rule():
    mesh = FakeDeviceMesh({"data": 16, "model": 16})
    rules = SR.make_rules(get_config("glm4-9b"), SHAPES["train_4k"], mesh)
    # kv=2 not divisible by model=16 -> replicated kv, seq-sharded cache
    assert rules.table["model_kv"] is None
    assert rules.table["model_kvseq"] == "model"
    rules = SR.make_rules(get_config("granite-moe-3b-a800m"),
                          SHAPES["train_4k"], mesh)
    assert rules.table["model_kv"] is None      # 8 kv heads over 16
    rules = SR.make_rules(get_config("granite-moe-3b-a800m"),
                          SHAPES["train_4k"], FakeDeviceMesh(
                              {"data": 2, "model": 2}))
    assert rules.table["model_kv"] == "model"


def test_rules_match_reference_tables():
    for arch in ARCH_IDS:
        for shape in SHAPES:
            for mesh in MESHES.values():
                want = RSR.make_rules(jget_config(arch), JSHAPES[shape],
                                      FakeMesh(mesh)).table
                got = SR.make_rules(get_config(arch), SHAPES[shape],
                                    FakeDeviceMesh(mesh)).table
                assert got == want, (arch, shape, mesh)


# ---------------------------------------------------------------------------
# every leaf's spec, port against reference
# ---------------------------------------------------------------------------
def _norm(ax):
    """One spec entry; a tuple of one mesh dim is that dim (JAX's
    ``PartitionSpec`` reads them alike)."""
    if isinstance(ax, tuple):
        return None if not ax else ax[0] if len(ax) == 1 else ax
    return ax


def _pad(spec, ndim):
    spec = tuple(_norm(a) for a in spec)
    return spec + (None,) * (ndim - len(spec))


@functools.lru_cache(maxsize=None)
def _reference_abstract(arch):
    cfg = jget_config(arch)
    params = jax.eval_shape(RREG.build_model(cfg).init,
                            jax.random.PRNGKey(0))
    opt = jax.eval_shape(lambda p: jinit_opt(cfg, p), params)
    return params, opt


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    return abstract_train_state(get_config(arch))


def _ref_flat(tree):
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_names(params):
    norms = {f"{mn}.bias" for mn, m in params.named_modules()
             if isinstance(m, Norm)}
    return {n: jax_key(n, p, n in norms)
            for n, p in params.named_parameters()}


def _mapped(spec, key, transposed, ndim):
    """The reference leaf's spec as the port's tensor's."""
    spec = tuple(spec)
    if is_stacked(key):
        spec = _pad(spec, ndim + 1)[1:]
    spec = _pad(spec, ndim)
    return spec[::-1] if transposed else spec


def _inputs(cfg, shape):
    if shape.kind == "train":
        return RREG.train_input_specs(cfg, shape)
    if shape.kind == "decode":
        return RREG.decode_input_specs(cfg, shape)
    return RREG.prefill_input_specs(cfg, shape)


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


@pytest.fixture
def ref_specs(monkeypatch):
    """The reference's sharding functions returning their specs (its
    ``NamedSharding`` would need real devices)."""
    monkeypatch.setattr(RSR, "NamedSharding", lambda mesh, spec: spec)
    return RSR


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_every_spec_matches_reference(ref_specs, arch, shape, mesh):
    assert arch in JARCH_IDS
    jcfg, cfg = jget_config(arch), get_config(arch)
    jrules = RSR.make_rules(jcfg, JSHAPES[shape], FakeMesh(MESHES[mesh]))
    rules = SR.make_rules(cfg, SHAPES[shape], FakeDeviceMesh(MESHES[mesh]))
    jparams, jopt = _reference_abstract(arch)
    state = _port_abstract(arch)
    params = state["params"]
    names = _port_names(params)
    ndim = {n: p.dim() for n, p in params.named_parameters()}

    # params
    want = _ref_flat(ref_specs.param_shardings(jcfg, jrules, jparams))
    got = SR.param_specs(cfg, rules, params)
    assert set(got) == set(names)
    for n, (key, transposed) in names.items():
        nd = ndim[n]
        assert _pad(got[n], nd) == _mapped(want[key], key, transposed, nd), \
            (n, key)

    # optimizer state
    want = ref_specs.opt_shardings(jcfg, jrules, jparams, jopt)
    got = SR.opt_specs(cfg, rules, params, state["opt"])
    assert tuple(want["step"]) == got["step"] == ()
    if cfg.optimizer == "adafactor":
        wflat = _ref_flat(want["inner"])
        leaves = _ref_flat(jopt["inner"])
        gflat = flatten(got["inner"])
        assert set(gflat) == set(wflat)
        for k, spec in gflat.items():
            nd = len(leaves[k].shape)
            assert _pad(spec, nd) == _pad(wflat[k], nd), k
    else:
        for mom in ("m", "v"):
            wflat = _ref_flat(want["inner"][mom])
            for n, (key, transposed) in names.items():
                nd = ndim[n]
                spec = wflat[key]
                if is_stacked(key) and _pad(spec, nd + 1)[0] is not None:
                    # ZeRO-1 on the stacked leaf's layer axis: a per-layer
                    # tensor cannot take it and stays whole
                    spec = (None,) * (nd + 1)
                assert _pad(got["inner"][mom][n], nd) == \
                    _mapped(spec, key, transposed, nd), (mom, n)

    # batch and cache
    specs = _inputs(jcfg, JSHAPES[shape])
    want = ref_specs.batch_shardings(jcfg, jrules, specs)
    got = SR.batch_shardings(cfg, rules, _shapes(specs))
    assert set(got) == set(want)
    for k in want:
        if k == "cache":
            wflat, gflat = _ref_flat(want[k]), flatten(got[k])
            leaves = _ref_flat(specs[k])
            assert set(gflat) == set(wflat)
            for p, sh in gflat.items():
                nd = len(leaves[p].shape)
                assert _pad(sh.spec, nd) == _pad(wflat[p], nd), (k, p)
        else:
            nd = len(specs[k].shape)
            assert _pad(got[k].spec, nd) == _pad(want[k], nd), k


def test_zero1_on_a_layer_axis_is_the_one_spec_that_does_not_map(ref_specs):
    """mamba2-1.3b's 48 layers over 16 data ranks: the reference shards the
    stacked in_proj moment on its layer axis; the port's per-layer moment
    stays whole there."""
    mesh = MESHES["single_pod"]
    jcfg, cfg = jget_config("mamba2-1.3b"), get_config("mamba2-1.3b")
    jrules = RSR.make_rules(jcfg, JSHAPES["train_4k"], FakeMesh(mesh))
    rules = SR.make_rules(cfg, SHAPES["train_4k"], FakeDeviceMesh(mesh))
    jparams, jopt = _reference_abstract("mamba2-1.3b")
    want = _ref_flat(ref_specs.opt_shardings(jcfg, jrules, jparams,
                                             jopt)["inner"]["m"])
    assert tuple(want["layers/mixer/in_proj/w"])[0] == "data"
    state = _port_abstract("mamba2-1.3b")
    got = SR.opt_specs(cfg, rules, state["params"], state["opt"])
    assert got["inner"]["m"]["layers.0.mixer.in_proj.weight"] == (None, None)


def test_placements_follow_the_spec():
    """One placement per mesh dim; a tuple of mesh dims on one tensor dim
    in the mesh's order (``tests/test_torch_spmd.py`` holds each rank's
    rows against the JAX device's at the same coordinates)."""
    from repro_torch.sharding import placements_for
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeDeviceMesh({"data": 4, "model": 2})
    assert placements_for(mesh, (("data", "model"), None)) == \
        (Shard(0), Shard(0))
    assert placements_for(mesh, (None, "model")) == (Replicate(), Shard(1))
    assert placements_for(mesh, ("model", "data")) == (Shard(1), Shard(0))
    with pytest.raises(ValueError, match="order"):
        placements_for(mesh, (("model", "data"),))
    with pytest.raises(ValueError, match="two tensor dims"):
        placements_for(mesh, ("data", "data"))


def test_production_mesh_needs_its_world():
    """``make_production_mesh`` refuses a world of another size (here no
    process group: one rank) and names the reference's mesh configs."""
    from repro_torch.configs import MULTI_POD, SINGLE_POD
    from repro_torch.launch import mesh as M
    for multi, want in ((False, 256), (True, 512)):
        with pytest.raises(ValueError, match=f"needs {want} ranks"):
            M.make_production_mesh(multi_pod=multi, device_type="cpu")
    assert M.mesh_config() == SINGLE_POD
    assert M.mesh_config(multi_pod=True) == MULTI_POD
