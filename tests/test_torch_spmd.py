"""The port's sharded steps on 8 gloo ranks against the reference's sharded
steps on 8 XLA CPU devices, both on a ("data", "model") = (4, 2) mesh.

The reference side runs in one subprocess (the device-count flag must
precede jax's start), on a mesh of Auto axes: jax 0.9 makes Explicit axes
by default, and the reference's ``_cast_params_pinned`` then refuses its
own sharding constraint (its ``tests/test_sharding_rules.py`` SPMD test
fails so). It trains one step each of the smoke configs of granite (TP +
EP + FSDP), recurrentgemma (TP of the RG-LRU and heads), qwen2-0.5b (DP
only, its vocab widened to 16,384 so that the table's moments pass ZeRO-1's
2^20 elements; granite in two microbatches) and seamless (the enc-dec sites), each sharded by the rules
of its full config; granite also at capacity factor 100, sharded and on one
device; then granite's sharded prefill and two decode steps, and its
``moe_ffn`` alone (the EP path); then qwen2's prefill and decode steps
from a cache split on its sequence. The port side is one spawn of 8 gloo
ranks on the same params (``params_from_jax``) and inputs. Both runs are
shared by the whole file.

The sharded MoE step does not compute the one-device step: each data
shard's capacity comes from its own tokens (``moe_ffn_ep``), so at the
default capacity factor the two drop different tokens. At capacity factor
100 nothing is dropped, and the sharded step equals the one-device one.
"""
import dataclasses
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys
import textwrap
import traceback

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.interop import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
MESH = (4, 2)
WORLD = MESH[0] * MESH[1]
BATCH, SEQ, LR = 8, 32, 1e-3
PROMPT, DECODE_STEPS = 12, 2
CF_ALL = 100.0           # a capacity factor at which nothing is dropped
CASES = {
    # two microbatches: their gradients summed before one reduction
    "granite": ("granite-moe-3b-a800m", {"microbatches": 2}),
    "recurrentgemma": ("recurrentgemma-9b", {}),
    "qwen2": ("qwen2-0.5b", {"vocab_size": 16384}),
    "seamless": ("seamless-m4t-large-v2", {}),
}
GC_CASE = "qwen2"        # also one step with int8 gradient compression
# qwen2 (DP only) serves from a cache long enough to be split on its
# sequence over "model" (``cache_shardings``: 4096 positions or more, KV
# heads not split), with a batch that the data dim alone splits
LONG_CASE, LONG_LEN, LONG_BATCH = "qwen2", 4096, 4
TIMEOUT_S = 300
REL = 1e-5
SPEC = {"mesh": MESH, "batch": BATCH, "seq": SEQ, "lr": LR,
        "prompt": PROMPT, "decode_steps": DECODE_STEPS, "cf_all": CF_ALL,
        "cases": CASES, "gc_case": GC_CASE, "long_case": LONG_CASE,
        "long_len": LONG_LEN, "long_batch": LONG_BATCH}

# ---------------------------------------------------------------------------
# the reference's sharded steps (one subprocess)
# ---------------------------------------------------------------------------
REF_CODE = textwrap.dedent("""
    import os, sys, json, dataclasses
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "src")
    import numpy as np, jax, jax.numpy as jnp
    from repro.configs import SHAPES, get_config, smoke_config
    from repro.launch import shardrules as SR
    from repro.launch import steps as ST
    from repro.models import moe as RM
    from repro.models.registry import build_model
    from repro.sharding import use_rules

    spec = json.loads(sys.argv[1])
    out_path = sys.argv[2]
    mesh = jax.make_mesh(tuple(spec["mesh"]), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=spec["seq"],
                                global_batch=spec["batch"])
    out = {}

    def save(prefix, tree):
        for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            key = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                           for k in path)
            out[prefix + key] = np.asarray(leaf)

    def set_cf(cf):
        RM.moe_ffn_ep.__defaults__ = (cf,)
        RM.moe_ffn_sort.__defaults__ = (cf,)

    def batch_for(cfg, rng):
        b, s = spec["batch"], spec["seq"]
        if cfg.family == "encdec":
            tok = rng.integers(0, cfg.vocab_size, (b, s // 2 + 1))
            return {"frames": rng.standard_normal(
                        (b, s, cfg.d_model)).astype(np.float32),
                    "tokens": tok[:, :-1].astype(np.int32),
                    "labels": tok[:, 1:].astype(np.int32)}
        tok = rng.integers(0, cfg.vocab_size, (b, s + 1))
        return {"tokens": tok[:, :-1].astype(np.int32),
                "labels": tok[:, 1:].astype(np.int32)}

    def sds(tree):
        return {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
                for k, v in tree.items()}

    def setup(arch, upd, gc=False):
        cfg = dataclasses.replace(smoke_config(arch), **upd)
        rules = SR.make_rules(get_config(arch), shape, mesh)
        return cfg, rules, ST.init_train_state(cfg, jax.random.PRNGKey(0),
                                               grad_compression=gc)

    def step(name, cfg, rules, state, batch, gc=False):
        knobs = {"lr": jnp.float32(spec["lr"])}
        if rules is None:
            new, met = jax.jit(ST.make_train_step(cfg))(state, batch, knobs)
        else:
            with mesh:
                st_sh = ST.train_state_shardings(cfg, rules, state)
                b_sh = SR.batch_shardings(cfg, rules, sds(batch))
                new, met = jax.jit(
                    ST.make_train_step(cfg, rules, grad_compression=gc),
                    in_shardings=(st_sh, b_sh, None),
                    out_shardings=(st_sh, None))(state, batch, knobs)
        save(name + "/new/", new["params"])
        save(name + "/m/", new["opt"]["inner"]["m"])
        for k, v in met.items():
            out[name + "/metric/" + k] = np.asarray(v)

    for name, (arch, upd) in spec["cases"].items():
        cfg, rules, state = setup(arch, upd)
        batch = batch_for(cfg, np.random.default_rng(1))
        save(name + "/param/", state["params"])
        for k, v in batch.items():
            out[name + "/batch/" + k] = v
        step(name, cfg, rules, state, batch)
        if name == "granite":
            set_cf(spec["cf_all"])
            step("granite_cf/sharded", cfg, rules, state, batch)
            step("granite_cf/one", cfg, None, state, batch)
            set_cf(1.25)
        if name == spec["gc_case"]:
            cfg, rules, state = setup(arch, upd, gc=True)
            step(name + "_gc", cfg, rules, state, batch, gc=True)

    # granite: prefill, decode steps, and moe_ffn alone, sharded
    cfg, rules, state = setup(*spec["cases"]["granite"])
    params = state["params"]
    model = build_model(cfg)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, cfg.vocab_size,
                          (spec["batch"], spec["prompt"])).astype(np.int32)
    max_len = spec["prompt"] + spec["decode_steps"] + 1
    dt = jnp.dtype(cfg.dtype)

    def prefill(p, b):
        with use_rules(rules):
            return model.prefill(ST._cast_tree(p, dt), b, max_len)

    def decode(p, t, c):
        with use_rules(rules):
            return model.decode_step(ST._cast_tree(p, dt), t, c)[0]

    with mesh:
        p_sh = SR.param_shardings(cfg, rules, params)
        b = {"tokens": prompt}
        b_sh = SR.batch_shardings(cfg, rules, sds(b))
        logits, _ = jax.jit(prefill, in_shardings=(p_sh, b_sh))(params, b)
        tok, cache = jax.jit(ST.make_prefill_step(cfg, rules, max_len),
                             in_shardings=(p_sh, b_sh))(params, b)
        c_sh = SR.cache_shardings(cfg, rules, jax.eval_shape(lambda: cache))
        t_sh = rules.sharding("batch", None)
        serve = jax.jit(ST.make_serve_step(cfg, rules),
                        in_shardings=(p_sh, t_sh, c_sh, None),
                        out_shardings=(t_sh, c_sh, None))
        dec = jax.jit(decode, in_shardings=(p_sh, t_sh, c_sh))
        tok, cache = jax.device_put(tok, t_sh), jax.device_put(cache, c_sh)
        out["serve/prompt"] = prompt
        out["serve/prefill_logits"] = np.asarray(logits)[:, -1]
        out["serve/tok0"] = np.asarray(tok)
        for i in range(spec["decode_steps"]):
            out[f"serve/logits{i}"] = np.asarray(dec(params, tok, cache))[:, -1]
            tok, cache, lp = serve(params, tok, cache, jax.random.PRNGKey(0))
            out[f"serve/tok{i + 1}"] = np.asarray(tok)
            out[f"serve/lp{i}"] = np.asarray(lp)

        p0 = jax.tree.map(lambda a: a[0], params["layers"]["moe"])
        x = rng.standard_normal((spec["batch"], spec["seq"], cfg.d_model)
                                ).astype(np.float32)

        def moe(p, x):
            with use_rules(rules):
                return RM.moe_ffn(p, x, cfg)
        y, aux = jax.jit(moe)(p0, x)
        out["moe/x"], out["moe/out"], out["moe/aux"] = x, np.asarray(y), \\
            np.asarray(aux)
    # qwen2: its long cache split on the sequence over "model"
    arch, upd = spec["cases"][spec["long_case"]]
    lshape = dataclasses.replace(SHAPES["decode_32k"], seq_len=spec["prompt"],
                                 global_batch=spec["long_batch"])
    cfg, rules, state = setup(arch, upd)
    rules = SR.make_rules(get_config(arch), lshape, mesh)
    params = state["params"]
    prompt = rng.integers(0, cfg.vocab_size, (spec["long_batch"],
                                              spec["prompt"])).astype(np.int32)
    with mesh:
        p_sh = SR.param_shardings(cfg, rules, params)
        b = {"tokens": prompt}
        b_sh = SR.batch_shardings(cfg, rules, sds(b))
        tok, cache = jax.jit(ST.make_prefill_step(cfg, rules, spec["long_len"]),
                             in_shardings=(p_sh, b_sh))(params, b)
        c_sh = SR.cache_shardings(cfg, rules, jax.eval_shape(lambda: cache))
        t_sh = rules.sharding("batch", None)
        serve = jax.jit(ST.make_serve_step(cfg, rules),
                        in_shardings=(p_sh, t_sh, c_sh, None),
                        out_shardings=(t_sh, c_sh, None))
        tok, cache = jax.device_put(tok, t_sh), jax.device_put(cache, c_sh)
        out["long/prompt"] = prompt
        out["long/cache_spec"] = np.array(str(tuple(c_sh["layers"]["k"].spec)))
        out["long/tok0"] = np.asarray(tok)
        for i in range(spec["decode_steps"]):
            tok, cache, lp = serve(params, tok, cache, jax.random.PRNGKey(0))
            out[f"long/tok{i + 1}"] = np.asarray(tok)
            out[f"long/lp{i}"] = np.asarray(lp)
    # which rows and columns each device holds under a spec of two mesh
    # dims on one tensor dim, and of one mesh dim on each
    from jax.sharding import NamedSharding, PartitionSpec as P
    for tag, pspec in (("flat", P(("data", "model"), None)),
                       ("two", P("data", "model"))):
        idx = NamedSharding(mesh, pspec).devices_indices_map((8, 4))
        starts = np.zeros((4, 2, 2), np.int64)
        for i in range(4):
            for j in range(2):
                r, c = idx[mesh.devices[i, j]]
                starts[i, j] = (r.start or 0, c.start or 0)
        out["layout/" + tag] = starts
    np.savez(out_path, **out)
    print(json.dumps({"devices": jax.device_count(), "keys": len(out)}))
""")


def _run_reference(out_path: str) -> None:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", REF_CODE, json.dumps(SPEC),
                          out_path], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["devices"] == 8


# ---------------------------------------------------------------------------
# the port's sharded steps (8 spawned gloo ranks)
# ---------------------------------------------------------------------------
def _sub(ref, prefix):
    return {k[len(prefix):]: ref[k] for k in ref.files if k.startswith(prefix)}


def _port_rank(rank, port, ref_path, out_dir):
    """One rank: every case's sharded step, granite's serve and moe_ffn;
    rank 0 writes the results (whole tensors) to ``out_dir``; every rank
    writes its traceback there if it fails."""
    try:
        torch.set_num_threads(1)
        _port_rank_body(rank, port, ref_path, out_dir)
    except BaseException:
        with open(os.path.join(out_dir, f"fail{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def _port_rank_body(rank, port, ref_path, out_dir):
    import torch.distributed as dist

    from repro_torch.configs import SHAPES, get_config, smoke_config
    from repro_torch.interop import load_jax_params
    from repro_torch.launch import shardrules as SR
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import (cast_params, distribute_train_state,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)
    from repro_torch.models import moe as M
    from repro_torch.models.registry import build_model
    from repro_torch.sharding import from_full, full_tensor, init_ranks, \
        use_rules

    init_ranks(rank, WORLD, port, "cpu")
    mesh = make_mesh(MESH, ("data", "model"), "cpu")
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=SEQ,
                                global_batch=BATCH)
    ref = np.load(ref_path)
    out = {}

    def set_cf(cf):     # as the reference side sets it
        M.moe_ffn_ep.__defaults__ = (cf,)
        M.moe_ffn_sort.__defaults__ = (cf,)

    def setup(name, gc=False):
        arch, upd = CASES[name]
        cfg = dataclasses.replace(smoke_config(arch), **upd)
        rules = SR.make_rules(get_config(arch), shape, mesh)
        params = build_model(cfg).init(torch.Generator().manual_seed(0))
        load_jax_params(params, _sub(ref, f"{name}/param/"))
        state = distribute_train_state(cfg, rules,
                                       params.requires_grad_(True), gc)
        return cfg, rules, state

    def step(name, tag, cfg, rules, state, gc=False):
        batch = {k: torch.as_tensor(v)
                 for k, v in _sub(ref, f"{name}/batch/").items()}
        new, met = make_train_step(cfg, rules, grad_compression=gc)(
            state, batch, {"lr": LR})
        for n, p in new["params"].named_parameters():
            out[f"{tag}/new/{n}"] = full_tensor(p.detach()).numpy()
        named = dict(new["params"].named_parameters())
        for n, m in new["opt"]["inner"]["m"].items():
            out[f"{tag}/placements/m/{n}"] = np.array(str(m.placements))
            out[f"{tag}/placements/param/{n}"] = np.array(
                str(named[n].placements))
        for k, v in met.items():
            out[f"{tag}/metric/{k}"] = np.asarray(float(v))

    for name in CASES:
        cfg, rules, state = setup(name)
        step(name, name, cfg, rules, state)
        if name == "granite":
            set_cf(CF_ALL)
            cfg, rules, state = setup(name)
            step(name, "granite_cf/sharded", cfg, rules, state)
            set_cf(1.25)
        if name == GC_CASE:
            cfg, rules, state = setup(name, gc=True)
            step(name, name + "_gc", cfg, rules, state, gc=True)

    # granite's prefill and decode steps, then moe_ffn alone
    cfg, rules, state = setup("granite")
    params = cast_params(state["params"], cfg.dtype)
    prompt = torch.as_tensor(ref["serve/prompt"])
    max_len = PROMPT + DECODE_STEPS + 1
    model = build_model(cfg)
    with torch.no_grad():
        with use_rules(rules):
            from repro_torch.launch.steps import place_inputs
            logits, _ = model.prefill(
                params, place_inputs(cfg, rules, {"tokens": prompt}), max_len)
            out["serve/prefill_logits"] = full_tensor(logits)[:, -1].numpy()
        tok, cache = make_prefill_step(cfg, rules, max_len)(
            params, {"tokens": prompt})
        out["serve/tok0"] = tok.numpy()
        serve = make_serve_step(cfg, rules)
        for i in range(DECODE_STEPS):
            copy = {"layers": {k: v.clone()
                               for k, v in cache["layers"].items()},
                    "idx": cache["idx"].clone()}
            with use_rules(rules):
                lg, _ = model.decode_step(
                    params, place_inputs(cfg, rules, {"tokens": tok})[
                        "tokens"], copy)
                out[f"serve/logits{i}"] = full_tensor(lg)[:, -1].numpy()
            tok, cache, lp = serve(params, tok, cache)
            out[f"serve/tok{i + 1}"] = tok.numpy()
            out[f"serve/lp{i}"] = lp.numpy()
        with use_rules(rules):
            x = from_full(torch.as_tensor(ref["moe/x"]), mesh,
                          rules.placements("batch", None, None))
            y, aux = M.moe_ffn(state["params"].layers[0].moe, x, cfg)
            out["moe/out"] = full_tensor(y).numpy()
            out["moe/aux"] = np.asarray(float(full_tensor(aux)))
    # qwen2 from a cache split on its sequence over "model"
    arch, upd = CASES[LONG_CASE]
    cfg, _, state = setup(LONG_CASE)
    rules = SR.make_rules(get_config(arch), dataclasses.replace(
        SHAPES["decode_32k"], seq_len=PROMPT, global_batch=LONG_BATCH), mesh)
    params = cast_params(state["params"], cfg.dtype)
    tok, cache = make_prefill_step(cfg, rules, LONG_LEN)(
        params, {"tokens": torch.as_tensor(ref["long/prompt"])})
    out["long/cache_placements"] = np.array(
        str(cache["layers"]["k"].placements))
    out["long/tok0"] = tok.numpy()
    serve = make_serve_step(cfg, rules)
    for i in range(DECODE_STEPS):
        tok, cache, lp = serve(params, tok, cache)
        out[f"long/tok{i + 1}"] = tok.numpy()
        out[f"long/lp{i}"] = lp.numpy()
    # the rows and columns this rank holds, by its mesh coordinates
    from repro_torch.sharding import placements_for
    whole = torch.arange(8 * 4).reshape(8, 4)
    for tag, spec in (("flat", (("data", "model"), None)),
                      ("two", ("data", "model"))):
        first = int(from_full(whole, mesh, placements_for(mesh, spec))
                    .to_local()[0, 0])
        got = [None] * WORLD
        dist.all_gather_object(got, (mesh.get_coordinate(), first))
        starts = np.zeros((4, 2, 2), np.int64)
        for (i, j), f in got:
            starts[i, j] = (f // 4, f % 4)
        out["layout/" + tag] = starts
    dist.barrier()
    if rank == 0:
        np.savez(os.path.join(out_dir, "port.npz"), **out)
    dist.destroy_process_group()


def _run_port(ref_path: str, out_dir: str) -> None:
    from repro_torch.sharding import free_port
    ctx = multiprocessing.get_context("spawn")
    port = free_port()
    procs = [ctx.Process(target=_port_rank, args=(r, port, ref_path, out_dir))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = TIMEOUT_S
    import time
    t0 = time.monotonic()
    for p in procs:
        p.join(max(1.0, deadline - (time.monotonic() - t0)))
    alive = [p for p in procs if p.is_alive()]
    for p in alive:
        p.kill()
        p.join(10)
    fails = sorted(pathlib.Path(out_dir).glob("fail*.txt"))
    assert not fails, fails[0].read_text()[-3000:]
    assert not alive, f"{len(alive)} ranks did not finish in {TIMEOUT_S} s"
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("spmd")
    ref_path = str(d / "ref.npz")
    _run_reference(ref_path)
    _run_port(ref_path, str(d))
    return np.load(ref_path), np.load(d / "port.npz")


def _rel(got, want):
    return abs(float(got) - float(want)) / max(abs(float(want)), 1e-30)


def _check_step(ref, got, ref_tag, port_tag, name, m_tag=None):
    """Loss and grad norm to ``REL``; every param after the step within
    ``REL`` of its leaf's largest, or 1e-2 lr where that is less (a leaf
    that starts at zero, a bias, is one update large, and an update moves
    by a share of lr where its gradient is small: ``test_torch_train``'s
    limit), but where the reference's first moment is unresolved (below
    1e-4 of its largest: a gradient at rounding level, whose update's sign
    either side may flip, so 2 lr)."""
    for k in ("loss", "grad_norm", "aux_loss"):
        want = ref[f"{ref_tag}/metric/{k}"]
        g = got[f"{port_tag}/metric/{k}"]
        assert _rel(g, want) <= REL or abs(float(want)) == float(g) == 0, \
            (name, k, float(g), float(want))
    want = params_from_jax(_sub(ref, f"{ref_tag}/new/"))
    m_ref = params_from_jax(_sub(ref, f"{m_tag or ref_tag}/m/"))
    for n, w in want.items():
        g = torch.as_tensor(got[f"{port_tag}/new/{n}"]).double()
        w = w.double()
        m = m_ref[n].double().abs()
        tol = torch.where(m >= 1e-4 * m.max(),
                          max(REL * float(w.abs().max()), 1e-2 * LR),
                          torch.full_like(m, 2 * LR))
        if n.endswith("attn.k.bias"):   # its gradient is 0 in exact math
            tol = torch.full_like(m, 2 * LR)
        err = (g - w).abs()
        assert bool((err <= tol).all()), (name, n, float(err.max()))


@pytest.mark.parametrize("name", list(CASES) + [GC_CASE + "_gc"])
def test_sharded_train_step_matches_reference(runs, name):
    """Every case's step; ``<case>_gc`` with int8 gradient compression
    (each leaf's scale its global largest)."""
    ref, got = runs
    _check_step(ref, got, name, name, name)


def test_sharded_step_at_capacity_factor_100_is_the_one_device_step(runs):
    ref, got = runs
    _check_step(ref, got, "granite_cf/sharded", "granite_cf/sharded",
                "cf sharded")
    _check_step(ref, got, "granite_cf/one", "granite_cf/sharded",
                "cf one device", m_tag="granite_cf/one")
    # at the default capacity the shards drop other tokens than one device
    assert _rel(ref["granite/metric/loss"],
                ref["granite_cf/one/metric/loss"]) > 1e-5


def test_zero1_shards_the_replicated_moments_over_data(runs):
    _, got = runs
    # qwen2 is DP only: its params are replicated; the table's moments
    # (16,384 x 64 = 2^20 elements) are split over "data", the smaller
    # leaves' are not
    rep = "(Replicate(), Replicate())"
    assert str(got["qwen2/placements/param/embed.weight"]) == rep
    assert str(got["qwen2/placements/m/embed.weight"]) == \
        "(Shard(dim=0), Replicate())"
    assert str(got["qwen2/placements/m/layers.0.mlp.up.weight"]) == rep
    # granite's experts are split over "model" (EP) and "data" (FSDP),
    # and so are their moments
    assert str(got["granite/placements/param/layers.0.moe.up"]) == \
        "(Shard(dim=1), Shard(dim=0))"
    assert str(got["granite/placements/m/layers.0.moe.up"]) == \
        "(Shard(dim=1), Shard(dim=0))"


def test_sharded_prefill_and_decode_match_reference(runs):
    ref, got = runs
    for i in range(DECODE_STEPS + 1):
        np.testing.assert_array_equal(got[f"serve/tok{i}"],
                                      ref[f"serve/tok{i}"])
    for key in ["serve/prefill_logits"] + [f"serve/logits{i}"
                                           for i in range(DECODE_STEPS)]:
        want = ref[key]
        err = np.abs(got[key] - want).max()
        assert err <= REL * np.abs(want).max(), (key, err)
    for i in range(DECODE_STEPS):
        np.testing.assert_allclose(got[f"serve/lp{i}"], ref[f"serve/lp{i}"],
                                   rtol=REL, atol=REL)


def test_decode_from_a_cache_split_on_its_sequence_matches_reference(runs):
    """qwen2's cache of 4096 positions is split on its sequence over
    "model" on both sides; each rank writes the new positions that fall in
    its slice, and the decode's tokens and log-probs are the reference's."""
    ref, got = runs
    assert str(ref["long/cache_spec"]) == \
        "(None, 'data', 'model', None, None)"
    assert str(got["long/cache_placements"]) == \
        "(Shard(dim=1), Shard(dim=2))"
    for i in range(DECODE_STEPS + 1):
        np.testing.assert_array_equal(got[f"long/tok{i}"],
                                      ref[f"long/tok{i}"])
    for i in range(DECODE_STEPS):
        np.testing.assert_allclose(got[f"long/lp{i}"], ref[f"long/lp{i}"],
                                   rtol=REL, atol=REL)


def test_moe_ffn_ep_matches_reference(runs):
    ref, got = runs
    want = ref["moe/out"]
    err = np.abs(got["moe/out"] - want).max()
    assert err <= REL * np.abs(want).max(), err
    assert _rel(got["moe/aux"], ref["moe/aux"]) <= REL


@pytest.mark.parametrize("tag", ["flat", "two"])
def test_each_rank_holds_the_rows_of_the_jax_device(runs, tag):
    """Under P(("data", "model"), None) (the batch over both dims, data
    major) and P("data", "model"), the rank at each mesh coordinate holds
    the rows and columns that the JAX device at the same coordinates
    holds."""
    ref, got = runs
    np.testing.assert_array_equal(got["layout/" + tag], ref["layout/" + tag])
