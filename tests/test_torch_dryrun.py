"""The port's dry run (``launch/dryrun.py``) on the fake backend: the input
specs against the reference's for every arch x shape (shape and dtype),
``run_cell`` on a smoke config of each family at world 8 (status ``ok``,
the reference's record keys), and one full-width ``qwen2-0.5b train_4k``
cell at world 256 through the command line (``ok``, 256 devices, its
argument bytes equal to the closed form of its local shards). The fake
group is process-wide: each world is a subprocess, both started at once."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import registry as RR  # noqa: E402
from repro.models import transformer as RT  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_config  # noqa: E402
from repro_torch.models import registry as PR  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 300
# the keys of the reference's run_cell record (src/repro/launch/dryrun.py)
RECORD_KEYS = {"arch", "shape", "mesh", "tag", "status", "lower_s",
               "compile_s", "memory", "flops", "bytes_accessed",
               "transcendentals", "collectives", "num_devices"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "alias_size_in_bytes",
               "per_device_total"}
FAMILIES = {"dense": "qwen2-0.5b", "moe": "granite-moe-3b-a800m",
            "ssm": "mamba2-1.3b", "hybrid": "recurrentgemma-9b",
            "encdec": "seamless-m4t-large-v2", "vlm": "qwen2-vl-2b"}
# smoke cells at world 8: each family's train step, and the dense model's
# serve and prefill steps
SMOKE_CELLS = [(a, "train") for a in FAMILIES.values()] + [
    ("qwen2-0.5b", "decode"), ("qwen2-0.5b", "prefill")]

SMOKE_CODE = textwrap.dedent("""
    import json, pathlib, sys
    from repro_torch.sharding import init_fake_ranks
    init_fake_ranks(8)
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    out = {}
    for arch, kind in json.loads(sys.argv[1]):
        shape = ShapeConfig("smoke_" + kind, 64, 8, kind)
        out[f"{arch}/{kind}"] = run_cell(
            arch, shape.name, False, pathlib.Path(sys.argv[2]),
            cfg=smoke_config(arch), shape=shape, mesh=mesh)
    print("JSON" + json.dumps(out))
""")


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both worlds at once: the smoke cells at 8 and the full-width cell
    at 256 (``python -m repro_torch.launch.dryrun``)."""
    out = tmp_path_factory.mktemp("dryrun")
    smoke = subprocess.Popen(
        [sys.executable, "-c", SMOKE_CODE, json.dumps(SMOKE_CELLS),
         str(out / "smoke")], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    full = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--shape", "train_4k", "--mesh", "single", "--out",
         str(out / "full")], env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        s_out, s_err = smoke.communicate(timeout=TIMEOUT_S)
        f_out, f_err = full.communicate(timeout=TIMEOUT_S)
    finally:
        for p in (smoke, full):
            if p.poll() is None:
                p.kill()
                p.wait()
    assert smoke.returncode == 0, s_err[-4000:]
    assert full.returncode == 0, f_err[-4000:]
    line = [ln for ln in s_out.splitlines() if ln.startswith("JSON")][-1]
    rec = json.loads(
        (out / "full" / "qwen2-0.5b__train_4k__pod_16x16.json").read_text())
    return {"smoke": json.loads(line[4:]), "full": rec, "full_out": f_out}


# ---------------------------------------------------------------------------
# input specs
# ---------------------------------------------------------------------------
def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tuple(tree.shape), np.dtype(str(tree.dtype).replace(
            "torch.", ""))


@pytest.mark.parametrize("arch,shape", [(a, s) for a in ARCH_IDS
                                        for s in SHAPES])
def test_input_specs_equal_reference(arch, shape):
    cfg, sh = get_config(arch), SHAPES[shape]
    ref_cfg, ref_sh = ref_get_config(arch), REF_SHAPES[shape]
    kind = sh.kind
    got = {"train": PR.train_input_specs, "decode": PR.decode_input_specs,
           "prefill": PR.prefill_input_specs}[kind](cfg, sh)
    want = {"train": RR.train_input_specs, "decode": RR.decode_input_specs,
            "prefill": RR.prefill_input_specs}[kind](ref_cfg, ref_sh)
    assert all(t.device.type == "meta" for _, t in _tensors(got))
    got_l = {k: (s, d) for k, s, d in _leaves(got)}
    want_l = {k: (s, d) for k, s, d in _leaves(want)}
    # the port's enc-dec cache also holds the decode kernel's kv length
    extra = {"/cache/cross_kv_len"} if (
        kind == "decode" and cfg.family == "encdec") else set()
    assert set(got_l) == set(want_l) | extra
    for k in want_l:
        assert got_l[k] == want_l[k], k


def _tensors(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _tensors(v, f"{prefix}/{k}")
    elif tree is not None:
        yield prefix, tree


# ---------------------------------------------------------------------------
# smoke cells at world 8
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kind", SMOKE_CELLS)
def test_smoke_cell_ok_with_reference_keys(runs, arch, kind):
    rec = runs["smoke"][f"{arch}/{kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["num_devices"] == 8
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    mem = rec["memory"]
    assert mem["per_device_total"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    if kind == "train":
        # the gradients are synced: every train step issues collectives
        assert rec["collectives"]["total_bytes"] > 0


# ---------------------------------------------------------------------------
# the full-width cell at world 256
# ---------------------------------------------------------------------------
def _zero1_local(shape, data=16):
    """Elements of a moment of a replicated reference leaf on one rank:
    ZeRO-1 splits one of 2^20 elements or more over "data" on its first
    dim that divides (``launch/shardrules.py``'s ``zero1_spec``)."""
    n = int(np.prod(shape))
    if n >= 1 << 20 and any(d % data == 0 for d in shape):
        return n // data
    return n


def test_full_width_cell_at_world_256(runs):
    """qwen2-0.5b is data-parallel only: every rank holds the fp32 params
    whole, its ZeRO-1 share of AdamW's two fp32 moments (per reference
    leaf), the step counter and its 1 of 256 rows of tokens and labels."""
    rec = runs["full"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert set(rec) == RECORD_KEYS
    assert rec["num_devices"] == 256
    assert "[dryrun] qwen2-0.5b__train_4k__pod_16x16: OK" in runs["full_out"]
    cfg = ref_get_config("qwen2-0.5b")
    leaves = jax.tree.leaves(jax.eval_shape(
        lambda: RT.init_params(cfg, jax.random.PRNGKey(0))))
    n = sum(int(np.prod(x.shape)) for x in leaves)
    moments = sum(_zero1_local(x.shape) for x in leaves)
    rows = 256 * 4096 // 256
    want = 4 * n + 2 * 4 * moments + 4 + 2 * 4 * rows
    assert rec["memory"]["argument_size_in_bytes"] == want
    assert rec["collectives"]["counts"].get("all-reduce", 0) > 0
