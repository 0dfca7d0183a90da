"""The port's collective counts (``analysis/hlo_collectives.py``): the
reference's link-bytes model on the same stats, and ``count_collectives``
on DTensor redistributions at world 8 on the fake backend (exact in kind,
count and per-device bytes), then the gradient sync of the smoke qwen2's
train step on a data-only mesh against its closed form. The fake group is
process-wide, so the world-8 runs are one subprocess; the reference's
``parse_collectives`` figure for its compiled step on the same mesh is
another, printed beside the port's (``-s``) and not asserted: the two
count different programs (XLA fuses and schedules its collectives)."""
import json
import os
import pathlib
import subprocess
import sys
import textwrap

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.analysis.hlo_collectives import CollectiveStats as RefStats  # noqa: E402
from repro_torch.analysis.hlo_collectives import CollectiveStats  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
TIMEOUT_S = 240
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")

PORT_CODE = textwrap.dedent("""
    import json, sys
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor._utils import \\
        compute_local_shape_and_global_offset
    from repro_torch.sharding import init_fake_ranks
    init_fake_ranks(8)
    from repro_torch.analysis.hlo_collectives import count_collectives
    from repro_torch.analysis.roofline import count_cell
    from repro_torch.configs import ShapeConfig, smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.steps import abstract_train_state, shape_cells

    out = {}
    mesh = make_mesh((4, 2), ("data", "model"), "cpu")
    shape = (16, 8)

    def dt(pl):
        local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
        return DTensor.from_local(torch.empty(local, device="meta"), mesh,
                                  pl, run_check=False,
                                  shape=torch.Size(shape), stride=(8, 1))

    cases = {"shard_to_replicate": ([Shard(0), Replicate()],
                                    [Replicate(), Replicate()]),
             "partial_to_replicate": ([Partial(), Replicate()],
                                      [Replicate(), Replicate()]),
             "partial_to_shard": ([Partial(), Replicate()],
                                  [Shard(0), Replicate()]),
             "shard0_to_shard1": ([Shard(0), Replicate()],
                                  [Shard(1), Replicate()])}
    for name, (src, dst) in cases.items():
        x = dt(src)
        with count_collectives() as st:
            y = x.redistribute(mesh, dst)
        out[name] = {"counts": st.counts, "bytes": st.bytes_by_kind,
                     "local_shape": list(y.to_local().shape)}

    data = make_mesh((8, 1), ("data", "model"), "cpu")
    cfg = smoke_config("qwen2-0.5b")
    c = count_cell(shape_cells(cfg, ShapeConfig("s", 32, 8, "train"), data))
    params = list(abstract_train_state(cfg)["params"].parameters())
    out["grad_sync"] = {"counts": c["collectives"].counts,
                        "bytes": c["collectives"].bytes_by_kind,
                        "n_params": sum(p.numel() for p in params),
                        "n_tensors": len(params)}
    print("JSON" + json.dumps(out))
""")

REF_CODE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, "src")
    import jax
    from repro.analysis.hlo_collectives import parse_collectives
    from repro.configs import ShapeConfig, smoke_config
    from repro.launch.steps import lower_train_step
    mesh = jax.make_mesh((8, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)
    cfg = smoke_config("qwen2-0.5b")
    st = parse_collectives(lower_train_step(
        cfg, ShapeConfig("s", 32, 8, "train"), mesh).compile().as_text())
    print("JSON" + json.dumps({"counts": st.counts,
                               "bytes": st.bytes_by_kind}))
""")


def _run(code: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=TIMEOUT_S)
    assert out.returncode == 0, out.stderr[-4000:]
    line = [ln for ln in out.stdout.splitlines() if ln.startswith("JSON")]
    return json.loads(line[-1][4:])


@pytest.fixture(scope="module")
def port():
    return _run(PORT_CODE)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("n", [1, 8, 256, 512])
def test_link_bytes_matches_reference(seed, n):
    rng = np.random.default_rng(seed)
    ref, got = RefStats(), CollectiveStats()
    for _ in range(12):
        kind = KINDS[rng.integers(len(KINDS))]
        nbytes = int(rng.integers(0, 1 << 30))
        ref.add(kind, nbytes)
        got.add(kind, nbytes)
    assert got.counts == ref.counts
    assert got.bytes_by_kind == ref.bytes_by_kind
    assert got.total_bytes == ref.total_bytes
    assert got.link_bytes(n) == ref.link_bytes(n)


# a [16, 8] fp32 tensor on a ("data", "model") = (4, 2) mesh: per device,
# each collective's result shape, as the reference's post-SPMD HLO gives it
REDISTRIBUTIONS = {
    # [4, 8] gathered to [16, 8]
    "shard_to_replicate": ({"all-gather": 1}, {"all-gather": 16 * 8 * 4},
                           [16, 8]),
    # [16, 8] summed over "data"
    "partial_to_replicate": ({"all-reduce": 1}, {"all-reduce": 16 * 8 * 4},
                             [16, 8]),
    # [16, 8] summed and scattered to [4, 8]
    "partial_to_shard": ({"reduce-scatter": 1},
                         {"reduce-scatter": 4 * 8 * 4}, [4, 8]),
    # [4, 8] rows exchanged for [16, 2] columns: one all-to-all of each
    # rank's payload
    "shard0_to_shard1": ({"all-to-all": 1}, {"all-to-all": 16 * 2 * 4},
                         [16, 2]),
}


@pytest.mark.parametrize("case", sorted(REDISTRIBUTIONS))
def test_count_collectives_exact_on_redistributions(port, case):
    counts, nbytes, local = REDISTRIBUTIONS[case]
    assert port[case]["counts"] == counts
    assert port[case]["bytes"] == nbytes
    assert port[case]["local_shape"] == local


def test_grad_sync_on_data_mesh_is_its_closed_form(port):
    """Data-parallel over 8 ranks: one all-reduce of each fp32 gradient
    (4 bytes a parameter; the smoke config has no moment large enough for
    ZeRO-1 to shard) and two of fp32 scalars (the loss and the aux loss
    made whole), and nothing else."""
    g = port["grad_sync"]
    assert g["counts"] == {"all-reduce": g["n_tensors"] + 2}
    assert g["bytes"] == {"all-reduce": 4 * g["n_params"] + 2 * 4}


def test_reference_step_on_same_mesh_counts(port, capsys):
    ref = _run(REF_CODE)
    assert ref["counts"].get("all-reduce", 0) > 0
    with capsys.disabled():
        print(f"\n[collectives] qwen2 smoke train step, (8, 1) mesh: port "
              f"{port['grad_sync']['counts']} {port['grad_sync']['bytes']}; "
              f"reference (parse_collectives) {ref['counts']} "
              f"{ref['bytes']}")
