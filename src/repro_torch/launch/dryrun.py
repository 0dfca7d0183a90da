"""Multi-pod dry run: count every (arch x shape x mesh) cell on meta tensors.

The reference lowers and compiles each cell's sharded step for 256 or 512
fake XLA devices. The port has nothing to lower: it joins
``torch.distributed``'s ``fake`` backend as rank 0 of a world of 256 or 512
(``sharding.init_fake_ranks``, before anything builds a mesh), builds the
production mesh on it, and runs the cell's sharded step once on meta
tensors (``launch.steps.shape_cells``), counted per device by
``analysis.roofline.count_cell``: FLOPs (matrix products), bytes accessed,
transcendentals, collectives (kind, count, bytes, link bytes) and a memory
record with the reference's keys. Each invocation handles one cell and
writes a JSON record with the reference's keys; ``lower_s`` is the seconds
to build the cell (state, params and inputs on meta), ``compile_s`` those
of the counted step. The fake group is process-wide: one world per
process.

Attention takes the chunked schedule (``attn_impl="chunked"``, as the
reference's production lowering does; ``--packed-causal`` halves it). The
card runs the flash kernel, whose working set is smaller: the memory
record follows the chunked schedule.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
      --shape train_4k --mesh single   [--out results/dryrun_torch]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all  # full grid
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Optional

from repro_torch.configs import ARCH_IDS, SHAPES, cell_status, get_config
from repro_torch.configs.base import MULTI_POD, SINGLE_POD


def input_specs(arch: str, shape_name: str):
    """Meta-tensor stand-ins for every model input of this cell."""
    from repro_torch.models.registry import (decode_input_specs,
                                             prefill_input_specs,
                                             train_input_specs)
    cfg, shape = get_config(arch), SHAPES[shape_name]
    if shape.kind == "train":
        return train_input_specs(cfg, shape)
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape)
    return prefill_input_specs(cfg, shape)


def join_world(multi_pod: bool) -> None:
    """Joins the fake world of the production mesh's size, once a process."""
    import torch.distributed as dist
    from repro_torch.sharding import init_fake_ranks
    world = (MULTI_POD if multi_pod else SINGLE_POD).num_devices
    if not dist.is_initialized():
        init_fake_ranks(world)
    if dist.get_world_size() != world:
        raise RuntimeError(f"this process has joined a world of "
                           f"{dist.get_world_size()}, not {world}")


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: pathlib.Path, *, packed_causal: bool = False,
             tag: str = "", cfg=None, shape=None, mesh=None) -> dict:
    """One cell's record. ``cfg``, ``shape`` and ``mesh`` replace the
    arch's config, the named shape and the production mesh (a smoke
    config on a small mesh); without ``mesh`` the process joins the
    production world."""
    from repro_torch.analysis.roofline import count_cell
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import shape_cells

    cfg = cfg if cfg is not None else get_config(arch)
    shape = shape if shape is not None else SHAPES[shape_name]
    mesh_name = "multipod_2x16x16" if multi_pod else "pod_16x16"
    cell_id = f"{arch}__{shape_name}__{mesh_name}" + (f"__{tag}" if tag else "")
    rec: dict = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                 "tag": tag, "status": None}

    status = cell_status(cfg, shape)
    if status != "run":
        rec["status"] = status
        _write(out_dir, cell_id, rec)
        return rec

    # large-shape-safe attention + loss chunking for the production count
    cfg = dataclasses.replace(cfg, attn_impl="chunked",
                              packed_causal=packed_causal)
    try:
        if mesh is None:
            join_world(multi_pod)
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
        t0 = time.time()
        cell = shape_cells(cfg, shape, mesh)
        t1 = time.time()
        c = count_cell(cell)
        t2 = time.time()
        coll = c["collectives"]
        rec.update({
            "status": "ok",
            "lower_s": round(t1 - t0, 2),
            "compile_s": round(t2 - t1, 2),
            "memory": _mem_dict(c["memory"]),
            "flops": c["flops"],
            "bytes_accessed": c["bytes"],
            "transcendentals": c["transcendentals"],
            "collectives": {
                "counts": coll.counts,
                "bytes_by_kind": coll.bytes_by_kind,
                "total_bytes": coll.total_bytes,
                "link_bytes_per_chip": coll.link_bytes(mesh.size()),
            },
            "num_devices": mesh.size(),
        })
        print(f"[dryrun] {cell_id}: OK "
              f"(build {rec['lower_s']}s count {rec['compile_s']}s, "
              f"flops {rec['flops']:.3e})")
        print(f"[dryrun] {cell_id} memory: {rec['memory']}")
    except Exception as e:  # noqa: BLE001 — record the failure, keep the grid
        rec["status"] = f"error: {type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] {cell_id}: FAILED {type(e).__name__}: {e}")
    _write(out_dir, cell_id, rec)
    return rec


def _mem_dict(mem: dict) -> dict:
    """The reference's memory keys, in its order, ints."""
    keys = ("argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "alias_size_in_bytes", "per_device_total")
    return {k: int(mem[k]) for k in keys if mem.get(k) is not None}


def _write(out_dir: pathlib.Path, cell_id: str, rec: dict):
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell_id}.json").write_text(json.dumps(rec, indent=2))


def main(argv: Optional[list] = None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--packed-causal", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--out", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)

    if args.all:
        # one world a process: the single-pod grid (run again with
        # --all --mesh multi for the multi-pod one)
        for arch in ARCH_IDS:
            for shape in SHAPES:
                run_cell(arch, shape, args.mesh == "multi", out)
        return
    assert args.arch and args.shape, "--arch/--shape required without --all"
    run_cell(args.arch, args.shape, args.mesh == "multi", out,
             packed_causal=args.packed_causal, tag=args.tag)


if __name__ == "__main__":
    main()
