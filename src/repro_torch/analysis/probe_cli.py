"""Roofline depth-probe CLI: one (arch x shape) cell per process (single-pod
mesh by default, ``--multi`` for the multi-pod one).

The process joins ``torch.distributed``'s fake backend at the mesh's world
(256 or 512) before anything builds a mesh (``launch.dryrun.join_world``);
the fake group is process-wide, so one cell's world per process.

    PYTHONPATH=src python -m repro_torch.analysis.probe_cli \\
        --arch qwen2-0.5b --shape train_4k   [--out results/roofline_torch]
"""
import argparse
import json
import pathlib
import traceback


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi", action="store_true")
    ap.add_argument("--out", default="results/roofline_torch")
    args = ap.parse_args(argv)

    from repro_torch.analysis.roofline import analyze_cell
    from repro_torch.configs import SHAPES, cell_status, get_config
    from repro_torch.launch.dryrun import join_world

    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    mesh_name = "multipod_2x16x16" if args.multi else "pod_16x16"
    cell = f"{args.arch}__{args.shape}__{mesh_name}"
    status = cell_status(get_config(args.arch), SHAPES[args.shape])
    if status != "run":
        rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
               "status": status}
    else:
        try:
            join_world(args.multi)
            rec = analyze_cell(args.arch, args.shape, args.multi)
            rec["status"] = "ok"
            t = rec["terms"]
            print(f"[roofline] {cell}: compute {t['compute_s']*1e3:.2f}ms "
                  f"memory {t['memory_s']*1e3:.2f}ms "
                  f"collective {t['collective_s']*1e3:.2f}ms "
                  f"-> {t['bottleneck']}; "
                  f"MFU {rec['roofline_fraction']*100:.1f}% "
                  f"useful {rec['useful_ratio']*100:.1f}%")
        except Exception as e:  # noqa: BLE001
            rec = {"arch": args.arch, "shape": args.shape, "mesh": mesh_name,
                   "status": f"error: {type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-3000:]}
            print(f"[roofline] {cell}: FAILED {e}")
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=2))


if __name__ == "__main__":
    main()
