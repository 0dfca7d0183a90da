#!/usr/bin/env python3
"""Runs the ``spmd`` phase of one checkout's ``chip_smoke.py`` alone, so
that two checkouts' sharded train and serve can be compared on one card.

    python scripts/spmd_ab.py --root DIR [--label NAME]

Loads ``DIR/chip_smoke.py`` (which puts ``DIR/src`` first on the import
path) and runs its ``phase_spmd("cuda")`` with the phase's own settings:
granite-moe-3b-a800m at full width cut to 4 layers on a ("data", "model")
= (2, 2) mesh of 4 processes. The phase prints its own lines; then one
line ``AB {...}``: the label, the train's s/step, tokens/s, losses, the
collectives' host ms of the profiled step, the peak memory a rank, the
serve's prefill and decode ms, the serve check, the train check's loss
and grad norm, and the phase's seconds. Needs a CUDA card; exits 1 if the
phase fails. Compare two checkouts in one call, in turns (parent, change,
change, parent), one process each.
"""
import argparse
import json
import os
import sys
import time


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=".")
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import chip_smoke
    t0 = time.time()
    try:
        res = chip_smoke.phase_spmd("cuda")
    except Exception as e:          # the phase's failure, reported
        print("AB " + json.dumps({"label": args.label, "ok": False,
                                  "err": repr(e)[-3000:]}), flush=True)
        return 1
    tr, sv = res["train"], res["serve"]
    print("AB " + json.dumps({
        "label": args.label, "ok": True, "wall_s": time.time() - t0,
        "phase_s": res["seconds"], "s_per_step": tr["s_per_step"],
        "tokens_per_s": tr["tokens_per_s"], "losses": tr["losses"],
        "collective_host_ms": tr["collective_host_ms"],
        "collectives_top": tr["collectives_top"],
        "profiled_step_s": tr["profiled_step_s"],
        "peak_mem_bytes": res["train_peak_mem_bytes"],
        "prefill_ms": sv["prefill_ms"],
        "decode_ms_per_step": sv["decode_ms_per_step"],
        "serve_check": sv["check"], "part_seconds": res["part_seconds"],
        "train_check": {k: res["train_check"][k] for k in (
            "loss", "grad_norm", "max_grad_err_over_largest")}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
