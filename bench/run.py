"""Run one cell of BENCHMARK.json once on the card, and print its result.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds the port (``src/repro_torch``).
Set-up (process start to the window's start: imports, the kernel build on
a checkout's first run, weights, the store's backlog, the warm-up steps)
is ``setup_s``; the window then runs the cell's traffic for ``--seconds``.
With ``--trace 0`` the result's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics, read from a profile of the
window. Once the window has closed, what the timed path produced is held
against the plain reference (``correct``), and each number compared is
printed beside its limit, last on standard error and last in the result.
The last line of standard output is the result, one JSON object.

Exits 2 without a result when the card is missing or has fewer devices
than the cell asks for, and 3 when the JAX package or JAX was loaded.
"""
from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def cache_env() -> None:
    """Every build and kernel cache at a fixed place inside the checkout."""
    cache = ROOT / "build" / "bench_cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list:
    """Modules loaded in this process whose top-level name is JAX's, Flax's
    or the JAX package's (whole names: the port's own name starts with the
    JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def run(cell_name: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", t_start: float = None, spec=None,
        files=None) -> dict:
    """One run of cell ``cell_name``; returns the result. ``device``,
    ``spec`` (in place of BENCHMARK.json) and ``files`` (the directory of
    its mixes and limits) serve the benchmark's own tests."""
    import torch
    from benchlib import cells, checks

    t_start = T_START if t_start is None else t_start
    cell = cells.cell(cell_name, spec, files or cells.BENCH)
    on_card = torch.device(device).type == "cuda"
    kind = importlib.import_module(f"benchlib.{cell.mix['kind']}")
    r = kind.Run(cell, seed, device, trace)
    r.setup()
    setup_s = time.time() - t_start
    win = r.window(seconds)
    peak = max(torch.cuda.max_memory_allocated(i)
               for i in range(cell.chips)) if on_card else 0
    r.close_program()
    found = r.check()
    ok, table = checks.verdict(found, cell.limits["limits"])
    loaded = forbidden_modules()
    if loaded:
        raise ImportError(f"loaded in the run's process: {loaded}")

    metrics = {}
    if not trace:
        values = dict(r.end_to_end(win), setup_s=setup_s)
        for m in cell.end_to_end:
            if values.get(m["name"]) is not None:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = cells.metric_reader(m["name"])(win["obs"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    out = {"correct": bool(ok), "attempted": r.attempted(win),
           "failed": r.failed(win), "metrics": metrics, "device": dev}
    if trace:
        obs = win["obs"]
        dev.update(busy_s=obs["busy_s"], window_s=obs["window_s"])
        out["breakdown"] = {"device_ops": obs["device_ops"],
                            "idle_gaps": obs["idle_gaps"]}
        out["card"] = power_limit() if on_card else ""
    out["info"] = dict(r.info(win), **{k: v for k, v in found.items()
                                       if k not in table})
    out["checks"] = table
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    cache_env()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from benchlib import cells
    chips = cells.cell(a.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        print(f"bench: the cell needs {chips} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    try:
        out = run(a.workload, a.seed, a.seconds, bool(a.trace))
    except ImportError as e:
        print(f"bench: {e}", file=sys.stderr)
        return 3
    for name, v in out["checks"].items():
        print(f"check {name}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
