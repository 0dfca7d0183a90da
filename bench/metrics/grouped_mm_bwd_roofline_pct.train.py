"""The grouped product backward's share of its roofline in the traced
train window, its time read through the ``GroupedMmBackward0`` nodes.

A layer calls the entry at two shapes (gate and up, then down), each once
in the forward and once in remat's recompute, and runs one backward node
for each: the nodes' calls are counted at the forward calls' shapes in
the proportion the forward calls have them (``roofline.share_pct`` takes
a backward at one forward shape only)."""
from benchlib import cells, peaks


def read(obs):
    times = obs["op_device_s"].get("grouped_mm.bwd", [])
    shapes = obs["shapes"].get("grouped_mm", [])
    if not times or not shapes or sum(times) <= 0:
        return None
    count = cells.kernel_count("grouped_mm_bwd")
    mean = sum(peaks.bound_s(*count(**s)) for s in shapes) / len(shapes)
    return 100.0 * len(times) * mean / sum(times)
