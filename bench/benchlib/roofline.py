"""A kernel's share of its roofline in a traced window: the least time the
card could take for every call of an op (its kernel file's operations and
bytes at each call's shapes, :mod:`benchlib.peaks`) over the device time
read through the op's entry (:mod:`benchlib.trace`)."""
from __future__ import annotations

from typing import Optional

import numpy as np

from benchlib import cells, peaks


def attention_pairs(s: int, skv: int, causal: bool = True,
                    window: int = 0) -> int:
    """(query, key) pairs S queries over Skv keys compute: causal, query i
    sees keys up to i; windowed, the last ``window`` of those."""
    if not causal and not window:
        return s * skv
    if causal and skv == s and (not window or window >= s):
        return s * (s + 1) // 2
    i = np.arange(s)
    hi = np.minimum(i + 1, skv) if causal else np.full(s, skv)
    lo = np.maximum(0, i - window + 1) if window else np.zeros(s, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def share_pct(obs: dict, op: str, kernel: str,
              backward: bool = False) -> Optional[float]:
    """The share in %, or None when the window holds no call of ``op``. A
    backward node carries no shapes: its calls are counted at the shape of
    the forward calls, which must then all be one shape."""
    times = obs["op_device_s"].get(op + (".bwd" if backward else ""), [])
    shapes = obs["shapes"].get(op, [])
    if not times or not shapes or sum(times) <= 0:
        return None
    count = cells.kernel_count(kernel)
    if backward:
        if any(s != shapes[0] for s in shapes):
            return None
        shapes = [shapes[0]] * len(times)
    elif len(shapes) != len(times):
        return None
    bound = sum(peaks.bound_s(*count(**s)) for s in shapes)
    return 100.0 * bound / sum(times)
