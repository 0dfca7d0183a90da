"""The dropless MoE's grouped product forward (``kernels.ops.grouped_mm``:
``torch._grouped_mm`` on the card): x [M,K] in G groups of rows, each
times its own w[g] [K,N]: 2 M K N operations; x, w and the group ends read
once and the [M,N] result written once.

A traced run wraps every entry the kernel files declare, in every cell. A
checkout whose port has no such entry (one from before the dropless MoE)
is given a stand-in that raises if it is ever called, so that its traced
runs can wrap it; no model of such a port calls it.
"""
from __future__ import annotations

OP = "grouped_mm"               # its entry in repro_torch.kernels.ops
LABEL = "grouped_mm"
NODE = "GroupedMm"              # its backward node, GroupedMmBackward0


def _absent(*a, **k):
    raise NotImplementedError(f"this port has no kernels.ops.{OP}")


def _give_the_port_an_entry() -> None:
    try:
        from repro_torch.kernels import ops
    except ImportError:
        return
    if not hasattr(ops, OP):
        setattr(ops, OP, _absent)


_give_the_port_an_entry()


def shape(x, w, offs):
    """``count``'s keywords of a call of the entry."""
    return {"m": x.shape[0], "k": x.shape[1], "n": w.shape[-1],
            "g": w.shape[0], "dtype": str(x.dtype).replace("torch.", "")}


def count(m, k, n, g, dtype):
    """(operations, bytes, operand dtype) of one call."""
    elt = 2 if dtype in ("bfloat16", "float16") else 4
    return 2.0 * m * k * n, elt * (m * k + g * k * n + m * n) + 4.0 * g, \
        "bfloat16" if elt == 2 else "float32"
