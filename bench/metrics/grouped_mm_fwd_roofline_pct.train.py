"""The dropless MoE's grouped product forward's share of its roofline in
the traced train window (its calls in the forward and in remat's
recompute), its time read through ``kernels.ops.grouped_mm``."""
from benchlib.roofline import share_pct


def read(obs):
    return share_pct(obs, "grouped_mm", "grouped_mm_fwd")
