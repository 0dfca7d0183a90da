"""The SSD scan forward's share of its roofline in the traced train
window, its time read through ``kernels.ops.ssd_scan``."""
from benchlib.roofline import share_pct


def read(obs):
    return share_pct(obs, "ssd", "ssd_fwd")
