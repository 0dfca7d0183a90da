"""The flash attention forward's share of its roofline in the traced
train window, its time read through ``kernels.ops.flash_attention``."""
from benchlib.roofline import share_pct


def read(obs):
    return share_pct(obs, "flash", "flash_fwd")
