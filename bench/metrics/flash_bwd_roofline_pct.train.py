"""The flash attention backward's share of its roofline in the traced
train window, its time read through ``FlashAttentionFn``'s backward
node."""
from benchlib.roofline import share_pct


def read(obs):
    return share_pct(obs, "flash", "flash_bwd", backward=True)
