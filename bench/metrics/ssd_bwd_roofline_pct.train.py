"""The SSD scan backward's share of its roofline in the traced train
window, its time read through ``SSDScanFn``'s backward node."""
from benchlib.roofline import share_pct


def read(obs):
    return share_pct(obs, "ssd", "ssd_bwd", backward=True)
