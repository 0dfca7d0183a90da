"""The loss chunk's cross-entropy forward's share of its roofline in the
traced train window, its time that of the ``xent_*`` kernels launched
inside ``kernels.ops.cross_entropy`` (``bench/kernels/xent_fwd.py``)."""
from benchlib.roofline import share_pct


def read(obs):
    return share_pct(obs, "xent", "xent_fwd")
