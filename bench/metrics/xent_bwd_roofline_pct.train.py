"""The loss chunk's cross-entropy backward's share of its roofline in the
traced train window, its time that of the ``xent_*`` kernels launched
inside ``CrossEntropyFn``'s backward node, less the recomputed forward's
entry (``bench/kernels/xent_bwd.py``)."""
from benchlib.roofline import share_pct


def read(obs):
    return share_pct(obs, "xent", "xent_bwd", backward=True)
