"""Optimizers of the port: AdamW, Adafactor, clipping, int8 gradient
compression and the LR schedule, each the reference's formula
(``repro/optim``) on the port's per-layer tensors."""
from repro_torch.optim.api import OptState, apply_updates, init_opt  # noqa: F401
