"""Host -> device batch placement with the step's input shardings (the
reference's ``data/sharding.py``)."""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.sharding import from_full


def place_batch(batch: Dict[str, Any], shardings: Dict[str, Any]
                ) -> Dict[str, torch.Tensor]:
    """Each field as a DTensor of its sharding's layout, made from this
    rank's rows of it (``DTensor.from_local``: the counterpart of
    ``jax.make_array_from_process_local_data``; every rank is handed the
    whole host batch, as the reference's ``device_put`` is, and keeps its
    own rows on the field's device); a field without a sharding as it
    is."""
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(np.asarray(v)) if not torch.is_tensor(v) else v
        sh = shardings.get(k)
        out[k] = t if sh is None else from_full(t, sh.mesh, sh.placements)
    return out
