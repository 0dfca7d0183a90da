"""Collective ops and their byte counts, per device, for one step of the
port (the reference's ``analysis/hlo_collectives.py``).

The reference regexes the post-SPMD HLO of a compiled step for all-gather /
all-reduce / reduce-scatter / all-to-all / collective-permute and sums their
result-shape bytes. The port has no HLO, so :func:`count_collectives` is a
``TorchDispatchMode`` that records the collectives a step issues while it
runs: the functional ``_c10d_functional`` ops that DTensor's redistributions
issue, DTensor's own ``_dtensor.shard_dim_alltoall``, and the in-place
``c10d`` ops (``torch.distributed.all_reduce`` and the like). Each is
mapped to the reference's kind names and counted at the bytes of its
result shape, as the reference counts them.

Per device: the mode returns ``NotImplemented`` to every op on DTensors,
so that DTensor runs first and the mode sees the ops it issues on each
rank's local tensors, collectives among them. Their shapes are the
rank's own (a one-op check: an all-gather of a [16, 8] tensor split on
dim 0 over 4 ranks is seen as [4, 8] -> [16, 8]), as the reference's
post-SPMD HLO shapes are each device's.

Per-chip link-bytes model (ring algorithms on a 1D/2D torus):
  all-reduce:        2 * S * (n-1)/n   bytes through each chip
  all-gather:        S * (n-1)/n       (S = full gathered size)
  reduce-scatter:    S * (n-1)/n
  all-to-all:        S * (n-1)/n       (S = per-chip payload * n)
  collective-permute: S                (one hop)

The reference's ``parse_collectives`` (HLO text) has no counterpart: there
is no HLO to parse.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode


# op name (namespace-free) -> the reference's kind
_KINDS = {
    # functional collectives (DTensor's redistributions, funcol)
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    # DTensor's Shard(i) -> Shard(j)
    "shard_dim_alltoall": "all-to-all",
    # in-place c10d ops (their outputs are their first argument)
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "_dtensor",
               "c10d")


@dataclass
class CollectiveStats:
    counts: Dict[str, int] = field(default_factory=dict)
    bytes_by_kind: Dict[str, int] = field(default_factory=dict)
    total_bytes: int = 0

    def add(self, kind: str, nbytes: int):
        self.counts[kind] = self.counts.get(kind, 0) + 1
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0) + nbytes
        self.total_bytes += nbytes

    def link_bytes(self, n_devices: int) -> float:
        """Per-chip bytes through the busiest link under ring algorithms."""
        f = (n_devices - 1) / max(n_devices, 1)
        total = 0.0
        for kind, b in self.bytes_by_kind.items():
            if kind == "all-reduce":
                total += 2.0 * b * f
            elif kind == "collective-permute":
                total += float(b)
            else:
                total += b * f
        return total


def tensor_bytes(tree: Any) -> int:
    """Bytes of every tensor in ``tree`` (tensors, lists and tuples of
    them), at its own shape."""
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, (list, tuple)):
        return sum(tensor_bytes(t) for t in tree)
    return 0


def collective_kind(func) -> Optional[str]:
    """The reference's kind name of a collective op, or None."""
    if func.namespace not in _NAMESPACES:
        return None
    return _KINDS.get(func._schema.name.split("::")[-1])


def result_bytes(func, args, out) -> int:
    """Bytes of a collective's result: its output, or, for an in-place
    ``c10d`` op, its first argument (the tensors it writes)."""
    return tensor_bytes(args[0] if func.namespace == "c10d" else out)


def _is_type(t, cls) -> bool:
    return isinstance(t, type) and issubclass(t, cls)


class CollectiveCounter(TorchDispatchMode):
    """Records each collective issued on this rank into ``stats``."""

    def __init__(self):
        super().__init__()
        self.stats = CollectiveStats()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(_is_type(t, DTensor) for t in types):
            # let DTensor run first: its local ops and collectives come
            # back through this mode on each rank's own tensors
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if any(_is_type(t, FakeTensor) for t in types) or \
                torch._C._get_dispatch_mode(
                    torch._C._TorchDispatchModeKey.FAKE) is not None:
            # DTensor's shape inference for an op it has not seen yet
            # (under a fake mode, at the global shapes): no rank runs it
            return out
        self.record(func, args, kwargs or {}, out)
        return out

    def record(self, func, args, kwargs, out) -> None:
        kind = collective_kind(func)
        if kind is not None:
            self.stats.add(kind, result_bytes(func, args, out))


@contextlib.contextmanager
def count_collectives() -> Iterator[CollectiveStats]:
    """``with count_collectives() as stats:`` records, on this rank, the
    collectives the block issues (kind, count and result bytes)."""
    mode = CollectiveCounter()
    with mode:
        yield mode.stats
