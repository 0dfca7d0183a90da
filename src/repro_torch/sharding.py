"""Logical-axis sharding annotations, decoupled from any concrete mesh.

PyTorch counterpart of ``repro/sharding.py``. Models annotate activations
and params with *logical* axis names ("batch", "seq", "model_ff", ...). The
launch layer installs a rule set mapping logical axes to the named dims of a
``DeviceMesh`` for the current (arch x shape x mesh); outside such a context
every annotation is a no-op, so the single-device paths run the exact same
model code.

DTensor (``torch.distributed.tensor``) stands where the reference has
``NamedSharding`` and GSPMD: a tensor's layout is one ``Shard(d)`` or
``Replicate()`` per mesh dim, and the collectives follow from the layouts of
an op's inputs. :func:`shard` is ``with_sharding_constraint``: a DTensor is
redistributed to the layout the rules give; anything else passes through.
A spec is the reference's ``PartitionSpec`` as a tuple: one entry per tensor
dim, each None, a mesh-dim name, or a tuple of them, which shards that dim
over those mesh dims major to minor, as JAX does.

:func:`init_ranks` builds the process group the ranks of a mesh share: NCCL
where each rank has a card of its own, gloo on the CPU and where ranks share
a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import types
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Logical = Union[str, None, Tuple[str, ...]]
Spec = Tuple[Any, ...]

# the installed rule set: process-wide, not per thread, because the
# autograd engine runs a CUDA backward (and the recompute of a checkpointed
# layer inside it) on a thread of its own
_state = types.SimpleNamespace(rules=None)


def axis_sizes(mesh) -> Dict[str, int]:
    """{mesh-dim name: size} of a ``DeviceMesh`` (or of anything with its
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def axis_size(mesh, name: str) -> int:
    """Size of the mesh dim ``name``; 1 where the mesh has no such dim."""
    return axis_sizes(mesh).get(name, 1)


def placements_for(mesh, spec: Sequence[Any]) -> tuple:
    """A spec (one entry per tensor dim) as DTensor placements (one per mesh
    dim). A tensor dim over several mesh dims is split major to minor in the
    spec's order, which DTensor does in the mesh's order: the two must
    agree."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        axes = ax if isinstance(ax, tuple) else (ax,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {ax} is not in the mesh's dim order "
                             f"{tuple(names)}")
        for i in idx:
            if out[i] != Replicate():
                raise ValueError(f"mesh dim {names[i]} shards two tensor "
                                 f"dims in {tuple(spec)}")
            out[i] = Shard(d)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: the layout of one tensor (the reference's
    ``jax.sharding.NamedSharding``)."""
    mesh: Any
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)


class Rules:
    """Mapping logical axis name -> mesh-dim name (or tuple, or None)."""

    def __init__(self, mesh, table: Dict[str, Logical]):
        self.mesh = mesh
        self.table = dict(table)
        self._axis_sizes = axis_sizes(mesh)

    def physical(self, logical: Logical) -> Logical:
        if logical is None:
            return None
        if isinstance(logical, tuple):
            parts: Tuple[str, ...] = ()
            for l in logical:
                p = self.physical(l)
                if p is None:
                    continue
                parts += p if isinstance(p, tuple) else (p,)
            return parts or None
        phys = self.table.get(logical)
        if phys is None:
            return None
        if isinstance(phys, tuple):
            phys = tuple(a for a in phys if a in self._axis_sizes)
            return phys or None
        return phys if phys in self._axis_sizes else None

    def size(self, logical: Logical) -> int:
        """How many shards the logical axis makes (1 when unmapped)."""
        phys = self.physical(logical)
        n = 1
        for a in (phys if isinstance(phys, tuple) else (phys,)):
            if a is not None:
                n *= self._axis_sizes[a]
        return n

    def spec(self, *logical: Logical) -> Spec:
        return tuple(self.physical(l) for l in logical)

    def placements(self, *logical: Logical) -> tuple:
        return placements_for(self.mesh, self.spec(*logical))

    def sharding(self, *logical: Logical) -> NamedSharding:
        return NamedSharding(self.mesh, self.spec(*logical))


def current_rules() -> Optional[Rules]:
    return _state.rules


@contextlib.contextmanager
def use_rules(rules: Optional[Rules]):
    """Installs ``rules`` for the block; with a rule set, plain tensors that
    meet DTensors in an op are taken as replicated (positions, masks and
    constants made inside the model)."""
    prev = _state.rules
    _state.rules = rules
    try:
        if rules is None:
            yield rules
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield rules
    finally:
        _state.rules = prev


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *logical: Logical) -> torch.Tensor:
    """Redistribute ``x`` to the layout of its logical axes.

    A no-op when no rule set is installed or ``x`` is not a DTensor.
    Trailing unannotated dims are replicated, as the reference's ``P``
    leaves them."""
    rules = current_rules()
    if rules is None or not is_dtensor(x):
        return x
    names = list(logical) + [None] * (x.ndim - len(logical))
    want = rules.placements(*names)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def whole_unless_divides(x: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``x`` with tensor dim ``dim`` made whole over the mesh dims that split
    it where their product does not divide ``n``: the dim is about to be
    viewed as ``n`` parts (heads), which DTensor can split only in whole
    parts per rank (24 heads over a "model" dim of 16, for example), and
    GSPMD gathers there too. A plain tensor, or one that divides, as it
    is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    dim %= x.ndim
    mesh = x.device_mesh
    split = [i for i, p in enumerate(x.placements)
             if p.is_shard() and p.dim == dim]
    total = 1
    for i in split:
        total *= mesh.size(i)
    if n % total == 0:
        return x
    pl = [Replicate() if i in split else p
          for i, p in enumerate(x.placements)]
    return x.redistribute(mesh, pl)


def flat_rows(x: torch.Tensor) -> torch.Tensor:
    """[..., D] -> [rows, D]. On a mesh, a DTensor is laid out on its first
    dim alone (whole over the mesh dims that split another) and flattened
    on each rank's own rows, and its gradient comes back in that layout:
    DTensor's own view would take back a gradient that its propagation
    split on the rows over a second mesh dim, which a rank holding one
    batch row cannot split."""
    if not is_dtensor(x):
        return x.reshape(-1, x.shape[-1])
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    pl = [p if p == Shard(0) else Replicate() for p in x.placements]
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    return local_map(lambda t: t.reshape(-1, t.shape[-1]), out_placements=pl,
                     in_placements=(pl,), device_mesh=x.device_mesh)(x)


def local_slice(full: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's shard of ``full`` under ``placements`` (DTensor's
    ``torch.chunk`` split), a view of ``full``: no collective."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        full.shape, mesh, list(placements))
    out = full
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != full.shape[d]:
            out = out.narrow(d, o, n)
    return out


def from_full(full: torch.Tensor, mesh, placements, device=None):
    """A DTensor of layout ``placements`` holding ``full``'s values, which
    every rank has: each rank keeps its own shard, moved to ``device``
    alone (the reference's ``jax.device_put`` with a sharding)."""
    from torch.distributed.tensor import DTensor
    local = local_slice(full, mesh, placements)
    local = local.to(device if device is not None else local.device,
                     copy=True).contiguous()
    return DTensor.from_local(local, mesh, list(placements), run_check=False,
                              shape=full.shape, stride=_contiguous(full.shape))


def zeros(shape, dtype, sharding, device):
    """A DTensor of zeros of ``sharding``'s layout: each rank allocates its
    own shard alone, on ``device``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    local, _ = compute_local_shape_and_global_offset(
        tuple(shape), sharding.mesh, list(sharding.placements))
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), sharding.mesh,
        list(sharding.placements), run_check=False, shape=torch.Size(shape),
        stride=_contiguous(shape))


def _contiguous(shape) -> tuple:
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def full_tensor(x):
    """The whole of ``x`` on every rank (a plain tensor as it is)."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# process groups
# ---------------------------------------------------------------------------
def backend_for(device_type: str, world: int) -> str:
    """NCCL where every rank has a card of its own, else gloo (the CPU, and
    ranks that share a card: NCCL refuses two ranks on one device)."""
    if device_type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def init_ranks(rank: int, world: int, port: int,
               device_type: str = "cuda") -> torch.device:
    """Joins the default process group of ``world`` ranks at
    ``tcp://localhost:port`` and returns this rank's device (card ``rank``
    modulo the cards there are, or the CPU). Where ranks share a card
    (gloo on CUDA tensors), the all-gathers of DTensor are staged through
    host memory (:func:`stage_gathers_through_host`)."""
    import torch.distributed as dist
    if device_type == "cuda":
        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    backend = backend_for(device_type, world)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    if device_type == "cuda" and backend == "gloo":
        stage_gathers_through_host()
    return device


def stage_gathers_through_host() -> None:
    """Makes the functional all-gather (DTensor's, for a ``Shard`` made
    whole) copy a CUDA tensor to the host, gather there and copy the result
    back. Gloo's all-gather of CUDA tensors in that form
    (``allgather_into_tensor_coalesced``) ends the process with a
    segmentation fault (torch 2.11, CUDA 12.8, on an H100), while its
    all-reduce, reduce-scatter and all-to-all of CUDA tensors work; the
    math stays on the card. Only for ranks that share a card: NCCL gathers
    on the card."""
    import torch.distributed._functional_collectives as funcol
    for name in ("all_gather_tensor", "all_gather_single"):
        orig = getattr(funcol, name, None)
        if orig is None or getattr(orig, "_staged", False):
            continue

        def staged(self, gather_dim, group, tag="", _orig=orig):
            if self.device.type != "cuda":
                return _orig(self, gather_dim, group, tag)
            out = _orig(self.cpu(), gather_dim, group, tag)
            if isinstance(out, funcol.AsyncCollectiveTensor):
                out = out.wait()
            return out.to(self.device)
        staged._staged = True
        setattr(funcol, name, staged)


def init_fake_ranks(world: int) -> None:
    """Joins ``torch.distributed``'s ``fake`` backend as rank 0 of
    ``world`` ranks, alone in this process: every collective returns at
    once with its output as allocated, so that a step can run on meta
    tensors at the world of a production mesh (the dry run) while
    DTensor issues the collectives each rank would. Process-wide: a
    process joins one group. DTensor's moves of a shard from one dim to
    another are sent to the all-to-all (:func:`shard_moves_by_alltoall`)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    shard_moves_by_alltoall()


def shard_moves_by_alltoall() -> None:
    """Makes DTensor move a ``Shard(i)`` to ``Shard(j)`` by the all-to-all
    it issues on a CUDA mesh, on a CPU mesh too. On a CPU mesh DTensor
    gathers the whole dim and keeps its own chunk, because gloo has no
    all-to-all; the fake backend has one, and the count of a dry run on a
    CPU mesh should be that of the card's mesh, where each rank sends its
    payload once instead of receiving the whole."""
    import torch.distributed.tensor._collective_utils as cu
    import torch.distributed.tensor.placement_types as pt

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            mesh.get_group(mesh_dim).group_name)
    for mod in (cu, pt):
        if not hasattr(mod, "shard_dim_alltoall"):
            raise RuntimeError(f"{mod.__name__} has no shard_dim_alltoall "
                               f"(torch {torch.__version__})")
        mod.shard_dim_alltoall = alltoall


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
