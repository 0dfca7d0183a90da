"""Mesh construction (the reference's ``launch/mesh.py``) over
``torch.distributed.device_mesh``.

Functions, not module-level constants, so importing this module touches no
process group. A mesh needs the default process group of exactly as many
ranks as it has devices (``sharding.init_ranks``); ``make_host_mesh`` joins
a group of one rank itself when there is none.
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.configs.base import MULTI_POD, SINGLE_POD, MeshConfig


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with its dims named ``axes``, over the
    ranks of the default process group in order."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """(16, 16) ("data", "model"), or (2, 16, 16) with "pod" in front; the
    world must hold exactly that many ranks."""
    import torch.distributed as dist
    mc = mesh_config(multi_pod=multi_pod)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != mc.num_devices:
        raise ValueError(f"the production mesh {mc.shape} needs "
                         f"{mc.num_devices} ranks; the world has {world}")
    return make_mesh(mc.shape, mc.axes, device_type)


def mesh_config(*, multi_pod: bool = False) -> MeshConfig:
    return MULTI_POD if multi_pod else SINGLE_POD


def make_host_mesh(device_type: str = "cuda"):
    """1 x 1 ("data", "model") mesh for runs on one device through the same
    code path (a process group of one rank is joined if none is)."""
    import torch.distributed as dist
    if not dist.is_initialized():
        from repro_torch.sharding import free_port, init_ranks
        init_ranks(0, 1, free_port(), device_type)
    return make_mesh((1, 1), ("data", "model"), device_type)
