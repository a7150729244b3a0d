"""Production mesh definitions (functions, not module constants: importing
this module never touches torch.distributed).

Port of `repro.launch.mesh`.  Meshes are `DeviceMesh`es built by
`init_device_mesh` over whatever process group is initialized.  The dry
run traces on torch's "fake" backend (`start_fake_group`), the
counterpart of the reference's 512 placeholder host devices: every
collective returns at once and no rank but this one exists.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _make_mesh(shape, axes, device_type: str):
    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """16x16 = 256 chips per pod; multi_pod adds a leading pod=2 axis
    (512 chips)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, axes, device_type)


def make_test_mesh(shape=(2, 2), axes=("data", "model"), device_type: str = "cuda"):
    """Small mesh for unit tests (the process group must have
    prod(shape) ranks)."""
    return _make_mesh(shape, axes, device_type)


def mesh_chips(mesh) -> int:
    return int(mesh.size())


def start_fake_group(world_size: int, rank: int = 0) -> None:
    """Initialize torch's "fake" process group of `world_size` ranks, this
    process being `rank`, unless a group is already up.  Tensors laid out
    on a mesh over it trace every collective without running it."""
    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of {dist.get_world_size()} ranks is "
                               f"already up; the fake mesh wants {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world_size)
