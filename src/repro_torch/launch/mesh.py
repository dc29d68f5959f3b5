"""Production meshes of the dry run, as the reference's ``launch/mesh.py``:
a 16x16 ``("data", "model")`` mesh of 256 ranks, or a 2x16x16 ``("pod",
"data", "model")`` mesh of 512, built over PyTorch's ``"fake"`` process
group (``torch.testing._internal.distributed.fake_pg``) in one process
as rank 0.  The fake group moves no data: every collective returns at
once, so a step runs on rank 0's shards as if the other ranks were there.

The default process group is process-global, so one process holds one
mesh at a time: :func:`production_mesh` creates the group, yields the
mesh and destroys the group, and the dry run enters it once per cell
(a run of both meshes destroys and re-creates the group between them).
The mesh's device type is ``"cpu"``: the dry run's tensors are fake CPU
tensors, and nothing touches a card.

Builders are functions, so importing this module creates no group.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Tuple, Union

import torch

#: mesh shapes and axis names by name, as the reference's artifacts name
#: them
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


def mesh_name(multi_pod: bool) -> str:
    return "pod2x16x16" if multi_pod else "pod16x16"


def init_fake_group(world_size: int, rank: int = 0) -> None:
    """The default process group as the ``"fake"`` backend: ``world_size``
    ranks, this process ``rank``."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """Single pod: 16x16 = 256 ranks (data, model).  Multi-pod: 2 pods x
    256 = 512 ranks (pod, data, model).  Needs a default process group of
    that size (:func:`init_fake_group`)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape, axes = MESHES[mesh_name(multi_pod)]
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


@contextlib.contextmanager
def production_mesh(*, multi_pod: bool = False) -> Iterator:
    """A fake group of the mesh's size, the mesh over it, and the group
    destroyed on exit."""
    import torch.distributed as dist

    shape, _ = MESHES[mesh_name(multi_pod)]
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already; the "
                           "dry run needs its own fake group")
    init_fake_group(math.prod(shape))
    try:
        yield make_production_mesh(multi_pod=multi_pod)
    finally:
        dist.destroy_process_group()


def make_smoke_mesh():
    """Whatever ranks the default group has, as a 1D ``("data",)`` mesh on
    the card when there is one."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    device_type = "cuda" if torch.cuda.is_available() else "cpu"
    return init_device_mesh(device_type, (dist.get_world_size(),),
                            mesh_dim_names=("data",))


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a device mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def dp_axes(mesh) -> Union[str, Tuple[str, ...]]:
    """The data-parallel / FSDP axes: ('pod','data') when a pod axis
    exists, else 'data'."""
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else "data"


def dp_size(mesh) -> int:
    sizes = axis_sizes(mesh)
    return sizes["data"] * sizes.get("pod", 1)


def mdl_size(mesh) -> int:
    return axis_sizes(mesh).get("model", 1)


def _alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's ``Shard(i) -> Shard(j)`` step as the all-to-all it is on
    NCCL (``_dtensor::shard_dim_alltoall``)."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


@contextlib.contextmanager
def alltoall_redistribution() -> Iterator[None]:
    """Inside: a ``Shard(i) -> Shard(j)`` redistribution on a CPU mesh
    issues the all-to-all, as it does on a CUDA mesh.

    DTensor replaces that all-to-all with an all-gather and a local chunk
    when the mesh's device type is ``"cpu"``, because gloo has no
    all-to-all.  The fake group moves no data and takes the all-to-all,
    so the dry run (whose mesh is a CPU one) records the collective a
    card's NCCL group would run: the MoE dispatch's all-to-alls are not
    counted as all-gathers of the whole buffer."""
    from torch.distributed.tensor import _collective_utils, placement_types

    # the placements module calls it by the name it imported (or, in
    # other releases, through the module that defines it)
    saved = [(m, m.shard_dim_alltoall)
             for m in (placement_types, _collective_utils)
             if hasattr(m, "shard_dim_alltoall")]
    for m, _ in saved:
        m.shard_dim_alltoall = _alltoall
    try:
        yield
    finally:
        for m, fn in saved:
            m.shard_dim_alltoall = fn
