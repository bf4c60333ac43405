"""Device meshes (the port of ``repro.launch.mesh``).

Single pod: (16, 16) = 256 cards, axes ("data", "model") — FSDP over
``data`` (parameters and optimizer state sharded, all-gathered on use),
TP/EP over ``model`` (heads, d_ff, experts, the decode cache's sequence).

Multi-pod: (2, 16, 16) = 512 cards, a leading ``pod`` axis of pure data
parallelism (gradient all-reduce across pods).

Defined as FUNCTIONS, so importing this module opens no process group: a
``DeviceMesh`` needs the default group of its size, which the caller
opens first (``torch.distributed.init_process_group``; the dry run opens a
fake one).  Every function that reads a mesh's axes also takes a plain
``{axis name: size}`` mapping in mesh-dimension order — an abstract mesh,
for the sharding rules alone.
"""

from __future__ import annotations

from typing import Dict, Mapping, Union

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device

__all__ = ["make_production_mesh", "make_local_mesh", "mesh_axis_sizes",
           "MeshLike"]

MeshLike = Union[DeviceMesh, Mapping[str, int]]


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_local_mesh(data: int = 1, model: int = 1,
                    device: DeviceLike = None) -> DeviceMesh:
    """A (data, model) mesh over the default process group's ranks, on
    ``device``'s type (``cuda`` unless the caller names another)."""
    return init_device_mesh(resolve_device(device).type, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_axis_sizes(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size}, in mesh-dimension order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))
