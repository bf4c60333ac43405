"""Activation-sharding registry (the port of ``repro.pspec``).

Model code is mesh-agnostic; the launcher registers the active mesh, and
layers annotate activations with *logical* axes:

    with pspec.activation_mesh(mesh):
        step(...)             # model calls pspec.shard(x, "batch", None, "tp")

Outside a registered mesh, and on a plain tensor, every annotation returns
its input unchanged, so single-device runs are untouched.  On a
``DTensor`` under a registered ``DeviceMesh`` it redistributes the tensor
to the annotated placements — DTensor's counterpart of XLA's
``with_sharding_constraint``: the collectives it needs (a gather, a
reduce-scatter of a ``Partial`` sum) are issued there, and show in the
dry run's counts.

Specs are divisibility-guarded (an axis that does not divide the dim is
dropped), so one rule set serves full-size and smoke configs.  The
exception is ``tp_pad``: heads that do not divide the TP axis (MLA's 40
heads on 16-way TP) are still sharded.  XLA pads 40 to 48, 3 heads a
device; DTensor shards unevenly as ``torch.chunk`` does, ceil(40/16) = 3
heads a rank (ranks 0-12 hold 3, rank 13 one, ranks 14-15 none), so rank
0 holds the same 3 heads as XLA's device 0.

A tensor dim over two mesh axes, as ``("pod", "data")``, is ``Shard(d)``
on both mesh dims; DTensor splits it in mesh-dimension order, outer dim
first, which is XLA's major-to-minor order for the axes as the spec lists
them (``placements`` checks that the spec lists them in mesh order).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Iterator, Mapping, Optional, Sequence, Tuple, Union

import torch

from .launch.mesh import mesh_axis_sizes

__all__ = ["activation_mesh", "shard", "axis_size", "current_mesh",
           "logical_spec", "placements", "placements_of", "is_dtensor",
           "pin_grad", "Spec"]

# one entry per tensor dim: unsharded, one mesh axis, or several
SpecEntry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[SpecEntry, ...]

# the registered mesh, process-wide: autograd runs a CUDA backward, and
# with it remat's recomputed forward, on threads of its own
_registered = [None]

# logical name -> physical mesh axes
_LOGICAL = {
    "batch": ("pod", "data"),   # data parallel (pods x FSDP groups)
    "fsdp": ("data",),
    "tp": ("model",),           # tensor / expert parallel
    "sp": ("model",),           # Megatron-style sequence parallelism: the
    #                             residual stream between layers shards its
    #                             sequence dim over the TP axis
    "seq": ("data", "model"),   # sequence parallelism (long-context decode)
    "tp_pad": ("model",),       # TP with uneven sharding allowed (heads
    #                             that do not divide the TP axis)
}

_ALLOW_UNEVEN = {"tp_pad"}


def current_mesh():
    return _registered[0]


@contextlib.contextmanager
def activation_mesh(mesh) -> Iterator[None]:
    """Register ``mesh`` for ``shard``.  On a ``DeviceMesh`` the model's
    own helper tensors (positions, masks, the attention's running maxima,
    zero states) also join DTensor ops as replicated, through DTensor's
    ``implicit_replication``."""
    prev = _registered[0]
    _registered[0] = mesh
    try:
        if isinstance(mesh, Mapping):          # an abstract mesh: rules only
            yield
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            with implicit_replication():
                yield
    finally:
        _registered[0] = prev


def axis_size(name: str) -> int:
    mesh = current_mesh()
    if mesh is None:
        return 1
    sizes = mesh_axis_sizes(mesh)
    return math.prod(sizes[a] for a in _LOGICAL.get(name, ())
                     if a in sizes)


def logical_spec(shape: Sequence[int], logical: Sequence[Optional[str]],
                 mesh_axis_sizes: Dict[str, int]) -> Spec:
    """The reference's spec for ``shard(x, *logical)`` on a mesh of these
    axis sizes: each logical name maps to its mesh axes, and an axis is
    kept while the product so far divides the dim (``tp_pad``: while it
    does not exceed the dim)."""
    spec = []
    for dim, name in zip(shape, logical):
        if name is None:
            spec.append(None)
            continue
        phys = [a for a in _LOGICAL.get(name, (name,))
                if a in mesh_axis_sizes]
        uneven_ok = name in _ALLOW_UNEVEN
        kept, size = [], 1
        for a in phys:
            s = mesh_axis_sizes[a]
            if dim % (size * s) == 0 or (uneven_ok and dim >= size * s):
                kept.append(a)
                size *= s
        spec.append(tuple(kept) if len(kept) > 1
                    else (kept[0] if kept else None))
    spec += [None] * (len(shape) - len(spec))
    return tuple(spec)


def placements(spec: Spec, mesh_axis_sizes: Dict[str, int]):
    """DTensor placements of ``spec`` on a mesh of these axes (in mesh-dim
    order): mesh dim ``i`` is ``Shard(d)`` when the spec puts its axis on
    tensor dim ``d`` and the axis has more than one rank, else
    ``Replicate()`` (a split over one rank is no split, and DTensor's
    strategies mishandle shards of size-1 mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard
    axis_names = list(mesh_axis_sizes)
    out = [Replicate()] * len(axis_names)
    for d, entry in enumerate(spec):
        axes = (entry,) if isinstance(entry, str) else (entry or ())
        idx = [list(axis_names).index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} lists mesh axes out of "
                             f"mesh order {tuple(axis_names)}")
        for i in idx:
            if mesh_axis_sizes[axis_names[i]] > 1:
                out[i] = Shard(d)
    return tuple(out)


def placements_of(x, *logical: Optional[str]):
    """The placements ``shard(x, *logical)`` gives ``x`` on the registered
    mesh."""
    sizes = mesh_axis_sizes(current_mesh())
    return placements(logical_spec(x.shape, logical, sizes), sizes)


def shard(x, *logical: Optional[str]):
    """Annotate ``x`` with logical axes (None = unsharded dim): ``x``
    unchanged when no mesh is registered or ``x`` is not a DTensor, else
    ``x`` redistributed to the spec's placements."""
    if current_mesh() is None or not is_dtensor(x):
        return x
    want = placements_of(x, *logical)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor) or type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def pin_grad(w):
    """``w`` itself, whose gradient returns in ``w``'s own placements: a
    weight used twice (a tied embedding's lookup and unembedding) sums
    its two gradients there, and a reshape's gradient reaches it in the
    layout its forward had.  DTensor otherwise passes on whatever
    placements the backward products chose: before torch 2.13 it cannot
    turn a shard into the partial sum a sum of two may ask for, and its
    view rule cannot fold every split back (MoE's token groups)."""
    if not is_dtensor(w):
        return w
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(w.to_local(grad_placements=w.placements),
                              w.device_mesh, w.placements, run_check=False,
                              shape=w.shape, stride=w.stride())
