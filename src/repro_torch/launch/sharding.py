"""Sharding rules: parameter / input / cache specs per (arch, shape,
mesh), as DTensor placements (the port of ``repro.launch.sharding``).

Strategy, as in the reference:
* ``pod``   — pure DP: parameters replicated across pods, batch sharded.
* ``data``  — FSDP: the non-TP dimension of every weight matrix is sharded
  over ``data``; optimizer state takes the weight's spec (ZeRO).
* ``model`` — TP: attention heads / d_ff / experts / mamba d_inner; for
  decode shapes also the KV-cache sequence dimension (sequence-parallel
  cache).

A spec is the reference's ``PartitionSpec`` as a tuple, one entry per
tensor dim: ``None``, a mesh axis name, or a tuple of names.  Every rule is
divisibility-guarded (``guard_spec``: an axis that does not divide the
dimension is dropped), so the same rules serve full-size and smoke
configs.  ``named`` gives the guarded spec with its placements on the
mesh (``NamedSharding``'s counterpart).  A mesh is a ``DeviceMesh`` or an
``{axis: size}`` mapping (``mesh.mesh_axis_sizes``).

Trees are nested dicts / lists / tuples of tensors (the reference's
parameter pytree from ``Model.abstract_params``, or the port's per-layer
caches); ``param_specs`` also takes an ``nn.Module``, whose parameter
names are the leaves' paths.  A layer's tensors in the port's per-layer
lists lack the reference's leading stacked dim, which the rules leave
unsharded: their spec is the stacked spec without that entry.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
from torch import nn

from .. import pspec
from ..models.config import ModelConfig, ShapeConfig
from .mesh import MeshLike, mesh_axis_sizes

__all__ = ["param_specs", "input_specs_sharding", "cache_specs",
           "batch_axes", "named", "guard_spec", "Named", "distribute",
           "distribute_params"]

Spec = pspec.Spec


@dataclass(frozen=True)
class Named:
    """A guarded spec and its DTensor placements on ``mesh``."""
    mesh: Any
    spec: Spec
    placements: Tuple[Any, ...]


def _axis_size(sizes: Dict[str, int], name) -> int:
    if name is None:
        return 1
    if isinstance(name, tuple):
        return math.prod(_axis_size(sizes, n) for n in name)
    return sizes[name]


def guard_spec(mesh: MeshLike, spec: Sequence, shape: Sequence[int]) -> Spec:
    """Drop spec axes that don't divide the corresponding dim."""
    sizes = mesh_axis_sizes(mesh)
    out = []
    for dim, names in zip(shape, tuple(spec) + (None,) * (len(shape)
                                                          - len(spec))):
        if names is None:
            out.append(None)
            continue
        cand = names if isinstance(names, tuple) else (names,)
        kept, size = [], 1
        for n in cand:
            s = _axis_size(sizes, n)
            if dim % (size * s) == 0:
                kept.append(n)
                size *= s
        out.append(tuple(kept) if len(kept) > 1
                   else (kept[0] if kept else None))
    return tuple(out)


def named(mesh: MeshLike, spec: Sequence, shape: Sequence[int]) -> Named:
    g = guard_spec(mesh, spec, shape)
    return Named(mesh, g, pspec.placements(g, mesh_axis_sizes(mesh)))


def batch_axes(mesh: MeshLike) -> Tuple[str, ...]:
    names = mesh_axis_sizes(mesh)
    return tuple(n for n in ("pod", "data") if n in names)


# ---------------------------------------------------------------------------
# parameter rules (keyed by leaf name, stacked leading layer dim ignored)
# ---------------------------------------------------------------------------

# name -> spec for the *trailing* dims (leading stacked dims -> None)
_RULES: Dict[str, Tuple[Optional[Any], ...]] = {
    # embeddings
    "embed": ("model", "data"),
    "unembed": ("data", "model"),
    "patch_proj": ("data", "model"),
    "dec_pos": (None, "data"),
    "enc_pos": (None, None),
    # attention (col-parallel in, row-parallel out)
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    # MLA
    "wdq": ("data", "model"),
    "wuq": ("model", None),       # (q_lora, H*qk): H over model would be 2nd
    "wdkv": ("data", None),
    "wkr": ("data", None),
    "wuk": ("model", None, None),  # (H, rank, hd)
    "wuv": ("model", None, None),
    # MLP
    "w_gate": ("data", "model"),
    "w_up": ("data", "model"),
    "w_down": ("model", "data"),
    # MoE (leading E dim)
    "router": ("data", None),
    # mamba
    "in_proj": ("data", "model"),
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "x_proj": ("model", None),
    "dt_proj": (None, "model"),
    "dt_bias": ("model",),
    "A_log": ("model", None),
    "D": ("model",),
    "out_proj": ("model", "data"),
    # norms
    "scale": (None,),
    "bias": (None,),
}

# MoE expert tensors carry a leading E dim that shards over `model`
_MOE_EXPERT_RULES: Dict[str, Tuple[Optional[Any], ...]] = {
    "w_gate": ("model", "data", None),
    "w_up": ("model", "data", None),
    "w_down": ("model", None, "data"),
}

# the port's per-layer lists, whose entries the reference stacks
_LAYER_LISTS = ("layers", "enc_layers", "dec_layers")


def _leaf_spec(names: Sequence[Any], shape: Sequence[int]) -> Spec:
    """The reference's rule for the leaf at path ``names`` (keys and
    indices) of ``shape``, stacked layout."""
    name = str(names[-1])
    in_moe = any(str(n) == "ffn" for n in names) and \
        name in _MOE_EXPERT_RULES and len(shape) >= 3
    # distinguish MoE expert weights (R, E, d, f) from MLP (R, d, f) by rank
    if in_moe and len(shape) == 4:
        trail = _MOE_EXPERT_RULES[name]
    elif name in _RULES:
        trail = _RULES[name]
    else:
        trail = ()
    lead = len(shape) - len(trail)
    if lead < 0:  # unstacked variant (e.g. whisper top-level embed)
        trail = trail[-len(shape):] if len(shape) else ()
        lead = len(shape) - len(trail)
    return (None,) * lead + tuple(trail)


def _port_leaf_spec(names: Sequence[Any], shape: Sequence[int]) -> Spec:
    """``_leaf_spec`` of a leaf of the port's layout: inside a per-layer
    list the leaf lacks the stacked dim, which the rule leaves None."""
    if any(str(n) in _LAYER_LISTS for n in names):
        return _leaf_spec(names, (1,) + tuple(shape))[1:]
    return _leaf_spec(names, shape)


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, Mapping):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def param_specs(mesh: MeshLike, params) -> Any:
    """``Named`` placements for every parameter: a tree like ``params``
    (the reference's stacked layout, or the port's per-layer lists), or for
    an ``nn.Module`` a dict keyed by ``named_parameters()``'s names."""
    if isinstance(params, nn.Module):
        return {n: named(mesh, _port_leaf_spec(n.split("."), p.shape),
                         p.shape)
                for n, p in params.named_parameters()}
    return _map_with_path(
        lambda path, leaf: named(mesh, _port_leaf_spec(path, leaf.shape),
                                 leaf.shape), params)


# ---------------------------------------------------------------------------
# inputs and caches
# ---------------------------------------------------------------------------


def input_specs_sharding(mesh: MeshLike, specs: Mapping[str, Any]
                         ) -> Dict[str, Named]:
    """Batch-shard every input over (pod, data)."""
    ba = batch_axes(mesh)
    return {k: named(mesh, (ba,) if v.shape[0] > 1 else (), v.shape)
            for k, v in specs.items()}


def cache_specs(mesh: MeshLike, cfg: ModelConfig, abstract_cache,
                shape: ShapeConfig) -> Any:
    """Decode caches: batch over (pod, data) when divisible; the cache
    sequence dim over ``model`` (sequence-parallel KV).  For B == 1
    (long_500k) the sequence dim takes (data, model).  Takes the
    reference's stacked caches (leading repeat dim) or the port's
    per-layer ones (``lm.init_cache``, ``encdec.init_cache_encdec``);
    leaves that are not tensors (the port's ``pos`` counters) map to
    None."""
    ba = batch_axes(mesh)
    seq_axes = ("model",) if shape.global_batch > 1 else ("data", "model")
    rules = {
        "k": (None, ba, seq_axes, None, None),        # (R, B, T, KV, hd)
        "v": (None, ba, seq_axes, None, None),
        "c_kv": (None, ba, seq_axes, None),           # (R, B, T, rank)
        "k_rope": (None, ba, seq_axes, None),
        "cross_k": (None, ba, None, "model", None),   # (L, B, T_enc, H, hd)
        "cross_v": (None, ba, None, "model", None),
        "conv": (None, ba, None, "model"),            # (R, B, dc-1, di)
        "h": (None, ba, "model", None),               # (R, B, di, N)
        "kpos": (None, seq_axes),                     # (R, T)
    }

    def f(path, leaf):
        if not isinstance(leaf, torch.Tensor):
            return None
        # the leaf's name: its last key (per-layer lists add an index)
        name = next((k for k in reversed(path) if isinstance(k, str)), "")
        spec = rules.get(name, ())
        if spec and leaf.dim() == len(spec) - 1:      # per layer: no R dim
            spec = spec[1:]
        return named(mesh, spec, leaf.shape)

    return _map_with_path(f, abstract_cache)


# ---------------------------------------------------------------------------
# placing tensors
# ---------------------------------------------------------------------------


def distribute(t: torch.Tensor, mesh, placement: Named):
    """``t`` (the whole tensor, the same on every rank) as a DTensor on
    ``mesh`` with ``placement``'s placements: each rank keeps its own
    shard, cut locally (no collective; the rules shard evenly), on the
    mesh's device type -- a ``meta`` tensor's shard stays ``meta`` (the
    dry run)."""
    from torch.distributed.tensor import DTensor
    coord = mesh.get_coordinate()
    local = t
    for i, p in enumerate(placement.placements):
        if p.is_shard():
            n = mesh.size(i)
            if local.shape[p.dim] % n:
                raise ValueError(f"{tuple(t.shape)} does not split evenly "
                                 f"under {placement.spec}")
            local = torch.chunk(local, n, dim=p.dim)[coord[i]]
    if not local.is_meta:
        local = local.to(mesh.device_type)
    local = local.contiguous()
    return DTensor.from_local(local, mesh,
                              placement.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_params(module: nn.Module, mesh) -> nn.Module:
    """Every parameter of ``module`` replaced, in place, by a parameter
    holding its DTensor on ``mesh`` placed by ``param_specs``."""
    specs = param_specs(mesh, module)
    for name, p in list(module.named_parameters()):
        owner, _, leaf = name.rpartition(".")
        mod = module.get_submodule(owner) if owner else module
        setattr(mod, leaf, nn.Parameter(distribute(p.detach(), mesh,
                                                   specs[name]),
                                        requires_grad=p.requires_grad))
    return module
