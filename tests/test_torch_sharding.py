"""The port's sharding rules (``launch.sharding``, ``pspec``) held against
the reference's, exactly (no tolerance).

For every arch at full size and for the meshes (16, 16), (2, 16, 16) and
(4, 2) — on the reference's side a ``jax.sharding.AbstractMesh`` with
Auto axes, on the port's an ``{axis: size}`` mapping — the specs of
``param_specs`` (leaf by leaf, on the reference's stacked tree and on the
port's ``nn.Module``), ``cache_specs`` (every runnable prefill and decode
cell, stacked and per layer) and ``input_specs_sharding`` are equal.
``pspec.logical_spec`` equals the output sharding of the reference's
``pspec.shard`` under ``jax.jit`` on 8 forced host devices (subprocess).
A checkpoint restored with ``shardings`` onto a (4, 2) mesh over a fake
process group gives every leaf the reference's shard shape and rank 0's
values.
"""

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, AxisType

from repro.configs import all_arch_ids
from repro.configs import get_config as ref_config
from repro.launch import sharding as ref_sharding
from repro.models import api as ref_api
from repro.models.config import SHAPES
from repro_torch import pspec
from repro_torch.ckpt import load_pytree, save_pytree
from repro_torch.configs import get_config as port_config
from repro_torch.launch import dryrun, sharding
from repro_torch.models import api as port_api
from repro_torch.models import lm as port_lm

ROOT = Path(__file__).resolve().parents[1]
ARCHS = all_arch_ids()
MESHES = {"16x16": (("data", 16), ("model", 16)),
          "2x16x16": (("pod", 2), ("data", 16), ("model", 16)),
          "4x2": (("data", 4), ("model", 2))}
SERVE_CELLS = [(a, s) for a in ARCHS for s, sh in SHAPES.items()
               if sh.mode in ("prefill", "decode")]
ALL_CELLS = [(a, s) for a in ARCHS for s in SHAPES]


def _meshes(name):
    axes = MESHES[name]
    ref = AbstractMesh(tuple(n for _, n in axes), tuple(a for a, _ in axes),
                       axis_types=(AxisType.Auto,) * len(axes))
    return ref, dict(axes)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return ref_api.get_model(ref_config(arch)).abstract_params()


@functools.lru_cache(maxsize=None)
def _port_params(arch):
    return port_api.get_model(port_config(arch)).abstract_params()


def _key(path):
    return tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)


def _at(tree, key):
    for k in key:
        tree = tree[k]
    return tree


def _spec(named_sharding):
    return tuple(named_sharding.spec)


def _pad(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, mesh):
    ref_mesh, sizes = _meshes(mesh)
    ref = ref_sharding.param_specs(ref_mesh, _ref_params(arch))
    port = sharding.param_specs(sizes, _port_params(arch))
    leaves = jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: hasattr(x, "spec"))[0]
    assert len(leaves) == len(jax.tree.leaves(
        port, is_leaf=lambda x: isinstance(x, sharding.Named)))
    for path, r in leaves:
        p = _at(port, _key(path))
        shape = _at(_port_params(arch), _key(path)).shape
        assert p.spec == _pad(_spec(r), len(shape)), \
            jax.tree_util.keystr(path)


def _layer_path(cfg, name):
    """A module parameter's name -> (its path in the reference's stacked
    tree, True when it sits in a per-layer list)."""
    parts = name.split(".")
    lists = {"layers": lambda i: ("blocks", i % port_lm.pattern_period(cfg)),
             "enc_layers": lambda i: ("enc_blocks",),
             "dec_layers": lambda i: ("dec_blocks",)}
    if parts[0] in lists:
        return lists[parts[0]](int(parts[1])) + tuple(parts[2:]), True
    return tuple(parts), False


@pytest.mark.parametrize("arch", ARCHS)
def test_module_param_specs_match_reference(arch):
    """The port's ``nn.Module`` (per-layer lists): each parameter's spec is
    its stacked reference leaf's without the leading layer dim."""
    cfg = port_config(arch)
    module = dryrun.meta_module(cfg)
    for mesh in MESHES:
        ref_mesh, sizes = _meshes(mesh)
        ref = ref_sharding.param_specs(ref_mesh, _ref_params(arch))
        specs = sharding.param_specs(sizes, module)
        assert len(specs) == len(list(module.named_parameters()))
        for name, p in module.named_parameters():
            path, stacked = _layer_path(cfg, name)
            r = _spec(_at(ref, path))
            want = _pad(r, p.dim() + stacked)[1:] if stacked \
                else _pad(r, p.dim())
            assert specs[name].spec == want, (mesh, name)


def _port_cache(ref_cache):
    """The reference's abstract cache as ``meta`` tensors, same tree."""
    return jax.tree.map(
        lambda s: torch.empty(s.shape, device="meta",
                              dtype=getattr(torch, str(s.dtype))),
        ref_cache)


@pytest.mark.parametrize("arch,shape", SERVE_CELLS)
def test_cache_specs_match_reference(arch, shape):
    rcfg, pcfg, sh = ref_config(arch), port_config(arch), SHAPES[shape]
    if not ref_api.cell_is_runnable(rcfg, sh)[0]:
        return
    ref_cache = jax.eval_shape(lambda: ref_api.get_model(rcfg).init_cache(
        sh.global_batch, sh.seq_len))
    per_layer = port_api.get_model(pcfg).init_cache(
        sh.global_batch, sh.seq_len, device="meta")
    for mesh in MESHES:
        ref_mesh, sizes = _meshes(mesh)
        ref = ref_sharding.cache_specs(ref_mesh, rcfg, ref_cache, sh)
        port = sharding.cache_specs(sizes, pcfg, _port_cache(ref_cache), sh)
        leaves = jax.tree_util.tree_flatten_with_path(
            ref, is_leaf=lambda x: hasattr(x, "spec"))[0]
        shapes = dict(jax.tree_util.tree_flatten_with_path(ref_cache)[0])
        for path, r in leaves:
            ndim = len(shapes[path].shape)
            assert _at(port, _key(path)).spec == _pad(_spec(r), ndim), \
                (mesh, jax.tree_util.keystr(path))
        # the port's per-layer caches: the stacked spec without its R dim
        layer = sharding.cache_specs(sizes, pcfg, per_layer, sh)
        if pcfg.enc_dec is not None:
            pairs = [(("self", name), layer["self"][0][name])
                     for name in ("k", "v", "kpos")]
            pairs += [((name,), layer[name][0])
                      for name in ("cross_k", "cross_v")]
        else:
            P = port_lm.pattern_period(pcfg)
            pairs = [((pos, name), layer[pos][name]) for pos in range(P)
                     for name, t in per_layer[pos].items()
                     if isinstance(t, torch.Tensor)]
        for key, got in pairs:
            r = _spec(_at(ref, key))
            ndim = len(_at(ref_cache, key).shape)
            assert got.spec == _pad(r, ndim)[1:], (mesh, key)
        # the port's host-int positions are no tensors: no placement
        selfs = layer["self"] if pcfg.enc_dec is not None else layer
        assert all(c["pos"] is None for c in selfs if "pos" in c)


@pytest.mark.parametrize("arch,shape", ALL_CELLS)
def test_input_specs_sharding_matches_reference(arch, shape):
    rcfg, pcfg, sh = ref_config(arch), port_config(arch), SHAPES[shape]
    if not ref_api.cell_is_runnable(rcfg, sh)[0]:
        return
    ref_specs = ref_api.input_specs(rcfg, sh)
    port_specs = port_api.input_specs(pcfg, sh)
    for mesh in MESHES:
        ref_mesh, sizes = _meshes(mesh)
        ref = ref_sharding.input_specs_sharding(ref_mesh, ref_specs)
        port = sharding.input_specs_sharding(sizes, port_specs)
        assert set(ref) == set(port)
        for k, r in ref.items():
            assert port[k].spec == _pad(_spec(r), port_specs[k].dim()), k


def test_placements_follow_mesh_order():
    sizes = {"pod": 2, "data": 16, "model": 16}
    from torch.distributed.tensor import Replicate, Shard
    assert pspec.placements((("pod", "data"), None, "model"), sizes) == \
        (Shard(0), Shard(0), Shard(2))
    assert pspec.placements((None,), sizes) == (Replicate(),) * 3
    # a split over one rank is no split
    assert pspec.placements(("data", "model"), {"data": 1, "model": 4}) \
        == (Replicate(), Shard(1))
    # a dim over two axes lists them major to minor, in mesh order (as
    # DTensor splits it, outer mesh dim first)
    with pytest.raises(ValueError, match="mesh order"):
        pspec.placements(((("model", "data")),), sizes)


# ---------------------------------------------------------------------------
# pspec.logical_spec against the reference's with_sharding_constraint
# ---------------------------------------------------------------------------

# (shape, logical): every logical name, divisible and not, and tp_pad's
# uneven split (5 heads on 2-way TP, as MLA's 40 on 16)
LOGICAL_CASES = [
    ((8, 6, 4), ("batch", "sp", None)),
    ((8, 6, 4), ("batch", None, "tp")),
    ((8, 5, 4), ("batch", "tp", None)),
    ((6, 8, 4), ("batch", None, None)),
    ((8, 6, 4), ("fsdp", "tp", None)),
    ((8, 16, 4), (None, "seq", None)),
    ((8, 12, 4), (None, "seq", None)),
    ((8, 7, 4), (None, "seq", None)),
    ((8, 4, 5, 3), ("batch", None, "tp_pad", None)),
    ((8, 4, 1, 3), ("batch", None, "tp_pad", None)),
    ((8, 4, 6, 3), ("batch", None, "tp_pad", None)),
    ((2, 4), ("batch", "tp")),
    ((8, 6), ("batch",)),
]

REF_LOGICAL = r"""
import json, os, re, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, {src!r})
import jax, jax.numpy as jnp
from jax.sharding import AxisType
from repro import pspec
mesh = jax.make_mesh((4, 2), ("data", "model"),
                     axis_types=(AxisType.Auto,) * 2)
out = []
for shape, logical in {cases!r}:
    f = jax.jit(lambda x, lg=tuple(logical): pspec.shard(x, *lg))
    with pspec.activation_mesh(mesh):
        text = f.lower(jax.ShapeDtypeStruct(tuple(shape),
                                            jnp.float32)).as_text()
    # the constraint as lowered: sdy.sharding_constraint %x <@mesh,
    # [{{"data"}}, {{}}, ...]>, one brace group of axis names a dim
    dims = re.search(r"sharding_constraint [^<]*<@\w+, \[(.*)\]>",
                     text).group(1)
    out.append([re.findall(r'"(\w+)"', g)
                for g in re.findall(r"\{{([^}}]*)\}}", dims)])
print(json.dumps(out))
"""


def _norm(dims):
    """Per-dim axis lists -> the tuple spec (None, a name, or names)."""
    return tuple(None if not d else d[0] if len(d) == 1 else tuple(d)
                 for d in dims)


def test_logical_spec_matches_reference_shard():
    code = REF_LOGICAL.format(src=str(ROOT / "src"), cases=LOGICAL_CASES)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    sizes = {"data": 4, "model": 2}
    for (shape, logical), r in zip(LOGICAL_CASES, ref):
        got = pspec.logical_spec(shape, logical, sizes)
        assert got == _norm(r), (shape, logical, r)
    assert set(pspec._LOGICAL) <= {n for _, lg in LOGICAL_CASES
                                   for n in lg if n}


def test_registered_mesh_is_seen_by_other_threads():
    """autograd runs a CUDA backward, and remat's recomputed forward with
    it, on threads of its own: they see the registered mesh."""
    import threading
    seen = []
    with pspec.activation_mesh({"data": 4, "model": 2}):
        t = threading.Thread(target=lambda: seen.append(pspec.current_mesh()))
        t.start()
        t.join(timeout=10)
    assert not t.is_alive() and seen == [{"data": 4, "model": 2}]
    assert pspec.current_mesh() is None


def test_shard_is_identity_off_mesh():
    x = torch.randn(4, 6)
    assert pspec.current_mesh() is None
    assert pspec.shard(x, "batch", "tp") is x
    with pspec.activation_mesh({"data": 4, "model": 2}):
        assert pspec.shard(x, "batch", "tp") is x      # a plain tensor
        assert pspec.axis_size("tp") == 2
        assert pspec.axis_size("batch") == 4
    assert pspec.axis_size("tp") == 1


# ---------------------------------------------------------------------------
# elastic restore onto a (4, 2) mesh
# ---------------------------------------------------------------------------


@pytest.fixture
def fake_mesh_4x2():
    from torch.distributed.device_mesh import init_device_mesh
    dryrun.open_fake_group(8)
    try:
        yield init_device_mesh("cpu", (4, 2),
                               mesh_dim_names=("data", "model"))
    finally:
        torch.distributed.destroy_process_group()


def test_load_pytree_reshards_onto_mesh(tmp_path, fake_mesh_4x2):
    """olmo-1b's smoke parameters, saved whole (as any mesh would save
    them), restored onto a (4, 2) mesh: each leaf's local shard has the
    shape of the reference's ``device_put`` onto its (4, 2) sharding and
    holds rank 0's block of the saved array."""
    cfg = port_config("olmo-1b")
    from repro_torch.configs import get_smoke_config
    scfg = get_smoke_config("olmo-1b")
    tree = port_lm.reference_layout(
        port_lm._init_tree(scfg, torch.Generator().manual_seed(0), "cpu"),
        port_lm.stacks(scfg))
    save_pytree({"params": tree}, tmp_path, 3)
    like = {"params": jax.tree.map(lambda t: t.to("meta"), tree)}
    shardings = {"params": sharding.param_specs(fake_mesh_4x2,
                                                like["params"])}
    restored = load_pytree(tmp_path / "step_000000003", like, shardings)
    ref_mesh, _ = _meshes("4x2")
    ref_tree = jax.tree.map(lambda t: jax.ShapeDtypeStruct(
        tuple(t.shape), jnp.float32), tree)
    ref_sh = ref_sharding.param_specs(ref_mesh, ref_tree)
    flat = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    assert cfg.arch_id == scfg.arch_id
    n_sharded = 0
    for path, r in flat:
        key = _key(path)
        got = _at(restored["params"], key)
        want_shape = _at(ref_sh, key).shard_shape(r.shape)
        local = got.to_local()
        assert tuple(local.shape) == tuple(want_shape), key
        whole = _at(tree, key)
        block = whole[tuple(slice(0, n) for n in want_shape)]
        assert torch.equal(local, block), key
        n_sharded += tuple(want_shape) != tuple(r.shape)
    assert n_sharded == 8      # embed and the 7 stacked weight matrices
