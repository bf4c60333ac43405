"""Multi-pod dry run: one step of every (architecture x input shape x
mesh) cell on the production mesh, counted per device (the port of
``repro.launch.dryrun``).

The reference lowers and compiles each cell with XLA on 512 forced host
devices.  Here a cell runs its step once, eagerly, on a fake process
group (``torch.testing``'s ``FakeStore``, backend ``"fake"``: collectives
complete without moving data) of the mesh's size, as rank 0: parameters,
optimizer state, caches and inputs are DTensors placed by
``launch.sharding``, each rank's shard a ``meta`` tensor (shapes only, no
storage), and the model's ``pspec.shard`` hints redistribute activations
as the reference's constraints do.  ``StepCounter`` counts the step's
FLOPs, bytes and collectives on rank 0's shards; ``MemTracker`` its peak
live memory.  One product and one sum a chunk stand in for the chunked
scan's step-by-step recurrence (``_scan_stand_in``; the record's
``stand_in`` says so).  The state is built with ``DTensor.from_local`` outside the
counter: placing it issues no collective.

The local shards are ``meta`` tensors rather than ``FakeTensor``s under
an ambient ``FakeTensorMode``: DTensor's bookkeeping for shards strided
over two mesh dims (``_StridedShard``, which a reshape of a tensor sharded
over batch and heads gives) computes with small real tensors, which an
ambient fake mode turns into data-dependent fakes.

A process has one default process group, so the dry run runs in a process
of its own (``python -m``), as the reference's does for its ``XLA_FLAGS``;
meshes of another size re-open the fake group.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both --out experiments/dryrun_torch
    PYTHONPATH=src python -m repro_torch.launch.dryrun \\
        --arch jamba-v0.1-52b --shape decode_32k --mesh single
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
from dataclasses import replace
from pathlib import Path
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from .. import pspec
from ..configs import ALIASES, all_arch_ids, get_config
from ..models import encdec, lm, mamba
from ..models.api import cell_is_runnable, input_specs
from ..models.config import SHAPES, ModelConfig, ShapeConfig
from ..optim import adamw_init
from .mesh import make_production_mesh, mesh_axis_sizes
from .roofline import StepCounter, _tensors
from .sharding import (cache_specs, distribute, distribute_params,
                       input_specs_sharding)
from .steps import make_decode_step, make_prefill_step, make_train_step

__all__ = ["run_cell", "run_cells", "open_fake_group", "meta_module",
           "main"]

META = torch.device("meta")


def open_fake_group(world_size: int) -> None:
    """(Re)open the process's default group as a fake one of this size,
    this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size \
                and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def meta_module(cfg: ModelConfig) -> torch.nn.Module:
    """The model's ``nn.Module`` with ``meta`` parameters."""
    if cfg.enc_dec is not None:
        return encdec.EncDec(cfg, encdec.param_specs_encdec(cfg))
    return lm.LM(cfg, lm.param_specs(cfg))


def _scan_stand_in(dA: torch.Tensor, dBx: torch.Tensor, h: torch.Tensor):
    """``mamba._recurrence`` for the dry run: one product and one sum over
    the chunk in place of the C steps' ones (3 dispatches, not 2·C + 1).
    The same shapes, autograd inputs, FLOPs (none) and collectives (none),
    and in a forward the same bytes; a backward moves fewer bytes than
    the loop's, whose every step returns a chunk-sized gradient."""
    hs = (dA * h[:, None].expand_as(dA) + dBx).clone()   # the stack
    return hs, hs[:, -1]


@contextlib.contextmanager
def _with_scan_stand_in():
    prev, mamba._recurrence = mamba._recurrence, _scan_stand_in
    try:
        yield
    finally:
        mamba._recurrence = prev


def _place_tree(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, s, mesh)
                          for v, s in zip(tree, specs))
    return distribute(tree, mesh, specs) if isinstance(tree, torch.Tensor) \
        else tree


def _local_bytes(tree) -> int:
    """Bytes of rank 0's shards of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in
               (x.to_local() if pspec.is_dtensor(x) else x
                for x in _tensors(tree)))


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh_axis_sizes(mesh).values())


def run_cell(cfg: ModelConfig, shape: ShapeConfig, mesh
             ) -> Dict[str, Any]:
    """Place one cell's state on ``mesh`` (a ``DeviceMesh`` over the fake
    group) and run its step once, counted; returns the record."""
    from torch.distributed._tools.mem_tracker import MemTracker
    module = distribute_params(meta_module(cfg), mesh)
    specs = input_specs(cfg, shape)
    in_sh = input_specs_sharding(mesh, specs)
    inputs = {k: distribute(v, mesh, in_sh[k]) for k, v in specs.items()}
    if shape.mode == "train":
        # m/v take the weight's placements (zeros_like of a DTensor);
        # the step count is a host int (the reference's replicated int32)
        state = adamw_init({n: p for n, p in module.named_parameters()
                            if p.requires_grad})
        step, args = make_train_step(cfg), (module, state, inputs)
        arg_bytes = _local_bytes(state) + 4
    else:
        cache = (encdec.init_cache_encdec if cfg.enc_dec is not None
                 else lm.init_cache)(cfg, shape.global_batch, shape.seq_len,
                                     META)
        state = _place_tree(cache, cache_specs(mesh, cfg, cache, shape),
                            mesh)
        if shape.mode == "prefill":
            step, args = make_prefill_step(cfg), (module, state, inputs)
        else:
            step = make_decode_step(cfg)
            args = (module, state, inputs["token"])
        arg_bytes = _local_bytes(state)
    arg_bytes += _local_bytes(dict(module.named_parameters())) \
        + _local_bytes(inputs)

    counter, mem = StepCounter(device="meta"), MemTracker()
    mem.track_external(module, *_tensors((state, inputs)))
    t0 = time.time()
    with _with_scan_stand_in(), pspec.activation_mesh(mesh), mem, counter:
        step(*args)
    run_s = time.time() - t0
    peak = mem.get_tracker_snapshot("peak")
    rec = {
        "arch": cfg.arch_id,
        "shape": shape.name,
        "mesh": _mesh_name(mesh),
        "mode": shape.mode,
        "run_s": round(run_s, 1),
        "memory": {
            "argument_bytes": arg_bytes,
            "peak_bytes": max((d.get("Total", 0) for d in peak.values()),
                              default=0),
        },
        "flops_per_device": counter.flops,
        "bytes_per_device": counter.bytes,
        "collective_counts": counter.collective_counts,
        "collective_bytes": counter.collectives,
        "collective_bytes_total": counter.collective_bytes,
        "n_params": cfg.n_params(),
        "n_active_params": cfg.n_active_params(),
    }
    if "mamba" in cfg.layer_kinds() and shape.mode != "decode":
        rec["stand_in"] = "mamba recurrence: one product and sum a chunk"
        if shape.mode == "train":
            rec["stand_in"] += "; backward bytes below the loop's"
    return rec


def run_cells(arch_ids, shape_names, meshes, out_dir: Path,
              force: bool = False, layers: Optional[int] = None):
    """Every (arch x shape x mesh) cell, one JSON record each under
    ``out_dir``.  ``layers``: cut every arch to this depth (a multiple of
    its pattern period; the record says so under ``cut``)."""
    out_dir.mkdir(parents=True, exist_ok=True)
    results = []
    for mesh_name in meshes:
        multi = mesh_name == "multi"
        mesh = None
        for aid in arch_ids:
            cfg = get_config(aid)
            cut = None
            if layers is not None and layers != cfg.n_layers:
                cut = f"depth {layers} of {cfg.n_layers} layers"
                cfg = replace(cfg, n_layers=layers)
            for sname in shape_names:
                shape = SHAPES[sname]
                ok, why = cell_is_runnable(cfg, shape)
                tag = f"{ALIASES.get(aid, aid)}__{sname}__{mesh_name}"
                path = out_dir / f"{tag}.json"
                if path.exists() and not force:
                    results.append(json.loads(path.read_text()))
                    print(f"[cached] {tag}")
                    continue
                if not ok:
                    rec = {"arch": cfg.arch_id, "shape": sname,
                           "mesh": mesh_name, "skipped": why}
                    path.write_text(json.dumps(rec, indent=1))
                    print(f"[skip]   {tag}: {why}")
                    results.append(rec)
                    continue
                if mesh is None:
                    open_fake_group(512 if multi else 256)
                    mesh = make_production_mesh(multi_pod=multi)
                t0 = time.time()
                try:
                    rec = run_cell(cfg, shape, mesh)
                    if cut:
                        rec.update(cut=cut, n_layers=cfg.n_layers)
                    print(f"[ok]     {tag}: {rec['run_s']}s "
                          f"{rec['flops_per_device']:.4g} FLOP/dev, args "
                          f"{rec['memory']['argument_bytes'] / 2**30:.2f} "
                          f"GiB/dev")
                except Exception as e:  # noqa: BLE001 - record and continue
                    rec = {"arch": cfg.arch_id, "shape": sname,
                           "mesh": mesh_name,
                           "error": f"{type(e).__name__}: {e}",
                           "traceback": traceback.format_exc()[-4000:],
                           "elapsed_s": round(time.time() - t0, 1)}
                    print(f"[FAIL]   {tag}: {type(e).__name__}: {e}")
                path.write_text(json.dumps(rec, indent=1))
                results.append(rec)
    return results


def main(argv: Optional[list] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut every arch to this depth (default: published)")
    args = ap.parse_args(argv)

    archs = all_arch_ids() if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": ["single"], "multi": ["multi"],
              "both": ["single", "multi"]}[args.mesh]
    t0 = time.time()
    results = run_cells(archs, shapes, meshes, Path(args.out),
                        force=args.force, layers=args.layers)
    n_ok = sum("memory" in r for r in results)
    n_skip = sum("skipped" in r for r in results)
    n_fail = sum("error" in r for r in results)
    print(f"\n=== dry-run: {n_ok} ok, {n_skip} skipped (by rule), "
          f"{n_fail} FAILED in {time.time() - t0:.1f} s ===")
    if dist.is_initialized():
        dist.destroy_process_group()
    return 0 if n_fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
