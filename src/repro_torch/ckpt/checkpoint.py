"""Atomic, resumable checkpoints of nested dicts (and lists) of tensors:
the port of ``repro.ckpt.checkpoint``, with its on-disk layout, so either
package reads the other's checkpoints.

Layout of one checkpoint:

    <dir>/step_000123/
        manifest.json        # leaf index, shapes/dtypes, data-iter state
        arr_00000.npy ...    # one .npy per leaf (host values)
        COMMIT               # written LAST -> crash-safe atomicity marker

Fault-tolerance contract, as in the reference:

* **atomic** — a checkpoint is written to a ``.tmp_…`` directory that is
  renamed into place once ``COMMIT`` is in it; one without ``COMMIT`` is
  ignored by the loader, so a preemption mid-save can never corrupt the
  restore path;
* **auto-resume** — ``latest_checkpoint`` finds the newest committed step;
* **dtype cast on load** — a leaf is cast to the dtype of the matching
  leaf of ``like``;
* **bounded retention** — keep the newest ``keep`` checkpoints.

A leaf's key is JAX's ``keystr`` of its path (``['params']['blocks'][0]
['mix']['wq']``): dict keys in sorted order, as JAX flattens dicts, lists
and tuples by index; an empty dict has no leaves.  Leaves are tensors (on
any device; copied to the host), numpy arrays or Python numbers.  numpy
has no bfloat16: the reference's ``np.save`` of an ml_dtypes bfloat16
array writes its raw 2-byte values under the descr ``<V2`` (``np.load``
gives a void array) with ``"bfloat16"`` in the manifest, so bfloat16
leaves are written here as those bits under that descr (the file equals
the reference's byte for byte) and read back from the bits.

A restored leaf goes to the device of its ``like`` leaf (the CPU for a
``meta`` tensor, a numpy array, or no ``like``).  With ``shardings`` (a
tree like ``like`` of ``launch.sharding.Named`` placements on a
``DeviceMesh``, None for a leaf to leave whole), each leaf becomes a
DTensor on its mesh, every rank cutting its own shard from the whole
array on its host: the reference's elastic-reshard path, where the mesh
the checkpoint was saved from does not matter.
"""

from __future__ import annotations

import json
import re
import shutil
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["save_pytree", "load_pytree", "latest_checkpoint",
           "manifest_extra", "CheckpointManager"]

COMMIT = "COMMIT"
MANIFEST = "manifest.json"
_KEY_PART = re.compile(r"\[(\d+|'[^']*'|\"[^\"]*\")\]")


def _leaf_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    if isinstance(tree, Mapping):
        return [kv for k in sorted(tree)
                for kv in _leaf_paths(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in _leaf_paths(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def _host_array(leaf) -> Tuple[np.ndarray, str]:
    """(the leaf on the host -- a bfloat16 one as int16 bits --, the
    manifest's dtype name)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype)


def _save_array(path: Path, arr: np.ndarray, dtype: str) -> None:
    if dtype != "bfloat16":
        np.save(path, arr)
        return
    with open(path, "wb") as f:        # ml_dtypes' bfloat16 descr, raw bits
        np.lib.format.write_array_header_1_0(f, {
            "descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr).tobytes())


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    arr = np.require(arr, requirements="C")
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save_pytree(tree, directory: str | Path, step: int,
                extra: Optional[Dict[str, Any]] = None) -> Path:
    """Write one atomic checkpoint; returns its path."""
    directory = Path(directory)
    final = directory / f"step_{step:09d}"
    tmp = directory / f".tmp_step_{step:09d}_{int(time.time()*1e6)}"
    tmp.mkdir(parents=True, exist_ok=True)

    index = []
    for i, (key, leaf) in enumerate(_leaf_paths(tree)):
        arr, dtype = _host_array(leaf)
        fname = f"arr_{i:05d}.npy"
        _save_array(tmp / fname, arr, dtype)
        index.append({"key": key, "file": fname, "shape": list(arr.shape),
                      "dtype": dtype})
    manifest = {"step": step, "index": index, "extra": extra or {},
                "time": time.time(), "version": 1}
    (tmp / MANIFEST).write_text(json.dumps(manifest, indent=1))
    (tmp / COMMIT).write_text("ok")          # commit marker LAST
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                        # atomic on POSIX
    return final


def latest_checkpoint(directory: str | Path) -> Optional[Path]:
    directory = Path(directory)
    if not directory.exists():
        return None
    cands = sorted(p for p in directory.iterdir()
                   if p.name.startswith("step_") and (p / COMMIT).exists())
    return cands[-1] if cands else None


def _key_path(key: str) -> List[Any]:
    parts = _KEY_PART.findall(key)
    if "".join(f"[{p}]" for p in parts) != key:
        raise ValueError(f"not a leaf key: {key!r}")
    return [int(p) if p.isdigit() else p[1:-1] for p in parts]


def _as_tree(node):
    """Nested dicts whose keys are the indices 0..n-1 -> lists."""
    if not isinstance(node, dict):
        return node
    node = {k: _as_tree(v) for k, v in node.items()}
    if node and all(isinstance(k, int) for k in node):
        if sorted(node) != list(range(len(node))):
            raise ValueError(f"list indices {sorted(node)} have gaps")
        return [node[i] for i in range(len(node))]
    return node


def _restore_like(like, loaded: Dict[str, torch.Tensor], shardings,
                  prefix: str = ""):
    if isinstance(like, Mapping):
        return {k: _restore_like(v, loaded, _at(shardings, k),
                                 f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_restore_like(v, loaded, _at(shardings, i),
                                        f"{prefix}[{i}]")
                          for i, v in enumerate(like))
    t = loaded[prefix]
    ref = like if isinstance(like, torch.Tensor) else torch.from_numpy(
        np.asarray(like))
    if shardings is not None:
        from ..launch.sharding import distribute
        return distribute(t.to(ref.dtype), shardings.mesh, shardings)
    device = ref.device if ref.device.type != "meta" else torch.device("cpu")
    return t.to(device=device, dtype=ref.dtype)


def _at(shardings, key):
    return None if shardings is None else shardings[key]


def load_pytree(path: str | Path, like=None, shardings=None):
    """The checkpoint at ``path`` as tensors.  With ``like`` (a tree of
    tensors, ``meta`` ones included, or numpy arrays) the result has its
    structure, each leaf cast to the dtype of its ``like`` leaf; without,
    the tree is rebuilt from the keys (dicts, and lists for indices) with
    the saved dtypes.  ``shardings`` (with ``like``): a tree of
    ``launch.sharding.Named`` placements; each leaf is placed on its mesh
    as a DTensor (elastic re-sharding)."""
    if shardings is not None and like is None:
        raise ValueError("shardings need the structure of like")
    path = Path(path)
    manifest = json.loads((path / MANIFEST).read_text())
    by_key = {e["key"]: e for e in manifest["index"]}
    keys = ([k for k, _ in _leaf_paths(like)] if like is not None
            else list(by_key))
    loaded = {}
    for key in keys:
        e = by_key.get(key)
        if e is None:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        loaded[key] = _tensor(np.load(path / e["file"]), e["dtype"])
    if like is not None:
        return _restore_like(like, loaded, shardings)
    root: Dict[Any, Any] = {}
    for key, t in loaded.items():
        *parents, last = _key_path(key)
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = t
    return _as_tree(root)


def manifest_extra(path: str | Path) -> Dict[str, Any]:
    return json.loads((Path(path) / MANIFEST).read_text())["extra"]


class CheckpointManager:
    """Periodic + on-signal checkpointing with retention and auto-resume."""

    def __init__(self, directory: str | Path, every_steps: int = 100,
                 keep: int = 3):
        self.directory = Path(directory)
        self.every_steps = every_steps
        self.keep = keep

    def should_save(self, step: int) -> bool:
        return step > 0 and step % self.every_steps == 0

    def save(self, tree, step: int, extra: Optional[Dict[str, Any]] = None):
        path = save_pytree(tree, self.directory, step, extra)
        self._gc()
        return path

    def restore_or_none(self, like=None, shardings=None):
        path = latest_checkpoint(self.directory)
        if path is None:
            return None, None
        tree = load_pytree(path, like, shardings)
        return tree, manifest_extra(path)

    def _gc(self) -> None:
        cands = sorted(p for p in self.directory.iterdir()
                       if p.name.startswith("step_") and (p / COMMIT).exists())
        for p in cands[:-self.keep]:
            shutil.rmtree(p, ignore_errors=True)
