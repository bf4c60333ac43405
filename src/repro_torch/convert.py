"""Carrying AIDGs and LM parameters across from the reference package.

In this system the AIDG plays the part that weights play in a model: the
graph the evaluators run on.  ``aidg_from_numpy`` rebuilds the port's
``AIDG`` from plain numpy arrays and dicts — the fields of any AIDG, for
instance the reference package's — so one graph can be fed to both.

``lm_params_from_numpy`` does the same for an LM: it takes the reference's
parameter pytree as numpy arrays and returns the port's ``LM`` module.
``cast_params`` casts a module's weights to the compute dtype once, in
place.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from .core.aidg.builder import AIDG
from .device import DeviceLike, resolve_device
from .models import lm as _lm
from .models.config import ModelConfig

__all__ = ["ARRAY_FIELDS", "DICT_FIELDS", "aidg_from_numpy",
           "lm_params_from_numpy", "cast_params"]

# field -> dtype of the port's AIDG
ARRAY_FIELDS: Dict[str, type] = {
    "work": np.float32, "fu_lat": np.float32, "mem_lat": np.float32,
    "base": np.float32, "preds": np.int32, "pred_extra": np.float32,
    "op_class": np.int32, "op_scale": np.float32, "mem_words": np.float32,
}
DICT_FIELDS = ("storage_nodes", "storage_lat", "storage_slots", "classes")


def aidg_from_numpy(fields: Mapping[str, object]) -> AIDG:
    """``fields`` holds every name of ``ARRAY_FIELDS`` (array-likes) and
    ``DICT_FIELDS`` (dicts keyed by storage or class name); returns a fresh
    port ``AIDG`` that owns copies of them."""
    missing = [k for k in (*ARRAY_FIELDS, *DICT_FIELDS) if k not in fields]
    if missing:
        raise KeyError(f"aidg_from_numpy: missing fields {missing}")
    arr = {k: np.array(fields[k], dtype=dt) for k, dt in ARRAY_FIELDS.items()}
    n = arr["work"].shape[0]
    if arr["preds"].ndim != 2 or arr["preds"].shape != \
            arr["pred_extra"].shape or arr["preds"].shape[0] != n:
        raise ValueError(f"preds/pred_extra must both be (n={n}, P), got "
                         f"{arr['preds'].shape} and "
                         f"{arr['pred_extra'].shape}")
    return AIDG(
        n=n, **arr,
        storage_nodes={k: np.array(v, dtype=np.int64)
                       for k, v in fields["storage_nodes"].items()},
        storage_lat={k: np.array(v, dtype=np.float32)
                     for k, v in fields["storage_lat"].items()},
        storage_slots={k: int(v) for k, v in fields["storage_slots"].items()},
        classes={k: int(v) for k, v in fields["classes"].items()})


# ---------------------------------------------------------------------------
# LM parameters
# ---------------------------------------------------------------------------


def _to_tensor(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as JAX gives it
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _numpy_dtype_name(dtype: torch.dtype) -> str:
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]


def _leaves(tree: Mapping, prefix=()):
    for name, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (name,))
        else:
            yield prefix + (name,), val


def _ref_leaf(tree: Mapping, path, what: str):
    node: Any = tree
    for key in path:
        try:
            node = node[key]
        except (KeyError, IndexError, TypeError):
            raise KeyError(f"lm_params_from_numpy: missing leaf {what}") \
                from None
    return node


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping,
                         device: DeviceLike = None) -> "_lm.LM":
    """The reference's parameter pytree (``repro.models.lm.init_params``
    layout, leaves as numpy arrays: ``embed``, ``blocks`` — a tuple over
    pattern positions of dicts whose leaves stack the R repeats —,
    ``final_norm``, ``unembed``, ``patch_proj``) -> the port's ``LM`` on
    ``device``.  Layer ``r * P + pos`` takes ``blocks[pos][...][r]``.
    Every leaf's shape and dtype is checked against the port's layout;
    a missing leaf is named, and so is one the port does not expect."""
    dev = resolve_device(device)
    P = _lm.pattern_period(cfg)
    specs = _lm.param_specs(cfg)
    expected = set()

    def take(dest: Dict, path, ref_path, spec: torch.Tensor, what: str):
        a = np.asarray(_ref_leaf(tree, ref_path, what))
        want = _numpy_dtype_name(spec.dtype)
        if tuple(a.shape) != tuple(spec.shape) or a.dtype.name != want:
            raise ValueError(f"lm_params_from_numpy: {what} is {a.dtype.name}"
                             f" {tuple(a.shape)}, the port expects {want} "
                             f"{tuple(spec.shape)}")
        for key in path[:-1]:
            dest = dest.setdefault(key, {})
        dest[path[-1]] = _to_tensor(a, dev)

    def skeleton(spec_tree: Mapping) -> Dict:
        """The nested dicts of ``spec_tree`` without leaves (so empty ones,
        the non-parametric norms, are kept)."""
        return {k: skeleton(v) for k, v in spec_tree.items()
                if isinstance(v, Mapping)}

    top = {k: v for k, v in specs.items() if k != "layers"}
    out = skeleton(top)
    for path, spec in _leaves(top):
        expected.add(("top",) + path)
        take(out, path, path, spec, "/".join(path))
    out["layers"] = []
    for i, layer_spec in enumerate(specs["layers"]):
        r, pos = divmod(i, P)
        lt = skeleton(layer_spec)
        for path, spec in _leaves(layer_spec):
            expected.add(("blocks", pos) + path)
            take(lt, path, ("blocks", pos) + path + (r,), spec,
                 f"blocks[{pos}]/{'/'.join(path)}[{r}]")
        out["layers"].append(lt)

    blocks = tree.get("blocks", ())
    if len(blocks) != P:
        raise ValueError(f"lm_params_from_numpy: {len(blocks)} pattern "
                         f"positions in blocks, the config has {P}")
    extra = [f"blocks[{pos}]/{'/'.join(path)}"
             for pos, blk in enumerate(blocks)
             for path, _ in _leaves(blk)
             if ("blocks", pos) + path not in expected]
    extra += ["/".join(path) for path, _ in _leaves(
        {k: v for k, v in tree.items() if k != "blocks"})
        if ("top",) + path not in expected]
    if extra:
        raise ValueError(f"lm_params_from_numpy: leaves the port does not "
                         f"expect: {extra}")
    return _lm.LM(cfg, out)


def cast_params(model: torch.nn.Module, dtype: torch.dtype
                ) -> torch.nn.Module:
    """Cast, once and in place, the weights that ``cast_tree`` would cast
    on every forward: every float32/bfloat16 parameter except the float32
    leaves (``A_log``, ``D``, ``dt_bias``, ``router``).  One parameter at a
    time, so the peak is the model plus its largest parameter.  Embedding,
    unembedding and the final norm are cast too: the forward casts them at
    use, which gives the same numbers."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if (not _lm.keeps_f32(leaf) and p.dtype != dtype
                    and p.dtype in (torch.float32, torch.bfloat16)):
                p.data = p.data.to(dtype)
    return model
