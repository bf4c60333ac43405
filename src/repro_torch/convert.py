"""Carrying AIDGs and LM parameters across from the reference package.

In this system the AIDG plays the part that weights play in a model: the
graph the evaluators run on.  ``aidg_from_numpy`` rebuilds the port's
``AIDG`` from plain numpy arrays and dicts — the fields of any AIDG, for
instance the reference package's — so one graph can be fed to both.

``lm_params_from_numpy`` does the same for an LM: it takes the reference's
parameter pytree as numpy arrays and returns the port's ``LM`` module (an
``EncDec`` for the encoder-decoder family).
``train_state_from_numpy`` takes the reference's training state (the
parameters and AdamW's ``step``, ``m``, ``v``) to the port's;
``train_state_tree`` goes back, into the layout both packages' training
loops checkpoint, and ``load_train_state`` reads such a checkpoint, so a
run trained by either package resumes in the other.  ``cast_params``
casts a module's weights to the compute dtype once, in place (serving).
``surrogate_params_from_numpy`` carries a surrogate's stacked parameters
(the reference's ``init_stacked_params`` or a trained bundle's
``params``) across as tensors.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from .ckpt import load_pytree
from .core.aidg.builder import AIDG
from .device import DeviceLike, resolve_device
from .models import encdec as _ed
from .models import lm as _lm
from .models.config import ModelConfig

__all__ = ["ARRAY_FIELDS", "DICT_FIELDS", "aidg_from_numpy",
           "lm_params_from_numpy", "train_state_from_numpy",
           "train_state_tree", "load_train_state", "cast_params",
           "SURROGATE_LEAVES", "surrogate_params_from_numpy"]

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


def _to_tensor(a, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):       # the checkpoint reader's leaves
        return a.detach().to(device=device, copy=True)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16, as JAX gives it
        t = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16).copy())
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _shape_and_dtype(a) -> Tuple[tuple, str]:
    if isinstance(a, torch.Tensor):
        return tuple(a.shape), str(a.dtype).replace("torch.", "")
    a = np.asarray(a)
    return tuple(a.shape), a.dtype.name


def _numpy_dtype_name(dtype: torch.dtype) -> str:
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]


def _leaves(tree: Mapping, prefix=()):
    for name, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (name,))
        else:
            yield prefix + (name,), val


def _skeleton(spec_tree: Mapping) -> Dict:
    """The nested dicts of ``spec_tree`` without leaves (so empty ones, the
    non-parametric norms, are kept)."""
    return {k: _skeleton(v) for k, v in spec_tree.items()
            if isinstance(v, Mapping)}


def _set(dest: Dict, path, value) -> None:
    for key in path[:-1]:
        dest = dest.setdefault(key, {})
    dest[path[-1]] = value


def _ref_leaf(tree: Mapping, path, who: str, what: str):
    node: Any = tree
    for key in path:
        try:
            node = node[key]
        except (KeyError, IndexError, TypeError):
            raise KeyError(f"{who}: missing leaf {what}") from None
    return node


def _ref_leaves(tree, prefix=()):
    """(path, leaf) over a reference pytree of dicts, lists and tuples
    (sequence indices are ints in the path)."""
    items = tree.items() if isinstance(tree, Mapping) else enumerate(tree)
    for key, val in items:
        if isinstance(val, (Mapping, list, tuple)):
            yield from _ref_leaves(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def _name(path) -> str:
    """A reference path as text: ``blocks[0]/mix/wq[3]``."""
    out = ""
    for key in path:
        out += f"[{key}]" if isinstance(key, int) else (
            f"/{key}" if out else key)
    return out


def _family(cfg: ModelConfig):
    """(the port's layout as ``meta`` tensors, where the reference stacks
    each layer list, the module class) of ``cfg``'s family."""
    if cfg.enc_dec is not None:
        return (_ed.param_specs_encdec(cfg), _ed.stacks_encdec(cfg),
                _ed.EncDec)
    return _lm.param_specs(cfg), _lm.stacks(cfg), _lm.LM


def _port_layout(cfg: ModelConfig, tree: Mapping, dev: torch.device,
                 who: str, dtype: Optional[torch.dtype] = None) -> Dict:
    """The reference's parameter-shaped pytree -> the port's nested layout
    (``{"embed", "layers": [...], ...}``, or the enc-dec's) of tensors on
    ``dev``, every leaf's shape and dtype (the parameter's, or ``dtype``)
    checked."""
    specs, stack_list, _ = _family(cfg)
    expected = set()

    def take(dest: Dict, path, ref_path, spec: torch.Tensor):
        what = _name(ref_path)
        a = _ref_leaf(tree, ref_path, who, what)
        shape, name = _shape_and_dtype(a)
        want = _numpy_dtype_name(dtype or spec.dtype)
        if shape != tuple(spec.shape) or name != want:
            raise ValueError(f"{who}: {what} is {name} {shape}, the port "
                             f"expects {want} {tuple(spec.shape)}")
        _set(dest, path, _to_tensor(a, dev))

    top = {k: v for k, v in specs.items() if k not in dict(stack_list)}
    out = _skeleton(top)
    for path, spec in _leaves(top):
        expected.add(path)
        take(out, path, path, spec)
    positions: Dict[str, set] = {}
    for list_name, place in stack_list:
        out[list_name] = []
        for i, layer_spec in enumerate(specs[list_name]):
            prefix, r = place(i)
            if len(prefix) == 2:
                positions.setdefault(prefix[0], set()).add(prefix[1])
            lt = _skeleton(layer_spec)
            for path, spec in _leaves(layer_spec):
                expected.add(prefix + path)
                take(lt, path, prefix + path + (r,), spec)
            out[list_name].append(lt)

    for seq, pos in positions.items():
        if len(tree.get(seq, ())) != len(pos):
            raise ValueError(f"{who}: {len(tree.get(seq, ()))} pattern "
                             f"positions in {seq}, the config has "
                             f"{len(pos)}")
    extra = [_name(path) for path, _ in _ref_leaves(tree)
             if path not in expected]
    if extra:
        raise ValueError(f"{who}: leaves the port does not expect: {extra}")
    return out


def lm_params_from_numpy(cfg: ModelConfig, tree: Mapping,
                         device: DeviceLike = None) -> torch.nn.Module:
    """The reference's parameter pytree (leaves as numpy arrays) -> the
    port's module on ``device``.  Decoder-only (``repro.models.lm.
    init_params`` layout: ``embed``, ``blocks`` -- a tuple over pattern
    positions of dicts whose leaves stack the R repeats --, ``final_norm``,
    ``unembed``, ``patch_proj``): an ``LM``, whose layer ``r * P + pos``
    takes ``blocks[pos][...][r]``.  Enc-dec (``repro.models.encdec``:
    ``enc_pos``, ``enc_blocks``, ``enc_norm``, ``embed``, ``dec_pos``,
    ``dec_blocks``, ``final_norm``): an ``EncDec``, whose encoder and
    decoder layer ``i`` take ``enc_blocks[...][i]`` and
    ``dec_blocks[...][i]``.  Every leaf's shape and dtype is checked
    against the port's layout; a missing leaf is named, and so is one the
    port does not expect."""
    cls = _family(cfg)[2]
    return cls(cfg, _port_layout(cfg, tree, resolve_device(device),
                                 "lm_params_from_numpy"))


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The port's nested layout -> {parameter name: tensor}, named as the
    module's ``named_parameters`` (``layers.3.mix.wq``)."""
    out: Dict[str, torch.Tensor] = {}
    for name, val in tree.items():
        if isinstance(val, Mapping):
            out.update(_flat(val, f"{prefix}{name}."))
        elif isinstance(val, list):
            for i, sub in enumerate(val):
                out.update(_flat(sub, f"{prefix}{name}.{i}."))
        else:
            out[prefix + name] = val
    return out


def _nest(spec, flat: Mapping[str, torch.Tensor], prefix: str = ""):
    """The nesting of ``spec`` (the port's layout) with its leaves taken
    from ``flat`` ({parameter name: tensor}, ``_flat``'s inverse) as
    detached CPU tensors."""
    if isinstance(spec, Mapping):
        return {k: _nest(v, flat, f"{prefix}{k}.") for k, v in spec.items()}
    if isinstance(spec, list):
        return [_nest(v, flat, f"{prefix}{i}.") for i, v in enumerate(spec)]
    return flat[prefix[:-1]].detach().cpu()


def train_state_from_numpy(cfg: ModelConfig, params_tree: Mapping,
                           opt_tree: Mapping, device: DeviceLike = None
                           ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """The reference's training state -> the port's: its parameter pytree
    (as ``lm_params_from_numpy`` takes it) and its AdamW state
    ``{"step", "m", "v"}`` (the moments float32 and shaped like the
    parameters) become the module (trainable) and the state
    ``optim.adamw_init`` shapes: ``{"step": int, "m": {name: tensor},
    "v": {...}}``, keyed by the module's parameter names.  Leaves are
    numpy arrays or CPU tensors (``ckpt.load_pytree`` gives those)."""
    dev = resolve_device(device)
    cls = _family(cfg)[2]
    model = cls(cfg, _port_layout(cfg, params_tree, dev, "params"))
    state: Dict[str, Any] = {"step": int(np.asarray(opt_tree["step"]))}
    for k in ("m", "v"):
        state[k] = _flat(_port_layout(cfg, opt_tree[k], dev, f"opt/{k}",
                                      dtype=torch.float32))
    return model, state


def train_state_tree(model: torch.nn.Module, opt_state: Mapping) -> Dict:
    """The port's module (``LM`` or ``EncDec``) and AdamW state -> the
    reference's layout of the training state, ``{"params": parameter
    pytree, "opt": {"step", "m", "v"}}``, as CPU tensors (``step`` int32):
    what both packages' ``train_loop`` checkpoint, so either resumes the
    other's run."""
    specs, stack_list, _ = _family(model.cfg)

    def ref_layout(flat: Mapping[str, torch.Tensor]) -> Dict:
        return _lm.reference_layout(_nest(specs, flat), stack_list)

    return {"params": ref_layout(dict(model.named_parameters())),
            "opt": {"step": torch.tensor(opt_state["step"],
                                         dtype=torch.int32),
                    "m": ref_layout(opt_state["m"]),
                    "v": ref_layout(opt_state["v"])}}


def load_train_state(cfg: ModelConfig, path, device: DeviceLike = None
                     ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """A training checkpoint directory (``step_…/``) that either package's
    ``train_loop`` wrote -> ``train_state_from_numpy``'s (LM, state); read
    with numpy and torch alone, bfloat16 leaves included."""
    tree = load_pytree(path)
    return train_state_from_numpy(cfg, tree["params"], tree["opt"], device)


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


# leaf -> its shape in (S cells, G groups, J paths, K knobs)
SURROGATE_LEAVES: Dict[str, str] = {
    "a": "SGJ", "w_raw": "SGJK", "tau_raw": "SG", "alpha_raw": "SK",
    "beta_raw": "S", "gamma_raw": "S"}


def surrogate_params_from_numpy(tree: Mapping[str, object],
                                device: DeviceLike = None
                                ) -> Dict[str, torch.Tensor]:
    """A surrogate's stacked parameter dict (every leaf of
    ``SURROGATE_LEAVES``, float32 array-likes with a leading cell axis, as
    the reference's ``init_stacked_params`` gives them) -> float32 tensors
    on ``device`` that the port's ``surrogate.model`` takes.  Missing or
    extra leaves, other dtypes and inconsistent shapes raise."""
    dev = resolve_device(device)
    missing = [k for k in SURROGATE_LEAVES if k not in tree]
    if missing:
        raise KeyError(f"surrogate_params_from_numpy: missing leaves "
                       f"{missing}")
    extra = sorted(set(tree) - set(SURROGATE_LEAVES))
    if extra:
        raise ValueError(f"surrogate_params_from_numpy: unknown leaves "
                         f"{extra}")
    arrs = {k: np.asarray(tree[k]) for k in SURROGATE_LEAVES}
    dims: Dict[str, int] = {}
    for k, a in arrs.items():
        axes = SURROGATE_LEAVES[k]
        if a.dtype != np.float32:
            raise ValueError(f"{k}: dtype {a.dtype}, expected float32")
        if a.ndim != len(axes):
            raise ValueError(f"{k}: shape {a.shape}, expected axes {axes}")
        for ax, n in zip(axes, a.shape):
            if dims.setdefault(ax, n) != n:
                raise ValueError(f"{k}: axis {ax} is {n}, other leaves "
                                 f"give {dims[ax]}")
    return {k: torch.tensor(a, device=dev) for k, a in arrs.items()}
