"""Decoder-only LM over the config schema, in PyTorch: the port of
``repro.models.lm`` for the GQA, MLA, Mamba and MoE families.

The parameters live in ``nn.Module``s whose parameter names are the
reference's leaf names: ``LM`` holds ``embed``, ``layers`` (one ``Block``
per layer: ``ln1``, ``mix`` = ``Attention``, ``MLA`` or ``Mamba``, ``ln2``,
``ffn`` = ``MLP`` or ``MoE``), ``final_norm`` and, untied, ``unembed``.  The
reference stacks layers by pattern position; layer ``r * P + pos`` here
holds the reference's ``blocks[pos][...][r]`` (``P = pattern_period``).
The functions below take the ``LM`` where the reference takes its
parameter pytree.  Floating parameters are trainable masters (float32 by
default).

Entry points:
  init_params(cfg, generator)          random parameters at the reference's
                                       init scales, on the generator's device
  abstract_params(cfg)                 the reference's parameter layout as
                                       ``meta`` tensors (the dry run)
  forward / forward_with_aux           logits of a full pass: training
                                       (under autograd) or scoring
  init_cache / prefill / decode_step   serving path with KV/SSM caches,
                                       under ``torch.inference_mode``

A full pass records autograd when grad mode is on and a parameter requires
a gradient; then ``remat`` follows the reference's hierarchical
rematerialisation: each group of ``cfg.remat_group`` pattern-period
repeats runs under ``torch.utils.checkpoint`` (non-reentrant), which
saves the group's input and nothing inside it, and the backward recomputes
the group (``remat=False``: plain autograd).  Otherwise the pass runs under
``torch.inference_mode``.  The hand-written kernels have no backward (nor
have the reference's Pallas kernels): a recorded pass on CUDA tensors with
the kernel impls raises; on the CPU their plain versions are
differentiable.

Weights are cast to the compute dtype inside the pass, keeping the
numerics-critical leaves (``_F32_LEAVES``) in float32, as ``cast_tree``
does in the reference (under remat, once, outside the checkpointed groups,
as the reference casts outside its scan); ``convert.cast_params`` does
that cast once, in place, for serving, so a pass then copies nothing.
Caches are updated in place (see ``layers.attention_block``).  While a
profiler records, each part of a pass opens a span (``runtime.spans``):
the embedding, each layer's cast, norms, mixer and FFN, the unembedding,
and ``prefill`` or ``decode`` around the whole.  The layer
output's cotangent is cast to the compute dtype
(``_grad_to_compute_dtype``), as in the reference.  The reference's
``_barrier`` (an XLA scheduling hint, the identity) has no counterpart in
eager PyTorch.  Its sharding hints sit where it has them
(``pspec.shard``): outside a registered mesh, or on plain tensors, they
return their input; on DTensor parameters under
``pspec.activation_mesh`` they redistribute the activations, and a pass
that autograd does not record runs under ``torch.no_grad`` rather than
inference mode (``unrecorded``).  The encoder-decoder family is
``models.encdec``.
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from .. import pspec
from .config import ModelConfig
from . import layers as L
from .layers import init_norm, norm
from .mamba import init_mamba, init_mamba_cache, mamba_block
from .moe import init_moe, moe_block
from ..runtime.spans import span, spanned

__all__ = ["pattern_period", "cast_tree", "init_params", "param_specs",
           "abstract_params", "stacks", "reference_layout", "forward",
           "forward_with_aux", "init_cache", "prefill", "decode_step", "LM",
           "Block", "Attention", "MLA", "Mamba", "MLP", "MoE", "Norm",
           "Params", "keeps_f32", "records_grad", "unrecorded"]

# parameters kept in float32 regardless of compute dtype (numerics-critical)
_F32_LEAVES = ("A_log", "D", "dt_bias", "router")


def _dtype(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def pattern_period(cfg: ModelConfig) -> int:
    p = cfg.attn_period
    if cfg.moe is not None:
        p = math.lcm(p, cfg.moe.every)
    assert cfg.n_layers % p == 0, (cfg.n_layers, p)
    return p


def keeps_f32(name: str) -> bool:
    """Whether the leaf ``name`` stays float32 under ``cast_tree``."""
    return any(k in name for k in _F32_LEAVES)


def cast_tree(tree: Mapping, dtype: torch.dtype) -> Dict:
    """Cast weight leaves to the compute dtype, keeping numerics-critical
    leaves (SSM decay, router) in float32.  A leaf already in ``dtype`` is
    returned as it is (no copy)."""
    out: Dict[str, Any] = {}
    for name, a in tree.items():
        if isinstance(a, Mapping):
            out[name] = cast_tree(a, dtype)
        elif keeps_f32(name) or a.dtype not in (torch.float32,
                                                torch.bfloat16):
            out[name] = a
        else:
            out[name] = a.to(dtype)
    return out


# ---------------------------------------------------------------------------
# modules
# ---------------------------------------------------------------------------


def _parameter(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=t.is_floating_point())


class Params(nn.Module):
    """A module holding a nested dict of tensors as parameters and
    sub-modules, named by the dict's keys; floating ones are trainable."""

    def __init__(self, tree: Mapping):
        super().__init__()
        for name, val in tree.items():
            if isinstance(val, Mapping):
                self.add_module(name, Params(val))
            else:
                self.register_parameter(name, _parameter(val))

    def tree(self) -> Dict:
        """The parameters as the reference's nested dict of leaves."""
        out: Dict[str, Any] = dict(self.named_parameters(recurse=False))
        for name, child in self.named_children():
            out[name] = child.tree()
        return out


class Norm(Params):
    """``scale`` (rmsnorm), ``scale`` and ``bias`` (layernorm), or nothing
    (non-parametric LayerNorm)."""


class Attention(Params):
    """GQA attention: ``wq``, ``wk``, ``wv``, ``wo``."""


class MLA(Params):
    """Multi-head latent attention: ``wdq``, ``q_norm``, ``wuq``, ``wdkv``,
    ``kv_norm``, ``wkr``, ``wuk``, ``wuv``, ``wo``."""


class Mamba(Params):
    """Mamba-1 mixer: ``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``,
    ``dt_proj``, ``dt_bias``, ``A_log``, ``D``, ``out_proj``."""


class MLP(Params):
    """Gated (``w_gate``, ``w_up``, ``w_down``) or plain FFN."""


class MoE(Params):
    """``router``, stacked experts ``w_gate``/``w_up``/``w_down``, and an
    optional ``shared`` MLP."""


class Block(nn.Module):
    """One layer: ``ln1``, ``mix``, and (unless pure-mamba) ``ln2``,
    ``ffn``; ``kind`` and ``is_moe`` say which."""

    def __init__(self, kind: str, is_moe: bool, tree: Mapping):
        super().__init__()
        self.kind, self.is_moe = kind, is_moe
        self.ln1 = Norm(tree["ln1"])
        mixer = Mamba if kind == "mamba" else (
            MLA if "wdkv" in tree["mix"] else Attention)
        self.mix = mixer(tree["mix"])
        if "ffn" in tree:
            self.ln2 = Norm(tree["ln2"])
            self.ffn = (MoE if is_moe else MLP)(tree["ffn"])

    def tree(self) -> Dict:
        return {name: child.tree() for name, child in self.named_children()}


class LM(nn.Module):
    """The decoder-only LM; ``tree`` is the port's layout of the
    reference's parameters: {"embed", "layers": [layer dicts], "final_norm",
    "unembed"?, "patch_proj"?}."""

    def __init__(self, cfg: ModelConfig, tree: Mapping):
        super().__init__()
        self.cfg = cfg
        kinds, moes = cfg.layer_kinds(), cfg.moe_layers()
        if len(tree["layers"]) != cfg.n_layers:
            raise ValueError(f"{len(tree['layers'])} layers for a "
                             f"{cfg.n_layers}-layer config")
        self.layers = nn.ModuleList(
            Block(kinds[i], moes[i], lt)
            for i, lt in enumerate(tree["layers"]))
        self.final_norm = Norm(tree["final_norm"])
        for name in ("embed", "unembed", "patch_proj"):
            if name in tree:
                self.register_parameter(name, _parameter(tree[name]))
        if "unembed" not in tree:
            self.unembed = None

    def forward(self, tokens, patches=None, impl=None, chunk: int = 1024):
        return forward(self, self.cfg, tokens, patches, impl, chunk)


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def _init_layer(gen, cfg: ModelConfig, kind: str, is_moe: bool,
                dtype: torch.dtype, device) -> Dict:
    p: Dict[str, Any] = {"ln1": init_norm(cfg.norm, cfg.d_model, dtype,
                                          device),
                         "ln2": init_norm(cfg.norm, cfg.d_model, dtype,
                                          device)}
    if kind == "attn":
        init = L.init_mla if cfg.attention.kind == "mla" else \
            L.init_attention
        p["mix"] = init(gen, cfg.attention, cfg.d_model, dtype, device)
    else:
        p["mix"] = init_mamba(gen, cfg.ssm, cfg.d_model, dtype, device)
    if is_moe:
        p["ffn"] = init_moe(gen, cfg.moe, cfg.d_model, dtype, device)
    elif cfg.d_ff > 0:
        gated = cfg.activation == "silu"
        p["ffn"] = L.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype, device,
                              gated=gated)
    else:
        del p["ln2"]  # pure-mamba layer (falcon-mamba): mixer only
    return p


def _init_tree(cfg: ModelConfig, gen, device) -> Dict:
    dtype = _dtype(cfg.param_dtype)
    kinds, moes = cfg.layer_kinds(), cfg.moe_layers()
    s = cfg.d_model ** -0.5
    tree: Dict[str, Any] = {
        "embed": L.normal(gen, (cfg.vocab_size, cfg.d_model), dtype, s,
                          device),
        "layers": [_init_layer(gen, cfg, kinds[i], moes[i], dtype, device)
                   for i in range(cfg.n_layers)],
        "final_norm": init_norm(cfg.norm, cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = L.normal(gen, (cfg.d_model, cfg.vocab_size), dtype,
                                   s, device)
    if cfg.n_patches > 0:  # VLM stub: projection of precomputed patch embeds
        tree["patch_proj"] = L.normal(gen, (cfg.d_model, cfg.d_model), dtype,
                                      s, device)
    return tree


def init_params(cfg: ModelConfig, generator: torch.Generator) -> LM:
    """Random parameters at the reference's init scales (not its PRNG
    stream), drawn from ``generator`` on the generator's device."""
    pattern_period(cfg)
    return LM(cfg, _init_tree(cfg, generator, generator.device))


def param_specs(cfg: ModelConfig) -> Dict:
    """The port's parameter layout as ``meta`` tensors (shapes and dtypes,
    no storage)."""
    return _init_tree(cfg, None, torch.device("meta"))


def stacks(cfg: ModelConfig):
    """Where the reference keeps each layer of the port's layout: ``[(list
    name, place)]``, ``place(i)`` -> (path of layer ``i``'s stacked dict in
    the reference's tree, its index along the stacked axis).  Layer
    ``r * P + pos`` is ``blocks[pos][...][r]``."""
    P = pattern_period(cfg)
    return [("layers", lambda i: (("blocks", i % P), i // P))]


def reference_layout(tree: Mapping, stack_list) -> Dict:
    """The port's layout (lists of layer dicts, as ``param_specs``) -> the
    reference's: each list goes where ``stack_list`` places its layers (a
    dict, or a tuple of dicts by pattern position), each leaf the
    ``torch.stack`` of its layers' in layer order (``meta`` tensors stay
    ``meta``: no storage)."""
    out: Dict[str, Any] = {k: v for k, v in tree.items()
                           if k not in dict(stack_list)}
    for name, place in stack_list:
        groups: Dict[tuple, list] = {}
        for i, layer in enumerate(tree[name]):
            groups.setdefault(place(i)[0], []).append(layer)
        for path, members in groups.items():
            stacked = _stack_trees(members)
            if len(path) == 1:
                out[path[0]] = stacked
            else:           # (name, position): a tuple over positions
                seq = list(out.get(path[0], [None] * len(groups)))
                seq[path[1]] = stacked
                out[path[0]] = tuple(seq)
    return out


def _stack_trees(trees: List[Mapping]) -> Dict:
    return {k: _stack_trees([t[k] for t in trees])
            if isinstance(v, Mapping) else torch.stack([t[k] for t in trees])
            for k, v in trees[0].items()}


def abstract_params(cfg: ModelConfig) -> Dict:
    """The reference's parameter pytree (``blocks`` a tuple over pattern
    positions whose leaves stack the repeats) as ``meta`` tensors: the
    dry run's shapes and dtypes; nothing is drawn and no storage is
    allocated."""
    return reference_layout(param_specs(cfg), stacks(cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


class _GradToComputeDtype(torch.autograd.Function):
    """Identity whose backward casts the cotangent to the primal's dtype
    (the reference's ``_grad_to_compute_dtype``): float32 cotangents from
    the float32 statistics (norms, attention scores) do not carry on into
    the layers below, so inter-layer gradients stay in the compute dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def _grad_to_compute_dtype(x: torch.Tensor) -> torch.Tensor:
    return _GradToComputeDtype.apply(x) if x.requires_grad else x


@spanned("repro_torch.norm")
def _norm(cfg: ModelConfig, x: torch.Tensor, p: Mapping) -> torch.Tensor:
    return norm(cfg.norm, x, p)


@spanned("repro_torch.layer")
def _layer_apply(cfg: ModelConfig, kind: str, is_moe: bool, lp: Mapping,
                 x: torch.Tensor, positions: torch.Tensor,
                 cache: Optional[Dict], impl: str, chunk: int,
                 ) -> Tuple[torch.Tensor, Optional[Dict], torch.Tensor]:
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    # Megatron-SP discipline: the residual is sequence-sharded between
    # layers and gathered at layer entry.  The reference keeps serving's h
    # sequence-sharded into the projections; DTensor cannot multiply an
    # activation split over both batch and sequence (no strided split of a
    # flattened (B, S) before torch 2.13), so serving gathers it too
    h = pspec.shard(_norm(cfg, x, lp["ln1"]), "batch", None, None)
    if kind == "attn":
        fn = L.mla_block if cfg.attention.kind == "mla" else \
            L.attention_block
        with span("repro_torch.attention"):
            mixed, new_cache = fn(lp["mix"], h, cfg.attention,
                                  positions=positions, causal=True,
                                  cache=cache, impl=impl, chunk=chunk)
    else:
        with span("repro_torch.mamba"):
            mixed, new_cache = mamba_block(lp["mix"], h, cfg.ssm,
                                           cache=cache, impl=cfg.ssm_impl)
    # the row-parallel products' partial sums resolve onto the residual's
    # layout before the add (DTensor's gradient cannot return a shard to a
    # partial sum before torch 2.13)
    mixed = pspec.shard(mixed, "batch", "sp", None)
    x = _grad_to_compute_dtype(pspec.shard(x + mixed, "batch", "sp", None))
    if "ffn" not in lp:          # pure-mamba layer (falcon-mamba)
        return x, new_cache, aux
    h = pspec.shard(_norm(cfg, x, lp["ln2"]), "batch", None, None)
    if is_moe:
        with span("repro_torch.moe"):
            ff, aux = moe_block(lp["ffn"], h, cfg.moe,
                                activation=cfg.activation)
    else:
        with span("repro_torch.mlp"):
            ff = L.mlp_block(lp["ffn"], h, cfg.activation)
    ff = pspec.shard(ff, "batch", "sp", None)
    return (_grad_to_compute_dtype(pspec.shard(x + ff, "batch", "sp", None)),
            new_cache, aux)


def _tokens(params: LM, tokens) -> torch.Tensor:
    t = torch.as_tensor(tokens, dtype=torch.long, device=params.embed.device)
    # the lookup takes the batch over one mesh axis: DTensor's index rule
    # refuses a dim split over two (the multi-pod mesh's pod and data)
    return pspec.shard(t, "fsdp", *[None] * (t.dim() - 1))


def lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; on a mesh ``F.embedding``, whose gradient DTensor
    shards (the index's, an ``index_put`` into the table, it does not).
    The table's model dim is gathered first (FSDP's gather): split over
    the data axis that also splits the tokens, DTensor would gather the
    tokens instead and mask the vocabulary shards with the ungathered
    tokens' mask.  The rows' masked partial sums resolve at once, onto
    the residual stream's layout: met by another operand first, they
    make DTensor mask that operand with a mask its sharding cache kept
    from an earlier lookup (torch 2.11)."""
    if pspec.is_dtensor(table):
        rows = F.embedding(tokens, pspec.shard(pspec.pin_grad(table), "tp",
                                               None))
        return pspec.shard(rows, "batch", "sp", None)
    return table[tokens]


@spanned("repro_torch.embed")
def _embed(params: LM, cfg: ModelConfig, tokens: torch.Tensor,
           patches, dtype: torch.dtype) -> torch.Tensor:
    x = lookup(params.embed, tokens).to(dtype)
    if cfg.n_patches > 0 and patches is not None:
        patches = torch.as_tensor(patches, device=x.device)
        px = patches.to(dtype) @ params.patch_proj.to(dtype)
        x = torch.cat([px, x], dim=1)
    # pin the residual-stream layout: the vocab-sharded gather would
    # otherwise leave x replicated (see ``pspec``)
    return pspec.shard(x, "batch", "sp", None)


@spanned("repro_torch.unembed")
def _unembed(params: LM, x: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    x = pspec.shard(x, "batch", None, None)   # sequence gathered, as above
    if params.unembed is None:
        logits = x @ pspec.pin_grad(params.embed).T.to(dtype)
    else:
        logits = x @ params.unembed.to(dtype)
    return pspec.shard(logits, "batch", None, "tp")


def _layers(params: LM, dtype: torch.dtype):
    """(layer, its parameters cast to the compute dtype), layer by layer."""
    for layer in params.layers:
        with span("repro_torch.cast"):
            lp = cast_tree(layer.tree(), dtype)
        yield layer, lp


_KERNEL_IMPLS = {"attn": ("flash_pallas", "flash_pallas_interpret"),
                 "mamba": ("pallas", "pallas_interpret")}


def records_grad(params: nn.Module) -> bool:
    """Whether a pass over ``params`` is recorded by autograd: grad mode is
    on and a parameter requires a gradient."""
    return torch.is_grad_enabled() and any(p.requires_grad
                                           for p in params.parameters())


def forward_with_aux(params: LM, cfg: ModelConfig, tokens,
                     patches=None, impl: Optional[str] = None,
                     chunk: int = 1024, remat: bool = True
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens: (B, S_text); VLM: patches (B, n_patches, d) prepended.
    Returns (logits (B, S_total, V), MoE aux loss).  Recorded by autograd
    when grad mode is on and a parameter requires a gradient (with
    ``remat``: checkpointed groups of ``cfg.remat_group`` pattern-period
    repeats), else run under ``torch.inference_mode``."""
    impl = impl or cfg.attention_impl
    if not records_grad(params):
        with unrecorded(params):
            return _forward(params, cfg, tokens, patches, impl, chunk, None)
    if params.embed.is_cuda:
        used = {"attn": impl, "mamba": cfg.ssm_impl}
        for kind in set(cfg.layer_kinds()):
            if used[kind] in _KERNEL_IMPLS[kind]:
                raise NotImplementedError(
                    f"the {used[kind]!r} kernel has no backward (nor has the "
                    f"reference's Pallas kernel): a pass recorded by "
                    f"autograd takes the chunked impls (run scoring under "
                    f"torch.no_grad or torch.inference_mode)")
    group = None
    if remat:
        group = max(1, cfg.remat_group)
        repeats = cfg.n_layers // pattern_period(cfg)
        if repeats % group:
            raise ValueError(f"remat_group {group} does not divide the "
                             f"{repeats} pattern-period repeats")
    return _forward(params, cfg, tokens, patches, impl, chunk, group)


def _forward(params: LM, cfg: ModelConfig, tokens, patches, impl: str,
             chunk: int, group: Optional[int]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The pass; ``group``: pattern-period repeats per checkpointed group,
    or None for no checkpointing."""
    dtype = _dtype(cfg.compute_dtype)
    x = _embed(params, cfg, _tokens(params, tokens), patches, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)

    def run(layers, x, aux):
        for layer, lp in layers:
            x, _, a = _layer_apply(cfg, layer.kind, layer.is_moe, lp, x,
                                   positions, None, impl, chunk)
            aux = aux + a
        return x, aux

    if group is None:
        x, aux = run(_layers(params, dtype), x, aux)
    else:
        layers = list(_layers(params, dtype))   # cast once, outside
        n = group * pattern_period(cfg)
        for g0 in range(0, len(layers), n):
            x, aux = checkpoint(run, layers[g0:g0 + n], x, aux,
                                use_reentrant=False,
                                preserve_rng_state=False)
    x = _norm(cfg, x, params.final_norm.tree())
    return _unembed(params, x, dtype), aux


def forward(params: LM, cfg: ModelConfig, tokens, patches=None,
            impl: Optional[str] = None, chunk: int = 1024,
            remat: bool = True) -> torch.Tensor:
    return forward_with_aux(params, cfg, tokens, patches, impl, chunk,
                            remat)[0]


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                 dtype: torch.dtype, device) -> Dict:
    a = cfg.attention
    if kind == "attn" and a.kind == "mla":
        return {"c_kv": torch.zeros((batch, max_len, a.kv_lora_rank),
                                    dtype=dtype, device=device),
                "k_rope": torch.zeros((batch, max_len, a.qk_rope_head_dim),
                                      dtype=dtype, device=device),
                "pos": 0}
    if kind == "attn":
        t = max_len if a.window == 0 else min(max_len,
                                              _round_up(a.window, 128))
        return {"k": torch.zeros((batch, t, a.n_kv_heads, a.head_dim),
                                 dtype=dtype, device=device),
                "v": torch.zeros((batch, t, a.n_kv_heads, a.head_dim),
                                 dtype=dtype, device=device),
                "kpos": torch.full((t,), -1, dtype=torch.int32,
                                   device=device),
                "pos": 0}
    return init_mamba_cache(cfg.ssm, cfg.d_model, batch, dtype, device)


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               device) -> List[Dict]:
    """One cache per layer, in layer order (attention: KV ring or buffer
    with absolute positions; MLA: the compressed KV and the rotary key;
    mamba: conv tail and SSM state)."""
    dtype = _dtype(cfg.compute_dtype)
    return [_layer_cache(cfg, kind, batch, max_len, dtype, device)
            for kind in cfg.layer_kinds()]


def unrecorded(params: nn.Module):
    """The context of a pass over ``params`` that autograd does not
    record: ``torch.inference_mode``, or ``torch.no_grad`` for DTensor
    parameters (a device mesh): DTensor's in-place slice writes into the
    caches cannot run under inference mode."""
    if pspec.is_dtensor(next(params.parameters())):
        return torch.no_grad()
    return torch.inference_mode()


def _unrecorded(fn):
    @functools.wraps(fn)
    def wrapper(params, *args, **kwargs):
        with unrecorded(params):
            return fn(params, *args, **kwargs)
    return wrapper


@_unrecorded
@spanned("repro_torch.prefill")
def prefill(params: LM, cfg: ModelConfig, tokens, cache: List[Dict],
            patches=None, impl: str = "chunked", chunk: int = 1024
            ) -> Tuple[torch.Tensor, List[Dict]]:
    """Run the prompt through the model, filling the caches.  Returns
    (last-position logits (B, 1, V), caches)."""
    dtype = _dtype(cfg.compute_dtype)
    x = _embed(params, cfg, _tokens(params, tokens), patches, dtype)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    new_cache = []
    for (layer, lp), c in zip(_layers(params, dtype), cache):
        x, nc, _ = _layer_apply(cfg, layer.kind, layer.is_moe, lp, x,
                                positions, c, impl, chunk)
        new_cache.append(nc if nc is not None else c)
    x = _norm(cfg, x[:, -1:], params.final_norm.tree())
    return _unembed(params, x, dtype), new_cache


@_unrecorded
@spanned("repro_torch.decode")
def decode_step(params: LM, cfg: ModelConfig, token, cache: List[Dict]
                ) -> Tuple[torch.Tensor, List[Dict]]:
    """One decode step.  token: (B, 1) -> logits (B, 1, V), caches."""
    dtype = _dtype(cfg.compute_dtype)
    with span("repro_torch.embed"):
        x = pspec.shard(lookup(params.embed,
                               _tokens(params, token)).to(dtype),
                        "batch", None, None)
    positions = torch.full((1, 1), _find_pos(cache), dtype=torch.long,
                           device=x.device)
    new_cache = []
    for (layer, lp), c in zip(_layers(params, dtype), cache):
        x, nc, _ = _layer_apply(cfg, layer.kind, layer.is_moe, lp, x,
                                positions, c, "dense", 1024)
        new_cache.append(nc if nc is not None else c)
    x = _norm(cfg, x, params.final_norm.tree())
    return _unembed(params, x, dtype), new_cache


def _find_pos(cache: List[Dict]) -> int:
    for c in cache:
        if "pos" in c:
            return int(c["pos"])
    return 0
