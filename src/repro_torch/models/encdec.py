"""Whisper-style encoder-decoder (whisper-small backbone) in PyTorch: the
port of ``repro.models.encdec``.

The conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, encoder_len, d_model), what the two
stride-2 convs of real Whisper produce (1500 frames for 30 s of audio).

Encoder: bidirectional dense attention over the frames, sinusoidal
positions.  Decoder: causal self-attention, cross-attention over the
encoder's output, learned positions, non-gated GELU MLPs, LayerNorm
everywhere, tied embeddings.  The attention impls are the reference's
(``dense`` in the encoder and the cross-attention, ``chunked`` in the
decoder's self-attention): no kernel lies on this path.

The parameters live in ``EncDec``: ``enc_pos``, ``enc_layers`` (one
``Params`` per encoder layer: ``ln1``, ``attn``, ``ln2``, ``mlp``),
``enc_norm``, ``embed``, ``dec_pos``, ``dec_layers`` (``ln1``, ``self``,
``lnx``, ``cross``, ``ln2``, ``mlp``) and ``final_norm``; encoder layer
``i`` is the reference's ``enc_blocks[...][i]``, decoder layer ``i`` its
``dec_blocks[...][i]``.  A full pass records autograd when grad mode is on
and a parameter requires a gradient (the reference applies no remat
here), else it runs under ``torch.inference_mode``; ``prefill_encdec`` and
``decode_step_encdec`` always do, and update the caches in place.  The
reference's sharding hints sit where it has them (``pspec.shard``: the
residual stream batch- and sequence-sharded); outside a registered mesh
they return their input.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .. import pspec
from .config import ModelConfig
from . import layers as L
from .layers import init_norm, norm
from .lm import (Norm, Params, _dtype, _layer_cache, _parameter, _tokens,
                 _unrecorded, cast_tree, lookup, records_grad,
                 reference_layout, unrecorded)

__all__ = ["EncDec", "init_params_encdec", "param_specs_encdec",
           "abstract_params_encdec", "stacks_encdec", "encode",
           "forward_encdec", "init_cache_encdec", "prefill_encdec",
           "decode_step_encdec"]


def _sinusoidal(length: int, d: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    dim = np.arange(0, d, 2)[None, :]
    ang = pos / np.power(10_000.0, dim / d)
    out = np.zeros((length, d), np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out


class EncDec(nn.Module):
    """The encoder-decoder; ``tree`` is the port's layout of the
    reference's parameters: {"enc_pos", "enc_layers": [layer dicts],
    "enc_norm", "embed", "dec_pos", "dec_layers": [...], "final_norm"}."""

    def __init__(self, cfg: ModelConfig, tree: Dict):
        super().__init__()
        self.cfg = cfg
        for name, n in (("enc_layers", cfg.enc_dec.n_encoder_layers),
                        ("dec_layers", cfg.n_layers)):
            if len(tree[name]) != n:
                raise ValueError(f"{len(tree[name])} {name} for a config "
                                 f"with {n}")
            self.add_module(name, nn.ModuleList(Params(t)
                                                for t in tree[name]))
        for name in ("enc_pos", "embed", "dec_pos"):
            self.register_parameter(name, _parameter(tree[name]))
        self.enc_norm = Norm(tree["enc_norm"])
        self.final_norm = Norm(tree["final_norm"])

    def forward(self, tokens, frames):
        return forward_encdec(self, self.cfg, tokens, frames)


# ---------------------------------------------------------------------------
# parameter construction
# ---------------------------------------------------------------------------


def _init_xattn(gen, cfg: ModelConfig, d: int, dtype: torch.dtype,
                device) -> Dict:
    a = cfg.attention
    s = d ** -0.5
    hd = a.n_heads * a.head_dim
    return {"wq": L.normal(gen, (d, hd), dtype, s, device),
            "wk": L.normal(gen, (d, hd), dtype, s, device),
            "wv": L.normal(gen, (d, hd), dtype, s, device),
            "wo": L.normal(gen, (hd, d), dtype, s, device)}


def _init_tree(cfg: ModelConfig, gen, device) -> Dict:
    dtype = _dtype(cfg.param_dtype)
    d, e = cfg.d_model, cfg.enc_dec

    def ln():
        return init_norm("layernorm", d, dtype, device)

    def mlp():
        return L.init_mlp(gen, d, cfg.d_ff, dtype, device, gated=False)

    def enc_layer():
        return {"ln1": ln(),
                "attn": L.init_attention(gen, cfg.attention, d, dtype,
                                         device),
                "ln2": ln(), "mlp": mlp()}

    def dec_layer():
        return {"ln1": ln(),
                "self": L.init_attention(gen, cfg.attention, d, dtype,
                                         device),
                "lnx": ln(), "cross": _init_xattn(gen, cfg, d, dtype, device),
                "ln2": ln(), "mlp": mlp()}

    device = torch.device(device)
    if device.type == "meta":
        enc_pos = torch.empty((e.encoder_len, d), dtype=dtype, device=device)
    else:
        enc_pos = torch.from_numpy(_sinusoidal(e.encoder_len, d)).to(
            device=device, dtype=dtype)
    return {
        "enc_pos": enc_pos,
        "enc_layers": [enc_layer() for _ in range(e.n_encoder_layers)],
        "enc_norm": ln(),
        "embed": L.normal(gen, (cfg.vocab_size, d), dtype, d ** -0.5, device),
        "dec_pos": L.normal(gen, (min(cfg.max_seq_len, 32768), d), dtype,
                            0.02, device),
        "dec_layers": [dec_layer() for _ in range(cfg.n_layers)],
        "final_norm": ln(),
    }


def init_params_encdec(cfg: ModelConfig, generator: torch.Generator
                       ) -> EncDec:
    """Random parameters at the reference's init scales (not its PRNG
    stream), drawn from ``generator`` on its device; ``enc_pos`` is the
    sinusoidal table."""
    return EncDec(cfg, _init_tree(cfg, generator, generator.device))


def param_specs_encdec(cfg: ModelConfig) -> Dict:
    """The port's parameter layout as ``meta`` tensors."""
    return _init_tree(cfg, None, torch.device("meta"))


def stacks_encdec(cfg: ModelConfig):
    """Where the reference keeps each layer list (see ``lm.stacks``):
    encoder layer ``i`` at ``enc_blocks[...][i]``, decoder layer ``i`` at
    ``dec_blocks[...][i]``."""
    return [("enc_layers", lambda i: (("enc_blocks",), i)),
            ("dec_layers", lambda i: (("dec_blocks",), i))]


def abstract_params_encdec(cfg: ModelConfig) -> Dict:
    """The reference's parameter pytree as ``meta`` tensors (the dry
    run): nothing is drawn and no storage is allocated."""
    return reference_layout(param_specs_encdec(cfg), stacks_encdec(cfg))


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _zero_positions(s: int, device) -> torch.Tensor:
    """Whisper uses no RoPE; the GQA block with positions 0 (rope(0) is
    the identity) serves, as in the reference."""
    return torch.zeros((1, s), dtype=torch.long, device=device)


def _layer_in(x: torch.Tensor, ln) -> torch.Tensor:
    """A sublayer's input: the normed residual, its sequence gathered (as
    ``lm``'s layers do: DTensor cannot multiply an activation split over
    both batch and sequence)."""
    return pspec.shard(norm("layernorm", x, ln), "batch", None, None)


def _branch(t: torch.Tensor) -> torch.Tensor:
    """A sublayer's output on the residual's layout: the row-parallel
    product's partial sums resolved before the add (``lm._layer_apply``)."""
    return pspec.shard(t, "batch", "sp", None)


def _cross_attn(lp, x: torch.Tensor, enc_k: torch.Tensor,
                enc_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    a = cfg.attention
    q = L.split_heads(x @ lp["wq"], a.n_heads, a.head_dim)
    out = L._attend(q, enc_k, enc_v, causal=False, window=0, impl="dense",
                    chunk=0)
    return _branch(L.merge_heads(out) @ lp["wo"])


def _enc_kv(lp_cross, enc_out: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    a = cfg.attention
    k = L.split_heads(enc_out @ lp_cross["wk"], a.n_heads, a.head_dim)
    v = L.split_heads(enc_out @ lp_cross["wv"], a.n_heads, a.head_dim)
    return k, v


def _pass(fn, params: EncDec, *args):
    """``fn(params, *args)``, under ``torch.inference_mode`` unless
    autograd records it (``lm.records_grad``)."""
    if records_grad(params):
        return fn(params, *args)
    with unrecorded(params):
        return fn(params, *args)


def encode(params: EncDec, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames: (B, encoder_len, d) precomputed conv-frontend output (the
    stub) -> the encoder's output in the compute dtype."""
    return _pass(_encode, params, cfg, frames)


def _encode(params: EncDec, cfg: ModelConfig, frames) -> torch.Tensor:
    dtype = _dtype(cfg.compute_dtype)
    frames = torch.as_tensor(frames, device=params.embed.device)
    x = frames.to(dtype) + params.enc_pos.to(dtype)[None]
    x = pspec.shard(x, "batch", "sp", None)
    zero_pos = _zero_positions(x.shape[1], x.device)
    for layer in params.enc_layers:
        lp = cast_tree(layer.tree(), dtype)
        h = _layer_in(x, lp["ln1"])
        mixed, _ = L.attention_block(lp["attn"], h, cfg.attention,
                                     positions=zero_pos, causal=False,
                                     impl="dense")
        x = x + _branch(mixed)
        h = _layer_in(x, lp["ln2"])
        x = pspec.shard(x + _branch(L.mlp_block(lp["mlp"], h, "gelu")),
                        "batch", "sp", None)
    return _layer_in(x, params.enc_norm.tree())


def _decoder_input(params: EncDec, tokens: torch.Tensor, start: int,
                   dtype: torch.dtype) -> torch.Tensor:
    s = tokens.shape[1]
    return (lookup(params.embed, tokens).to(dtype)
            + params.dec_pos[start:start + s].to(dtype)[None])


def _logits(params: EncDec, x: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    return _layer_in(x, params.final_norm.tree()) @ \
        pspec.pin_grad(params.embed).T.to(dtype)


def forward_encdec(params: EncDec, cfg: ModelConfig, tokens,
                   frames) -> torch.Tensor:
    """Teacher-forced decode over the whole token sequence (training,
    scoring): logits (B, S, V)."""
    return _pass(_forward, params, cfg, tokens, frames)


def _forward(params: EncDec, cfg: ModelConfig, tokens, frames
             ) -> torch.Tensor:
    dtype = _dtype(cfg.compute_dtype)
    enc_out = _encode(params, cfg, frames)
    x = pspec.shard(_decoder_input(params, _tokens(params, tokens), 0,
                                   dtype), "batch", "sp", None)
    zero_pos = _zero_positions(x.shape[1], x.device)
    for layer in params.dec_layers:
        lp = cast_tree(layer.tree(), dtype)
        h = _layer_in(x, lp["ln1"])
        mixed, _ = L.attention_block(lp["self"], h, cfg.attention,
                                     positions=zero_pos, causal=True,
                                     impl="chunked", chunk=1024)
        x = x + _branch(mixed)
        h = _layer_in(x, lp["lnx"])
        x = x + _cross_attn(lp["cross"], h,
                            *_enc_kv(lp["cross"], enc_out, cfg), cfg)
        h = _layer_in(x, lp["ln2"])
        x = pspec.shard(x + _branch(L.mlp_block(lp["mlp"], h, "gelu")),
                        "batch", "sp", None)
    return _logits(params, x, dtype)


# ---------------------------------------------------------------------------
# serving: cache init / prefill / decode
# ---------------------------------------------------------------------------


def init_cache_encdec(cfg: ModelConfig, batch: int, max_len: int,
                      device) -> Dict[str, List]:
    """Per decoder layer, in layer order: the self-attention KV buffer
    (``"self"``, as the LM's attention caches) and the encoder's keys and
    values for the cross-attention (``"cross_k"``, ``"cross_v"``: (B,
    encoder_len, H, D)), which ``prefill_encdec`` fills."""
    dtype = _dtype(cfg.compute_dtype)
    a, e = cfg.attention, cfg.enc_dec
    cross = lambda: [torch.zeros((batch, e.encoder_len, a.n_heads,  # noqa
                                  a.head_dim), dtype=dtype, device=device)
                     for _ in range(cfg.n_layers)]
    return {"self": [_layer_cache(cfg, "attn", batch, max_len, dtype, device)
                     for _ in range(cfg.n_layers)],
            "cross_k": cross(), "cross_v": cross()}


@_unrecorded
def prefill_encdec(params: EncDec, cfg: ModelConfig, tokens, frames,
                   cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Encode the audio and run the prompt tokens, filling the self- and
    cross-attention caches (in place).  Returns (last-position logits
    (B, 1, V), caches)."""
    dtype = _dtype(cfg.compute_dtype)
    enc_out = _encode(params, cfg, frames)
    x = pspec.shard(_decoder_input(params, _tokens(params, tokens), 0,
                                   dtype), "batch", "sp", None)
    zero_pos = _zero_positions(x.shape[1], x.device)
    self_c = []
    for i, layer in enumerate(params.dec_layers):
        lp = cast_tree(layer.tree(), dtype)
        h = _layer_in(x, lp["ln1"])
        mixed, nc = L.attention_block(lp["self"], h, cfg.attention,
                                      positions=zero_pos, causal=True,
                                      cache=cache["self"][i],
                                      impl="chunked", chunk=1024)
        self_c.append(nc)
        x = x + _branch(mixed)
        ck, cv = _enc_kv(lp["cross"], enc_out, cfg)
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
        h = _layer_in(x, lp["lnx"])
        x = x + _cross_attn(lp["cross"], h, ck, cv, cfg)
        h = _layer_in(x, lp["ln2"])
        x = x + _branch(L.mlp_block(lp["mlp"], h, "gelu"))
    return _logits(params, x[:, -1:], dtype), dict(cache, self=self_c)


@_unrecorded
def decode_step_encdec(params: EncDec, cfg: ModelConfig, token,
                       cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """One decode step: token (B, 1) -> logits (B, 1, V), caches (the
    self-attention buffers updated in place)."""
    dtype = _dtype(cfg.compute_dtype)
    pos0 = int(cache["self"][0]["pos"])
    x = _decoder_input(params, _tokens(params, token), pos0, dtype)
    zero_pos = _zero_positions(1, x.device)
    self_c = []
    for i, layer in enumerate(params.dec_layers):
        lp = cast_tree(layer.tree(), dtype)
        h = _layer_in(x, lp["ln1"])
        mixed, nc = L.attention_block(lp["self"], h, cfg.attention,
                                      positions=zero_pos, causal=True,
                                      cache=cache["self"][i], impl="dense")
        self_c.append(nc)
        x = x + _branch(mixed)
        h = _layer_in(x, lp["lnx"])
        x = x + _cross_attn(lp["cross"], h, cache["cross_k"][i],
                            cache["cross_v"][i], cfg)
        h = _layer_in(x, lp["ln2"])
        x = x + _branch(L.mlp_block(lp["mlp"], h, "gelu"))
    return _logits(params, x, dtype), dict(cache, self=self_c)
