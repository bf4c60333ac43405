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
reference's sharding hints have no counterpart here.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
from torch import nn

from .config import ModelConfig
from . import layers as L
from .layers import init_norm, norm
from .lm import (Norm, Params, _dtype, _layer_cache, _parameter, _tokens,
                 cast_tree, records_grad, reference_layout)

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


def _cross_attn(lp, x: torch.Tensor, enc_k: torch.Tensor,
                enc_v: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    a = cfg.attention
    b, s, _ = x.shape
    q = (x @ lp["wq"]).reshape(b, s, a.n_heads, a.head_dim)
    out = L.dense_attention(q, enc_k, enc_v, causal=False)
    return out.reshape(b, s, a.n_heads * a.head_dim) @ lp["wo"]


def _enc_kv(lp_cross, enc_out: torch.Tensor, cfg: ModelConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    a = cfg.attention
    b, t, _ = enc_out.shape
    k = (enc_out @ lp_cross["wk"]).reshape(b, t, a.n_heads, a.head_dim)
    v = (enc_out @ lp_cross["wv"]).reshape(b, t, a.n_heads, a.head_dim)
    return k, v


def _pass(fn, params: EncDec, *args):
    """``fn(params, *args)``, under ``torch.inference_mode`` unless
    autograd records it (``lm.records_grad``)."""
    if records_grad(params):
        return fn(params, *args)
    with torch.inference_mode():
        return fn(params, *args)


def encode(params: EncDec, cfg: ModelConfig, frames) -> torch.Tensor:
    """frames: (B, encoder_len, d) precomputed conv-frontend output (the
    stub) -> the encoder's output in the compute dtype."""
    return _pass(_encode, params, cfg, frames)


def _encode(params: EncDec, cfg: ModelConfig, frames) -> torch.Tensor:
    dtype = _dtype(cfg.compute_dtype)
    frames = torch.as_tensor(frames, device=params.embed.device)
    x = frames.to(dtype) + params.enc_pos.to(dtype)[None]
    zero_pos = _zero_positions(x.shape[1], x.device)
    for layer in params.enc_layers:
        lp = cast_tree(layer.tree(), dtype)
        h = norm("layernorm", x, lp["ln1"])
        mixed, _ = L.attention_block(lp["attn"], h, cfg.attention,
                                     positions=zero_pos, causal=False,
                                     impl="dense")
        x = x + mixed
        h = norm("layernorm", x, lp["ln2"])
        x = x + L.mlp_block(lp["mlp"], h, "gelu")
    return norm("layernorm", x, params.enc_norm.tree())


def _decoder_input(params: EncDec, tokens: torch.Tensor, start: int,
                   dtype: torch.dtype) -> torch.Tensor:
    s = tokens.shape[1]
    return (params.embed[tokens].to(dtype)
            + params.dec_pos[start:start + s].to(dtype)[None])


def _logits(params: EncDec, x: torch.Tensor, dtype: torch.dtype
            ) -> torch.Tensor:
    x = norm("layernorm", x, params.final_norm.tree())
    return x @ params.embed.T.to(dtype)


def forward_encdec(params: EncDec, cfg: ModelConfig, tokens,
                   frames) -> torch.Tensor:
    """Teacher-forced decode over the whole token sequence (training,
    scoring): logits (B, S, V)."""
    return _pass(_forward, params, cfg, tokens, frames)


def _forward(params: EncDec, cfg: ModelConfig, tokens, frames
             ) -> torch.Tensor:
    dtype = _dtype(cfg.compute_dtype)
    enc_out = _encode(params, cfg, frames)
    x = _decoder_input(params, _tokens(params, tokens), 0, dtype)
    zero_pos = _zero_positions(x.shape[1], x.device)
    for layer in params.dec_layers:
        lp = cast_tree(layer.tree(), dtype)
        h = norm("layernorm", x, lp["ln1"])
        mixed, _ = L.attention_block(lp["self"], h, cfg.attention,
                                     positions=zero_pos, causal=True,
                                     impl="chunked", chunk=1024)
        x = x + mixed
        h = norm("layernorm", x, lp["lnx"])
        x = x + _cross_attn(lp["cross"], h,
                            *_enc_kv(lp["cross"], enc_out, cfg), cfg)
        h = norm("layernorm", x, lp["ln2"])
        x = x + L.mlp_block(lp["mlp"], h, "gelu")
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


@torch.inference_mode()
def prefill_encdec(params: EncDec, cfg: ModelConfig, tokens, frames,
                   cache: Dict[str, Any]) -> Tuple[torch.Tensor, Dict]:
    """Encode the audio and run the prompt tokens, filling the self- and
    cross-attention caches (in place).  Returns (last-position logits
    (B, 1, V), caches)."""
    dtype = _dtype(cfg.compute_dtype)
    enc_out = _encode(params, cfg, frames)
    x = _decoder_input(params, _tokens(params, tokens), 0, dtype)
    zero_pos = _zero_positions(x.shape[1], x.device)
    self_c = []
    for i, layer in enumerate(params.dec_layers):
        lp = cast_tree(layer.tree(), dtype)
        h = norm("layernorm", x, lp["ln1"])
        mixed, nc = L.attention_block(lp["self"], h, cfg.attention,
                                      positions=zero_pos, causal=True,
                                      cache=cache["self"][i],
                                      impl="chunked", chunk=1024)
        self_c.append(nc)
        x = x + mixed
        ck, cv = _enc_kv(lp["cross"], enc_out, cfg)
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
        h = norm("layernorm", x, lp["lnx"])
        x = x + _cross_attn(lp["cross"], h, ck, cv, cfg)
        h = norm("layernorm", x, lp["ln2"])
        x = x + L.mlp_block(lp["mlp"], h, "gelu")
    return _logits(params, x[:, -1:], dtype), dict(cache, self=self_c)


@torch.inference_mode()
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
        h = norm("layernorm", x, lp["ln1"])
        mixed, nc = L.attention_block(lp["self"], h, cfg.attention,
                                      positions=zero_pos, causal=True,
                                      cache=cache["self"][i], impl="dense")
        self_c.append(nc)
        x = x + mixed
        h = norm("layernorm", x, lp["lnx"])
        x = x + _cross_attn(lp["cross"], h, cache["cross_k"][i],
                            cache["cross_v"][i], cfg)
        h = norm("layernorm", x, lp["ln2"])
        x = x + L.mlp_block(lp["mlp"], h, "gelu")
    return _logits(params, x, dtype), dict(cache, self=self_c)
