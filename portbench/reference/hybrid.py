"""A hybrid Mamba-attention expert LM (AI21-Jamba2-Mini) in plain
float32 PyTorch: the reference that decides ``correct`` in
``drivers/prefill_hybrid.py``'s cells.  It imports nothing of the port.

    x = embed[tokens]
    per layer (``seeded_hybrid.kinds``):  h = rmsnorm(x)
        attention: GQA, causal softmax(q kᵀ / √D) v, no positional encoding
        Mamba-1:   x', z = h W_in;  x' = silu(causal depthwise conv(x') +
                   conv_b);  dt, B, C = x' W_x, each through an RMSNorm
                   with its gain;  dt = softplus(dt W_dt + dt_bias);
                   h_t = exp(dt_t A) h_{t-1} + dt_t x'_t B_t (h_0 = 0,
                   A = -exp(A_log));  y_t = C_t · h_t + D x'_t;
                   out = (y ⊙ silu(z)) W_out
        x = x + out;  h = rmsnorm(x)
        experts:   p = softmax(h W_router) over every expert; the top k
                   kept (or the ids a ``route`` hook hands in: a check
                   replays the program's routes), their probabilities the
                   gates (no renormalisation); each held expert e adds
                   Σ_k [id_k = e] p_k · swiglu_e(h)
        dense:     swiglu(h) = (silu(h W_gate) ⊙ h W_up) W_down
        x = x + that
    logits = rmsnorm(x) W_unembed at the last position

The equations of transformers' ``modeling_jamba.py``.  Departures: float32
throughout (TF32 off), where the model computes in bf16; only the held
experts' part of an expert layer, the part one card of the expert-
parallel deployment computes; eps 1e-6 (the configuration's
``rms_norm_eps``).  The scan steps one time step at a time, in blocks of
``SCAN_BLOCK`` steps whose factors exp(dt A) and dt x B are made at once;
attention runs a request at a time, in query blocks (``lm.attention``);
the FFNs in blocks of ``ROW_BLOCK`` rows; no (S, S) score matrix exists at
once.  ``Precision("fp8")`` (``reference/lm.py``) is the control.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..seeded_hybrid import dims, kinds
from .lm import Precision, attention as _attention

EPS = 1e-6
SCAN_BLOCK = 256
ROW_BLOCK = 8192


def rmsnorm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * \
        gain.float()


def _w(flat, name) -> torch.Tensor:
    return flat[name].float()


def attention_layer(h, flat, p, s, prec: Precision):
    """(out, k, v): k and v (B, S, KV, D) as the cache holds them."""
    b, n, _ = h.shape
    hd = s["head_dim"]
    q = prec.mm(h, _w(flat, p + "wq")).view(b, n, s["heads"], hd)
    k = prec.mm(h, _w(flat, p + "wk")).view(b, n, s["kv_heads"], hd)
    v = prec.mm(h, _w(flat, p + "wv")).view(b, n, s["kv_heads"], hd)
    a = torch.cat([_attention(q[r:r + 1], k[r:r + 1], v[r:r + 1], prec)
                   for r in range(b)])
    out = prec.mm(a.reshape(b, n, s["heads"] * hd), _w(flat, p + "wo"))
    return out, k, v


def scan(x, dt, bm, cm, a, d):
    """y (B, S, Di) and h_S (B, Di, N) of the recurrence from h_0 = 0,
    step by step, the factors made SCAN_BLOCK steps at a time."""
    b, n, di = x.shape
    state = x.new_zeros(b, di, a.shape[1])
    y = torch.empty_like(x)
    for t0 in range(0, n, SCAN_BLOCK):
        t1 = min(n, t0 + SCAN_BLOCK)
        da = torch.exp(dt[:, t0:t1, :, None] * a).transpose(0, 1)
        dbx = ((dt[:, t0:t1] * x[:, t0:t1])[..., None]
               * bm[:, t0:t1, None, :]).transpose(0, 1)
        da, dbx = da.contiguous(), dbx.contiguous()   # (L, B, Di, N)
        hs = torch.empty_like(da)
        for t in range(t1 - t0):
            state = torch.addcmul(dbx[t], da[t], state, out=hs[t])
        y[:, t0:t1] = torch.einsum("lbdn,bln->bld", hs, cm[:, t0:t1]) + \
            d * x[:, t0:t1]
        state = state.clone()
        del da, dbx, hs
    return y, state


def mamba_layer(h, flat, p, s, prec: Precision):
    """(out, h_S (B, Di, N), conv tail (B, d_conv - 1, Di): the conv's last
    d_conv - 1 inputs)."""
    b, n, _ = h.shape
    di, dc, ns = s["d_inner"], s["d_conv"], s["d_state"]
    xz = prec.mm(h, _w(flat, p + "in_proj"))
    z = xz[..., di:].clone()
    xpad = torch.cat([xz.new_zeros(b, dc - 1, di), xz[..., :di]], dim=1)
    del xz
    conv_w = _w(flat, p + "conv_w")
    xc = _w(flat, p + "conv_b").expand(b, n, di).clone()
    for i in range(dc):
        xc.add_(xpad[:, i:i + n] * conv_w[i])
    xc = F.silu(xc)
    tail = xpad[:, n:].clone()
    del xpad
    proj = prec.mm(xc, _w(flat, p + "x_proj"))
    dtr = proj.shape[-1] - 2 * ns
    dt = rmsnorm(proj[..., :dtr], _w(flat, p + "dt_norm"))
    bm = rmsnorm(proj[..., dtr:dtr + ns], _w(flat, p + "b_norm"))
    cm = rmsnorm(proj[..., dtr + ns:], _w(flat, p + "c_norm"))
    dt = F.softplus(prec.mm(dt, _w(flat, p + "dt_proj"))
                    + _w(flat, p + "dt_bias"))
    y, state = scan(xc, dt, bm, cm, -torch.exp(_w(flat, p + "A_log")),
                    _w(flat, p + "D"))
    del xc, dt
    y = y * F.silu(z)
    del z
    return prec.mm(y, _w(flat, p + "out_proj")), state, tail


def swiglu(h, w_gate, w_up, w_down, prec: Precision):
    out = torch.empty_like(h)
    for r0 in range(0, h.shape[0], ROW_BLOCK):
        r = h[r0:r0 + ROW_BLOCK]
        out[r0:r0 + ROW_BLOCK] = prec.mm(
            F.silu(prec.mm(r, w_gate)) * prec.mm(r, w_up), w_down)
    return out


def expert_layer(h, flat, p, s, prec: Precision, route=None):
    """The held experts' part of the dropless top-k layer; each expert
    computes only the rows routed to it.  ``route(probs, ids)``, if given,
    returns the ids (rows, k) the layer takes in place of its own top k;
    the gates are then those ids' probabilities."""
    shape = h.shape
    rows = h.reshape(-1, shape[-1])
    probs = torch.softmax(prec.mm(rows, _w(flat, p + "router")), dim=-1)
    gates, ids = torch.topk(probs, s["top_k"], dim=-1)
    if route is not None:
        ids = route(probs, ids)
        gates = probs.gather(-1, ids)
    out = torch.zeros_like(rows)
    for e in range(s["held"]):
        picked = ids == e
        tok = picked.any(-1).nonzero()[:, 0]
        if tok.numel() == 0:
            continue
        gate = (gates * picked).sum(-1)[tok, None]
        y = swiglu(rows[tok], flat[p + "w_gate"][e].float(),
                   flat[p + "w_up"][e].float(),
                   flat[p + "w_down"][e].float(), prec)
        out.index_add_(0, tok, gate * y)
    return out.view(shape)


def dense_layer(h, flat, p, prec: Precision):
    shape = h.shape
    out = swiglu(h.reshape(-1, shape[-1]), _w(flat, p + "w_gate"),
                 _w(flat, p + "w_up"), _w(flat, p + "w_down"), prec)
    return out.view(shape)


@torch.no_grad()
def prefill(flat: Dict[str, torch.Tensor], conf: dict, tokens: torch.Tensor,
            prec: Precision, kv: Optional[Callable] = None,
            state: Optional[Callable] = None,
            route: Optional[Callable] = None) -> torch.Tensor:
    """The full forward pass over ``tokens`` (B, T); returns the last
    position's logits (B, V).  ``kv(layer, k, v)`` receives each attention
    layer's keys and values (B, T, KV, D); ``state(layer, h_S, tail)``
    each Mamba layer's last state (B, Di, N) and conv tail (B, d_conv - 1,
    Di); ``route(layer, probs, ids)`` each expert layer's router
    probabilities (B T, E) and top-k ids (B T, k), and returns the ids the
    layer takes (a check replays the program's routes so).  Weights (any
    float type) are taken to float32 as they are used."""
    s = dims(conf)
    x = flat["embed"].float()[tokens]
    for i, (mixer, expert) in enumerate(kinds(conf)):
        p = f"layers.{i}."
        if x.is_cuda:
            # the last layer's blocks back to the card: beside ~54 GiB of
            # weights, a cache split by other sizes cannot fit this one's
            torch.cuda.empty_cache()
        h = rmsnorm(x, flat[p + "ln1.scale"])
        if mixer == "attn":
            out, k, v = attention_layer(h, flat, p + "mix.", s, prec)
            if kv is not None:
                kv(i, k, v)
        else:
            out, last, tail = mamba_layer(h, flat, p + "mix.", s, prec)
            if state is not None:
                state(i, last, tail)
        x = x + out
        del h, out
        h = rmsnorm(x, flat[p + "ln2.scale"])
        if expert:
            x = x + expert_layer(
                h, flat, p + "ffn.", s, prec,
                None if route is None else (
                    lambda probs, ids, i=i: route(i, probs, ids)))
        else:
            x = x + dense_layer(h, flat, p + "ffn.", prec)
        del h
    x = rmsnorm(x[:, -1], flat["final_norm.scale"])
    return prec.mm(x, _w(flat, "unembed"))
