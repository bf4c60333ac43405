"""Shared model layers in PyTorch: norms, RoPE, the attention family, MLPs.

The port of ``repro.models.layers``.  Functions take their parameters as a
mapping of tensors with the reference's leaf names and are
shape-polymorphic over batch and sequence, as in the reference; the
``nn.Module``s of ``models.lm`` hold those tensors and call them.  Dtypes
follow the reference: norms take their statistics in float32 and apply the
normaliser in ``x``'s dtype; every ``preferred_element_type=float32``
einsum upcasts its operands first, so bf16 inputs give the same numbers.

``impl="flash_pallas"`` (and ``"flash_pallas_interpret"``, the same thing
here) sends attention through ``kernels.flash_attention``: the
hand-written kernel for CUDA tensors, its plain version for CPU tensors.
The chunked impl (training's) sends a call whose input qualifies
(``flash_train_applies``: CUDA, bf16, head dims 128, causal, no window
that cuts, S == T a multiple of 128) to the training flash kernel, which
has a backward; every other call runs ``chunked_attention`` as the
reference does.

MLA (``init_mla``/``mla_block``) prefills and trains through ``_attend``
at Dq = dn + dr != Dv, and decodes in the absorbed form over its
compressed cache.
"""

from __future__ import annotations

import functools
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import pspec
from .config import AttentionConfig
from ..kernels import flash_attention as _fa

__all__ = [
    "rmsnorm", "layernorm", "nonparametric_ln", "norm", "init_norm",
    "rope_frequencies", "apply_rope",
    "chunked_attention", "dense_attention",
    "attention_block", "mla_block", "mlp_block", "split_heads",
    "merge_heads",
    "init_attention", "init_mla", "init_mlp", "normal",
]

NEG = -1e18
Params = Mapping[str, object]


def normal(gen: Optional[torch.Generator], shape, dtype: torch.dtype,
           scale: float, device) -> torch.Tensor:
    """Standard-normal weights times ``scale`` (the reference's init
    scales; not its PRNG stream).  ``gen=None`` on the ``meta`` device
    gives the shape and dtype only."""
    t = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return t.mul_(scale).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def _sq_mean(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return (xf * xf).sum(dim=-1) / x.shape[-1]


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    inv = torch.rsqrt(_sq_mean(x) + eps)[..., None].to(x.dtype)
    return x * inv * scale.to(x.dtype)


def nonparametric_ln(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """OLMo's non-parametric LayerNorm: no scale, no bias."""
    mu = x.float().mean(dim=-1, keepdim=True)
    xc = x - mu.to(x.dtype)
    inv = torch.rsqrt(_sq_mean(xc) + eps)[..., None].to(x.dtype)
    return xc * inv


def layernorm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    return nonparametric_ln(x, eps) * scale.to(x.dtype) + bias.to(x.dtype)


def norm(kind: str, x: torch.Tensor, params: Optional[Params] = None
         ) -> torch.Tensor:
    if kind == "rmsnorm":
        return rmsnorm(x, params["scale"])
    if kind == "layernorm":
        return layernorm(x, params["scale"], params["bias"])
    if kind == "nonparametric_ln":
        return nonparametric_ln(x)
    raise ValueError(kind)


def init_norm(kind: str, d: int, dtype: torch.dtype, device) -> Dict:
    if kind == "rmsnorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        return {"scale": torch.ones((d,), dtype=dtype, device=device),
                "bias": torch.zeros((d,), dtype=dtype, device=device)}
    return {}  # non-parametric


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, device=None
                     ) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    ang = positions[..., None].float() * freqs               # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                       # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# attention cores
# ---------------------------------------------------------------------------


def _expand_kv(k: torch.Tensor, h: int) -> torch.Tensor:
    """(B, T, KV, D) -> (B, T, H, D) by group expansion (jnp.repeat)."""
    kv = k.shape[2]
    if kv == h:
        return k
    return k.repeat_interleave(h // kv, dim=2)


def _scaled(q: torch.Tensor, d: int) -> torch.Tensor:
    """``q / sqrt(d)`` with the divisor rounded to q's dtype first, as the
    reference's ``np.sqrt(d).astype(q.dtype)``."""
    return q / torch.tensor(np.sqrt(d), dtype=q.dtype, device=q.device)


def _mask(s: int, t: int, causal: bool, window: int, q_offset,
          device) -> torch.Tensor:
    qpos = q_offset + torch.arange(s, device=device)[:, None]
    kpos = torch.arange(t, device=device)[None, :]
    mask = torch.ones((s, t), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference attention.  q: (B, S, H, Dq), k/v: (B, T, KV, Dq/Dv);
    ``q_offset`` is the absolute position of q[0]."""
    b, s, h, dq = q.shape
    t = k.shape[1]
    kf = _expand_kv(k, h).float()
    vf = _expand_kv(v, h).float()
    scores = torch.einsum("bshd,bthd->bhst", q.float(), kf) / np.sqrt(dq)
    mask = _mask(s, t, causal, window, q_offset, q.device)
    scores = scores.masked_fill_(~mask, NEG)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhst,bthd->bshd", p, vf)
    return out.to(q.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int = 0, chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Online-softmax attention over KV chunks in plain PyTorch; never
    holds an (S, T) score matrix.  Falls back to ``dense_attention`` when
    T fits one chunk, as the reference does."""
    b, s, h, dq = q.shape
    t = k.shape[1]
    if t <= chunk:
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    assert t % chunk == 0, (t, chunk)
    dv = v.shape[-1]
    # the reference's head pins (uneven when H doesn't divide TP, e.g.
    # MLA's 40 heads); on a mesh ``_attend_on_mesh`` runs this function on
    # each rank's shards, with the heads already split
    kf = pspec.shard(_expand_kv(k, h), "batch", None, "tp_pad", None)
    vf = pspec.shard(_expand_kv(v, h), "batch", None, "tp_pad", None)
    qf = pspec.shard(_scaled(q, dq), "batch", None, "tp_pad", None).float()
    qpos = q_offset + torch.arange(s, device=q.device)
    m = torch.full((b, h, s), NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, s), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s, dv), dtype=torch.float32, device=q.device)
    for ci in range(t // chunk):
        kb = kf[:, ci * chunk:(ci + 1) * chunk]          # (B, C, H, Dq)
        vb = vf[:, ci * chunk:(ci + 1) * chunk]
        scores = torch.einsum("bshd,bchd->bhsc", qf, kb.float())
        kpos = ci * chunk + torch.arange(chunk, device=q.device)
        mask = torch.ones((s, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos[:, None] >= kpos[None, :]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        scores = scores.masked_fill_(~mask, NEG)
        m_new = torch.maximum(m, scores.amax(dim=-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhsc,bchd->bhsd", p.to(vb.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.movedim(1, 2).to(q.dtype)


# chunked-route attention calls on CUDA tensors that did not qualify for
# the training flash kernels (``_attend`` counts them; zero it by hand)
CHUNKED_CUDA_CALLS = 0


def flash_train_applies(q, k, v, *, causal: bool, window: int,
                        q_offset: int = 0) -> bool:
    """Whether a chunked-route call over q (B, S, H, Dq), k/v (B, T, KV,
    Dq/Dv) takes ``flash_attention_train``: decided from the input alone
    -- CUDA tensors in bf16, Dq == Dv == 128, causal, no window short of T,
    no query offset, S == T and a multiple of the kernel's tile."""
    s, t = q.shape[1], k.shape[1]
    return (all(x.is_cuda and x.dtype == torch.bfloat16 for x in (q, k, v))
            and q.shape[-1] == v.shape[-1] == _fa.TRAIN_HEAD_DIM
            and causal and (window == 0 or window >= t)
            and q_offset == 0 and s == t and s % _fa.TRAIN_TILE == 0)


def _flash_train(q, k, v) -> torch.Tensor:
    """Causal attention through the training kernel: q scaled in its dtype
    first (as ``chunked_attention`` scales it), k and v expanded to q's
    heads, (B, S, H, D) -> (B*H, S, D) and back."""
    b, s, h, d = q.shape
    qh, kh, vh = (x.movedim(2, 1).reshape(b * h, s, d).contiguous()
                  for x in (_scaled(q, d), _expand_kv(k, h), _expand_kv(v, h)))
    out = _fa.flash_attention_train(qh, kh, vh, scale=1.0)
    return out.reshape(b, h, s, d).movedim(1, 2)


def _attend(q, k, v, *, causal, window, impl, chunk, q_offset=0):
    global CHUNKED_CUDA_CALLS
    if pspec.is_dtensor(q):
        return _attend_on_mesh(q, k, v, causal=causal, window=window,
                               impl=impl, chunk=chunk, q_offset=q_offset)
    if impl == "dense":
        return dense_attention(q, k, v, causal=causal, window=window,
                               q_offset=q_offset)
    if impl in ("flash_pallas", "flash_pallas_interpret"):
        # the kernel path: (B, S, H, D) -> (B*H, S, D); the kernel reads KV
        # head i // (H/KV) itself, so k and v stay at KV heads
        b, s, h, dq = q.shape
        t, kv, dv = k.shape[1], k.shape[2], v.shape[-1]
        qh = q.movedim(2, 1).reshape(b * h, s, dq).contiguous()
        kh = k.movedim(2, 1).reshape(b * kv, t, dq).contiguous()
        vh = v.movedim(2, 1).reshape(b * kv, t, dv).contiguous()
        out = _fa.flash_attention(qh, kh, vh, causal=causal, window=window)
        return out.reshape(b, h, s, dv).movedim(1, 2)
    if flash_train_applies(q, k, v, causal=causal, window=window,
                           q_offset=q_offset):
        return _flash_train(q, k, v)
    if q.is_cuda:
        CHUNKED_CUDA_CALLS += 1
    return chunked_attention(q, k, v, causal=causal, window=window,
                             chunk=chunk, q_offset=q_offset)


def _attend_on_mesh(q, k, v, **kw):
    """``_attend`` on DTensors: every (batch, head) pair is independent, so
    attention runs on each rank's shards (``local_map``) with q, k and v
    split alike, batch over the data axes and heads over TP.  k and v are
    expanded to q's heads first, as views, so that a split KV head dim
    splits its groups with it.  Heads that do not divide TP (MLA's 40 on
    16) are padded with zero heads to the next multiple, as XLA pads the
    reference's ``tp_pad`` split (40 to 48), and cut off after."""
    from torch.distributed.tensor.experimental import local_map
    b, t, kv, dq = k.shape
    h, dv = q.shape[2], v.shape[-1]
    if kv != h:
        k = k[:, :, :, None].expand(b, t, kv, h // kv, dq).reshape(b, t, h, dq)
        v = v[:, :, :, None].expand(b, t, kv, h // kv, dv).reshape(b, t, h, dv)
    pad = -h % pspec.axis_size("tp_pad")
    if pad:
        q, k, v = (torch.cat([pspec.shard(x, "batch", None, None, None),
                              torch.zeros(x.shape[:2] + (pad, x.shape[3]),
                                          dtype=x.dtype, device=x.device)],
                             dim=2) for x in (q, k, v))
    heads = pspec.placements_of(q, "batch", None, "tp_pad", None)
    attend = local_map(functools.partial(_attend, **kw),
                       out_placements=(heads,),
                       in_placements=(heads, heads, heads),
                       device_mesh=q.device_mesh, redistribute_inputs=True)
    out = attend(q, k, v)
    return pspec.shard(out, "batch", None, None, None)[:, :, :h] if pad \
        else out


# ---------------------------------------------------------------------------
# GQA / SWA attention block
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: AttentionConfig, d_model: int,
                   dtype: torch.dtype, device) -> Dict:
    a = cfg
    s = d_model ** -0.5
    return {
        "wq": normal(gen, (d_model, a.n_heads * a.head_dim), dtype, s, device),
        "wk": normal(gen, (d_model, a.n_kv_heads * a.head_dim), dtype, s,
                     device),
        "wv": normal(gen, (d_model, a.n_kv_heads * a.head_dim), dtype, s,
                     device),
        "wo": normal(gen, (a.n_heads * a.head_dim, d_model), dtype, s, device),
    }


def _reshape_heads(t: torch.Tensor, heads: int, shape) -> torch.Tensor:
    """``t.reshape(B, S, *shape)``.  Where the heads do not split evenly
    over TP (mistral-large's 8 KV heads, whisper's 12 heads, MLA's 40 on
    16), DTensor can neither unflatten a split that cuts a head nor
    flatten an uneven one, where XLA pads: the reshape then runs on whole
    heads, each rank's batch rows (``local_map`` pins that layout in the
    gradient too)."""
    if heads % pspec.axis_size("tp") == 0:
        return t.reshape(t.shape[0], t.shape[1], *shape)
    from torch.distributed.tensor.experimental import local_map
    rows = pspec.placements_of(t, "batch")
    reshape = local_map(lambda x: x.reshape(x.shape[0], x.shape[1], *shape),
                        out_placements=(rows,), in_placements=(rows,),
                        device_mesh=t.device_mesh, redistribute_inputs=True)
    return reshape(t)


def split_heads(t: torch.Tensor, heads: int, head_dim: int) -> torch.Tensor:
    """(B, S, heads * head_dim) -> (B, S, heads, head_dim)."""
    return _reshape_heads(t, heads, (heads, head_dim))


def merge_heads(t: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> (B, S, H * D)."""
    return _reshape_heads(t, t.shape[2], (t.shape[2] * t.shape[3],))


def attention_block(params: Params, x: torch.Tensor, cfg: AttentionConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    cache: Optional[Dict] = None, impl: str = "chunked",
                    chunk: int = 1024) -> Tuple[torch.Tensor, Optional[Dict]]:
    """GQA (optionally sliding-window) attention.

    ``cache``: {"k": (B, T, KV, D), "v": ..., "kpos": (T,) int32, "pos":
    int} for prefill and decode (x is then (B, 1, d)).  Returns (out,
    new_cache).  The cache's tensors are updated IN PLACE where the
    reference writes a slice (decode, and a prefill shorter than the
    cache): use the returned cache, not the one passed in."""
    a = cfg
    b, s, _ = x.shape
    q = split_heads(x @ params["wq"], a.n_heads, a.head_dim)
    k = split_heads(x @ params["wk"], a.n_kv_heads, a.head_dim)
    v = split_heads(x @ params["wv"], a.n_kv_heads, a.head_dim)
    q = apply_rope(q, positions, a.rope_theta)
    k = apply_rope(k, positions, a.rope_theta)

    new_cache = None
    if cache is not None:
        t = cache["k"].shape[1]
        pos = int(cache["pos"])
        kd, vd = cache["k"].dtype, cache["v"].dtype
        ring = a.window > 0 and t < 1 << 30   # SWA caches are ring buffers
        if s == 1:
            idx = pos % t if ring else pos
            ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
            ck[:, idx] = k[:, 0].to(kd)
            cv[:, idx] = v[:, 0].to(vd)
            kpos[idx] = pos
        elif s >= t:
            # prefill longer than the ring: keep the last t positions at
            # their ring slots (slot of position p is p % t)
            shift = s % t
            ck = _roll(k[:, -t:].to(kd), shift, 1)
            cv = _roll(v[:, -t:].to(vd), shift, 1)
            kpos = _roll(torch.arange(s - t, s, dtype=torch.int32,
                                      device=x.device), shift, 0)
        else:
            ck, cv, kpos = cache["k"], cache["v"], cache["kpos"]
            ck[:, :s] = k.to(kd)
            cv[:, :s] = v.to(vd)
            kpos[:s] = torch.arange(s, dtype=torch.int32, device=x.device)
        new_cache = {"k": ck, "v": cv, "kpos": kpos, "pos": pos + s}
        if s == 1:
            out = _decode_attention(q, ck, cv, kpos, pos, window=a.window)
        else:  # prefill: attention over the fresh keys directly
            out = _attend(q, k, v, causal=causal, window=a.window, impl=impl,
                          chunk=chunk)
    else:
        out = _attend(q, k, v, causal=causal, window=a.window, impl=impl,
                      chunk=chunk)
    out = merge_heads(out) @ params["wo"]
    return out, new_cache


def _roll(x: torch.Tensor, shift: int, dim: int) -> torch.Tensor:
    """``torch.roll(x, shift, dim)`` (a copy) as slices and a concat,
    which DTensor shards (it has no rule for ``roll`` before torch 2.13)."""
    n = x.shape[dim]
    if shift % n == 0:
        return x.clone()
    return torch.cat([x.narrow(dim, n - shift, shift),
                      x.narrow(dim, 0, n - shift)], dim=dim)


def _decode_attention(q, ck, cv, kpos, cur_pos, window: int = 0):
    """Single-step decode over a (B, T, KV, D) cache whose slot j holds
    absolute position kpos[j] (-1 = never written); masks invalid and
    out-of-window slots.  KV heads stay compressed; the group expansion
    happens on the q side."""
    b, s, h, d = q.shape
    t, kv = ck.shape[1], ck.shape[2]
    g = h // kv
    # on a mesh the scores split over the cache's sequence dim; q keeps its
    # heads whole (a split of them would cut the KV groups, and DTensor
    # cannot flatten batch and heads both split)
    q = pspec.shard(q, "batch", None, None, None)
    qg = _scaled(q, d).reshape(b, s, kv, g, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg.float(), ck.float())
    mask = (kpos >= 0) & (kpos <= cur_pos)
    if window > 0:
        mask &= kpos > cur_pos - window
    scores = scores.masked_fill(~mask, NEG)   # out of place: DTensor scores
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgst,btkd->bskgd", p.to(cv.dtype).float(),
                       cv.float())
    return out.reshape(b, s, h, cv.shape[-1]).to(q.dtype)


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2)
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: AttentionConfig, d_model: int, dtype: torch.dtype,
             device) -> Dict:
    a = cfg
    s = d_model ** -0.5
    qk = a.qk_nope_head_dim + a.qk_rope_head_dim
    ones = lambda n: torch.ones((n,), dtype=dtype, device=device)  # noqa: E731
    return {
        "wdq": normal(gen, (d_model, a.q_lora_rank), dtype, s, device),
        "q_norm": {"scale": ones(a.q_lora_rank)},
        "wuq": normal(gen, (a.q_lora_rank, a.n_heads * qk), dtype, s, device),
        "wdkv": normal(gen, (d_model, a.kv_lora_rank), dtype, s, device),
        "kv_norm": {"scale": ones(a.kv_lora_rank)},
        "wkr": normal(gen, (d_model, a.qk_rope_head_dim), dtype, s, device),
        "wuk": normal(gen, (a.n_heads, a.kv_lora_rank, a.qk_nope_head_dim),
                      dtype, s, device),
        "wuv": normal(gen, (a.n_heads, a.kv_lora_rank, a.v_head_dim), dtype,
                      s, device),
        "wo": normal(gen, (a.n_heads * a.v_head_dim, d_model), dtype, s,
                     device),
    }


def mla_block(params: Params, x: torch.Tensor, cfg: AttentionConfig, *,
              positions: torch.Tensor, causal: bool = True,
              cache: Optional[Dict] = None, impl: str = "chunked",
              chunk: int = 1024) -> Tuple[torch.Tensor, Optional[Dict]]:
    """Multi-head latent attention.

    Prefill and training expand the compressed KV into per-head k (Dq =
    dn + dr) and v (Dv) and run ``_attend`` (the kernel path takes Dq !=
    Dv).  Decode is the absorbed form: the cache ``{"c_kv": (B, T, R),
    "k_rope": (B, T, dr), "pos": int}`` holds only the compressed KV and
    the shared rotary key; W_uk folds into the query and W_uv into the
    output, with float32 products.  The cache is updated IN PLACE, as in
    ``attention_block``: use the returned cache."""
    a = cfg
    b, s, _ = x.shape
    nh = a.n_heads
    dn, dr, dv = a.qk_nope_head_dim, a.qk_rope_head_dim, a.v_head_dim

    cq = rmsnorm(x @ params["wdq"], params["q_norm"]["scale"])
    q = split_heads(cq @ params["wuq"], nh, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, a.rope_theta)

    c_kv = rmsnorm(x @ params["wdkv"], params["kv_norm"]["scale"])  # (B,S,R)
    k_rope = apply_rope((x @ params["wkr"])[:, :, None, :], positions,
                        a.rope_theta)                            # (B,S,1,dr)

    new_cache = None
    if cache is not None:
        pos = int(cache["pos"])
        cc, cr = cache["c_kv"], cache["k_rope"]
        at = slice(pos, pos + 1) if s == 1 else slice(0, s)
        cc[:, at] = c_kv.to(cc.dtype)
        cr[:, at] = k_rope[:, :, 0].to(cr.dtype)
        new_cache = {"c_kv": cc, "k_rope": cr, "pos": pos + s}
    if cache is not None and s == 1:
        # absorbed single-step decode over the compressed cache
        f32 = lambda t: t.float()  # noqa: E731
        q_abs = torch.einsum("bshd,hrd->bshr", f32(q_nope),
                             f32(params["wuk"]))                 # (B,S,H,R)
        scale = 1.0 / np.sqrt(dn + dr)
        s_lat = torch.einsum("bshr,btr->bhst", q_abs, f32(cc))
        s_rope = torch.einsum("bshd,btd->bhst", f32(q_rope), f32(cr))
        scores = (s_lat + s_rope) * scale
        valid = torch.arange(cc.shape[1], device=x.device) < pos + s
        scores = scores.masked_fill(~valid, NEG)
        p = torch.softmax(scores, dim=-1)
        ctx = torch.einsum("bhst,btr->bshr", p, f32(cc))          # (B,S,H,R)
        out = torch.einsum("bshr,hrd->bshd", ctx,
                           f32(params["wuv"])).to(x.dtype)
    else:
        # train / prefill: expand the compressed KV, causal attention
        k_nope = torch.einsum("bsr,hrd->bshd", c_kv, params["wuk"])
        v = torch.einsum("bsr,hrd->bshd", c_kv, params["wuv"])
        k = torch.cat([k_nope, k_rope.expand(b, s, nh, dr)], dim=-1)
        qfull = torch.cat([q_nope, q_rope], dim=-1)
        out = _attend(qfull, k, v, causal=causal, window=0, impl=impl,
                      chunk=chunk)
    out = merge_heads(out) @ params["wo"]
    return out, new_cache


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def init_mlp(gen, d_model: int, d_ff: int, dtype: torch.dtype, device,
             gated: bool = True) -> Dict:
    s = d_model ** -0.5
    p = {"w_up": normal(gen, (d_model, d_ff), dtype, s, device),
         "w_down": normal(gen, (d_ff, d_model), dtype, d_ff ** -0.5, device)}
    if gated:
        p["w_gate"] = normal(gen, (d_model, d_ff), dtype, s, device)
    return p


def activation_fn(activation: str):
    """``jax.nn.silu`` or ``jax.nn.gelu`` (whose default is the tanh
    approximation)."""
    if activation == "silu":
        return F.silu
    return lambda x: F.gelu(x, approximate="tanh")


def mlp_block(params: Params, x: torch.Tensor,
              activation: str = "silu") -> torch.Tensor:
    act = activation_fn(activation)
    up = x @ params["w_up"]
    if "w_gate" in params:
        up = act(x @ params["w_gate"]) * up
    else:
        up = act(up)
    return up @ params["w_down"]
