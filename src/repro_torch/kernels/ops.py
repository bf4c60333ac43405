"""Public wrappers around the hand-written kernels — the port of
``src/repro/kernels/ops.py``, with the reference's four entry points and
their signatures.

On CUDA tensors each wrapper launches its kernel (there is no fallback to
a plain version, not even where the reference falls back to ``ref``); on
CPU tensors it takes the kernel module's plain version, as the kernel
wrappers themselves do.  The reference's ``interpret`` flag is dropped.
The TPU tiling arguments ``bm``/``bk``/``bn``/``bq``/``bd`` are accepted
and ignored: the card kernels choose their own tiles.

Ragged shapes need no padded copies: every kernel bounds-checks its
edges, which computes what the reference's padding computes — max-plus
edges count as ``NEG = -1e18`` (the reference pads with it), GEMM edges
as zeros, keys past the true length are masked (also without a causal
mask, where the reference drops to ``ref``), and channels past D are not
computed (the reference pads them).
"""

from __future__ import annotations

from typing import Optional

import torch

from . import flash_attention as _fa
from . import maxplus as _mp
from . import selective_scan as _ss
from . import systolic_gemm as _sg

__all__ = ["maxplus_matmul", "gemm", "flash_attention", "selective_scan"]

NEG = -1e18


def maxplus_matmul(a: torch.Tensor, b: torch.Tensor, *, bm: int = 128,
                   bk: int = 128, bn: int = 128) -> torch.Tensor:
    """(A ⊗ B) for (M, K) x (K, N) in float32; ragged edges act as NEG."""
    out = _mp.maxplus_matmul(a.float().contiguous()[None],
                             b.float().contiguous()[None])
    return out[0]


def gemm(a: torch.Tensor, b: torch.Tensor, *, activation: int = 0,
         bm: int = 128, bk: int = 128, bn: int = 128,
         out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """act(A @ B) for (M, K) x (K, N), float32 sum, cast to ``out_dtype``
    (the systolic GEMM kernel).  Mixed input types are promoted first, as
    JAX promotes them."""
    if a.dtype != b.dtype:
        dt = torch.promote_types(a.dtype, b.dtype)
        a, b = a.to(dt), b.to(dt)
    return _sg.systolic_gemm(a.contiguous(), b.contiguous(),
                             activation=activation, out_dtype=out_dtype)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0, bq: int = 128,
                    bk: int = 128, scale: Optional[float] = None
                    ) -> torch.Tensor:
    """Attention over (B, H, S, D) or (BH, S, D) inputs.  Each tensor keeps
    its own head dim, so Dv may differ from Dq in both layouts (the
    reference's 4-D path cannot reshape that case); k and v may carry
    fewer heads than q (GQA).  A causal or windowed mask needs Sq == Sk."""
    four = q.dim() == 4
    if four:
        b, h, sq, _ = q.shape
        q, k, v = (t.reshape(t.shape[0] * t.shape[1], t.shape[2],
                             t.shape[3]) for t in (q, k, v))
    out = _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                              causal=causal, window=window, scale=scale)
    if four:
        out = out.reshape(b, h, sq, out.shape[-1])
    return out


def selective_scan(x, dt, b, c, a, d, *, bd: int = 128) -> torch.Tensor:
    """Mamba-1 selective scan, x/dt (B, S, D), b/c (B, S, N), a (D, N),
    d (D,) -> (B, S, D) float32; any D (ragged channels are
    bounds-checked)."""
    ts = (x, dt, b, c, a, d)
    return _ss.selective_scan(*(t.float().contiguous() for t in ts))
