"""Plain PyTorch oracles for every kernel of this package — the port of
``src/repro/kernels/ref.py``, with its signatures and ``NEG = -1e18``.

Each function is the semantic reference the kernels are held to; where a
kernel module's plain version computes the same function it is reused.
"""

from __future__ import annotations

from typing import Optional

import torch

from .maxplus import maxplus_matmul_torch
from .selective_scan import selective_scan_torch
from .systolic_gemm import systolic_gemm_torch

__all__ = ["maxplus_matmul_ref", "gemm_ref", "flash_attention_ref",
           "selective_scan_ref"]

NEG = -1e18


def maxplus_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(A ⊗ B)_ij = max_k (A_ik + B_kj) — max-plus semiring matmul over any
    leading batch dims, in float32."""
    return maxplus_matmul_torch(a, b)


def gemm_ref(a: torch.Tensor, b: torch.Tensor, activation: int = 0,
             out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """C = act(A @ B) with float32 accumulation; activation 1 = ReLU (the
    Γ̈ ``gemm`` instruction's optional activation)."""
    return systolic_gemm_torch(a, b, activation=activation,
                               out_dtype=out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Masked multi-head attention, (B, H, S, D) layout, float32 softmax;
    the causal mask keeps key j for query i when j <= i + Sk - Sq (aligned
    at the sequence ends, as the reference's ``tril``)."""
    if scale is None:
        scale = 1.0 / (q.shape[-1] ** 0.5)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        qlen, klen = q.shape[-2], k.shape[-2]
        mask = torch.ones((qlen, klen), dtype=torch.bool,
                          device=q.device).tril(klen - qlen)
        s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def selective_scan_ref(x, dt, b, c, a, d) -> torch.Tensor:
    """Naive per-step selective scan: the Mamba-1 recurrence oracle.

    x/dt: (B, S, D); b/c: (B, S, N); a: (D, N); d: (D,) -> (B, S, D)."""
    return selective_scan_torch(x, dt, b, c, a, d)
