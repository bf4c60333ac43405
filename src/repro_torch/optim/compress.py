"""Gradient compression for the cross-pod all-reduce, in PyTorch (the port
of ``repro.optim.compress``).

* ``compress_bf16`` — stochastic-rounded bf16 (2x), its uniform draws
  from an explicit ``torch.Generator`` where the reference splits a
  ``jax.random`` key per leaf (so the draws are not the reference's; the
  rounding is unbiased in both).
* ``compress_int8`` / ``decompress_int8`` — per-tensor absmax int8 (4x)
  with ``error_feedback_update`` keeping a residual so quantization error
  accumulates into later steps instead of being lost (EF-SGD style).
  The reference's float32 arithmetic, so the same inputs give the same
  bits.
"""

from __future__ import annotations

from typing import Mapping, Tuple

import torch

__all__ = ["compress_bf16", "compress_int8", "decompress_int8",
           "error_feedback_update"]


def _stochastic_round(x: torch.Tensor, gen: torch.Generator) -> torch.Tensor:
    x = x.float()
    lo = x.to(torch.bfloat16)
    lo32 = lo.float()
    # next bf16 grid point toward x: one bf16 ULP via the bits (nextafter
    # would step one *f32* ULP, which collapses back to lo)
    bits = lo.view(torch.int16).to(torch.int32) & 0xFFFF
    step = torch.where((x > lo32) != (lo32 < 0), 1, -1)
    hi_bits = (bits + step) & 0xFFFF
    hi = torch.where(hi_bits >= 0x8000, hi_bits - 0x10000, hi_bits).to(
        torch.int16).view(torch.bfloat16)
    hi32 = hi.float()
    span = torch.where(hi32 != lo32, torch.abs(hi32 - lo32),
                       torch.ones_like(lo32))
    p_hi = torch.clamp(torch.abs(x - lo32) / span, 0.0, 1.0)
    u = torch.rand(x.shape, generator=gen, device=gen.device)
    return torch.where(u.to(x.device) < p_hi, hi, lo)


def compress_bf16(tree, generator: torch.Generator):
    """Stochastic rounding f32 -> bf16 (unbiased under averaging) of every
    tensor of ``tree`` (a tensor or nested dicts of tensors), one draw
    per element from ``generator``."""
    if isinstance(tree, Mapping):
        return {k: compress_bf16(v, generator) for k, v in tree.items()}
    return _stochastic_round(tree, generator)


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor absmax int8 quantization -> (q, scale)."""
    x = x.float()
    scale = torch.clamp(torch.max(torch.abs(x)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def error_feedback_update(grad: torch.Tensor, residual: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """EF: compress (grad + residual); the new residual is what the
    quantizer dropped.  Returns (q, scale, new_residual)."""
    g = grad.float() + residual
    q, scale = compress_int8(g)
    new_residual = g - decompress_int8(q, scale)
    return q, scale, new_residual
