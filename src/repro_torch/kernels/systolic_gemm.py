"""Dense matrix product with an optional fused ReLU: the hand-written
Hopper kernel in ``csrc/systolic_gemm.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/systolic_gemm.py:29``
(``systolic_gemm_kernel``, reached through ``systolic_gemm_pallas`` and
``ops.gemm``)::

    C = act(A @ B)      A (M, K), B (K, N) -> C (M, N)
    act: identity (activation=0) or ReLU (activation=1, the Γ̈ ``gemm``
    instruction's activation), applied after the last k step

A and B are both float32 or both bfloat16; the sum is float32 whatever the
inputs; C is cast to ``out_dtype`` (float32 or bfloat16).

Bound on the H100: 2·M·K·N flops at the tensor cores' bf16 rate (989
TFLOP/s) or the CUDA cores' FP32 rate (67 TFLOP/s; TF32 is never used),
against one read of A and B and one write of C at 3.35 TB/s — the prefill
products are bound by the flops, the decode ones (M = 8) by reading B.
The kernel source explains the design.

How far the kernel may lie from the plain version (``error_bound``):
both sum K products in float32, in different orders (and the tensor
cores may truncate where the CUDA cores round), so element by element
they differ by at most ``K·2^-22·(|A|@|B|)`` — twice the recursive-summation
bound K·u with u = 2^-24 for each of the two sums, and twice again for
truncation — plus ``1e-6``; with a bfloat16 output each side rounds once
more, at most half a bfloat16 unit in the last place each: ``2^-7·|C|``.

Dispatch: a CUDA tensor launches the kernel or raises — there is no
fallback; only CPU tensors take the plain version.  ``LAUNCHES`` and
``PLAIN_CALLS`` count both.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "reset_counts", "systolic_gemm",
           "systolic_gemm_torch", "error_bound", "build"]

LAUNCHES: Dict[str, int] = {"systolic_gemm": 0}
PLAIN_CALLS: Dict[str, int] = {"systolic_gemm": 0}

SOURCE = _build.CSRC / "systolic_gemm.cu"
DTYPES = (torch.float32, torch.bfloat16)
TILE_N = 128           # output columns per thread block


def reset_counts() -> None:
    """Zero the launch and plain-call counters."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _check(a: torch.Tensor, b: torch.Tensor, activation: int,
           out_dtype: torch.dtype) -> None:
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"systolic_gemm: shapes {tuple(a.shape)} x "
                         f"{tuple(b.shape)} are not (M, K) x (K, N)")
    if activation not in (0, 1):
        raise ValueError(f"systolic_gemm: activation must be 0 (none) or 1 "
                         f"(ReLU), got {activation}")
    if out_dtype not in DTYPES:
        raise TypeError(f"systolic_gemm: out_dtype must be float32 or "
                        f"bfloat16, got {out_dtype}")


def systolic_gemm_torch(a: torch.Tensor, b: torch.Tensor, *,
                        activation: int = 0,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """``act(a.float() @ b.float())`` cast to ``out_dtype`` — the port of
    ``ref.gemm_ref``.  The float32 product runs with TF32 off."""
    _check(a, b, activation, out_dtype)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out = torch.matmul(a.float(), b.float())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    if activation == 1:
        out = out.clamp_min_(0.0)
    return out.to(out_dtype)


def error_bound(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor
                ) -> torch.Tensor:
    """How far, element by element, the kernel's output may lie from
    ``systolic_gemm_torch``'s ``c`` on the same inputs (M, N), float32:
    ``K·2^-22·(|a|@|b|) + 1e-6``, plus ``2^-7·|c|`` when ``c`` is
    bfloat16 (see the module docstring)."""
    k = a.shape[1]
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        mag = torch.matmul(a.float().abs(), b.float().abs())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    bnd = mag.mul_(k * 2.0 ** -22).add_(1e-6)
    if c.dtype == torch.bfloat16:
        bnd.add_(c.float().abs(), alpha=2.0 ** -7)
    return bnd


def build() -> Path:
    """Compile ``csrc/systolic_gemm.cu`` (see ``_build.build``)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    for name in ("systolic_gemm_f32", "systolic_gemm_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, i, i, i, i, i, p]
        fn.restype = i


def systolic_gemm(a: torch.Tensor, b: torch.Tensor, *, activation: int = 0,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``act(a @ b)`` (M, N) in ``out_dtype`` with a float32 sum.  CUDA
    tensors launch the kernel (a and b both float32 or both bfloat16,
    contiguous, one device); CPU tensors take ``systolic_gemm_torch``."""
    _check(a, b, activation, out_dtype)
    if a.device.type == "cpu" and b.device.type == "cpu":
        PLAIN_CALLS["systolic_gemm"] += 1
        return systolic_gemm_torch(a, b, activation=activation,
                                   out_dtype=out_dtype)
    dev = a.device
    if dev.type != "cuda" or b.device != dev:
        raise ValueError(f"systolic_gemm: tensors on {a.device} and "
                         f"{b.device}; the kernel takes two tensors on one "
                         f"CUDA device")
    if a.dtype != b.dtype or a.dtype not in DTYPES:
        raise TypeError(f"systolic_gemm: expects a and b both float32 or "
                        f"both bfloat16, got {a.dtype} and {b.dtype}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("systolic_gemm: expects contiguous tensors")
    (m, k), n = a.shape, b.shape[1]
    if max(m, k, n) >= 2 ** 31 or -(-n // TILE_N) > 65535:
        raise ValueError(f"systolic_gemm: the kernel takes dims < 2^31 and "
                         f"N <= {65535 * TILE_N}, got ({m}, {k}, {n})")
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if k == 0:                        # an empty sum, and ReLU(0) = 0
        return out.zero_()
    lib = _build.load(SOURCE, _bind)
    fn = (lib.systolic_gemm_f32 if a.dtype == torch.float32
          else lib.systolic_gemm_bf16)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), m, k, n,
                 int(activation), int(out_dtype == torch.bfloat16), stream)
    _build.launch_check("systolic_gemm", err)
    LAUNCHES["systolic_gemm"] += 1
    return out
