"""Batched max-plus matmul and matvec: the hand-written Hopper kernel in
``csrc/maxplus.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/maxplus.py:29``
(``maxplus_matmul_kernel``, reached through ``maxplus_matmul_pallas`` and
``maxplus_matvec_pallas``)::

    C[b, i, j] = max_k (A[b, i, k] + B[b, k, j])        NEG = -1e18 is -inf

Bound on the H100: two FP32 instructions (add, max) per (i, j, k) triple,
issued at 33.5 T lane-instructions/s (half the published 67 TFLOP/s, which
counts an FMA as two), so the (128, 128) closure squarings of the blocked
AIDG engine are compute-bound; the matvec reads each A entry once and is
bound by memory bandwidth.  The kernel source explains the tiling.

Dispatch: a CUDA tensor launches the kernel or raises — there is no
fallback; only CPU tensors take the plain version.  ``LAUNCHES`` and
``PLAIN_CALLS`` count both, so a run can show which one the path took.

The kernel is compiled with ``nvcc`` at first use into
``build/repro_torch/`` at the repository root, named by a hash of the
source, and loaded with ``ctypes`` (plain C interface, no PyTorch headers;
see ``_build``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from . import _build

__all__ = ["NEG", "K_STEP", "LAUNCHES", "PLAIN_CALLS", "reset_counts",
           "maxplus_matmul", "maxplus_matvec", "maxplus_matmul_torch",
           "maxplus_matvec_torch", "build"]

NEG = -1e18
K_STEP = 8   # k-slab depth of the plain version (as the TPU kernel's K_STEP)

# launches of each kernel, and calls of each plain version (CPU tensors)
LAUNCHES: Dict[str, int] = {"maxplus_matmul": 0, "maxplus_matvec": 0}
PLAIN_CALLS: Dict[str, int] = {"maxplus_matmul": 0, "maxplus_matvec": 0}

SOURCE = _build.CSRC / "maxplus.cu"


def reset_counts() -> None:
    """Zero every launch and plain-call counter."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


# ---------------------------------------------------------------------------
# plain versions (CPU tensors, and the reference the kernel is held to)
# ---------------------------------------------------------------------------


def maxplus_matmul_torch(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(A ⊗ B)_ij = max_k A_ik + B_kj over any leading batch dims, reducing
    k in ``K_STEP``-deep slabs (never materialises an (M, K, N) cube)."""
    A = A.to(torch.float32)
    B = B.to(torch.float32)
    shape = torch.broadcast_shapes(A.shape[:-2], B.shape[:-2])
    acc = torch.full(shape + (A.shape[-2], B.shape[-1]), NEG,
                     dtype=torch.float32, device=A.device)
    for s in range(0, A.shape[-1], K_STEP):
        cand = (A[..., :, s:s + K_STEP, None]
                + B[..., None, s:s + K_STEP, :]).amax(dim=-2)
        acc = torch.maximum(acc, cand)
    return acc


def maxplus_matvec_torch(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(A ⊗ v)_i = max_k A_ik + v_k for A (..., M, K), v (..., K)."""
    return maxplus_matmul_torch(A, v[..., :, None])[..., 0]


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------


def build() -> Path:
    """Compile ``csrc/maxplus.cu`` into ``build/repro_torch/`` (see
    ``_build.build``) and return the library's path."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.maxplus_matmul_f32.argtypes = [p, p, p, ll, i, i, i, p]
    lib.maxplus_matmul_f32.restype = i
    lib.maxplus_matvec_f32.argtypes = [p, p, p, ll, i, i, p]
    lib.maxplus_matvec_f32.restype = i


def _load() -> ctypes.CDLL:
    return _build.load(SOURCE, _bind)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def _check_cuda(name: str, *ts: torch.Tensor) -> None:
    dev = ts[0].device
    for t in ts:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices "
                             f"({[str(x.device) for x in ts]})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: expects float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expects contiguous tensors")


def maxplus_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched ⊗: A (b, M, K), B (b, K, N) -> (b, M, N) float32.  CUDA
    tensors launch the kernel (float32, contiguous, same device); CPU
    tensors take ``maxplus_matmul_torch``."""
    if A.dim() != 3 or B.dim() != 3 or A.shape[0] != B.shape[0] \
            or A.shape[2] != B.shape[1]:
        raise ValueError(f"maxplus_matmul: shapes {tuple(A.shape)} x "
                         f"{tuple(B.shape)} are not (b, M, K) x (b, K, N)")
    if A.device.type == "cpu" and B.device.type == "cpu":
        PLAIN_CALLS["maxplus_matmul"] += 1
        return maxplus_matmul_torch(A, B)
    if A.device.type != "cuda":
        raise ValueError(f"maxplus_matmul: unsupported device {A.device}")
    _check_cuda("maxplus_matmul", A, B)
    b, M, K = A.shape
    N = B.shape[2]
    C = torch.empty((b, M, N), dtype=torch.float32, device=A.device)
    if C.numel() == 0:
        return C
    if K == 0:
        return C.fill_(NEG)
    lib = _load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxplus_matmul_f32(A.data_ptr(), B.data_ptr(), C.data_ptr(),
                                     b, M, K, N, stream)
    _build.launch_check("maxplus_matmul", err)
    LAUNCHES["maxplus_matmul"] += 1
    return C


def maxplus_matvec(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matvec: A (b, M, K), v (b, K) -> (b, M) float32, its own
    kernel (one warp per output row) so N = 1 wastes no 64-wide tile.
    Dispatch as :func:`maxplus_matmul`."""
    if A.dim() != 3 or v.dim() != 2 or A.shape[0] != v.shape[0] \
            or A.shape[2] != v.shape[1]:
        raise ValueError(f"maxplus_matvec: shapes {tuple(A.shape)} x "
                         f"{tuple(v.shape)} are not (b, M, K) x (b, K)")
    if A.device.type == "cpu" and v.device.type == "cpu":
        PLAIN_CALLS["maxplus_matvec"] += 1
        return maxplus_matvec_torch(A, v)
    if A.device.type != "cuda":
        raise ValueError(f"maxplus_matvec: unsupported device {A.device}")
    _check_cuda("maxplus_matvec", A, v)
    b, M, K = A.shape
    out = torch.empty((b, M), dtype=torch.float32, device=A.device)
    if out.numel() == 0:
        return out
    if K == 0:
        return out.fill_(NEG)
    lib = _load()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxplus_matvec_f32(A.data_ptr(), v.data_ptr(),
                                     out.data_ptr(), b, M, K, stream)
    _build.launch_check("maxplus_matvec", err)
    LAUNCHES["maxplus_matvec"] += 1
    return out
