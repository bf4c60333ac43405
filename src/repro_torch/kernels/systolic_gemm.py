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

Dispatch: a CUDA tensor launches a kernel or raises — there is no
fallback; only CPU tensors take the plain version.  Which of the four
kernels runs is decided by ``plan`` from the shape, the type and the
pointers' alignment alone, never by a failure:

* ``"wgmma"``: bf16 with M > 64, K and N multiples of 8 and both pointers
  16-byte aligned (what TMA can take) — TMA + ``wgmma``, warp-specialised,
  on a persistent grid of at most one block per SM (prefill);
* ``"splitk"``: the same with M <= 64 — 64-column panels of B, K split so
  that the grid has at least two blocks per SM, partial sums added in
  split order by the last block of each panel (decode; deterministic);
* ``"mma_sync"``: every other bf16 product — 128 x 128 tiles of
  ``mma.sync``;
* ``"f32"``: float32 inputs — 128 x 128 tiles on the CUDA cores.

``LAUNCHES`` counts every launch, ``VARIANT_LAUNCHES`` the launches of
each kernel, ``PLAIN_CALLS`` the plain version's calls.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Dict, NamedTuple, Tuple

import torch

from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "VARIANT_LAUNCHES", "VARIANTS",
           "Plan", "plan", "reset_counts", "systolic_gemm",
           "systolic_gemm_torch", "error_bound", "build"]

VARIANTS = ("wgmma", "splitk", "mma_sync", "f32")
LAUNCHES: Dict[str, int] = {"systolic_gemm": 0}
VARIANT_LAUNCHES: Dict[str, int] = {v: 0 for v in VARIANTS}
PLAIN_CALLS: Dict[str, int] = {"systolic_gemm": 0}

SOURCE = _build.CSRC / "systolic_gemm.cu"
DTYPES = (torch.float32, torch.bfloat16)
# tiles as (m, n, k) — the kernels' constants, checked against the
# library's ``systolic_gemm_tiles`` when it is loaded
WGMMA_TILE = (128, 256, 64)
SPLITK_N, SPLITK_K = 64, 64        # a split-K block's panel width, k tile
SPLITK_MAX_M = 64
SPLITK_BLOCKS_PER_SM = 2           # split K until the grid has this many
TILE_128 = 128                     # the mma_sync and f32 kernels' tiles
MMA_SYNC_TILE = (128, 128, 32)
F32_TILE = (128, 128, 8)
MAX_GRID_Y = 65535
H100_SMS = 132


class Plan(NamedTuple):
    """Which kernel computes an (M, K) x (K, N) product, and how:
    ``tile`` (m, n, k) is one block's output tile and k step, ``splits``
    the number of shares of K, ``grid`` the launch grid."""
    variant: str
    tile: Tuple[int, int, int]
    splits: int
    grid: Tuple[int, ...]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def plan(m: int, k: int, n: int, dtype: torch.dtype, aligned: bool, *,
         sms: int = H100_SMS) -> Plan:
    """The kernel for an (m, k) x (k, n) product of ``dtype`` inputs on a
    card with ``sms`` SMs; ``aligned``: both data pointers are 16-byte
    aligned.  Shape, type and alignment decide, nothing else."""
    if dtype == torch.float32:
        return Plan("f32", F32_TILE, 1,
                    (_cdiv(m, TILE_128), _cdiv(n, TILE_128)))
    if dtype != torch.bfloat16:
        raise TypeError(f"systolic_gemm: no kernel for {dtype}")
    if not (aligned and k % 8 == 0 and n % 8 == 0):
        return Plan("mma_sync", MMA_SYNC_TILE, 1,
                    (_cdiv(m, TILE_128), _cdiv(n, TILE_128)))
    if m <= SPLITK_MAX_M:
        rows = 8
        while rows < m:
            rows *= 2
        panels, ktiles = _cdiv(n, SPLITK_N), _cdiv(k, SPLITK_K)
        splits = min(ktiles, _cdiv(SPLITK_BLOCKS_PER_SM * sms, panels))
        return Plan("splitk", (rows, SPLITK_N, SPLITK_K), splits,
                    (panels, splits))
    tiles = _cdiv(m, WGMMA_TILE[0]) * _cdiv(n, WGMMA_TILE[1])
    return Plan("wgmma", WGMMA_TILE, 1, (min(tiles, sms),))


def reset_counts() -> None:
    """Zero the launch, per-kernel and plain-call counters."""
    for d in (LAUNCHES, VARIANT_LAUNCHES, PLAIN_CALLS):
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
    lib.systolic_gemm_bf16_wgmma.argtypes = [p, p, p, i, i, i, i, i, i, p]
    lib.systolic_gemm_bf16_wgmma.restype = i
    lib.systolic_gemm_bf16_splitk.argtypes = [p, p, p, p, p, i, i, i, i, i,
                                              i, p]
    lib.systolic_gemm_bf16_splitk.restype = i
    tiles = (ctypes.c_int * 7)()
    lib.systolic_gemm_tiles.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.systolic_gemm_tiles.restype = None
    lib.systolic_gemm_tiles(tiles)
    want = (WGMMA_TILE[0], WGMMA_TILE[1], WGMMA_TILE[2], SPLITK_N, SPLITK_K,
            TILE_128, TILE_128)
    if tuple(tiles) != want:
        raise RuntimeError(f"systolic_gemm: the library's tiles "
                           f"{tuple(tiles)} differ from the plan's {want}")


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _aligned16(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0


# one split-K counter buffer per (device, stream): zero between calls (the
# kernel's last block of each panel resets its counter), grown on demand
_counters: Dict[Tuple[int, int], torch.Tensor] = {}


def _counter_buffer(dev: torch.device, stream: int, panels: int
                    ) -> torch.Tensor:
    key = (dev.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < panels:
        buf = torch.zeros(max(panels, 1024), dtype=torch.int32, device=dev)
        _counters[key] = buf
    return buf


def systolic_gemm(a: torch.Tensor, b: torch.Tensor, *, activation: int = 0,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``act(a @ b)`` (M, N) in ``out_dtype`` with a float32 sum.  CUDA
    tensors launch the kernel that ``plan`` picks (a and b both float32 or
    both bfloat16, contiguous, one device); CPU tensors take
    ``systolic_gemm_torch``."""
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
    p = plan(m, k, n, a.dtype, _aligned16(a, b), sms=_sm_count(dev.index))
    return _launch(a, b, activation, out_dtype, p)


def _launch(a: torch.Tensor, b: torch.Tensor, activation: int,
            out_dtype: torch.dtype, p: Plan) -> torch.Tensor:
    """Launch the kernel of plan ``p`` on checked CUDA tensors.  Private:
    ``systolic_gemm`` passes its own plan; timing scripts pass the plan of
    another kernel to time it beside the chosen one on the same inputs."""
    (m, k), n = a.shape, b.shape[1]
    if max(m, k, n) >= 2 ** 31 or (p.variant in ("mma_sync", "f32")
                                   and p.grid[1] > MAX_GRID_Y):
        raise ValueError(f"systolic_gemm: the {p.variant} kernel takes dims "
                         f"< 2^31 and N <= {MAX_GRID_Y * TILE_128}, got "
                         f"({m}, {k}, {n})")
    dev = a.device
    out = torch.empty((m, n), dtype=out_dtype, device=dev)
    if out.numel() == 0:
        return out
    if k == 0:                        # an empty sum, and ReLU(0) = 0
        return out.zero_()
    lib = _build.load(SOURCE, _bind)
    # entering torch.cuda.device costs microseconds a call: only to switch
    if dev.index == torch.cuda.current_device():
        err = _run(lib, a, b, out, activation, p)
    else:
        with torch.cuda.device(dev):
            err = _run(lib, a, b, out, activation, p)
    _build.launch_check("systolic_gemm", err)
    LAUNCHES["systolic_gemm"] += 1
    VARIANT_LAUNCHES[p.variant] += 1
    return out


def _run(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor,
         out: torch.Tensor, activation: int, p: Plan) -> int:
    """One launch into ``out`` on its device's current stream (the device
    is current); returns the library's CUDA error code."""
    (m, k), n = a.shape, b.shape[1]
    dev = out.device
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # several microseconds of host time a call, about as long as a decode
    # product takes on the device
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    act, obf = int(activation), int(out.dtype == torch.bfloat16)
    ptrs = (a.data_ptr(), b.data_ptr(), out.data_ptr())
    if p.variant == "wgmma":
        return lib.systolic_gemm_bf16_wgmma(*ptrs, m, k, n, act, obf,
                                            p.grid[0], stream)
    if p.variant == "splitk":
        ws = (torch.empty((p.splits, m, n), dtype=torch.float32, device=dev)
              if p.splits > 1 else None)
        cnt = _counter_buffer(dev, stream, p.grid[0])
        return lib.systolic_gemm_bf16_splitk(
            *ptrs, None if ws is None else ws.data_ptr(), cnt.data_ptr(), m,
            k, n, act, obf, p.splits, stream)
    fn = lib.systolic_gemm_f32 if p.variant == "f32" else lib.systolic_gemm_bf16
    return fn(*ptrs, m, k, n, act, obf, stream)
