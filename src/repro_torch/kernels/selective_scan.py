"""Mamba-1 selective scan: the hand-written Hopper kernel in
``csrc/selective_scan.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/selective_scan.py:29``
(``selective_scan_kernel``, reached through ``selective_scan_pallas`` and
``ops.selective_scan``)::

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t        h_0 = 0
    y_t = h_t . C_t + D * x_t

x, dt (B, S, D); B, C (B, S, N); A (D, N); D (D,) -> y (B, S, D), all
float32.

Bound on the H100: one exponential per (step, channel, state), computed
by the special-function units at 16 per clock per SM, against one read of x
and dt and one write of y.  The kernel source explains the design.

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

__all__ = ["LAUNCHES", "PLAIN_CALLS", "reset_counts", "selective_scan",
           "selective_scan_torch", "build"]

MAX_STATE = 16         # the largest d_state of a ported config

LAUNCHES: Dict[str, int] = {"selective_scan": 0}
PLAIN_CALLS: Dict[str, int] = {"selective_scan": 0}

SOURCE = _build.CSRC / "selective_scan.cu"


def reset_counts() -> None:
    """Zero the launch and plain-call counters."""
    for d in (LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def _check_shapes(x, dt, b, c, a, d) -> None:
    if x.dim() != 3:
        raise ValueError(f"selective_scan: x must be (B, S, D), got "
                         f"{tuple(x.shape)}")
    bsz, s, dm = x.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    want = {"dt": (bsz, s, dm), "b": (bsz, s, n), "c": (bsz, s, n),
            "a": (dm, n), "d": (dm,)}
    got = {"dt": dt, "b": b, "c": c, "a": a, "d": d}
    bad = {k: tuple(t.shape) for k, t in got.items()
           if tuple(t.shape) != want[k]}
    if n < 1 or bad:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} wants dt, b, "
                         f"c, a, d of shapes {want}; got {bad}")


def selective_scan_torch(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, a: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """The per-step recurrence of ``ref.selective_scan_ref``, in float32."""
    _check_shapes(x, dt, b, c, a, d)
    x, dt, b, c, a, d = (t.float() for t in (x, dt, b, c, a, d))
    bsz, s, dm = x.shape
    h = torch.zeros((bsz, dm, a.shape[1]), dtype=torch.float32,
                    device=x.device)
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t, :, None] * a[None])
        h = dA * h + (dt[:, t] * x[:, t])[:, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]) + d[None] * x[:, t])
    if not ys:
        return torch.zeros_like(x)
    return torch.stack(ys, dim=1)


def build() -> Path:
    """Compile ``csrc/selective_scan.cu`` (see ``_build.build``)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.selective_scan_f32.restype = i


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """y (B, S, D) float32.  CUDA tensors launch the kernel (float32,
    contiguous, one device, N <= 16); CPU tensors take
    ``selective_scan_torch``."""
    _check_shapes(x, dt, b, c, a, d)
    ts = (x, dt, b, c, a, d)
    if all(t.device.type == "cpu" for t in ts):
        PLAIN_CALLS["selective_scan"] += 1
        return selective_scan_torch(*ts)
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError("selective_scan: tensors on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: expects float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("selective_scan: expects contiguous tensors")
    bsz, s, dm = x.shape
    n = a.shape[1]
    if n > MAX_STATE or bsz > 65535:
        raise ValueError(f"selective_scan: the kernel takes N <= "
                         f"{MAX_STATE} and B <= 65535, got N={n}, B={bsz}")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.load(SOURCE, _bind)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selective_scan_f32(x.data_ptr(), dt.data_ptr(),
                                     b.data_ptr(), c.data_ptr(), a.data_ptr(),
                                     d.data_ptr(), y.data_ptr(), bsz, s, dm, n,
                                     stream)
    _build.launch_check("selective_scan", err)
    LAUNCHES["selective_scan"] += 1
    return y
