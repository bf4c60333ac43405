"""Online-softmax attention: the hand-written Hopper kernel in
``csrc/flash_attention.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention.py:32``
(``flash_attention_kernel``, reached through ``flash_attention_pallas`` and
``ops.flash_attention``)::

    o[i] = softmax_j(scale * q[i] . k[j], masked) @ v        scale = 1/sqrt(Dq)
    mask: j <= i if causal; j > i - window if window > 0

Layout ``(BH, S, D)``, batch and heads flattened, as the TPU kernel takes
it.  GQA: ``k`` and ``v`` may hold fewer heads, ``BKV = BH / group``, and
query head ``i`` reads key/value head ``i // group`` — the same function as
attention over ``_expand_kv`` copies, without the copies.  ``Dv`` may
differ from ``Dq`` (the TPU kernel returns NaN there; the plain version
here is the port of ``ref.flash_attention_ref`` plus the window).

Bound on the H100: ``2 Sq Sk D`` multiply-adds (about half under a causal
mask) against one read of q, k, v and one write of o — compute-bound at the
LM path's shapes.  The kernel source explains the design.

Dispatch: a CUDA tensor launches a kernel or raises — there is no
fallback; only CPU tensors take the plain version.  Which kernel runs is
decided by ``plan`` from the type, the head dims and the pointers'
alignment alone:

* ``"wgmma"``: bf16 with ``Dq == Dv == 128`` and q, k, v 16-byte aligned
  (what TMA can take; the output is allocated aligned) — TMA + ``wgmma``,
  warp-specialised (the LM path of jamba, olmo-1b, olmoe, deepseek-moe and
  mistral-large);
* ``"wgmma_dv"``: the same kernel instantiated at ``(Dq, Dv)`` in
  ``WGMMA_DV_HEAD_DIMS`` — (96, 64), MLA's heads (minicpm3-4b's prefill
  and scoring) — bf16, 16-byte aligned, with its own entry point;
* ``"wgmma_120"`` and ``"wgmma_96"``: the same kernel at (120, 120)
  (h2o-danube3-4b, GQA with a window) and (96, 96) (phi3-vision-4b), bf16,
  16-byte aligned, an entry point each;
* ``"cuda_core"``: everything else — float32, other head dims, unaligned
  bf16 — on the CUDA cores.

``WGMMA_INSTANCES`` maps each instantiated ``(Dq, Dv)`` to its kernel.

One more kernel, ``"mma_sync"`` (the tensor-core kernel that served the
LM path before the ``wgmma`` one), is reached only through the private
``_launch``, as the timed yardstick; so is ``"cuda_core"`` at the head
dims of ``wgmma_dv``, ``wgmma_120`` and ``wgmma_96``.  ``LAUNCHES``
counts every launch, ``VARIANT_LAUNCHES`` the launches of each kernel,
``PLAIN_CALLS`` the plain version's calls.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Optional

import torch

from . import _build

__all__ = ["NEG", "LAUNCHES", "PLAIN_CALLS", "VARIANT_LAUNCHES", "VARIANTS",
           "plan", "reset_counts", "flash_attention",
           "flash_attention_torch", "bf16_error_bound", "build"]

NEG = -1e18
MAX_HEAD_DIM = 128     # the widest head of a ported config
WGMMA_HEAD_DIM = 128   # the wgmma kernel's Dq == Dv
WGMMA_DV_HEAD_DIMS = ((96, 64),)   # the wgmma_dv instances' (Dq, Dv)
# every (Dq, Dv) the TMA + wgmma template is instantiated at, and its kernel
WGMMA_INSTANCES = {(WGMMA_HEAD_DIM, WGMMA_HEAD_DIM): "wgmma",
                   **{dims: "wgmma_dv" for dims in WGMMA_DV_HEAD_DIMS},
                   (120, 120): "wgmma_120", (96, 96): "wgmma_96"}
DTYPES = (torch.float32, torch.bfloat16)

VARIANTS = ("wgmma", "wgmma_dv", "wgmma_120", "wgmma_96", "cuda_core",
            "mma_sync")
LAUNCHES: Dict[str, int] = {"flash_attention": 0}
VARIANT_LAUNCHES: Dict[str, int] = {v: 0 for v in VARIANTS}
PLAIN_CALLS: Dict[str, int] = {"flash_attention": 0}

SOURCE = _build.CSRC / "flash_attention.cu"


def reset_counts() -> None:
    """Zero the launch, per-kernel and plain-call counters."""
    for d in (LAUNCHES, VARIANT_LAUNCHES, PLAIN_CALLS):
        for k in d:
            d[k] = 0


def plan(dq: int, dv: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel for attention with head dims ``dq``, ``dv`` over
    ``dtype`` inputs; ``aligned``: q, k and v start on 16-byte boundaries.
    Type, head dims and alignment decide, nothing else."""
    if dtype not in DTYPES:
        raise TypeError(f"flash_attention: no kernel for {dtype}")
    if dtype == torch.bfloat16 and aligned:
        return WGMMA_INSTANCES.get((dq, dv), "cuda_core")
    return "cuda_core"


def _aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_shapes(q, k, v, causal: bool, window: int) -> int:
    """Validate (BH, Sq, Dq), (BKV, Sk, Dq), (BKV, Sk, Dv); return the GQA
    group BH / BKV."""
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError("flash_attention: q, k, v must be (BH, S, D)")
    bh, sq, dq = q.shape
    bkv, sk, dk = k.shape
    if v.shape[:2] != (bkv, sk) or dk != dq or bkv == 0 or bh % bkv:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)} are not (BH, "
                         f"Sq, Dq), (BKV, Sk, Dq), (BKV, Sk, Dv) with BKV "
                         f"dividing BH")
    if (causal or window > 0) and sq != sk:
        raise ValueError(f"flash_attention: a causal or windowed mask needs "
                         f"Sq == Sk, got {sq} and {sk}")
    return bh // bkv


def _probs(q, k, causal: bool, window: int, scale: Optional[float],
           group: int) -> torch.Tensor:
    """The masked softmax (BH, Sq, Sk) in float32."""
    sq, sk = q.shape[1], k.shape[1]
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    kf = k.float().repeat_interleave(group, dim=0)
    s = torch.matmul(q.float(), kf.transpose(1, 2)) * scale
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= kpos > qpos - window
    s = s.masked_fill_(~mask, NEG)
    return torch.softmax(s, dim=-1)


def flash_attention_torch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, window: int = 0,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Masked dense softmax attention in float32 (the port of
    ``ref.flash_attention_ref``, plus the window and GQA); output in q's
    dtype."""
    group = _check_shapes(q, k, v, causal, window)
    p = _probs(q, k, causal, window, scale, group)
    vf = v.float().repeat_interleave(group, dim=0)
    return torch.matmul(p, vf).to(q.dtype)


def bf16_error_bound(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """How far, element by element, the kernel's bfloat16 output may lie
    from ``flash_attention_torch``'s on the same bfloat16 inputs (BH, Sq,
    Dv), float32.

    The kernel rounds each probability to bfloat16 (relative error at most
    2^-8, about uniform) before the product with v; the plain version does
    not.  That puts an error of standard deviation at most
    2^-8 / sqrt(3) * sqrt(sum_j p_j^2 v_j^2) on o; the bound allows four
    times 2^-8 times that root (6.9 standard deviations, and the
    worst case outright for rows of up to 16 keys).  Both outputs are then
    rounded to bfloat16, which adds at most one unit in the last place,
    2^-7 |o|.  1e-5 covers float32 summation order."""
    group = _check_shapes(q, k, v, causal, window)
    p = _probs(q, k, causal, window, scale, group)
    vf = v.float().repeat_interleave(group, dim=0)
    o = torch.matmul(p, vf)
    spread = torch.matmul(p.square_(), vf.square_()).sqrt_()
    return (o.abs_().mul_(2.0 ** -7).add_(spread, alpha=4 * 2.0 ** -8)
            .add_(1e-5))


def build() -> Path:
    """Compile ``csrc/flash_attention.cu`` (see ``_build.build``)."""
    return _build.build(SOURCE)


# the library's entry point of each kernel (cuda_core: by input type)
ENTRY_POINTS = {"wgmma": "flash_attention_bf16_wgmma",
                "wgmma_dv": "flash_attention_bf16_wgmma_dv",
                "wgmma_120": "flash_attention_bf16_wgmma_120",
                "wgmma_96": "flash_attention_bf16_wgmma_96",
                "mma_sync": "flash_attention_bf16_mma_sync",
                ("cuda_core", torch.float32): "flash_attention_f32",
                ("cuda_core", torch.bfloat16): "flash_attention_bf16"}


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for name in ENTRY_POINTS.values():
        fn = getattr(lib, name)
        fn.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i, f, p]
        fn.restype = i
    for name in ("flash_attention_wgmma_smem_bytes",
                 "flash_attention_wgmma_dv_smem_bytes",
                 "flash_attention_wgmma_dv_stages",
                 "flash_attention_wgmma_120_smem_bytes",
                 "flash_attention_wgmma_120_stages",
                 "flash_attention_wgmma_96_smem_bytes",
                 "flash_attention_wgmma_96_stages"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = i


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Attention over q (BH, Sq, Dq), k (BKV, Sk, Dq), v (BKV, Sk, Dv) ->
    (BH, Sq, Dv) in q's dtype.  CUDA tensors launch the kernel that
    ``plan`` picks (all float32 or all bfloat16, contiguous, one device,
    Dq and Dv <= 128); CPU tensors take ``flash_attention_torch``."""
    _check_shapes(q, k, v, causal, window)
    if all(t.device.type == "cpu" for t in (q, k, v)):
        PLAIN_CALLS["flash_attention"] += 1
        return flash_attention_torch(q, k, v, causal=causal, window=window,
                                     scale=scale)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    for t in (q, k, v):
        if t.device != dev:
            raise ValueError("flash_attention: tensors on different devices")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise TypeError(f"flash_attention: expects q, k, v all float32 "
                            f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                            f"{v.dtype}")
        if not t.is_contiguous():
            raise ValueError("flash_attention: expects contiguous tensors")
    variant = plan(q.shape[2], v.shape[2], q.dtype, _aligned16(q, k, v))
    return _launch(q, k, v, causal, window, scale, variant)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, scale: Optional[float], variant: str
            ) -> torch.Tensor:
    """Launch kernel ``variant`` on checked CUDA tensors.  Private:
    ``flash_attention`` passes the kernel ``plan`` picks; timing scripts
    and the card tests pass ``"mma_sync"``, or ``"cuda_core"`` where the
    plan picks a ``wgmma`` instance, to run that kernel on the same
    inputs."""
    group = _check_shapes(q, k, v, causal, window)
    bh, sq, dq = q.shape
    sk, dv = k.shape[1], v.shape[2]
    if max(dq, dv) > MAX_HEAD_DIM or bh > 65535:
        raise ValueError(f"flash_attention: the kernel takes head dims <= "
                         f"{MAX_HEAD_DIM} and BH <= 65535, got Dq={dq}, "
                         f"Dv={dv}, BH={bh}")
    dev = q.device
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=dev)
    if out.numel() == 0:
        return out
    if sk == 0 or dq == 0:
        raise ValueError("flash_attention: no keys to attend to")
    if scale is None:
        scale = 1.0 / math.sqrt(dq)
    lib = _build.load(SOURCE, _bind)
    entry = ENTRY_POINTS[variant if variant != "cuda_core"
                         else (variant, q.dtype)]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, entry)(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
            group, sq, sk, dq, dv, int(causal), int(window), float(scale),
            stream)
    _build.launch_check(f"flash_attention ({variant})", err)
    LAUNCHES["flash_attention"] += 1
    VARIANT_LAUNCHES[variant] += 1
    return out
