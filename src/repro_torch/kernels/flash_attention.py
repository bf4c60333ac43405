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

Training (``flash_attention_train``, a ``torch.autograd.Function``):
causal attention at ``Dq == Dv == 128`` in bf16 with ``Sq == Sk`` a
multiple of 128 and as many k/v heads as q heads.  Its forward is the
``wgmma`` template instantiated once more, writing each row's log-sum-exp
beside o (``"train_fwd"``); its backward is three kernels -- D =
rowsum(dO o), then ``"train_dq"`` and ``"train_dkdv"``, FlashAttention-2's
equations on TMA + ``wgmma``, without atomics, so the gradients are
bit-equal run to run.  They replace no Pallas kernel (the reference's has
no VJP: it trains through plain attention that XLA fuses); the source
explains the design.  ``models.layers._attend`` sends a chunked-route call
here when its input qualifies (``layers.flash_train_applies``: CUDA
tensors only).  The plain versions are ``flash_attention_train_torch`` (o
and the log-sum-exp) and ``flash_attention_train_backward_torch`` (the
FlashAttention backward equations).

One more kernel, ``"mma_sync"`` (the tensor-core kernel that served the
LM path before the ``wgmma`` one), is reached only through the private
``_launch``, as the timed yardstick; so is ``"cuda_core"`` at the head
dims of ``wgmma_dv``, ``wgmma_120`` and ``wgmma_96``.  ``LAUNCHES``
counts every launch, ``VARIANT_LAUNCHES`` the launches of each kernel,
``PLAIN_CALLS`` the plain version's calls; a training call launches
``"train_fwd"`` once, its backward ``"train_dq"`` and ``"train_dkdv"``
once each (``LAUNCHES`` counts the D pass too).
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
           "flash_attention_torch", "bf16_error_bound", "build",
           "flash_attention_train", "flash_attention_train_torch",
           "flash_attention_train_backward_torch"]

NEG = -1e18
MAX_HEAD_DIM = 128     # the widest head of a ported config
WGMMA_HEAD_DIM = 128   # the wgmma kernel's Dq == Dv
WGMMA_DV_HEAD_DIMS = ((96, 64),)   # the wgmma_dv instances' (Dq, Dv)
# every (Dq, Dv) the TMA + wgmma template is instantiated at, and its kernel
WGMMA_INSTANCES = {(WGMMA_HEAD_DIM, WGMMA_HEAD_DIM): "wgmma",
                   **{dims: "wgmma_dv" for dims in WGMMA_DV_HEAD_DIMS},
                   (120, 120): "wgmma_120", (96, 96): "wgmma_96"}
DTYPES = (torch.float32, torch.bfloat16)
TRAIN_HEAD_DIM = 128   # the training kernels' Dq == Dv
TRAIN_TILE = 128       # ... and the multiple of it S has to be

VARIANTS = ("wgmma", "wgmma_dv", "wgmma_120", "wgmma_96", "cuda_core",
            "mma_sync", "train_fwd", "train_dq", "train_dkdv")
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
# the training kernels' entry points; the backward's D pass (rowsum(dO o))
# is flash_attention_train_bwd_dot, launched before train_dq
TRAIN_ENTRY_POINTS = {"train_fwd": "flash_attention_train_fwd",
                      "train_dq": "flash_attention_train_dq",
                      "train_dkdv": "flash_attention_train_dkdv"}


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
    lib.flash_attention_train_fwd.argtypes = [p, p, p, p, p, i, i, i, f, p]
    lib.flash_attention_train_bwd_dot.argtypes = [p, p, p, ctypes.c_longlong,
                                                  p]
    lib.flash_attention_train_dq.argtypes = [p, p, p, p, p, p, p, i, i, f, p]
    lib.flash_attention_train_dkdv.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                               f, p]
    for name in (*TRAIN_ENTRY_POINTS.values(),
                 "flash_attention_train_bwd_dot"):
        getattr(lib, name).restype = i
    for name in ("train_bwd_smem_bytes", "train_bwd_stages"):
        getattr(lib, f"flash_attention_{name}").argtypes = []
        getattr(lib, f"flash_attention_{name}").restype = i


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


# ---------------------------------------------------------------------------
# training: causal attention at Dq == Dv == 128 with a backward
# ---------------------------------------------------------------------------


def _check_train(q, k, v) -> None:
    """q, k, v (BH, S, D) alike: one k/v head a query head, Dq == Dv."""
    if q.dim() != 3 or q.shape != k.shape or q.shape != v.shape:
        raise ValueError(f"flash_attention_train: q, k, v must be (BH, S, "
                         f"D) alike (GQA expanded), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")


def _train_scores(q, k, scale: float) -> torch.Tensor:
    """scale * q k^T in float32 (BH, S, S), NEG above the diagonal."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * scale
    n = q.shape[1]
    upper = torch.ones((n, n), dtype=torch.bool, device=q.device).triu_(1)
    return s.masked_fill_(upper, NEG)


def flash_attention_train_torch(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, *,
                                scale: Optional[float] = None):
    """The plain version of the training forward: causal attention over
    q, k, v (BH, S, D) -> (o in q's dtype, lse (BH, S) float32), lse each
    row's natural log-sum-exp of its scaled scores."""
    _check_train(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    s = _train_scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    return torch.matmul(p, v.float()).to(q.dtype), lse


def flash_attention_train_backward_torch(q, k, v, o, lse, do, *,
                                         scale: Optional[float] = None):
    """The plain version of the training backward: FlashAttention's
    equations from the forward's o and log-sum-exp -> (dq, dk, dv) in q's
    dtype::

        D = rowsum(dO o)        P = exp(scale q k^T - lse), causal
        dV = P^T dO             dP = dO v^T
        dS = P (dP - D)         dQ = scale dS k      dK = scale dS^T q

    P is rounded to q's dtype for dV, and dS for dQ and dK, as the kernels
    round them (no-ops in float32)."""
    _check_train(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    dt = q.dtype
    p = torch.exp(_train_scores(q, k, scale) - lse[..., None])
    dof = do.float()
    dv = torch.matmul(p.to(dt).float().transpose(1, 2), dof)
    dp = torch.matmul(dof, v.float().transpose(1, 2))
    d = (dof * o.float()).sum(dim=-1)
    ds = (p * (dp - d[..., None])).to(dt).float()
    dq = torch.matmul(ds, k.float()) * scale
    dk = torch.matmul(ds.transpose(1, 2), q.float()) * scale
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _check_train_cuda(*tensors) -> None:
    dev = tensors[0].device
    for t in tensors:
        if not t.is_cuda or t.device != dev or t.dtype != torch.bfloat16:
            raise TypeError("flash_attention_train: the kernels take bf16 "
                            "tensors on one CUDA device")
    bh, s, d = tensors[0].shape
    if d != TRAIN_HEAD_DIM or s == 0 or s % TRAIN_TILE:
        raise ValueError(f"flash_attention_train: the kernels take D = "
                         f"{TRAIN_HEAD_DIM} and S a multiple of "
                         f"{TRAIN_TILE}, got D = {d}, S = {s}")


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t contiguous from a 16-byte boundary (what TMA takes): itself or a
    copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _count(variant: Optional[str]) -> None:
    LAUNCHES["flash_attention"] += 1
    if variant:
        VARIANT_LAUNCHES[variant] += 1


def _train_call(variant: Optional[str], entry: str, like: torch.Tensor,
                *args) -> None:
    """One launch of a training entry point on ``like``'s device and its
    current stream, checked and counted (``variant`` None: the D pass)."""
    lib = _build.load(SOURCE, _bind)
    with torch.cuda.device(like.device):
        err = getattr(lib, entry)(*args,
                                  torch.cuda.current_stream().cuda_stream)
    _build.launch_check(
        f"flash_attention ({entry[len('flash_attention_'):]})", err)
    _count(variant)


def _train_forward(q, k, v, scale: float):
    """The ``train_fwd`` kernel on contiguous, 16-byte aligned q, k, v:
    (o, lse)."""
    _check_train_cuda(q, k, v)
    bh, s, _ = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, s), dtype=torch.float32, device=q.device)
    _train_call("train_fwd", TRAIN_ENTRY_POINTS["train_fwd"], q,
                q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), bh, 1, s, float(scale))
    return o, lse


def _train_dot(o, do) -> torch.Tensor:
    """The backward's D = rowsum(dO o), (BH, S) float32."""
    bh, s, _ = o.shape
    dvec = torch.empty((bh, s), dtype=torch.float32, device=o.device)
    _train_call(None, "flash_attention_train_bwd_dot", o, o.data_ptr(),
                do.data_ptr(), dvec.data_ptr(), bh * s)
    return dvec


def _train_dq(q, k, v, do, lse, dvec, scale: float) -> torch.Tensor:
    """The ``train_dq`` kernel: dq."""
    bh, s, _ = q.shape
    dq = torch.empty_like(q)
    _train_call("train_dq", TRAIN_ENTRY_POINTS["train_dq"], q,
                *(t.data_ptr() for t in (q, k, v, do, lse, dvec, dq)), bh, s,
                float(scale))
    return dq


def _train_dkdv(q, k, v, do, lse, dvec, scale: float):
    """The ``train_dkdv`` kernel: (dk, dv)."""
    bh, s, _ = q.shape
    dk, dv = torch.empty_like(q), torch.empty_like(q)
    _train_call("train_dkdv", TRAIN_ENTRY_POINTS["train_dkdv"], q,
                *(t.data_ptr() for t in (q, k, v, do, lse, dvec, dk, dv)), bh,
                s, float(scale))
    return dk, dv


def _train_backward(q, k, v, o, lse, do, scale: float):
    """D = rowsum(dO o), then the ``train_dq`` and ``train_dkdv`` kernels:
    (dq, dk, dv)."""
    do = _aligned(do)
    _check_train_cuda(q, k, v, o, do)
    dvec = _train_dot(o, do)
    return (_train_dq(q, k, v, do, lse, dvec, scale),
            *_train_dkdv(q, k, v, do, lse, dvec, scale))


class _FlashTrain(torch.autograd.Function):
    """Causal attention with its backward, on the kernels."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        q, k, v = _aligned(q), _aligned(k), _aligned(v)
        o, lse = _train_forward(q, k, v, scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        return (*_train_backward(q, k, v, o, lse, do, ctx.scale), None)


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, scale: Optional[float] = None) -> torch.Tensor:
    """Causal attention over q, k, v (BH, S, D) -- one k/v head a query
    head -- -> o (BH, S, D) in q's dtype, differentiable in q, k and v,
    on the kernels: CUDA tensors in bf16, D = 128, S a multiple of 128
    (others raise) run ``train_fwd`` and, in the backward, ``train_dq``
    and ``train_dkdv``.  Scale is 1/sqrt(D) unless given."""
    _check_train(q, k, v)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _FlashTrain.apply(q, k, v, float(scale))
