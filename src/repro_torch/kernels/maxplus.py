"""Batched max-plus products: the hand-written Hopper kernels in
``csrc/maxplus.cu`` and their plain PyTorch versions.

Replaces the Pallas TPU kernel ``src/repro/kernels/maxplus.py:29``
(``maxplus_matmul_kernel``, reached through ``maxplus_matmul_pallas`` and
``maxplus_matvec_pallas``)::

    C[b, i, j] = max_k (A[b, i, k] + B[b, k, j])        NEG = -1e18 is -inf

Five entries, each with its plain version:

* ``maxplus_matmul`` / ``maxplus_matvec`` -- the general product and
  matrix-vector product, any shape (``kernels.ops.maxplus_matmul``);
* ``maxplus_closure`` -- the Kleene star of a batch of n x n blocks (n <=
  128) in one launch, P resident in shared memory through every squaring
  ``P <- max(P, P ⊗ P)``; its input ``max(D + w, I)`` is built in the
  kernel from a shared structure block and a per-item work vector.  Lower
  mode (``"closure_lower"``) computes only i >= j over k in [j, i];
  ``plan_closure`` picks it when that is exact, else full mode
  (``"closure_full"``);
* ``maxplus_matvec_lower`` -- a closure block from lower mode times a
  vector, reading the lower triangle only;
* ``maxplus_matvec_folded`` -- ``max(h0, (D + w) ⊗ prev)`` with the
  structure block shared and the work folded in, so the (b, n, n) operand
  ``D + w`` is never written.

Bound on the H100: two FP32 instructions (add, max) per (i, j, k) triple,
issued at 33.5 T lane-instructions/s (half the published 67 TFLOP/s, which
counts an FMA as two), so the closure is compute-bound -- counted over
what lower mode needs: P_kk stays 0, so only the C(n, 3) triples j < k
< i can change an entry, plus one max with the old P per entry i >= j;
the closure matvec reads each entry it needs once and is bound by memory
bandwidth; the folded matvec does three FP32 instructions per (item, i,
j).  The kernel source explains each design.

Dispatch: a CUDA tensor launches the kernel or raises -- there is no
fallback; only CPU tensors take the plain version.  ``LAUNCHES`` and
``PLAIN_CALLS`` count both per entry, ``VARIANT_LAUNCHES`` the closure's
two modes, so a run can show which one the path took.

The kernels are compiled with ``nvcc`` at first use into
``build/repro_torch/`` at the repository root, named by a hash of the
source, and loaded with ``ctypes`` (plain C interface, no PyTorch headers;
see ``_build``).
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import _build

__all__ = ["NEG", "K_STEP", "CLOSURE_MAX_N", "MAGNITUDE_LIMIT",
           "CLOSURE_VARIANTS", "LAUNCHES", "PLAIN_CALLS", "VARIANT_LAUNCHES",
           "reset_counts", "plan_closure", "closure_pieces",
           "maxplus_matmul", "maxplus_matvec", "maxplus_closure",
           "maxplus_matvec_lower", "maxplus_matvec_folded",
           "maxplus_matmul_torch", "maxplus_matvec_torch",
           "maxplus_closure_torch", "maxplus_matvec_folded_torch",
           "build"]

NEG = -1e18
K_STEP = 8   # k-slab depth of the plain version (as the TPU kernel's K_STEP)

CLOSURE_MAX_N = 128   # largest block the closure and its matvecs take
# NEG + x rounds back to NEG in float32 while |x| < 2^35 (half an ulp of
# 1e18): below it a term with a NEG operand can never win a max
MAGNITUDE_LIMIT = 2.0 ** 35
CLOSURE_VARIANTS = ("closure_lower", "closure_full")
PIECE_UNITS = 4       # a closure piece spans at most 4 x 8 values of k
CLOSURE_MAX_THREADS = 320   # CL_MAX_THREADS in csrc/maxplus.cu

_ENTRIES = ("maxplus_matmul", "maxplus_matvec", "maxplus_closure",
            "maxplus_matvec_lower", "maxplus_matvec_folded")
# launches of each kernel, and calls of each plain version (CPU tensors)
LAUNCHES: Dict[str, int] = {k: 0 for k in _ENTRIES}
PLAIN_CALLS: Dict[str, int] = {k: 0 for k in _ENTRIES}
# launches of the closure kernel by mode
VARIANT_LAUNCHES: Dict[str, int] = {v: 0 for v in CLOSURE_VARIANTS}

SOURCE = _build.CSRC / "maxplus.cu"


def reset_counts() -> None:
    """Zero every launch and plain-call counter."""
    for d in (LAUNCHES, PLAIN_CALLS, VARIANT_LAUNCHES):
        for k in d:
            d[k] = 0


def plan_closure(n: int, strictly_lower: bool, magnitude: float) -> str:
    """The closure kernel's mode for n x n blocks: ``"closure_lower"``
    when every block is strictly lower-triangular (NEG on and above the
    diagonal) and ``magnitude`` -- a bound on |x| over every finite value
    the closure computes, e.g. n (max finite |D| + max |w|) -- stays below
    2^35; else ``"closure_full"``.  Lower mode then equals full mode bit
    for bit, since every term it skips is NEG + x = NEG."""
    _check_n("maxplus_closure", n)
    return ("closure_lower" if strictly_lower and magnitude < MAGNITUDE_LIMIT
            else "closure_full")


def _place_warps(cost: List[int]) -> List[int]:
    """An order of the warps (by index into ``cost``) that minimises the
    largest sum of costs on one of the SM's four schedulers (branch and
    bound, longest first), taking warp w of a block to run on scheduler
    w % 4 -- NVIDIA documents no such rule, but on an H100 the placed
    lower-mode list at n = 128 runs 7% faster than the same warps in plain
    longest-first order (``tools/maxplus_breakdown.py``)."""
    W = len(cost)
    cap = [len(range(s, W, 4)) for s in range(4)]
    order = sorted(range(W), key=lambda w: -cost[w])
    best = [sum(cost) + 1, None]
    load, members = [0] * 4, [[] for _ in range(4)]

    def go(i: int) -> None:
        if max(load) >= best[0]:
            return
        if i == W:
            best[0], best[1] = max(load), [list(m) for m in members]
            return
        tried = set()
        for s in range(4):
            if len(members[s]) == cap[s] or (load[s], cap[s] -
                                             len(members[s])) in tried:
                continue
            tried.add((load[s], cap[s] - len(members[s])))
            load[s] += cost[order[i]]
            members[s].append(order[i])
            go(i + 1)
            members[s].pop()
            load[s] -= cost[order[i]]

    go(0)
    placed = [0] * W
    for s, m in enumerate(best[1]):
        for slot, w in zip(range(s, W, 4), m):
            placed[slot] = w
    return placed


def closure_pieces(n: int, variant: str) -> Tuple[np.ndarray, int]:
    """The closure kernel's work list for n x n blocks: an (threads, 8)
    int32 array of (row0, col0, k0, k1, slot, x0, x1, x2) -- thread t
    computes the 8 x 8 output tile at (row0, col0) over k in [k0, k1)
    (row0 -1: no work) -- and the number of scratch slots.  A tile's first
    piece (slot -1) folds in the results its other pieces leave in scratch
    slots x0, x1, x2 (-1: none) and writes the tile; every other piece
    leaves its result in slot ``slot``.  Slots follow the thread order, so
    neighbouring lanes write neighbouring slots.

    Full mode: one piece per tile over every k.  Lower mode: the tiles
    with row0 >= col0 over k in [col0, row0 + 8), each cut into pieces of
    at most ``PIECE_UNITS`` x 8 values of k of near-equal length.  Pieces
    go to warps longest first, so each warp's lanes run loops of one
    length, and the warps are placed so the four schedulers of an SM get
    near equal work."""
    if variant not in CLOSURE_VARIANTS:
        raise ValueError(f"unknown closure variant {variant!r}")
    T = -(-n // 8)
    pieces = []                       # (row0, col0, k0, k1, first piece?)
    for ti in range(T):
        for tj in range(T):
            if variant == "closure_full":
                pieces.append((8 * ti, 8 * tj, 0, n, True))
                continue
            if tj > ti:
                continue
            units = ti - tj + 1
            parts = -(-units // PIECE_UNITS)
            base, extra = divmod(units, parts)
            u = tj
            for p in range(parts):
                ln = base + (p < extra)
                pieces.append((8 * ti, 8 * tj, 8 * u, min(8 * (u + ln), n),
                               p == 0))
                u += ln
    # longest first; then by first k, so neighbouring lanes read the same
    # rows of P
    pieces.sort(key=lambda q: (-(q[3] - q[2]), q[2], q[0], q[1]))
    threads = max(128, -(-len(pieces) // 32) * 32)
    if threads > CLOSURE_MAX_THREADS:
        raise ValueError(f"closure_pieces: {threads} threads for n = {n}")
    pieces += [None] * (threads - len(pieces))
    warps = [pieces[i:i + 32] for i in range(0, threads, 32)]
    cost = [max((q[3] - q[2] for q in w if q), default=0) for w in warps]
    order = [q for w in _place_warps(cost) for q in warps[w]]
    slots: Dict[Tuple[int, int], List[int]] = {}
    nslots = 0
    table = np.full((threads, 8), -1, dtype=np.int32)
    table[:, 1:4] = 0
    for t, q in enumerate(order):
        if q is None:
            continue
        table[t, :4] = q[:4]
        if not q[4]:
            table[t, 4] = nslots
            slots.setdefault(q[:2], []).append(nslots)
            nslots += 1
    for t, q in enumerate(order):
        if q is not None and q[4]:
            extra = slots.get(q[:2], [])
            table[t, 5:5 + len(extra)] = extra
    return table, nslots


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


def maxplus_closure_torch(D: torch.Tensor, steps: int,
                          w: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kleene star by ``steps`` squarings ``P <- max(P, P ⊗ P)`` from ``P =
    max(M, I)``: M = D (b, n, n), or with ``w`` (nb, B, n) M = D[:, None] +
    w[..., None] (m_ij = d_ij + w_i) of shape (nb, B, n, n).  One ⊗ per
    squaring for the whole batch, each into a new buffer."""
    M = D if w is None else D[:, None] + w[..., None]
    n = M.shape[-1]
    eye = torch.full((n, n), NEG, dtype=torch.float32, device=M.device)
    eye.fill_diagonal_(0.0)
    P = torch.maximum(M, eye).reshape(-1, n, n)
    for _ in range(steps):
        Q = maxplus_matmul_torch(P, P)
        P = torch.maximum(P, Q, out=Q)
    return P.reshape(M.shape)


def maxplus_matvec_folded_torch(D: torch.Tensor, w: torch.Tensor,
                                prev: torch.Tensor, h0: torch.Tensor
                                ) -> torch.Tensor:
    """max(h0, (D + w[:, :, None]) ⊗ prev) for D (n, n) and w, prev, h0
    (b, n): the (b, n, n) operand written out, then the general matvec."""
    return torch.maximum(h0, maxplus_matvec_torch(D + w[:, :, None], prev))


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
    lib.maxplus_closure_f32.argtypes = [p, p, p, ll, ll, i, i, p, i, i, p]
    lib.maxplus_closure_f32.restype = i
    lib.maxplus_matvec_lower_f32.argtypes = [p, p, p, ll, i, p]
    lib.maxplus_matvec_lower_f32.restype = i
    lib.maxplus_matvec_folded_f32.argtypes = [p, p, p, p, p, ll, i, p]
    lib.maxplus_matvec_folded_f32.restype = i


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


def _dispatch(name: str, ts: Tuple[torch.Tensor, ...]) -> bool:
    """True when every tensor lies on the CPU (take the plain version);
    raises unless they all lie on one CUDA device as contiguous
    float32."""
    if all(t.device.type == "cpu" for t in ts):
        PLAIN_CALLS[name] += 1
        return True
    if ts[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {ts[0].device}")
    _check_cuda(name, *ts)
    return False


def _check_n(name: str, n: int) -> None:
    if not 0 < n <= CLOSURE_MAX_N:
        raise ValueError(f"{name}: n = {n} outside 1...{CLOSURE_MAX_N}")


def maxplus_matmul(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Batched ⊗: A (b, M, K), B (b, K, N) -> (b, M, N) float32.  CUDA
    tensors launch the kernel (float32, contiguous, same device); CPU
    tensors take ``maxplus_matmul_torch``."""
    if A.dim() != 3 or B.dim() != 3 or A.shape[0] != B.shape[0] \
            or A.shape[2] != B.shape[1]:
        raise ValueError(f"maxplus_matmul: shapes {tuple(A.shape)} x "
                         f"{tuple(B.shape)} are not (b, M, K) x (b, K, N)")
    if _dispatch("maxplus_matmul", (A, B)):
        return maxplus_matmul_torch(A, B)
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
    if _dispatch("maxplus_matvec", (A, v)):
        return maxplus_matvec_torch(A, v)
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


# the closure's work lists on each device, by (n, variant)
_PIECES: Dict[Tuple[int, str, torch.device], Tuple[torch.Tensor, int]] = {}


def _pieces_on(n: int, variant: str, device: torch.device
               ) -> Tuple[torch.Tensor, int]:
    key = (n, variant, device)
    hit = _PIECES.get(key)
    if hit is None:
        table, nslots = closure_pieces(n, variant)
        hit = (torch.from_numpy(table).to(device), nslots)
        _PIECES[key] = hit
    return hit


def maxplus_closure(D: torch.Tensor, steps: int,
                    w: Optional[torch.Tensor] = None, *,
                    variant: str = "closure_full") -> torch.Tensor:
    """Kleene star of every block in one launch: D (b, n, n) -> (b, n, n);
    with ``w`` (nb, B, n), D (nb, n, n) is a structure block per group and
    the star is of ``D[g] + w[g, c][:, None]``, (nb, B, n, n) blocks-major.
    n <= 128.  ``variant`` is ``plan_closure``'s choice; lower mode is
    exact only where the plan allows it.  CUDA tensors launch the kernel
    (float32, contiguous, one device); CPU tensors take
    ``maxplus_closure_torch``, whatever the variant."""
    if variant not in CLOSURE_VARIANTS:
        raise ValueError(f"maxplus_closure: unknown variant {variant!r}")
    if D.dim() != 3 or D.shape[1] != D.shape[2] or (
            w is not None and (w.dim() != 3 or w.shape[0] != D.shape[0]
                               or w.shape[2] != D.shape[2])):
        raise ValueError(f"maxplus_closure: shapes {tuple(D.shape)}, "
                         f"{None if w is None else tuple(w.shape)} are not "
                         f"(b, n, n) [, (b, B, n)]")
    n = D.shape[2]
    _check_n("maxplus_closure", n)
    if steps < 0:
        raise ValueError(f"maxplus_closure: steps = {steps} < 0")
    ts = (D,) if w is None else (D, w)
    if _dispatch("maxplus_closure", ts):
        return maxplus_closure_torch(D, steps, w)
    per_blk = 1 if w is None else w.shape[1]
    out = torch.empty(D.shape if w is None else (D.shape[0], per_blk, n, n),
                      dtype=torch.float32, device=D.device)
    if out.numel() == 0:
        return out
    table, nslots = _pieces_on(n, variant, D.device)
    lib = _load()
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxplus_closure_f32(
            D.data_ptr(), None if w is None else w.data_ptr(),
            out.data_ptr(), D.shape[0] * per_blk, per_blk, n, steps,
            table.data_ptr(), table.shape[0], nslots, stream)
    _build.launch_check("maxplus_closure", err)
    LAUNCHES["maxplus_closure"] += 1
    VARIANT_LAUNCHES[variant] += 1
    return out


def maxplus_matvec_lower(C: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """C ⊗ h for closure blocks C (b, n, n) whose entries above the
    diagonal are NEG (lower mode's output), h (b, n) -> (b, n), n <= 128.
    Reads C's lower triangle only; its plain version is the general one,
    ``maxplus_matvec_torch``.  Dispatch as :func:`maxplus_matmul`."""
    if C.dim() != 3 or h.dim() != 2 or C.shape[1] != C.shape[2] \
            or C.shape[0] != h.shape[0] or C.shape[2] != h.shape[1]:
        raise ValueError(f"maxplus_matvec_lower: shapes {tuple(C.shape)} x "
                         f"{tuple(h.shape)} are not (b, n, n) x (b, n)")
    _check_n("maxplus_matvec_lower", C.shape[2])
    if _dispatch("maxplus_matvec_lower", (C, h)):
        return maxplus_matvec_torch(C, h)
    out = torch.empty(h.shape, dtype=torch.float32, device=C.device)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(C.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxplus_matvec_lower_f32(C.data_ptr(), h.data_ptr(),
                                           out.data_ptr(), h.shape[0],
                                           h.shape[1], stream)
    _build.launch_check("maxplus_matvec_lower", err)
    LAUNCHES["maxplus_matvec_lower"] += 1
    return out


def maxplus_matvec_folded(D: torch.Tensor, w: torch.Tensor,
                          prev: torch.Tensor, h0: torch.Tensor
                          ) -> torch.Tensor:
    """max(h0, (D + w[:, :, None]) ⊗ prev) for one structure block D (n, n)
    and w, prev, h0 (b, n) -> (b, n), n <= 128, without writing D + w.
    Dispatch as :func:`maxplus_matmul`."""
    n = D.shape[-1]
    if D.dim() != 2 or D.shape[0] != n or any(
            t.dim() != 2 or t.shape != w.shape or t.shape[1] != n
            for t in (w, prev, h0)):
        raise ValueError(f"maxplus_matvec_folded: shapes {tuple(D.shape)}, "
                         f"{[tuple(t.shape) for t in (w, prev, h0)]} are not "
                         f"(n, n) and three (b, n)")
    _check_n("maxplus_matvec_folded", n)
    if _dispatch("maxplus_matvec_folded", (D, w, prev, h0)):
        return maxplus_matvec_folded_torch(D, w, prev, h0)
    out = torch.empty(w.shape, dtype=torch.float32, device=D.device)
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(D.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.maxplus_matvec_folded_f32(
            D.data_ptr(), w.data_ptr(), prev.data_ptr(), h0.data_ptr(),
            out.data_ptr(), w.shape[0], n, stream)
    _build.launch_check("maxplus_matvec_folded", err)
    LAUNCHES["maxplus_matvec_folded"] += 1
    return out
