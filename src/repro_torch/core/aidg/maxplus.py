"""Max-plus evaluation of the AIDG in PyTorch.

The recurrence  t_i = w_i + max(base_i, max_j (t_j + d_ji))  over the
build-time ``CompiledAIDG`` (trace → AIDG → LevelSchedule → CompiledAIDG,
see ``builder.compile_aidg``), for a batch of candidate weightings at once:
every function takes ``work``/``base`` of shape (n,) or (B, n) and answers
in the same rank.

* ``longest_path_wavefront`` — a Python loop over topological *levels*
  with vectorized predecessor gathers and a max over the predecessor axis
  inside each level; sequential depth is the DAG's critical depth.
* ``longest_path_scan`` — one loop step per node; the reference path.
* ``longest_path_blocked`` — the adjacency banded into dense 128-node
  blocks, each block solved by the max-plus Kleene closure
  t_b = M*_b ⊗ h_b.  Every ⊗ goes through ``repro_torch.kernels.maxplus``:
  the hand-written CUDA kernels on CUDA tensors, their plain versions on
  CPU tensors.  The closures of all blocks and candidates take one launch
  (lower mode where ``plan_closure`` allows it: ``compile_aidg`` numbers
  nodes level-major, so every diagonal block is strictly lower-triangular);
  each block step is a folded sub-diagonal matvec and a closure matvec.
* ``longest_path_condensed`` — the wavefront over the chain-condensed
  graph (``builder.condense_aidg``): one loop step per *unit* level,
  absorbed chain interiors rebuilt from an exact prefix sum, and the
  affine chains inside a window resolved by ``affine_scan``, a log-step
  scan in the reference's ``lax.associative_scan`` combine order.

``fixed_point_torch(engine=...)`` selects the relaxation used between
storage-queueing folds; ``fixed_point_batch`` takes raw batched latencies.
The storage request-slot queueing (arrival-ordered service) is
``slot_queue_scan``.  Sorts are ``stable=True`` throughout: queue tie-breaks
must match the reference's stable ``argsort``.

**The smooth relaxation family** (gradient-based co-design):
``longest_path_soft`` / ``slot_queue_soft`` / ``fixed_point_soft`` replace
each hard ``max`` with the temperature-τ log-sum-exp

    softmax_τ(x₁, …, x_K) = τ · log Σ_k exp(x_k / τ)
                          ∈ [max_k x_k,  max_k x_k + τ·log K]

which is smooth everywhere, monotone in every argument, and recovers the
exact result as τ → 0; autograd differentiates it.  Every engine function
that has a soft branch takes ``tau``: ``None`` is the hard path, left
operation for operation as it was; a value selects the soft family (the
reference's trace-time ``soft`` flag).  τ is carried as a 0-d float32
tensor on the data's device, as the reference traces it.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from ...device import resolve_device
from ...kernels import maxplus as K
from ...kernels.maxplus import (maxplus_matmul, maxplus_matmul_torch,
                                maxplus_matvec)
from .builder import AIDG, CompiledAIDG, CondensedAIDG, NEG, compile_aidg, \
    condense_aidg

__all__ = [
    "ENGINES",
    "DEFAULT_ENGINE",
    "longest_path_wavefront",
    "longest_path_scan",
    "longest_path_blocked",
    "longest_path_condensed",
    "condensed_prefix",
    "condensed_scan",
    "affine_scan",
    "slot_queue_scan",
    "fixed_point_torch",
    "fixed_point_batch",
    "maxplus_matmul_torch",
    "maxplus_closure",
    "Solver",
    "softmaximum",
    "softmax_reduce",
    "longest_path_soft",
    "slot_queue_soft",
    "fixed_point_soft",
]

ENGINES = ("wavefront", "scan", "blocked", "condensed")
DEFAULT_ENGINE = "wavefront"
SOFT_ENGINES = ("wavefront", "condensed")     # engines with a soft family

AIDGLike = Union[AIDG, CompiledAIDG]
Tensor = torch.Tensor


def _as_compiled(aidg: AIDGLike) -> CompiledAIDG:
    return aidg if isinstance(aidg, CompiledAIDG) else compile_aidg(aidg)


def _batched(x, default: np.ndarray, device: torch.device
             ) -> Tuple[Tensor, bool]:
    """(n,) or (B, n) input (or the AIDG default) -> ((B, n) float32 tensor
    on ``device``, whether the input was 1-D)."""
    v = torch.as_tensor(default if x is None else x, dtype=torch.float32,
                        device=device)
    return (v[None, :], True) if v.dim() == 1 else (v, False)


def _pair(work, base, a: AIDG, device: torch.device
          ) -> Tuple[Tensor, Tensor, bool]:
    """``work`` and ``base`` (or the AIDG's own) as (B, n) tensors with one
    shared batch size, and whether ``work`` was 1-D."""
    w, one = _batched(work, a.work, device)
    b, _ = _batched(base, a.base, device)
    B = max(w.shape[0], b.shape[0])
    return (w.expand(B, -1).contiguous(), b.expand(B, -1).contiguous(),
            one)


# ---------------------------------------------------------------------------
# per-node scan (reference path)
# ---------------------------------------------------------------------------


def _scan_impl(work: Tensor, base: Tensor, preds: Tensor,
               extra: Tensor) -> Tensor:
    """t_i = w_i + max(base_i, max_k t[preds_ik] + extra_ik), forward order,
    for every batch row at once."""
    B, n = work.shape
    valid = preds >= 0
    idx = preds.clamp(min=0)
    t = torch.zeros((B, n), dtype=torch.float32, device=work.device)
    for i in range(n):
        vals = torch.where(valid[i], t[:, idx[i]] + extra[i], NEG)
        m = torch.maximum(base[:, i], vals.amax(dim=1))
        t[:, i] = m + work[:, i]
    return t


def longest_path_scan(aidg: AIDGLike, work=None, base=None,
                      device=None) -> Tensor:
    """Exact forward relaxation with one sequential step per instruction —
    the reference path the wavefront and blocked engines are checked
    against."""
    dev = resolve_device(device)
    a = _as_compiled(aidg).aidg
    w, b, one = _pair(work, base, a, dev)
    t = _scan_impl(w, b, torch.as_tensor(a.preds, dtype=torch.long,
                                         device=dev),
                   torch.as_tensor(a.pred_extra, device=dev))
    return t[0] if one else t


# ---------------------------------------------------------------------------
# level-scheduled wavefront
# ---------------------------------------------------------------------------


def _wavefront_impl(work: Tensor, base: Tensor, preds_lv: Tensor,
                    extra_lv: Tensor, starts: Tuple[int, ...], order: Tensor,
                    rank: Tensor, width: int, tau=None) -> Tensor:
    """One loop step per *level* over the level-major renumbering: each
    step takes a contiguous ``width`` window of (preds, extra, work, base),
    gathers the already-final predecessor times, reduces over the
    predecessor axis and writes the window back.  Lanes past the level's
    true extent compute garbage and are overwritten when their own level
    runs.  With ``tau`` the reduction is ``softmax_reduce`` over the
    concatenated ``[base, preds]`` (the reference's order)."""
    B = work.shape[0]
    dev = work.device
    work_lv = torch.cat([work[:, order],
                         torch.zeros((B, width), dtype=torch.float32,
                                     device=dev)], dim=1)
    base_lv = torch.cat([base[:, order],
                         torch.full((B, width), NEG, dtype=torch.float32,
                                    device=dev)], dim=1)
    valid = preds_lv >= 0
    idx = preds_lv.clamp(min=0)
    t = torch.zeros((B, work.shape[1] + width), dtype=torch.float32,
                    device=dev)
    for start in starts:
        s = slice(start, start + width)
        vals = torch.where(valid[s], t[:, idx[s]] + extra_lv[s], NEG)
        if tau is None:
            m = torch.maximum(base_lv[:, s], vals.amax(dim=2))
        else:
            m = softmax_reduce(torch.cat([base_lv[:, s, None], vals], dim=2),
                               tau, dim=2)
        t[:, s] = m + work_lv[:, s]
    return t[:, rank]


def longest_path_wavefront(aidg: AIDGLike, work=None, base=None,
                           device=None) -> Tensor:
    """Exact longest path in ``n_levels`` sequential steps — identical to
    ``longest_path_scan``, the wavefront order is a parallel schedule of
    the same relaxation."""
    dev = resolve_device(device)
    ca = _as_compiled(aidg)
    a = ca.aidg
    w, b, one = _pair(work, base, a, dev)
    t = Solver(ca, "wavefront", dev).relax_for(w)(b)
    return t[0] if one else t


# ---------------------------------------------------------------------------
# condensed wavefront (chain super-edges; sequential depth = the CONDENSED
# critical depth)
# ---------------------------------------------------------------------------


def _interleave(even: Tensor, odd: Tensor) -> Tensor:
    """[e0, o0, e1, o1, ...] along the last axis (len(even) - len(odd) is
    0 or 1)."""
    out = even.new_empty(even.shape[:-1] + (even.shape[-1] + odd.shape[-1],))
    out[..., 0::2] = even
    out[..., 1::2] = odd
    return out


def _affine_op(va: Tensor, ha: Tensor, vb: Tensor, hb: Tensor, tau=None
               ) -> Tuple[Tensor, Tensor]:
    """(v₁, h₁) ∘ (v₂, h₂) = (max(v₁ + v₂, NEG), max(h₁ + v₂, h₂)); with
    ``tau`` the h combine is ``softmaximum`` (smooth chains compose under
    the same operator)."""
    h = (torch.maximum(ha + vb, hb) if tau is None
         else softmaximum(ha + vb, hb, tau))
    return torch.clamp_min(va + vb, NEG), h


def affine_scan(v: Tensor, h: Tensor, tau=None) -> Tuple[Tensor, Tensor]:
    """Inclusive scan of the max-plus affine composition along the last
    axis, in log-many steps, with the combine order of the reference's
    ``lax.associative_scan``: combine adjacent pairs, scan the half-length
    result recursively, then fill the even positions — so every partial
    sum is formed as the reference forms it.  ``tau``: the soft combine."""
    n = v.shape[-1]
    if n < 2:
        return v, h
    rv, rh = _affine_op(v[..., 0:n - 1:2], h[..., 0:n - 1:2], v[..., 1::2],
                        h[..., 1::2], tau)
    ov, oh = affine_scan(rv, rh, tau)
    if n % 2 == 0:
        ev, eh = _affine_op(ov[..., :-1], oh[..., :-1], v[..., 2::2],
                            h[..., 2::2], tau)
    else:
        ev, eh = _affine_op(ov, oh, v[..., 2::2], h[..., 2::2], tau)
    ev = torch.cat([v[..., :1], ev], dim=-1)
    eh = torch.cat([h[..., :1], eh], dim=-1)
    return _interleave(ev, ov), _interleave(eh, oh)


def condensed_prefix(cond: CondensedAIDG, w: Tensor) -> Tensor:
    """(B, n_ab) inclusive prefix weights of every absorbed node: the
    θ-reweighted super-edge sum ``Σ_prefix (edge extra + w_i)`` as one
    ``cumsum`` and two gathers, for (B, n) work ``w``."""
    return _prefix(_CondArrays(cond, w.device), w)


def _prefix(A: "_CondArrays", w: Tensor) -> Tensor:
    aw = w[:, A.absorbed] + A.ab_const
    tot0 = torch.cat([torch.zeros_like(aw[:, :1]),
                      torch.cumsum(aw, dim=1)], dim=1)
    return tot0[:, 1:] - tot0[:, A.ab_segstart]


def condensed_scan(w_perm: Tensor, b_perm: Tensor, extra_lv: Tensor,
                   v_lv: Tensor, preds_lv: Tensor, starts: Tuple[int, ...],
                   has_chains: bool = True, tau=None) -> Tensor:
    """The condensed wavefront for a batch: one loop step per UNIT level.
    Each step gathers the already-final cross-unit predecessor times,
    reduces them with the window's base, then resolves every affine chain
    inside the window with ``affine_scan``.  ``w_perm``/``b_perm`` (B, NK)
    in the level-major permuted kept layout; ``extra_lv`` (B or 1, NK + W,
    P) and ``v_lv`` (B, NK + W) the θ-reweighted edge and coupling weights
    (NEG = chain break); ``has_chains=False`` skips the affine scan."""
    B, NK = w_perm.shape
    W = preds_lv.shape[0] - NK
    P = preds_lv.shape[1]
    dev = w_perm.device
    work_pad = torch.cat([w_perm, torch.zeros((B, W), dtype=torch.float32,
                                              device=dev)], dim=1)
    base_pad = torch.cat([b_perm, torch.full((B, W), NEG,
                                             dtype=torch.float32,
                                             device=dev)], dim=1)
    valid = preds_lv >= 0
    idx = preds_lv.clamp(min=0)
    t = torch.zeros((B, NK + W), dtype=torch.float32, device=dev)
    for start in starts:
        s = slice(start, start + W)
        r = base_pad[:, s]
        if P:
            vals = torch.where(valid[s], t[:, idx[s]] + extra_lv[:, s], NEG)
            r = (torch.maximum(r, vals.amax(dim=2)) if tau is None
                 else softmaximum(r, softmax_reduce(vals, tau, dim=2), tau))
        if has_chains:
            _, tw = affine_scan(v_lv[:, s], r + work_pad[:, s], tau)
        else:
            tw = r + work_pad[:, s]
        t[:, s] = tw
    return t[:, :NK]


class _CondArrays:
    """The θ-independent arrays of one CondensedAIDG on one device."""

    def __init__(self, cond: CondensedAIDG, device: torch.device):
        T = lambda x, dt=None: torch.as_tensor(np.asarray(x), dtype=dt,
                                               device=device)
        L = torch.long
        self.cond = cond
        self.kept_perm = T(cond.kept_perm, L)
        self.absorbed = T(cond.absorbed, L)
        self.ab_const = T(cond.ab_const, torch.float32)
        self.ab_segstart = T(cond.ab_segstart, L)
        self.ab_anchor_perm = T(cond.ab_anchor_perm, L)
        self.vc = T(cond.v_const_lv, torch.float32)
        self.const = T(cond.const_lv, torch.float32)
        self.pidx = T(cond.pidx_lv, L)
        self.vp = T(cond.v_pidx_lv, L)
        self.preds = T(cond.preds_lv, L)
        self.starts = tuple(int(x) for x in cond.schedule.starts)
        self.width = cond.schedule.width
        self.has_chains = cond.stats["n_coupled"] > 0


def _condensed_relax_for(A: _CondArrays, w: Tensor, tau=None
                         ) -> Callable[[Tensor], Tensor]:
    """(B, n) work -> the condensed relaxation ``base (B, n) -> t (B, n)``:
    kept nodes by the unit-level wavefront with in-window affine chains,
    absorbed nodes rebuilt as anchor + exact prefix sum.  Everything that
    depends on work only (prefix sums, edge and coupling weights) is
    computed here once.  ``tau``: the soft family (absorbed steps and
    chain couplings keep their exact sums)."""
    cond = A.cond
    B = w.shape[0]
    wk = w[:, A.kept_perm]
    w_pad = torch.cat([wk, torch.zeros((B, A.width), dtype=torch.float32,
                                       device=w.device)], dim=1)
    coupled = A.vc > NEG / 2
    prefix = None
    if cond.n_absorbed:
        prefix = _prefix(A, w)
        extra = A.const + torch.where(A.pidx >= 0,
                                      prefix[:, A.pidx.clamp(min=0)], 0.0)
        vpre = torch.where(A.vp >= 0, prefix[:, A.vp.clamp(min=0)], 0.0)
    else:
        extra = A.const[None]
        vpre = 0.0
    v_lv = torch.where(coupled, A.vc + vpre + w_pad, NEG)

    def relax(b: Tensor) -> Tensor:
        tk = condensed_scan(wk, b[:, A.kept_perm], extra, v_lv, A.preds,
                            A.starts, has_chains=A.has_chains, tau=tau)
        t = torch.zeros((B, cond.n), dtype=torch.float32, device=w.device)
        t[:, A.kept_perm] = tk
        if prefix is not None:
            t[:, A.absorbed] = tk[:, A.ab_anchor_perm] + prefix
        return t

    return relax


def longest_path_condensed(aidg: AIDGLike, work=None, base=None,
                           device=None) -> Tensor:
    """Exact longest path in ``levels_condensed`` sequential steps: chain
    interiors folded into θ-parametric super-edges, so chain-dominated
    graphs lose most of their loop length.  Identical to
    ``longest_path_wavefront`` for any work vector with the ≥ 1-cycle
    floor."""
    dev = resolve_device(device)
    ca = _as_compiled(aidg)
    a = ca.aidg
    w, b, one = _pair(work, base, a, dev)
    t = Solver(ca, "condensed", dev).relax_for(w)(b)
    return t[0] if one else t


# ---------------------------------------------------------------------------
# blocked max-plus closure evaluation
# ---------------------------------------------------------------------------


def maxplus_closure(M: Tensor, steps: int) -> Tensor:
    """Kleene star M* = (I ⊕ M)^(2^steps) by repeated max-plus squaring, for
    M (..., n, n).  For n <= 128 all leading dims go to the closure kernel
    as ONE batch in ONE launch, in full mode (M may be any matrix); larger
    n take one general matmul launch per squaring, each into a new buffer
    (updating P in place would read entries it has just overwritten)."""
    n = M.shape[-1]
    if n <= K.CLOSURE_MAX_N:
        M3 = M.reshape(-1, n, n).to(torch.float32).contiguous()
        return K.maxplus_closure(M3, steps, variant="closure_full"
                                 ).reshape(M.shape)
    eye = torch.full((n, n), NEG, dtype=torch.float32, device=M.device)
    eye.fill_diagonal_(0.0)
    P = torch.maximum(M, eye).reshape(-1, n, n)
    for _ in range(steps):
        Q = maxplus_matmul(P, P)
        P = torch.maximum(P, Q, out=Q)
    return P.reshape(M.shape)


def _blocked_structure(ca: CompiledAIDG, block: int) -> Tuple[np.ndarray, ...]:
    """Banded structure-only edge matrices, cached per block size on the
    CompiledAIDG.

    Returns (D_diag, D_sub, far_src, far_dst, far_w): per block b,
    ``D_diag[b][i, j]`` is the extra delay of edge (local j -> local i)
    inside the block (NEG if absent) *without* w_i (runtime work is folded
    at eval so the blocked engine stays θ-reweightable), ``D_sub`` the same
    for edges from the previous block, and the ``far_*`` arrays a padded
    per-block gather list for edges reaching further back (pad: weight NEG,
    dst ``block`` — a scratch slot)."""
    hit = ca._block_cache.get(block)
    if hit is not None:
        return hit
    a = ca.aidg
    n = a.n
    nb = max(1, (n + block - 1) // block)
    Dd = np.full((nb, block, block), NEG, dtype=np.float32)
    Ds = np.full((nb, block, block), NEG, dtype=np.float32)
    far: Dict[int, list] = {b: [] for b in range(nb)}
    for i in range(n):
        bi, li = divmod(i, block)
        for k in range(a.preds.shape[1]):
            j = int(a.preds[i, k])
            if j < 0:
                break
            d = float(a.pred_extra[i, k])
            bj, lj = divmod(j, block)
            if bj == bi:
                Dd[bi, li, lj] = max(Dd[bi, li, lj], d)
            elif bj == bi - 1:
                Ds[bi, li, lj] = max(Ds[bi, li, lj], d)
            else:
                far[bi].append((j, li, d))
    F = max(1, max(len(v) for v in far.values()))
    far_src = np.zeros((nb, F), dtype=np.int32)
    far_dst = np.full((nb, F), block, dtype=np.int32)
    far_w = np.full((nb, F), NEG, dtype=np.float32)
    for b, lst in far.items():
        for k, (j, li, d) in enumerate(lst):
            far_src[b, k] = j
            far_dst[b, k] = li
            far_w[b, k] = d
    out = (Dd, Ds, far_src, far_dst, far_w)
    ca._block_cache[block] = out
    return out


def _diagonal_facts(ca: CompiledAIDG, block: int) -> Tuple[bool, float]:
    """(every diagonal block is strictly lower-triangular, the largest
    finite |d| in them), cached per block size beside the structure."""
    key = ("diagonal", block)
    hit = ca._block_cache.get(key)
    if hit is None:
        Dd = _blocked_structure(ca, block)[0]
        upper = np.triu(np.ones(Dd.shape[1:], dtype=bool))
        fin = Dd[Dd > NEG / 2]
        hit = (bool((Dd[:, upper] == NEG).all()),
               float(np.abs(fin).max()) if fin.size else 0.0)
        ca._block_cache[key] = hit
    return hit


def _matvec_folded_general(D: Tensor, w: Tensor, prev: Tensor, h0: Tensor
                           ) -> Tensor:
    """max(h0, (D + w) ⊗ prev) through the general matvec, for blocks above
    the folded kernel's 128."""
    return torch.maximum(h0, maxplus_matvec(D + w[:, :, None], prev))


def _blocked_relax(n: int, block: int, Ds: Tensor, fs: Tensor, fd: Tensor,
                   fw: Tensor, wb: Tensor, clo: Tensor, base: Tensor,
                   folded: Callable, closure_mv: Callable) -> Tensor:
    """The block recurrence for every batch row: for each block b,
    h_b = max(base+w, far-edge gathers, M_sub ⊗ t_{b-1}), t_b = M*_bb ⊗ h_b.

    ``wb`` (nb, B, block) and ``clo`` (nb, B, block, block) are stored
    blocks-major so that each step's slice is one contiguous batch for the
    matvec kernels.  ``folded(Ds_b, w_b, prev, h0_b)`` is max(h0_b, (Ds_b +
    w_b) ⊗ prev) (m_ij = d_ij + w_i), ``closure_mv`` the closure matvec."""
    nb, B = wb.shape[0], wb.shape[1]
    dev = base.device
    pad = nb * block - n
    b_p = torch.cat([base, torch.full((B, pad), NEG, dtype=torch.float32,
                                      device=dev)], dim=1)
    h0 = (b_p.view(B, nb, block).permute(1, 0, 2) + wb).contiguous()
    neg_col = torch.full((B, 1), NEG, dtype=torch.float32, device=dev)
    zero_col = torch.zeros((B, 1), dtype=torch.float32, device=dev)
    t = torch.full((B, nb * block), NEG, dtype=torch.float32, device=dev)
    for bi in range(nb):
        start = max(bi - 1, 0) * block
        prev = t[:, start:start + block].contiguous()
        # block 0 has an all-NEG Ds[0], so its (unwritten) prev is masked
        h = folded(Ds[bi], wb[bi], prev, h0[bi])
        w_pad = torch.cat([wb[bi], zero_col], dim=1)
        contrib = t[:, fs[bi]] + fw[bi] + w_pad[:, fd[bi]]   # pad: + NEG
        h = torch.cat([h, neg_col], dim=1).scatter_reduce(
            1, fd[bi].expand(B, -1), contrib, "amax", include_self=True)
        tb = closure_mv(clo[bi], h[:, :block].contiguous())
        t[:, bi * block:(bi + 1) * block] = tb      # closure has identity
    return t[:, :n]


def longest_path_blocked(aidg: AIDGLike, block: int = 128, work=None,
                         base=None, device=None) -> Tensor:
    """Blocked evaluation: per-block Kleene closures (one kernel launch for
    every block and candidate), then one matvec pair per block.  On CUDA
    tensors every ⊗ runs a hand-written kernel."""
    dev = resolve_device(device)
    ca = _as_compiled(aidg)
    a = ca.aidg
    w, b, one = _pair(work, base, a, dev)
    t = Solver(ca, "blocked", dev, block=block).relax_for(w)(b)
    return t[0] if one else t


# ---------------------------------------------------------------------------
# storage request-slot queueing
# ---------------------------------------------------------------------------


def slot_queue_scan(arrival: Tensor, lat: Tensor, slots: int) -> Tensor:
    """Service completion per access, arrival-ordered FIFO over ``slots``
    request slots.  ``arrival``/``lat`` are (k,) or (B, k), in *arrival
    order* along the last axis.

    A single-slot queue is max-plus *linear*:
    ``done_k = max(arrival_k, done_{k-1}) + lat_k`` unrolls to
    ``done_k = S_k + max_{j<=k} (arrival_j - S_{j-1})`` with S the latency
    prefix sum — one ``cumsum`` + one ``cummax``.  Multi-slot queues loop
    over the accesses with a sorted slot-free vector (the min over slot
    frees breaks max-plus linearity)."""
    if slots == 1:
        S = torch.cumsum(lat, dim=-1)
        return S + torch.cummax(arrival - S + lat, dim=-1).values
    one = arrival.dim() == 1
    arr = arrival[None] if one else arrival
    lt = lat[None] if one else lat
    free = torch.zeros((arr.shape[0], slots), dtype=torch.float32,
                       device=arr.device)
    done = torch.empty_like(arr)
    for k in range(arr.shape[1]):
        d = torch.maximum(arr[:, k], free[:, 0]) + lt[:, k]
        done[:, k] = d
        free = torch.sort(torch.cat([d[:, None], free[:, 1:]], dim=1),
                          dim=1).values
    return done[0] if one else done


# ---------------------------------------------------------------------------
# smooth max-plus relaxation (temperature-τ log-sum-exp family)
# ---------------------------------------------------------------------------


def _as_tau(tau, device: torch.device) -> Tensor:
    """τ as a 0-d float32 tensor on ``device`` (a tensor already there is
    returned as it is)."""
    return torch.as_tensor(tau, dtype=torch.float32, device=device)


def softmaximum(a, b, tau) -> Tensor:
    """Smooth two-argument max: τ·logaddexp(a/τ, b/τ) ≥ max(a, b), exact as
    τ → 0; monotone in both arguments and smooth everywhere — the gradient
    splits between a and b by their softmax weights (evenly at a tie)
    instead of picking a winner.

    Written as the reference's ``logaddexp`` computes its value, ``max(x,
    y) + log1p(exp(-|x - y|))``, so that autograd differentiates the exact
    weights σ(x - y): ``torch.logaddexp``'s backward forms them as exp(x -
    out), and out, rounded at the scale of x (= a/τ, 10⁵ and more at small
    τ), puts a relative error of ulp(x) on every weight — compounding over
    a path of soft maxima."""
    x, y = a / tau, b / tau
    return tau * (torch.maximum(x, y) + torch.log1p(torch.exp(-(x - y).abs())))


def softmax_reduce(x: Tensor, tau, dim: int = -1) -> Tensor:
    """Smooth max-reduction: τ·logsumexp(x/τ) over ``dim``, formed as
    ``jax.nn.logsumexp`` forms it — shifted by the (constant) maximum, so
    the gradient is the exact softmax exp(a - max)/Σ, not exp(a - out)
    (see ``softmaximum``).  Entries at the ``NEG`` sentinel get softmax
    weight exp(NEG/τ - max/τ) = 0 (NEG/τ stays finite in float32 down to
    τ = 1e-20), so padded slots stay inert."""
    a = x / tau
    m = a.amax(dim=dim, keepdim=True).detach()
    return tau * (torch.log(torch.exp(a - m).sum(dim=dim)) + m.squeeze(dim))


def longest_path_soft(aidg: AIDGLike, tau: float = 0.05, work=None,
                      base=None, device=None) -> Tensor:
    """Smooth wavefront relaxation: upper-bounds ``longest_path_wavefront``
    node-wise, with per-node slack at most depth·τ·log(in-degree + 1), so
    the τ → 0 limit is the exact longest path.  Differentiable in (work,
    base) everywhere."""
    dev = resolve_device(device)
    ca = _as_compiled(aidg)
    w, b, one = _pair(work, base, ca.aidg, dev)
    t = Solver(ca, "wavefront", dev).relax_for(w, _as_tau(tau, dev))(b)
    return t[0] if one else t


def slot_queue_soft(arrival: Tensor, lat: Tensor, slots: int, tau
                    ) -> Tensor:
    """``slot_queue_scan`` with every hard max softened.

    The single-slot closed form stays closed-form: ``done_k = S_k +
    max_{j<=k}(arrival_j - S_{j-1})`` becomes ``S_k + τ·logcumsumexp((arrival
    - S + lat)/τ)``.  Multi-slot queues keep the sorted slot-vector loop
    with a ``softmaximum`` service begin; the sort is piecewise-constant
    in the parameters and needs no smoothing (stable, as the reference's,
    so tied slots route their gradients alike)."""
    tau = _as_tau(tau, arrival.device)
    if slots == 1:
        S = torch.cumsum(lat, dim=-1)
        return S + tau * torch.logcumsumexp((arrival - S + lat) / tau,
                                            dim=-1)
    one = arrival.dim() == 1
    arr = arrival[None] if one else arrival
    lt = lat[None] if one else lat
    free = torch.zeros((arr.shape[0], slots), dtype=torch.float32,
                       device=arr.device)
    done = []
    for k in range(arr.shape[1]):
        d = softmaximum(arr[:, k], free[:, 0], tau) + lt[:, k]
        done.append(d)
        free = torch.sort(torch.cat([d[:, None], free[:, 1:]], dim=1),
                          dim=1, stable=True).values
    out = torch.stack(done, dim=1)
    return out[0] if one else out


# ---------------------------------------------------------------------------
# engine dispatch + the queueing fixed point
# ---------------------------------------------------------------------------


class Solver:
    """The structure of one CompiledAIDG as tensors on one device, for one
    engine — built once and reused by every evaluation over that graph.

    ``relax_for(work)`` returns the (base -> t) relaxation for a batch of
    work vectors; ``_fixed_point_core`` runs the queueing fixed point on
    it."""

    def __init__(self, ca: CompiledAIDG, engine: str, device,
                 block: int = 128):
        if engine not in ENGINES:
            raise ValueError(f"unknown engine {engine!r}; choose from "
                             f"{ENGINES}")
        dev = torch.device(device)
        a = ca.aidg
        self.ca, self.engine, self.block = ca, engine, block
        # the blocked engine's last closure mode (kernels.maxplus.plan_closure)
        self.closure_variant: Optional[str] = None
        T = lambda x, dt=None: torch.as_tensor(np.asarray(x), dtype=dt,
                                               device=dev)
        if engine == "wavefront":
            s = ca.schedule
            self._wf = (T(ca.preds_lv, torch.long), T(ca.extra_lv),
                        tuple(int(x) for x in s.starts),
                        T(s.order, torch.long), T(s.rank, torch.long),
                        s.width)
        elif engine == "scan":
            self._scan = (T(a.preds, torch.long), T(a.pred_extra))
        elif engine == "condensed":
            self._cond = _CondArrays(condense_aidg(a), dev)
        else:
            Dd, Ds, fs, fd, fw = _blocked_structure(ca, block)
            self._bl = (T(Dd), T(Ds), T(fs, torch.long), T(fd, torch.long),
                        T(fw))
            self._diag = _diagonal_facts(ca, block)
        self.fu_lat = T(a.fu_lat, torch.float32)
        self.scatter = {st: T(ca.storage_scatter[st], torch.long)
                        for st in ca.storage_order}

    def relax_for(self, work: Tensor, tau=None
                  ) -> Callable[[Tensor], Tensor]:
        """(B, n) work -> the relaxation ``base (B, n) -> t (B, n)``.  The
        blocked engine's closures depend only on work, so they are computed
        here once and reused by every relaxation of a fixed point (the
        reference recomputes them per relaxation; the result is the
        same).  Their mode comes from ``plan_closure``: the structure's
        lower-triangularity (cached) and one read of max |work| bound every
        value a closure takes by block x (max finite |d| + max |w|).
        ``tau`` selects the soft family, which only the wavefront and
        condensed engines have."""
        n = self.ca.aidg.n
        if tau is not None and self.engine not in SOFT_ENGINES:
            raise ValueError(f"fixed_point_soft supports engines "
                             f"'wavefront' and 'condensed', got "
                             f"{self.engine!r}")
        if self.engine == "wavefront":
            pl, el, st, od, rk, width = self._wf
            return lambda b: _wavefront_impl(work, b, pl, el, st, od, rk,
                                             width, tau)
        if self.engine == "scan":
            preds, extra = self._scan
            return lambda b: _scan_impl(work, b, preds, extra)
        if self.engine == "condensed":
            return _condensed_relax_for(self._cond, work, tau)
        Dd, Ds, fs, fd, fw = self._bl
        block = self.block
        nb, B = Dd.shape[0], work.shape[0]
        pad = nb * block - n
        w_p = torch.cat([work, torch.zeros((B, pad), dtype=torch.float32,
                                           device=work.device)], dim=1)
        wb = w_p.view(B, nb, block).permute(1, 0, 2).contiguous()
        steps = int(np.ceil(np.log2(max(2, block))))
        if block > K.CLOSURE_MAX_N:
            # absorb runtime work into edge weights: m_ij = d_ij + w_i
            clo = maxplus_closure(Dd[:, None] + wb[:, :, :, None], steps)
            folded, closure_mv = _matvec_folded_general, maxplus_matvec
        else:
            lower, dmax = self._diag
            wmax = float(work.abs().max()) if work.numel() else 0.0
            variant = K.plan_closure(block, lower, block * (dmax + wmax))
            self.closure_variant = variant
            clo = K.maxplus_closure(Dd, steps, wb, variant=variant)
            folded = K.maxplus_matvec_folded
            closure_mv = (K.maxplus_matvec_lower
                          if variant == "closure_lower" else maxplus_matvec)
        return lambda b: _blocked_relax(n, block, Ds, fs, fd, fw, wb, clo, b,
                                        folded, closure_mv)


def _fixed_point_core(solver: Solver, w: Tensor, b0: Tensor,
                      storage_lat: Optional[Dict[str, Tensor]],
                      n_iters: int, tau=None) -> Tensor:
    """(B, n) work and bases -> (B, n) completion times: relax the DAG,
    replay each storage's accesses in estimated-arrival order through
    ``queue``, ``fold`` the service needs back into the bases, iterate —
    one fixed point for the hard family (``tau`` None: ``slot_queue_scan``,
    a ``scatter_reduce`` amax fold) and the soft one (``slot_queue_soft``
    and ``_fold_soft``), so the gradient descends the objective the hard
    path scores.  The arrival order is a stable argsort (piecewise-constant
    in θ: a constant gather for autograd) and its inverse a scatter of the
    identity.  ``storage_lat`` None takes the AIDG's own latencies."""
    if tau is None:
        queue, fold = slot_queue_scan, _fold_max
    else:
        queue = lambda arr, lat, slots: slot_queue_soft(arr, lat, slots, tau)
        fold = lambda b, nd, need: _fold_soft(b, nd, need, tau)
    relax = solver.relax_for(w, tau)
    t = relax(b0)
    if not solver.ca.aidg.storage_nodes:
        return t
    for _ in range(n_iters):
        t = relax(_queue_fold(solver, w, t, b0, storage_lat, queue, fold))
    return t


def _fold_max(b: Tensor, nd: Tensor, need: Tensor) -> Tensor:
    """The hard fold: max the access needs into their nodes' bases."""
    return b.scatter_reduce(1, nd.expand(need.shape[0], -1), need, "amax",
                            include_self=True)


def _fold_soft(b: Tensor, nd: Tensor, need: Tensor, tau) -> Tensor:
    """The soft fold, as the reference's: scatter the needs into an
    all-NEG node vector (duplicates keep the hard max — a zero-measure
    kink), then ``softmaximum`` it into the bases; softmaximum(b, NEG) == b,
    so untouched nodes are inert."""
    return softmaximum(b, _fold_max(torch.full_like(b, NEG), nd, need), tau)


def _queue_fold(solver: Solver, w: Tensor, t: Tensor, b0: Tensor,
                storage_lat: Optional[Dict[str, Tensor]],
                queue: Callable = slot_queue_scan,
                fold: Callable = _fold_max) -> Tensor:
    """One queueing step of ``_fixed_point_core``: the bases ``b0`` with
    each storage's service needs, from its accesses replayed in the
    arrival order that the completion times ``t`` give."""
    ca = solver.ca
    a = ca.aidg
    B = w.shape[0]
    b = b0
    for st_name in ca.storage_order:
        lats = (torch.as_tensor(a.storage_lat[st_name], dtype=torch.float32,
                                device=w.device).expand(B, -1)
                if storage_lat is None else storage_lat[st_name])
        nd = solver.scatter[st_name]
        slots = a.storage_slots[st_name]
        w_nd = w[:, nd]
        arrival = t[:, nd] - w_nd
        order = torch.argsort(arrival, dim=1, stable=True)
        done_sorted = queue(arrival.gather(1, order), lats.gather(1, order),
                            slots)
        inv = torch.empty_like(order).scatter_(
            1, order, torch.arange(order.shape[1], device=w.device)
            .expand(B, -1))
        done = done_sorted.gather(1, inv)        # back to access order
        need = done + solver.fu_lat[nd] - w_nd
        b = fold(b, nd, need)
    return b


def fixed_point_torch(aidg: AIDGLike, n_iters: int = 3, work=None, base=None,
                      storage_lat: Optional[Dict[str, object]] = None,
                      engine: str = DEFAULT_ENGINE, device=None) -> Tensor:
    """Counterpart of ``builder.longest_path_fixed_point`` on tensors:
    ``work``/``base`` (n,) or (B, n), ``storage_lat`` {name: (k,) or
    (B, k)}; the answer has the rank of ``work``.  ``engine`` selects the
    DAG relaxation between queueing folds."""
    dev = resolve_device(device)
    ca = _as_compiled(aidg)
    w, b, sl, one = _fixed_point_inputs(ca.aidg, work, base, storage_lat,
                                        dev)
    t = _fixed_point_core(Solver(ca, engine, dev), w, b, sl, n_iters)
    return t[0] if one else t


def _fixed_point_inputs(a: AIDG, work, base, storage_lat, dev):
    """``work``/``base`` (n,) or (B, n) and ``storage_lat`` {name: (k,) or
    (B, k)} (or the AIDG's own) as tensors with one batch size, and
    whether ``work`` was 1-D."""
    w, one = _batched(work, a.work, dev)
    b, _ = _batched(base, a.base, dev)
    B = max(w.shape[0], b.shape[0])
    w, b = w.expand(B, -1).contiguous(), b.expand(B, -1).contiguous()
    sl = None
    if storage_lat is not None:
        sl = {name: _batched(storage_lat[name], a.storage_lat[name],
                             dev)[0].expand(B, -1)
              for name in a.storage_lat}
    return w, b, sl, one


def fixed_point_soft(aidg: AIDGLike, tau: float = 0.05, n_iters: int = 3,
                     work=None, base=None,
                     storage_lat: Optional[Dict[str, object]] = None,
                     engine: str = DEFAULT_ENGINE, device=None) -> Tensor:
    """``fixed_point_torch`` over the smooth family: soft relaxations
    between queueing folds, ``slot_queue_soft`` inside them and a
    ``softmaximum`` base fold-back.  ``engine``: ``"wavefront"`` (default)
    or ``"condensed"`` (chain super-edges keep their exact sums — a
    tighter soft relaxation on a shorter loop)."""
    if engine not in SOFT_ENGINES:
        raise ValueError(f"fixed_point_soft supports engines 'wavefront' "
                         f"and 'condensed', got {engine!r}")
    dev = resolve_device(device)
    ca = _as_compiled(aidg)
    w, b, sl, one = _fixed_point_inputs(ca.aidg, work, base, storage_lat,
                                        dev)
    t = _fixed_point_core(Solver(ca, engine, dev), w, b, sl, n_iters,
                          tau=_as_tau(tau, dev))
    return t[0] if one else t


def fixed_point_batch(aidg: AIDGLike, works=None, bases=None,
                      storage_lats: Optional[Dict[str, object]] = None,
                      n_iters: int = 3, engine: str = DEFAULT_ENGINE,
                      device=None) -> Tensor:
    """Batched ``fixed_point_torch``: any of ``works`` (B, n), ``bases``
    (B, n), ``storage_lats`` {name: (B, k)} may carry the batch axis;
    omitted inputs broadcast from the AIDG baseline.  Returns (B, n)
    completion times — the raw-latency counterpart of ``dse.sweep``."""
    ca = _as_compiled(aidg)
    a = ca.aidg
    batched = [x for x in (works, bases) if x is not None]
    if storage_lats is not None:
        unknown = set(storage_lats) - set(a.storage_lat)
        if unknown:
            raise KeyError(f"unknown storage(s) {sorted(unknown)}; "
                           f"AIDG has {sorted(a.storage_lat)}")
        batched.extend(storage_lats.values())
    if not batched:
        raise ValueError("fixed_point_batch needs at least one batched input")
    shapes = [tuple(np.shape(x)) for x in batched]
    if any(len(s) != 2 for s in shapes) or len({s[0] for s in shapes}) != 1:
        raise ValueError(f"batched inputs must be 2-D with one shared "
                         f"leading batch dim, got shapes {shapes}")
    dev = resolve_device(device)
    B = shapes[0][0]
    w = _batched(works, a.work, dev)[0].expand(B, -1).contiguous()
    b = _batched(bases, a.base, dev)[0].expand(B, -1).contiguous()
    sl = {name: _batched(None if storage_lats is None
                         else storage_lats.get(name), lat, dev)[0]
          .expand(B, -1) for name, lat in a.storage_lat.items()}
    return _fixed_point_core(Solver(ca, engine, dev), w, b, sl, n_iters)
