"""Mamba-1 selective-SSM block (falcon-mamba, jamba's mamba layers) in
PyTorch: the port of ``repro.models.mamba``.

    h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t,    y_t = C_t h_t + D x_t

with diagonal A (d_inner, d_state).  With ``cfg.inner_norms`` (jamba),
dt, B and C each pass an RMSNorm with a learned gain (``dt_norm``,
``b_norm``, ``c_norm``) after ``x_proj`` and before ``dt_proj`` and the
scan, as ``JambaMambaMixer`` has them.  Three branches:

- decode (a cache and S == 1): the one-step recurrence over the cached
  (conv tail, h);
- ``impl="pallas"`` (or ``"pallas_interpret"``, the same thing here):
  ``kernels.selective_scan`` — the hand-written kernel for CUDA tensors,
  its plain version for CPU tensors.  Under a cache (a prefill) it is
  ``selective_scan_state``, which starts from the cached h and returns
  h_S; the block returns h_S and the last ``d_conv - 1`` inputs of the
  conv as the new cache.  The launch runs inside the span
  ``repro_torch.scan``;
- otherwise (``impl="chunked_scan"``, the default, as the reference runs
  every pass): the chunked scan, a sequential loop over time inside
  chunks of ``cfg.chunk`` steps that carries h from chunk to chunk (from
  the cached h under a cache).  ``CHUNKED_SCAN_CALLS`` counts its calls.

A prefill into a cache pads the conv with zeros, as a fresh sequence,
on both paths.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import pspec
from .config import SSMConfig
from .layers import normal, rmsnorm
from ..kernels import selective_scan as _ss
from ..runtime.spans import span

__all__ = ["init_mamba", "mamba_block", "init_mamba_cache",
           "CHUNKED_SCAN_CALLS"]

# calls of the chunked scan (a plain int: zero it by hand)
CHUNKED_SCAN_CALLS = 0


def init_mamba(gen, cfg: SSMConfig, d_model: int, dtype: torch.dtype,
               device) -> Dict:
    di = cfg.d_inner(d_model)
    dtr = cfg.dt_rank_of(d_model)
    f32 = torch.float32
    s = d_model ** -0.5
    a_log = torch.log(torch.arange(1, cfg.d_state + 1, dtype=f32,
                                   device=device))
    p = {
        "in_proj": normal(gen, (d_model, 2 * di), dtype, s, device),
        "conv_w": normal(gen, (cfg.d_conv, di), dtype, 0.5, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": normal(gen, (di, dtr + 2 * cfg.d_state), dtype, di ** -0.5,
                         device),
        "dt_proj": normal(gen, (dtr, di), dtype, dtr ** -0.5, device),
        "dt_bias": torch.full((di,), -4.6, dtype=dtype, device=device),
        "A_log": a_log.expand(di, cfg.d_state).clone(),
        "D": torch.ones((di,), dtype=f32, device=device),
        "out_proj": normal(gen, (di, d_model), dtype, di ** -0.5, device),
    }
    if cfg.inner_norms:
        for name, width in (("dt_norm", dtr), ("b_norm", cfg.d_state),
                            ("c_norm", cfg.d_state)):
            p[name] = torch.ones((width,), dtype=dtype, device=device)
    return p


def init_mamba_cache(cfg: SSMConfig, d_model: int, batch: int,
                     dtype: torch.dtype, device) -> Dict:
    di = cfg.d_inner(d_model)
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, cfg.d_state), dtype=torch.float32,
                         device=device),
    }


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with JAX's promotion: f32 @ bf16 runs in f32."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


def _ssm_params(params: Mapping, cfg: SSMConfig, xb: torch.Tensor):
    """xb: (..., di) post-conv activations -> (dt, B, C) selective params,
    float32."""
    dtr = cfg.dt_rank_of(params["in_proj"].shape[0])
    n = cfg.d_state
    # x_proj contracts the TP-sharded d_inner: resolve its partial sums
    # here (XLA's all-reduce), or DTensor carries them into dt_proj and
    # replicates that product over TP
    proj = _mm(xb, params["x_proj"])
    proj = pspec.shard(proj, "batch", *[None] * (proj.dim() - 1))
    dt, Bm, Cm = proj[..., :dtr], proj[..., dtr:dtr + n], proj[..., dtr + n:]
    if cfg.inner_norms:
        dt = rmsnorm(dt, params["dt_norm"])
        Bm = rmsnorm(Bm, params["b_norm"])
        Cm = rmsnorm(Cm, params["c_norm"])
    dt = F.softplus(_mm(dt, params["dt_proj"])
                    + params["dt_bias"].float())             # (..., di)
    return dt, Bm.float(), Cm.float()


def _recurrence(dA: torch.Tensor, dBx: torch.Tensor, h: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = dA_t h_{t-1} + dBx_t over a chunk's steps: (every h_t stacked
    (B, C, di, N), the last)."""
    hs = []
    for t in range(dA.shape[1]):
        h = dA[:, t] * h + dBx[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def _scan_chunk(params: Mapping, cfg: SSMConfig, h0: torch.Tensor,
                xb: torch.Tensor, z: torch.Tensor,
                mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential selective scan over one chunk.

    xb/z: (B, C, di); h0: (B, di, N); mask: (C,) validity (padded positions
    leave the state untouched) -> (y (B, C, di) float32, h_C)."""
    A = -torch.exp(params["A_log"].float())                  # (di, N)
    xf = xb.float()
    dt, Bm, Cm = _ssm_params(params, cfg, xf)
    if mask is not None:
        dt = dt * mask[None, :, None]                        # dt=0: identity
    # pin shardings so every time step of the scan is collective-free:
    # state and dt d_inner-sharded over TP, B/C replicated per shard
    h0 = pspec.shard(h0, "batch", "tp", None)
    dt = pspec.shard(dt, "batch", None, "tp")
    Bm = pspec.shard(Bm, "batch", None, None)
    Cm = pspec.shard(Cm, "batch", None, None)
    xf = pspec.shard(xf, "batch", None, "tp")
    # the per-step factors for the whole chunk at once; the loop carries h
    dA = torch.exp(dt[..., None] * A)                        # (B, C, di, N)
    dBx = (dt * xf)[..., None] * Bm[:, :, None, :]
    recur = _recurrence
    if pspec.is_dtensor(dA):
        from torch.distributed.tensor.experimental import local_map
        # on a mesh the pinned layouts make every step collective-free:
        # the steps run on each rank's shards, h d_inner-sharded with N
        # replicated at every step (the reference's per-step constraint)
        steps = pspec.placements_of(dA, "batch", None, "tp", None)
        state = pspec.placements_of(h0, "batch", "tp", None)
        if not pspec.is_dtensor(h0):      # a pass without a cache: zeros
            h0 = torch.zeros_like(dA[:, 0]).copy_(h0)
        recur = local_map(_recurrence, out_placements=(steps, state),
                          in_placements=(steps, steps, state),
                          device_mesh=dA.device_mesh,
                          redistribute_inputs=True)
    hs, h = recur(dA, dBx, h0)
    y = pspec.shard(torch.einsum("bcdn,bcn->bcd", hs, Cm),
                    "batch", None, "tp")
    y = y + params["D"].float() * xf
    y = y * F.silu(z.float())
    return y, h


def mamba_block(params: Mapping, x: torch.Tensor, cfg: SSMConfig, *,
                cache: Optional[Dict] = None, impl: str = "chunked_scan",
                ) -> Tuple[torch.Tensor, Optional[Dict]]:
    """x: (B, S, d).  Returns (out (B, S, d), new cache or None)."""
    b, s, d = x.shape
    di = cfg.d_inner(d)
    xz = pspec.shard(x @ params["in_proj"], "batch", None, "tp")
    xr, z = xz.chunk(2, dim=-1)                              # (B, S, di) each
    # the split of the TP-sharded xz leaves its halves replicated under
    # DTensor; shard them again, as XLA's propagation keeps them
    xr = pspec.shard(xr, "batch", None, "tp")
    z = pspec.shard(z, "batch", None, "tp")

    if cache is not None and s == 1:
        # --- decode step ---
        conv_tail = cache["conv"]                            # (B, dc-1, di)
        win = torch.cat([conv_tail, xr.to(conv_tail.dtype)], dim=1)
        xb = torch.einsum("bcd,cd->bd", win.float(),
                          params["conv_w"].float()) + params["conv_b"].float()
        xb = F.silu(xb)
        A = -torch.exp(params["A_log"].float())
        dt, Bm, Cm = _ssm_params(params, cfg, xb)
        dA = torch.exp(dt[..., None] * A[None])
        h = dA * cache["h"] + (dt * xb)[..., None] * Bm[:, None, :]
        y = torch.einsum("bdn,bn->bd", h, Cm)
        y = y + params["D"].float() * xb
        y = y * F.silu(z[:, 0].float())
        out = (y.to(x.dtype) @ params["out_proj"])[:, None]
        new_cache = {"conv": win[:, 1:].to(conv_tail.dtype), "h": h}
        return out, new_cache

    # --- full pass / prefill: depthwise causal conv ---
    pad = torch.zeros((b, cfg.d_conv - 1, di), dtype=xr.dtype,
                      device=x.device)
    xpad = torch.cat([pad, xr], dim=1)                       # (B, S+dc-1, di)
    xb = sum(xpad[:, i:i + s] * params["conv_w"][i]
             for i in range(cfg.d_conv))
    xb = F.silu(xb + params["conv_b"])

    if impl in ("pallas", "pallas_interpret"):
        # the kernel path
        xf = xb.float().contiguous()
        del xb
        dt, Bm, Cm = _ssm_params(params, cfg, xf)
        args = (xf, dt.contiguous(), Bm.contiguous(), Cm.contiguous(),
                -torch.exp(params["A_log"].float()), params["D"].float())
        with span("repro_torch.scan"):
            if cache is None:
                y = _ss.selective_scan(*args)
            else:
                y, h = _ss.selective_scan_state(*args, cache["h"])
        del args, xf, dt, Bm, Cm
        y = y * F.silu(z.float())
        out = y.to(x.dtype) @ params["out_proj"]
        if cache is None:
            return out, None
        return out, {"conv": _conv_tail(xpad, s, cfg, cache), "h": h}

    global CHUNKED_SCAN_CALLS
    CHUNKED_SCAN_CALLS += 1
    chunk = min(cfg.chunk, s)
    s_pad = -(-s // chunk) * chunk                           # ragged: pad
    if s_pad != s:
        zpad = torch.zeros((b, s_pad - s, di), device=x.device)
        xb = torch.cat([xb, zpad.to(xb.dtype)], dim=1)
        z = torch.cat([z, zpad.to(z.dtype)], dim=1)
    valid = (torch.arange(s_pad, device=x.device) < s).float()
    h = (cache["h"] if cache is not None
         else torch.zeros((b, di, cfg.d_state), dtype=torch.float32,
                          device=x.device))
    ys = []
    for c0 in range(0, s_pad, chunk):
        y, h = _scan_chunk(params, cfg, h, xb[:, c0:c0 + chunk],
                           z[:, c0:c0 + chunk], valid[c0:c0 + chunk])
        ys.append(y)
    y = torch.cat(ys, dim=1)[:, :s]
    out = y.to(x.dtype) @ params["out_proj"]
    new_cache = None
    if cache is not None:  # prefill: final SSM state + conv tail
        new_cache = {"conv": _conv_tail(xpad, s, cfg, cache), "h": h}
    return out, new_cache


def _conv_tail(xpad: torch.Tensor, s: int, cfg: SSMConfig,
               cache: Dict) -> torch.Tensor:
    """The last d_conv - 1 real inputs of the conv, a copy (a view would
    keep the whole padded input alive in the cache)."""
    return xpad[:, s:s + cfg.d_conv - 1].to(cache["conv"].dtype, copy=True)
