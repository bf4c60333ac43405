"""Frozen operation counts of the hybrid prefill (``drivers/
prefill_hybrid.py``): the model's FLOPs per request and B3's least time
per launch.  Frozen here, beside ``counts.py``, so that a change to the
program cannot change what its work is counted as.

Peaks (NVIDIA's H100 SXM data sheet at 700 W, ``counts.py``): 989 TFLOP/s
bf16, 3.35 TB/s HBM; and the special-function units' exponentials, 16 per
clock per SM over 132 SMs at the 1.98 GHz boost clock (the CUDA
programming guide's throughput table for compute capability 9.0:
MUFU.EX2, the bound of kernel table row 3 in PERF.md).
"""

from __future__ import annotations

from typing import Tuple

from .counts import HBM_BYTES_PER_S, mask_pairs
from .seeded_hybrid import dims, kinds

SMS = 132
EXP_PER_CLOCK_PER_SM = 16
BOOST_HZ = 1.98e9
EXP_PER_S = SMS * EXP_PER_CLOCK_PER_SM * BOOST_HZ


def prefill_flops(conf: dict, batch: int, tokens: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``tokens``: the
    products of every layer at every position (attention's q, k, v, o and
    its causal pairs; Mamba's in_proj, x_proj, dt_proj and out_proj; the
    SwiGLUs), the held experts' expected share of the expert layers (top_k
    × held ÷ experts expert FFNs a token; the router, the program's own
    routing, not counted), and the output projection at the last
    position.  The scan, the conv and the norms are not counted."""
    s = dims(conf)
    d, ff, hd, di = s["d"], s["ff"], s["head_dim"], s["d_inner"]
    t = batch * tokens
    swiglu = 3 * 2.0 * d * ff
    total = 0.0
    for mixer, expert in kinds(conf):
        if mixer == "attn":
            proj = d * hd * (2 * s["heads"] + 2 * s["kv_heads"])
            total += 2.0 * proj * t + 2.0 * 2 * hd * s["heads"] * \
                mask_pairs(tokens, tokens, True) * batch
        else:
            total += 2.0 * t * (d * 2 * di + di * (s["dt_rank"] + 2 * s[
                "d_state"]) + s["dt_rank"] * di + di * d)
        share = s["top_k"] * s["held"] / s["experts"] if expert else 1.0
        total += share * swiglu * t
    return total + 2.0 * d * s["vocab"] * batch


def scan_bound(batch: int, steps: int, channels: int, states: int
               ) -> Tuple[float, str]:
    """(least seconds, "operations" | "bytes") of one selective scan over
    (batch, steps, channels) with ``states`` states: one exponential per
    (step, channel, state) at ``EXP_PER_S``, or x, dt and y in float32 and
    B and C moved once at the HBM rate, whichever is longer (the state
    read and written, batch × channels × states floats each way, is not
    counted)."""
    exps = float(batch) * steps * channels * states
    nbytes = 4.0 * batch * steps * (3 * channels + 2 * states)
    t_ops, t_bytes = exps / EXP_PER_S, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
