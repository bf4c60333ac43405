"""The yardstick's arithmetic: operations counted from a cell's shapes and
the published peaks of the card.  Frozen here so that a change to the
program cannot change what its work is counted as.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit):
989 TFLOP/s bf16, 67 TFLOP/s float32 off the tensor cores, 3.35 TB/s HBM.
"""

from __future__ import annotations

from typing import Tuple

from .seeded import dims

BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12


def mask_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs a head's mask leaves: row i keeps keys j < Sk
    with j <= i if causal and j > i - window if window > 0 (a window needs
    Sq == Sk).  Causal, no window: Sq (Sq + 1) / 2."""
    if window <= 0 or window >= sk:
        return sq * (sq + 1) // 2 if causal else sq * sk
    w = window
    if causal:      # row i keeps min(i + 1, w) keys
        return w * (w + 1) // 2 + (sq - w) * w
    # row i keeps the keys from max(0, i - w + 1) to Sk - 1
    cut = (sq - w) * (sq - w + 1) // 2 if sq > w else 0
    return sq * sk - cut


def flash_bound(bh: int, sq: int, sk: int, dq: int, dv: int, itemsize: int,
                causal: bool, window: int = 0,
                peak: float = BF16_FLOP_PER_S) -> Tuple[float, str]:
    """(least seconds, "operations" | "bytes") of one attention call over
    (BH, Sq, Dq) queries: 2 (Dq + Dv) operations for each pair the mask
    leaves at ``peak``, or q, k, v read once and o written once at the HBM
    rate, whichever is longer."""
    flops = 2.0 * bh * mask_pairs(sq, sk, causal, window) * (dq + dv)
    nbytes = itemsize * bh * (sq * dq + sk * dq + sk * dv + sq * dv)
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def block_matmul_params(conf: dict) -> int:
    """Weights that multiply every position in the layers: q, k, v, o and
    the gated MLP's three matrices."""
    s = dims(conf)
    attn = s["d"] * s["head_dim"] * (2 * s["heads"] + 2 * s["kv_heads"])
    return s["layers"] * (attn + 3 * s["d"] * s["ff"])


def attention_flops(conf: dict, batch: int, seq: int) -> float:
    """Forward products of causal attention over ``seq`` positions:
    2 (Dq + Dv) for each pair, each head, each layer."""
    s = dims(conf)
    return (2.0 * 2 * s["head_dim"] * mask_pairs(seq, seq, True)
            * s["heads"] * s["layers"] * batch)


def train_step_flops(conf: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step (forward and backward, the
    recomputation of remat not counted): 6 · N · T over the products'
    weights, N counting the (tied or untied) output projection once and
    the lookup not at all, plus 3 × causal attention's forward —
    6 · L · B · H · D · S² for Dq = Dv = D, with S (S + 1) / 2 pairs."""
    s = dims(conf)
    n = block_matmul_params(conf) + s["d"] * s["vocab"]
    return 6.0 * n * batch * seq + 3.0 * attention_flops(conf, batch, seq)


def prefill_flops(conf: dict, batch: int, text: int) -> float:
    """Model FLOPs of one prefill of ``batch`` prompts of ``text`` tokens
    after the configuration's patch positions: 2 · N_layers · T, the patch
    projection, causal attention, and the output projection at the last
    position only."""
    s = dims(conf)
    seq = text + s["patches"]
    return (2.0 * block_matmul_params(conf) * batch * seq
            + 2.0 * s["d"] * s["d"] * batch * s["patches"]
            + attention_flops(conf, batch, seq)
            + 2.0 * s["d"] * s["vocab"] * batch)
