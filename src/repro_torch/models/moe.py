"""Mixture-of-Experts block in PyTorch: top-k routing with capacity-based
dispatch (the port of ``repro.models.moe``).

1. router logits (G, Tg, E) -> top-k expert ids and normalised gates;
2. each (token, slot) gets its position inside its expert's capacity from
   K sequential one-hot cumsums;
3. dispatch by gather: a token-index table (G, E, C) -> expert inputs
   (G, E, C, d);
4. the expert FFNs as batched products over E;
5. combine by the transpose gather, weighted by the gates.

Shared experts (DeepSeekMoE) are a dense gated FFN of width
``n_shared * d_expert`` added to the routed output.

One difference from the reference, on purpose: a (token, slot) dropped for
capacity writes NOTHING into the token-index table.  The reference sends
it to flat index 0 with the table's old value, a duplicate of the write of
the token that legitimately holds (expert 0, slot 0); XLA applies
duplicate scatter updates in no specified order, and on the CPU the stale
write wins, so that token is handed expert 0's output for token 0's input
(ROADMAP.md, C5).  Here dropped writes go to a spare slot past the table,
which is discarded, so every kept token gets its own expert outputs.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch
import torch.nn.functional as F

from .. import pspec
from .config import MoEConfig
from .layers import activation_fn, init_mlp, mlp_block, normal

__all__ = ["init_moe", "moe_block"]


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def init_moe(gen, cfg: MoEConfig, d_model: int, dtype: torch.dtype,
             device) -> Dict:
    m = cfg
    s = d_model ** -0.5
    p = {
        "router": normal(gen, (d_model, m.n_experts), torch.float32, s,
                         device),
        "w_gate": normal(gen, (m.n_experts, d_model, m.d_expert), dtype, s,
                         device),
        "w_up": normal(gen, (m.n_experts, d_model, m.d_expert), dtype, s,
                       device),
        "w_down": normal(gen, (m.n_experts, m.d_expert, d_model), dtype,
                         m.d_expert ** -0.5, device),
    }
    if m.n_shared_experts > 0:
        p["shared"] = init_mlp(gen, d_model, m.n_shared_experts * m.d_expert,
                               dtype, device, gated=True)
    return p


def capacity(cfg: MoEConfig, tokens_per_group: int) -> int:
    """Slots per expert and group (a multiple of 8)."""
    return _round_up(max(1, int(tokens_per_group * cfg.top_k / cfg.n_experts
                                * cfg.capacity_factor)), 8)


def moe_block(params: Mapping, x: torch.Tensor, cfg: MoEConfig, *,
              activation: str = "silu", group: int = 1024,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (out, aux_loss)."""
    m = cfg
    E, K = m.n_experts, m.top_k
    b, s, d = x.shape
    T = b * s
    tg = min(group, T)
    assert T % tg == 0, (T, tg)
    g = T // tg
    if g % pspec.axis_size("batch"):
        # fewer groups than batch shards (decode's one group): whole rows,
        # as the reference's guard leaves them
        x = pspec.shard(x, None, None, None)
    # the gradient returns to the reshape in its forward layout (DTensor's
    # view rule cannot fold a token dim split over pod, data and model
    # back into rows)
    xg = pspec.pin_grad(x.reshape(g, tg, d))

    router = params["router"].to(xg.dtype).float()
    logits = xg.float() @ router                                  # (G,Tg,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1, sorted=True)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # aux load-balancing loss (Switch-style)
    me = probs.mean(dim=(0, 1))                                   # (E,)
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(dim=(0, 1))
    aux = E * torch.sum(me * ce) * m.aux_loss_coef

    cap = capacity(m, tg)

    # --- per-slot positions within expert capacity (K sequential cumsums);
    # token-index table (G, E*C + 1): the last column takes dropped writes
    spare = E * cap
    table = torch.zeros((g, spare + 1), dtype=torch.long, device=x.device)
    valid = torch.zeros((g, spare + 1), dtype=torch.bool, device=x.device)
    tok = torch.arange(tg, device=x.device).expand(g, tg)
    counts = torch.zeros((g, 1, E), dtype=torch.float32, device=x.device)
    slots = []
    for slot in range(K):
        e_ids = expert_ids[..., slot]                             # (G,Tg)
        onehot = F.one_hot(e_ids, E).float()                      # (G,Tg,E)
        pos = torch.cumsum(onehot, dim=1) - 1.0 + counts
        counts = counts + onehot.sum(dim=1, keepdim=True)
        p_tok = (pos * onehot).sum(dim=-1).long()                 # (G,Tg)
        ok = p_tok < cap
        slots.append((e_ids, p_tok, ok))
        flat = torch.where(ok, e_ids * cap + p_tok, spare)
        table = table.scatter(1, flat, tok)
        valid = valid.scatter(1, flat, ok)
    table, valid = table[:, :spare], valid[:, :spare]

    # --- dispatch gather: (G, E, C, d) ---
    gathered = torch.gather(xg, 1, table[..., None].expand(g, spare, d))
    gathered = torch.where(valid[..., None], gathered,
                           torch.zeros((), dtype=x.dtype, device=x.device))
    gathered = gathered.reshape(g, E, cap, d)
    # expert parallelism: groups follow the batch shards, experts follow TP
    gathered = pspec.shard(gathered, "batch", "tp", None, None)

    # --- expert FFNs ---
    act = activation_fn(activation)
    h = act(torch.einsum("gecd,edf->gecf", gathered, params["w_gate"])) * \
        torch.einsum("gecd,edf->gecf", gathered, params["w_up"])
    expert_out = pspec.shard(
        torch.einsum("gecf,efd->gecd", h, params["w_down"]),
        "batch", "tp", None, None)

    # --- combine: transpose gather per slot ---
    out = torch.zeros((g, tg, d), dtype=expert_out.dtype, device=x.device)
    eo_flat = expert_out.reshape(g, spare, d)
    for slot, (e_ids, p_tok, ok) in enumerate(slots):
        flat = (e_ids * cap + torch.clamp(p_tok, max=cap - 1)).clamp(
            0, spare - 1)
        piece = torch.gather(eo_flat, 1, flat[..., None].expand(g, tg, d))
        w = (gate_vals[..., slot] * ok.float())[..., None]
        out = out + piece * w.to(piece.dtype)

    # groups back to the batch: DTensor's view rule cannot undo the split
    # of a batch and a sequence dim sharded over two mesh dims (prefill_32k:
    # groups over data and model), so the groups follow the data axes alone
    out = pspec.shard(out, "batch", None, None)
    out = out.reshape(b, s, d).to(x.dtype)
    if "shared" in params:
        out = out + mlp_block(params["shared"], x, activation)
    return out, aux
