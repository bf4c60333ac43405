"""Mixture-of-Experts block in PyTorch: top-k routing with capacity-based
dispatch (the port of ``repro.models.moe``), or dropless dispatch over the
experts a layer holds.

Capacity dispatch (the default):

1. router logits (G, Tg, E) -> top-k expert ids and gates, normalised to
   sum to one unless ``cfg.renormalize`` is False;
2. each (token, slot) gets its position inside its expert's capacity from
   K sequential one-hot cumsums;
3. dispatch by gather: a token-index table (G, E, C) -> expert inputs
   (G, E, C, d);
4. the expert FFNs as batched products over E;
5. combine by the transpose gather, weighted by the gates.

``DROPPED_SLOTS`` counts the (token, slot) pairs it drops for capacity
(read through ``dropped_slots()``, which waits for the device).

Dropless dispatch (``cfg.dropless``, jamba): the router spans all
``n_experts``; the layer holds the experts ``cfg.held()`` (expert
parallelism: the others live on other cards) and gives every (token,
slot) routed to a held expert that expert's output times its gate, and
the others nothing, however uneven the routing.  The held slots are
sorted by expert and each held expert's SwiGLU runs once over its
contiguous rows; the row counts are read to the host once a layer (the
one synchronisation), and ``HELD_ROWS`` sums them.

Spans: ``repro_torch.route`` (router, top-k, the slots' places and sort)
and ``repro_torch.experts`` (dispatch, the experts' products, combine),
inside ``lm``'s ``repro_torch.moe``.

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

from typing import Dict, List, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from .. import pspec
from .config import MoEConfig
from .layers import activation_fn, init_mlp, mlp_block, normal
from ..runtime.spans import span

__all__ = ["init_moe", "moe_block", "dropped_slots", "DROPPED_SLOTS",
           "HELD_ROWS", "ROUTES"]

# (token, slot) pairs dropped for capacity, and rows the held experts
# computed on the dropless path (plain ints: zero them by hand; read
# DROPPED_SLOTS through dropped_slots())
DROPPED_SLOTS = 0
HELD_ROWS = 0
# drops counted on the device, not yet added to DROPPED_SLOTS (adding them
# there would wait for the device in every layer)
_pending_drops: Dict[torch.device, torch.Tensor] = {}
# None, or a list to which the dropless path appends each layer's expert
# ids (tokens, top_k) as it computed them (no copy, no sync): the routes a
# check replays through a reference
ROUTES: Optional[List[torch.Tensor]] = None


def dropped_slots() -> int:
    """``DROPPED_SLOTS`` with the drops still counted on the devices added
    (waits for them)."""
    global DROPPED_SLOTS
    for n in _pending_drops.values():
        DROPPED_SLOTS += int(n)
    _pending_drops.clear()
    return DROPPED_SLOTS


def _count_drops(valid: torch.Tensor, slots: int) -> None:
    """Add the ``slots`` (token, slot) pairs less the ones the table
    ``valid`` keeps to the device's pending count: one reduction, no sync
    (not on ``meta`` tensors or a mesh)."""
    if valid.device.type == "meta" or pspec.is_dtensor(valid):
        return
    dropped = slots - valid.sum()
    prev = _pending_drops.get(valid.device)
    _pending_drops[valid.device] = (dropped if prev is None
                                    else prev + dropped)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def init_moe(gen, cfg: MoEConfig, d_model: int, dtype: torch.dtype,
             device) -> Dict:
    m = cfg
    s = d_model ** -0.5
    e = len(m.held())        # the router spans all n_experts
    p = {
        "router": normal(gen, (d_model, m.n_experts), torch.float32, s,
                         device),
        "w_gate": normal(gen, (e, d_model, m.d_expert), dtype, s, device),
        "w_up": normal(gen, (e, d_model, m.d_expert), dtype, s, device),
        "w_down": normal(gen, (e, m.d_expert, d_model), dtype,
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
    if m.dropless:
        return _dropless(params, x, m, activation)
    if m.held_experts:
        raise ValueError("moe_block: a layer that holds some of the experts "
                         "takes dropless dispatch")
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

    with span("repro_torch.route"):
        gate_vals, expert_ids, aux = _route(params, xg, m)
        slots, table, valid, cap = _positions(expert_ids, m, g, tg, x.device)
    with span("repro_torch.experts"):
        out = _capacity_experts(params, xg, gate_vals, slots, table, valid,
                                cap, m, activation)
    # groups back to the batch: DTensor's view rule cannot undo the split
    # of a batch and a sequence dim sharded over two mesh dims (prefill_32k:
    # groups over data and model), so the groups follow the data axes alone
    out = pspec.shard(out, "batch", None, None)
    out = out.reshape(b, s, d).to(x.dtype)
    if "shared" in params:
        out = out + mlp_block(params["shared"], x, activation)
    return out, aux


def _route(params: Mapping, xg: torch.Tensor, m: MoEConfig,
           want_aux: bool = True):
    """Router logits (..., E) in float32 -> (top-k gates, expert ids, the
    load-balancing loss, or 0 unless ``want_aux``)."""
    E, K = m.n_experts, m.top_k
    router = params["router"].to(xg.dtype).float()
    logits = xg.float() @ router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(probs, K, dim=-1, sorted=True)
    if m.renormalize:
        gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                            min=1e-9)
    if not want_aux:
        return gate_vals, expert_ids, probs.new_zeros(())
    # aux load-balancing loss (Switch-style)
    rows = tuple(range(probs.dim() - 1))
    me = probs.mean(dim=rows)                                     # (E,)
    ce = F.one_hot(expert_ids[..., 0], E).float().mean(dim=rows)
    aux = E * torch.sum(me * ce) * m.aux_loss_coef
    return gate_vals, expert_ids, aux


def _positions(expert_ids: torch.Tensor, m: MoEConfig, g: int, tg: int,
               device):
    """Each (token, slot)'s position inside its expert's capacity, and the
    token-index table (G, E*C) with its validity."""
    E, K = m.n_experts, m.top_k
    cap = capacity(m, tg)

    # --- per-slot positions within expert capacity (K sequential cumsums);
    # token-index table (G, E*C + 1): the last column takes dropped writes
    spare = E * cap
    table = torch.zeros((g, spare + 1), dtype=torch.long, device=device)
    valid = torch.zeros((g, spare + 1), dtype=torch.bool, device=device)
    tok = torch.arange(tg, device=device).expand(g, tg)
    counts = torch.zeros((g, 1, E), dtype=torch.float32, device=device)
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
    _count_drops(valid, g * tg * K)
    return slots, table, valid, cap


def _capacity_experts(params: Mapping, xg: torch.Tensor,
                      gate_vals: torch.Tensor, slots, table, valid,
                      cap: int, m: MoEConfig, activation: str
                      ) -> torch.Tensor:
    """Dispatch by gather, the experts as batched products over E, and the
    combine: (G, Tg, d)."""
    E = m.n_experts
    g, tg, d = xg.shape
    spare = E * cap

    # --- dispatch gather: (G, E, C, d) ---
    gathered = torch.gather(xg, 1, table[..., None].expand(g, spare, d))
    gathered = torch.where(valid[..., None], gathered,
                           torch.zeros((), dtype=xg.dtype, device=xg.device))
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
    out = torch.zeros((g, tg, d), dtype=expert_out.dtype, device=xg.device)
    eo_flat = expert_out.reshape(g, spare, d)
    for slot, (e_ids, p_tok, ok) in enumerate(slots):
        flat = (e_ids * cap + torch.clamp(p_tok, max=cap - 1)).clamp(
            0, spare - 1)
        piece = torch.gather(eo_flat, 1, flat[..., None].expand(g, tg, d))
        w = (gate_vals[..., slot] * ok.float())[..., None]
        out = out + piece * w.to(piece.dtype)
    return out


def _dropless(params: Mapping, x: torch.Tensor, m: MoEConfig,
              activation: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dropless dispatch over the held experts (see the module's
    docstring): x (B, S, d) -> (out, aux_loss)."""
    global HELD_ROWS
    b, s, d = x.shape
    K, held = m.top_k, m.held()
    xf = x.reshape(b * s, d)
    with span("repro_torch.route"):
        # the loss only where a gradient may want it (not in serving)
        gates, ids, aux = _route(params, xf, m, torch.is_grad_enabled())
        if ROUTES is not None:
            ROUTES.append(ids)
        # each slot's place among the held experts; the others sort last
        place = [len(held)] * m.n_experts
        for j, e in enumerate(held):
            place[e] = j
        where = torch.tensor(place, device=x.device)[ids.reshape(-1)]
        order = torch.argsort(where, stable=True)
        counts = torch.bincount(where, minlength=len(held) + 1)
        counts = counts[:len(held)].tolist()   # the layer's one sync
    with span("repro_torch.experts"):
        n = sum(counts)
        slots = order[:n]                      # held slots, by expert
        rows = xf[slots // K]
        pieces, o = [], 0
        for j, c in enumerate(counts):
            if c:
                pieces.append(mlp_block(
                    {"w_gate": params["w_gate"][j],
                     "w_up": params["w_up"][j],
                     "w_down": params["w_down"][j]}, rows[o:o + c],
                    activation))
            o += c
        outs = torch.cat(pieces) if pieces else rows[:0]
        outs = outs * gates.reshape(-1)[slots, None].to(outs.dtype)
        per_slot = torch.zeros((b * s * K, d), dtype=outs.dtype,
                               device=x.device).index_copy(0, slots, outs)
        out = per_slot.view(b * s, K, d).sum(1).reshape(b, s, d).to(x.dtype)
    HELD_ROWS += n
    if "shared" in params:
        out = out + mlp_block(params["shared"], x, activation)
    return out, aux
