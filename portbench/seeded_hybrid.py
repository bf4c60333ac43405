"""The sizes, layer pattern and seeded weights of a hybrid Mamba-attention
expert configuration (a Jamba ``config.json``): ``seeded.py``'s
counterpart for ``drivers/prefill_hybrid.py``, whose reference
(``reference/hybrid.py``) and counts (``counts_hybrid.py``) read the same
sizes.

The file's ``num_experts`` is the experts held on this card (ids 0 to
``num_experts`` - 1); ``published["num_experts"]``, where given, is the
router's width.  Weights are named as the port's ``named_parameters``
names them (``layers.<i>.mix.in_proj``, ...), ``x @ W`` with W (in, out),
and made as ``seeded.weights`` makes its own: one buffer, filled by
``normal_`` in chunks from one generator, each leaf then scaled.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from . import seeded

# kinds of leaf: "normal" scale * N(0, 1); "norm" 1 + scale * N(0, 1) (a
# gain); "dt_bias" DT_BIAS + scale * N(0, 1) (softplus(-4.6) ~ 0.01, the
# middle of Mamba's dt range 0.001-0.1); "a_log" log(1..N) in every row
# (Mamba's S4D-real A; the seed's draws are left unused); "router" as
# "normal", then balanced (``balance_router``)
DT_BIAS = -4.6


def dims(conf: dict) -> Dict[str, int]:
    d = conf["hidden_size"]
    heads = conf["num_attention_heads"]
    held = conf["num_experts"]
    return {"d": d, "ff": conf["intermediate_size"],
            "layers": conf["num_hidden_layers"], "heads": heads,
            "kv_heads": conf["num_key_value_heads"],
            "head_dim": conf.get("head_dim") or d // heads,
            "vocab": conf["vocab_size"],
            "experts": conf.get("published", {}).get("num_experts", held),
            "held": held, "top_k": conf["num_experts_per_tok"],
            "d_state": conf["mamba_d_state"], "d_conv": conf["mamba_d_conv"],
            "d_inner": conf["mamba_expand"] * d,
            "dt_rank": conf["mamba_dt_rank"],
            "attn_period": conf["attn_layer_period"],
            "attn_offset": conf["attn_layer_offset"],
            "expert_period": conf["expert_layer_period"],
            "expert_offset": conf["expert_layer_offset"]}


def kinds(conf: dict) -> List[Tuple[str, bool]]:
    """(mixer "attn" | "mamba", expert FFN or not) of each layer, as
    ``JambaConfig.layers_block_type`` and ``layers_num_experts`` set
    them."""
    s = dims(conf)
    return [("attn" if i % s["attn_period"] == s["attn_offset"] else "mamba",
             i % s["expert_period"] == s["expert_offset"])
            for i in range(s["layers"])]


def layout(conf: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every weight as (dotted name, shape, kind, scale)."""
    s = dims(conf)
    d, ff, hd, di = s["d"], s["ff"], s["head_dim"], s["d_inner"]
    n, dtr, e = s["d_state"], s["dt_rank"], s["held"]
    out = [("embed", (s["vocab"], d), "normal", d ** -0.5)]
    for i, (mixer, expert) in enumerate(kinds(conf)):
        p = f"layers.{i}."
        out.append((p + "ln1.scale", (d,), "norm", 0.1))
        if mixer == "attn":
            out += [(p + "mix.wq", (d, s["heads"] * hd), "normal", d ** -0.5),
                    (p + "mix.wk", (d, s["kv_heads"] * hd), "normal",
                     d ** -0.5),
                    (p + "mix.wv", (d, s["kv_heads"] * hd), "normal",
                     d ** -0.5),
                    (p + "mix.wo", (s["heads"] * hd, d), "normal",
                     (s["heads"] * hd) ** -0.5)]
        else:
            out += [(p + "mix.in_proj", (d, 2 * di), "normal", d ** -0.5),
                    (p + "mix.conv_w", (s["d_conv"], di), "normal", 0.5),
                    (p + "mix.conv_b", (di,), "normal", 0.1),
                    (p + "mix.x_proj", (di, dtr + 2 * n), "normal",
                     di ** -0.5),
                    (p + "mix.dt_norm", (dtr,), "norm", 0.1),
                    (p + "mix.b_norm", (n,), "norm", 0.1),
                    (p + "mix.c_norm", (n,), "norm", 0.1),
                    (p + "mix.dt_proj", (dtr, di), "normal", dtr ** -0.5),
                    (p + "mix.dt_bias", (di,), "dt_bias", 0.5),
                    (p + "mix.A_log", (di, n), "a_log", 0.0),
                    (p + "mix.D", (di,), "norm", 0.1),
                    (p + "mix.out_proj", (di, d), "normal", di ** -0.5)]
        out.append((p + "ln2.scale", (d,), "norm", 0.1))
        if expert:
            out += [(p + "ffn.router", (d, s["experts"]), "router",
                     d ** -0.5),
                    (p + "ffn.w_gate", (e, d, ff), "normal", d ** -0.5),
                    (p + "ffn.w_up", (e, d, ff), "normal", d ** -0.5),
                    (p + "ffn.w_down", (e, ff, d), "normal", ff ** -0.5)]
        else:
            out += [(p + "ffn.w_gate", (d, ff), "normal", d ** -0.5),
                    (p + "ffn.w_up", (d, ff), "normal", d ** -0.5),
                    (p + "ffn.w_down", (ff, d), "normal", ff ** -0.5)]
    out += [("final_norm.scale", (d,), "norm", 0.1),
            ("unembed", (d, s["vocab"]), "normal", d ** -0.5)]
    return out


def balance_router(r: torch.Tensor, held: int) -> torch.Tensor:
    """The router (d, experts) with the mean column of the held experts
    (the first ``held``) and the mean column of the others each moved to
    the mean of all.  Random weights give the residual stream a common
    direction (the SiLUs' positive means), which favours some experts by
    the same margin for every token; drawn independently, the held half's
    share of the slots then moves by ~1% from seed to seed, and a
    request's time with it.  With equal mean columns neither half is
    favoured: the stand-in for the balanced expert placement of an EP
    deployment.  Every column keeps its own draw otherwise."""
    if held >= r.shape[1]:
        return r
    mean = r.mean(1, keepdim=True)
    out = r.clone()
    out[:, :held] += mean - r[:, :held].mean(1, keepdim=True)
    out[:, held:] += mean - r[:, held:].mean(1, keepdim=True)
    return out


def weights(conf: dict, seed: int, device, dtype: torch.dtype
            ) -> Dict[str, torch.Tensor]:
    """{dotted name: tensor}, views into one buffer filled from the seed's
    "weights" stream."""
    lay = layout(conf)
    total = sum(seeded._numel(shape) for _, shape, _, _ in lay)
    buf = torch.empty(total, dtype=dtype, device=device)
    g = seeded.generator(seed, "weights", device=device)
    for lo in range(0, total, seeded.CHUNK):
        buf[lo:lo + seeded.CHUNK].normal_(generator=g)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape, kind, scale in lay:
            size = seeded._numel(shape)
            t = buf[off:off + size].view(shape)
            if kind == "a_log":
                t.copy_(torch.log(torch.arange(
                    1, shape[1] + 1, dtype=torch.float32, device=device)))
            else:
                t.mul_(scale)
                if kind == "norm":
                    t.add_(1.0)
                elif kind == "dt_bias":
                    t.add_(DT_BIAS)
                elif kind == "router":
                    t.copy_(balance_router(t.float(),
                                           dims(conf)["held"]))
            out[name] = t
            off += size
    return out
