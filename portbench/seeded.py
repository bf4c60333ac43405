"""Weights and inputs made from ``--seed``, on the device, in a few large
calls.  The program and the reference are each handed what these functions
make; the reference makes it again from the seed rather than reading what
the program holds.

Every stream is a ``torch.Generator`` seeded by ``derive(seed, *tags)``, so
the same seed gives the same bits on the same kind of device.
"""

from __future__ import annotations

import hashlib
from typing import Dict, List, Tuple

import torch

CHUNK = 1 << 28          # elements per fill call
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream named by ``tags`` under ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(seed: int, *tags, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(derive(seed, *tags))
    return g


def dims(conf: dict) -> Dict[str, int]:
    """The sizes of a decoder-only LM configuration file."""
    d = conf["hidden_size"]
    heads = conf["num_attention_heads"]
    return {"d": d, "ff": conf["intermediate_size"],
            "layers": conf["num_hidden_layers"], "heads": heads,
            "kv_heads": conf.get("num_key_value_heads", heads),
            "head_dim": conf.get("head_dim") or d // heads,
            "vocab": conf["vocab_size"],
            "patches": conf.get("n_patches", 0)}


def layout(conf: dict) -> List[Tuple[str, Tuple[int, ...], str, float]]:
    """Every weight as (dotted name, shape, kind, scale), in the layout the
    port's ``LM`` takes (``x @ W`` with W (in, out)).  kind "normal" is
    scale · N(0, 1); kind "norm" is 1 + scale · N(0, 1), a norm's gain.
    Names are those of the port's ``named_parameters``."""
    s = dims(conf)
    d, ff, hd = s["d"], s["ff"], s["head_dim"]
    rms = conf["norm"] == "rmsnorm"
    out = [("embed", (s["vocab"], d), "normal", d ** -0.5)]
    for i in range(s["layers"]):
        p = f"layers.{i}."
        if rms:
            out.append((p + "ln1.scale", (d,), "norm", 0.1))
        out += [(p + "mix.wq", (d, s["heads"] * hd), "normal", d ** -0.5),
                (p + "mix.wk", (d, s["kv_heads"] * hd), "normal", d ** -0.5),
                (p + "mix.wv", (d, s["kv_heads"] * hd), "normal", d ** -0.5),
                (p + "mix.wo", (s["heads"] * hd, d), "normal", d ** -0.5)]
        if rms:
            out.append((p + "ln2.scale", (d,), "norm", 0.1))
        out += [(p + "ffn.w_up", (d, ff), "normal", d ** -0.5),
                (p + "ffn.w_down", (ff, d), "normal", ff ** -0.5),
                (p + "ffn.w_gate", (d, ff), "normal", d ** -0.5)]
    if rms:
        out.append(("final_norm.scale", (d,), "norm", 0.1))
    if not conf.get("tie_word_embeddings", False):
        out.append(("unembed", (d, s["vocab"]), "normal", d ** -0.5))
    if s["patches"]:
        out.append(("patch_proj", (d, d), "normal", d ** -0.5))
    return out


def weights(conf: dict, seed: int, device, dtype: torch.dtype
            ) -> Dict[str, torch.Tensor]:
    """{dotted name: tensor}, every tensor a view into one buffer filled by
    ``normal_`` in chunks of ``CHUNK`` elements from one generator."""
    lay = layout(conf)
    total = sum(_numel(shape) for _, shape, _, _ in lay)
    buf = torch.empty(total, dtype=dtype, device=device)
    g = generator(seed, "weights", device=device)
    for lo in range(0, total, CHUNK):
        buf[lo:lo + CHUNK].normal_(generator=g)
    out, off = {}, 0
    with torch.no_grad():
        for name, shape, kind, scale in lay:
            n = _numel(shape)
            t = buf[off:off + n].view(shape).mul_(scale)
            if kind == "norm":
                t.add_(1.0)
            out[name] = t
            off += n
    return out


def tree(flat: Dict[str, torch.Tensor], conf: dict) -> dict:
    """The nested layout the port's ``LM(cfg, tree)`` takes, norms without
    parameters as empty dicts."""
    s = dims(conf)
    t = {"embed": flat["embed"], "layers": [],
         "final_norm": _sub(flat, "final_norm.")}
    for i in range(s["layers"]):
        p = f"layers.{i}."
        t["layers"].append({k: _sub(flat, p + k + ".")
                            for k in ("ln1", "mix", "ln2", "ffn")})
    for name in ("unembed", "patch_proj"):
        if name in flat:
            t[name] = flat[name]
    return t


def _sub(flat, prefix):
    return {k[len(prefix):]: v for k, v in flat.items()
            if k.startswith(prefix)}


def _numel(shape) -> int:
    n = 1
    for x in shape:
        n *= x
    return n


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------


def train_batch(seed: int, step: int, batch: int, seq: int, vocab: int,
                device) -> Dict[str, torch.Tensor]:
    """Step ``step``'s rows: token ids drawn uniformly on the device, each
    row's labels its tokens shifted by one."""
    g = generator(seed, "batch", step, device=device)
    toks = torch.randint(0, vocab, (batch, seq + 1), generator=g,
                         device=device)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def prompt_pool(seed: int, pool: int, length: int, vocab: int
                ) -> torch.Tensor:
    """``pool`` text prompts (pool, length) int64 on the host, drawn
    uniformly; request row j takes prompt j % pool."""
    g = generator(seed, "prompts", device="cpu")
    return torch.randint(0, vocab, (pool, length), generator=g)


def patch_pool(seed: int, pool: int, patches: int, d: int, device,
               dtype: torch.dtype) -> torch.Tensor:
    """``pool`` images' patch embeddings (pool, patches, d) on the device,
    N(0, 1): the vision tower's output, which this benchmark stubs."""
    g = generator(seed, "patches", device=device)
    out = torch.empty((pool, patches, d), dtype=dtype, device=device)
    return out.normal_(generator=g)
