"""A decoder-only LM in plain float32 PyTorch: the reference that decides
``correct``.

    x = embed[tokens]  (patch embeddings @ patch_proj prepended for a VLM)
    per layer:  h = norm(x);  q, k, v = h Wq, h Wk, h Wv (heads of D)
                q, k = RoPE(q), RoPE(k)          rotate-half, θ^(-2i/D)
                x = x + softmax(q kᵀ / √D, causal[, window]) v  Wo
                h = norm(x);  x = x + (silu(h Wgate) ⊙ h Wup) Wdown
    logits = norm(x) embedᵀ (tied) or norm(x) Wunembed

norm is a non-parametric LayerNorm (OLMo) or an RMSNorm with a gain.
Training adds the mean next-token cross-entropy, autograd through each
layer under checkpointing, global-norm clipping and AdamW with decoupled
weight decay.  Attention runs in query blocks over the keys each block
can see; the loss in row blocks; so no (S, S) or (B·S, V) tensor exists
at once.

``Precision("fp8")`` is the control: every product's operands rounded to
float8 e4m3 (gradients to e5m2) with one scale per tensor, the step below
the configuration's bf16 that a later change could be tempted to take.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, List, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..seeded import dims

Q_BLOCK = 1024
ROW_BLOCK = 2048


class Precision:
    """How the reference multiplies: "float32" (TF32 off) or "fp8"."""

    def __init__(self, kind: str = "float32"):
        if kind not in ("float32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.kind == "float32":
            return torch.matmul(a, b)
        return _Fp8Matmul.apply(a, b)


def _q8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` (a float8 type) under one scale that maps
    its largest magnitude to the type's largest finite value."""
    top = torch.finfo(dtype).max
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = top / amax
    return (x.float() * scale).to(dtype).float() / scale


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _q8(a, torch.float8_e4m3fn), _q8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        ctx.b_dim = b.dim()
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _q8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        while gb.dim() > ctx.b_dim:
            gb = gb.sum(0)
        return ga, gb


def float32_only():
    """Full float32 products: TF32 off for cuBLAS and cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def norm(x: torch.Tensor, gain: Optional[torch.Tensor], conf: dict
         ) -> torch.Tensor:
    if conf["norm"] == "nonparametric_ln":
        mu = x.mean(-1, keepdim=True)
        var = (x - mu).square().mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + conf["layer_norm_eps"])
    if conf["norm"] == "rmsnorm":
        ms = x.square().mean(-1, keepdim=True)
        return x * torch.rsqrt(ms + conf["rms_norm_eps"]) * gain
    raise ValueError(conf["norm"])


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x (B, S, H, D) at positions 0..S-1, rotating
    the first half of each head against the second."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float64,
                                       device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def attention(q, k, v, prec: Precision, window: int = 0) -> torch.Tensor:
    """Causal (and, with ``window``, sliding-window) attention of q (B, S,
    H, D) over k, v (B, S, KV, D), query block by query block."""
    b, s, h, d = q.shape
    group = h // k.shape[2]
    qh = q.transpose(1, 2)
    kh = k.transpose(1, 2).repeat_interleave(group, dim=1)
    vh = v.transpose(1, 2).repeat_interleave(group, dim=1)
    outs = []
    for q0 in range(0, s, Q_BLOCK):
        q1 = min(s, q0 + Q_BLOCK)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        scores = prec.mm(qh[:, :, q0:q1], kh[:, :, k0:q1].transpose(-1, -2))
        scores = scores / math.sqrt(d)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        keep = kpos <= qpos
        if window > 0:
            keep &= kpos > qpos - window
        p = torch.softmax(scores.masked_fill(~keep, float("-inf")), dim=-1)
        outs.append(prec.mm(p, vh[:, :, k0:q1]))
    return torch.cat(outs, dim=2).transpose(1, 2)


def layer(x: torch.Tensor, w: Dict[str, torch.Tensor], conf: dict,
          prec: Precision, kv: Optional[Callable] = None) -> torch.Tensor:
    """One block over x (B, S, d); ``kv(k, v)`` receives the block's keys
    after RoPE and its values, (B, S, KV, D) each."""
    s = dims(conf)
    b, n, d = x.shape
    hd = s["head_dim"]
    h = norm(x, w.get("ln1.scale"), conf)
    q = prec.mm(h, w["mix.wq"]).view(b, n, s["heads"], hd)
    k = prec.mm(h, w["mix.wk"]).view(b, n, s["kv_heads"], hd)
    v = prec.mm(h, w["mix.wv"]).view(b, n, s["kv_heads"], hd)
    q, k = rope(q, conf["rope_theta"]), rope(k, conf["rope_theta"])
    if kv is not None:
        kv(k, v)
    a = attention(q, k, v, prec, conf.get("window", 0))
    x = x + prec.mm(a.reshape(b, n, s["heads"] * hd), w["mix.wo"])
    h = norm(x, w.get("ln2.scale"), conf)
    gate = torch.nn.functional.silu(prec.mm(h, w["ffn.w_gate"]))
    return x + prec.mm(gate * prec.mm(h, w["ffn.w_up"]), w["ffn.w_down"])


def layer_weights(flat: Dict[str, torch.Tensor], i: int
                  ) -> Dict[str, torch.Tensor]:
    p = f"layers.{i}."
    return {k[len(p):]: t for k, t in flat.items() if k.startswith(p)}


def embed(flat, conf, tokens, patches, prec: Precision) -> torch.Tensor:
    x = flat["embed"].float()[tokens]
    if patches is not None and dims(conf)["patches"]:
        px = prec.mm(patches.float(), flat["patch_proj"].float())
        x = torch.cat([px, x], dim=1)
    return x


def output_matrix(flat, conf) -> torch.Tensor:
    if conf.get("tie_word_embeddings", False):
        return flat["embed"].float().t()
    return flat["unembed"].float()


# ---------------------------------------------------------------------------
# serving: a prefill's outputs
# ---------------------------------------------------------------------------


@torch.no_grad()
def prefill(flat: Dict[str, torch.Tensor], conf: dict, tokens: torch.Tensor,
            patches: Optional[torch.Tensor], prec: Precision,
            kv: Optional[Callable] = None) -> torch.Tensor:
    """The full forward pass over ``tokens`` (B, T) after ``patches``;
    returns the last position's logits (B, V).  ``kv(layer, k, v)``
    receives each layer's keys and values.  The weights in ``flat`` (any
    float type) are taken to float32 layer by layer."""
    x = embed(flat, conf, tokens, patches, prec)
    for i in range(dims(conf)["layers"]):
        w = {k: t.float() for k, t in layer_weights(flat, i).items()}
        hook = None if kv is None else (lambda k, v, i=i: kv(i, k, v))
        x = layer(x, w, conf, prec, hook)
        del w
    x = norm(x[:, -1], _gain(flat, "final_norm.scale"), conf)
    return prec.mm(x, output_matrix(flat, conf))


def _gain(flat, name):
    return flat[name].float() if name in flat else None


# ---------------------------------------------------------------------------
# training: three steps of loss, autograd and AdamW
# ---------------------------------------------------------------------------


def loss(params: Dict[str, torch.Tensor], conf: dict, tokens, labels,
         prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy; each layer, and each block of rows of
    the output projection and its log-softmax, under checkpointing."""
    x = embed(params, conf, tokens, None, prec)
    for i in range(dims(conf)["layers"]):
        w = layer_weights(params, i)
        x = checkpoint(lambda x, w=w: layer(x, w, conf, prec), x,
                       use_reentrant=False)
    x = norm(x, params.get("final_norm.scale"), conf)
    rows = x.reshape(-1, x.shape[-1])
    want = labels.reshape(-1)

    def block_nll(r, y):
        z = prec.mm(r, output_matrix(params, conf))
        return -torch.log_softmax(z, dim=-1).gather(-1, y[:, None]).sum()

    total = 0.0
    for r0 in range(0, rows.shape[0], ROW_BLOCK):
        total = total + checkpoint(block_nll, rows[r0:r0 + ROW_BLOCK],
                                   want[r0:r0 + ROW_BLOCK],
                                   use_reentrant=False)
    return total / rows.shape[0]


def train(flat: Dict[str, torch.Tensor], conf: dict, batches: List[dict],
          opt: dict, prec: Precision) -> dict:
    """Steps over ``batches`` from the weights in ``flat`` (float32
    masters, updated in place).  Returns each step's loss, the first
    step's global gradient norm before clipping, each leaf's norm of the
    first gradient as AdamW applies it (after clipping), and each leaf's
    norm of its change over all the steps."""
    params = {k: t.detach().clone().float().requires_grad_(True)
              for k, t in flat.items()}
    start = {k: t.detach().clone() for k, t in params.items()}
    m = {k: torch.zeros_like(t) for k, t in params.items()}
    v = {k: torch.zeros_like(t) for k, t in params.items()}
    out = {"loss": []}
    for step, batch in enumerate(batches, start=1):
        value = loss(params, conf, batch["tokens"], batch["labels"], prec)
        grads = torch.autograd.grad(value, list(params.values()))
        grads = dict(zip(params, grads))
        out["loss"].append(float(value.detach()))
        gnorm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
        clip = opt["clip_norm"]
        scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
        if step == 1:
            out["gnorm"] = float(gnorm)
            out["grad_norms"] = {k: float(g.norm() * scale)
                                 for k, g in grads.items()}
        with torch.no_grad():
            b1, b2 = opt["b1"], opt["b2"]
            for k, p in params.items():
                g = grads[k] * scale
                m[k].mul_(b1).add_(g, alpha=1 - b1)
                v[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                mh = m[k] / (1 - b1 ** step)
                vh = v[k] / (1 - b2 ** step)
                p.sub_(opt["lr"] * (mh / (vh.sqrt() + opt["eps"])
                                    + opt["weight_decay"] * p))
        del grads
    out["change_norms"] = {k: float((params[k].detach() - start[k]).norm())
                           for k in params}
    return out
