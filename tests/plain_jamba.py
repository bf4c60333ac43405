"""A Jamba-style hybrid LM in plain float32 PyTorch: the reference the
port's hybrid path is held to on the CPU (``test_torch_jamba2.py``).  It
imports neither JAX nor anything of the port, and uses no kernel, cache
or batching trick.

    x = embed[tokens]
    per layer i:  h = rmsnorm(x)
                  attention where i % attn_period == attn_offset:
                      GQA, causal softmax(q kᵀ / √D) v, no positional
                      encoding
                  else the Mamba-1 mixer:
                      x', z = h W_in;  x' = silu(causal depthwise conv(x')
                      + conv_b);  dt, B, C = x' W_x;  dt, B, C = rmsnorm of
                      each with its gain;  dt = softplus(dt W_dt + dt_bias)
                      h_t = exp(dt_t A) h_{t-1} + dt_t x'_t B_t  (h_0 = 0,
                      A = -exp(A_log)),  y_t = C_t · h_t + D x'_t
                      out = (y ⊙ silu(z)) W_out
                  x = x + out;  h = rmsnorm(x)
                  experts where i % expert_period == expert_offset:
                      p = softmax(h W_router) over all experts, the top k
                      kept with their probabilities as gates (no
                      renormalisation); each held expert e gives
                      Σ_k [id_k = e] p_k · swiglu_e(h)
                  else swiglu(h) = (silu(h W_gate) ⊙ h W_up) W_down
                  x = x + that
    logits = rmsnorm(x) W_unembed

The equations are those of transformers' ``modeling_jamba.py``
(``JambaAttention``, ``JambaMambaMixer.slow_forward``,
``JambaSparseMoeBlock``, ``JambaMLP``, ``JambaRMSNorm``).  Departures:

- float32 throughout, where the model computes in its dtype (bf16);
- only the held experts' part of an expert layer: the result one card
  of an expert-parallel deployment computes (the absent experts' part is
  left out, as the program leaves it out);
- the scan is a loop over steps in float32 (``slow_forward`` takes the
  dot with C in the model's dtype);
- eps 1e-6 in every RMSNorm (Jamba's ``rms_norm_eps``).

Parameters are a nested dict of tensors named as the port's ``LM.tree()``
names them (``layers[i]["mix"]["in_proj"]`` and so on; ``x @ W`` with W
(in, out)); ``spec`` is a dict of sizes (see ``spec_of``).
"""

import torch
import torch.nn.functional as F

EPS = 1e-6


def spec_of(cfg):
    """The sizes this reference reads, from a port ``ModelConfig``."""
    a, s, m = cfg.attention, cfg.ssm, cfg.moe
    return {"heads": a.n_heads, "kv_heads": a.n_kv_heads,
            "head_dim": a.head_dim, "attn_period": cfg.attn_period,
            "attn_offset": cfg.attn_offset, "expert_period": m.every,
            "expert_offset": m.every - 1, "experts": m.n_experts,
            "top_k": m.top_k,
            "held": list(m.held_experts or range(m.n_experts)),
            "d_conv": s.d_conv, "d_state": s.d_state}


def rmsnorm(x, gain):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + EPS) * \
        gain.float()


def attention(h, w, spec):
    b, s, _ = h.shape
    hd, nh, kv = spec["head_dim"], spec["heads"], spec["kv_heads"]
    q = (h @ w["wq"].float()).view(b, s, nh, hd).transpose(1, 2)
    k = (h @ w["wk"].float()).view(b, s, kv, hd).transpose(1, 2)
    v = (h @ w["wv"].float()).view(b, s, kv, hd).transpose(1, 2)
    k = k.repeat_interleave(nh // kv, dim=1)
    v = v.repeat_interleave(nh // kv, dim=1)
    scores = q @ k.transpose(-1, -2) / hd ** 0.5
    causal = torch.ones(s, s, dtype=torch.bool).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    out = (p @ v).transpose(1, 2).reshape(b, s, nh * hd)
    return out @ w["wo"].float()


def mamba(h, w, spec):
    """(out, h_S (B, d_inner, N), conv tail (B, d_conv - 1, d_inner): the
    last d_conv - 1 inputs of the conv)."""
    b, s, _ = h.shape
    f = {k: t.float() for k, t in w.items()}
    xz = h @ f["in_proj"]
    xr, z = xz.chunk(2, dim=-1)
    dc = spec["d_conv"]
    xpad = torch.cat([xr.new_zeros(b, dc - 1, xr.shape[-1]), xr], dim=1)
    conv = sum(xpad[:, i:i + s] * f["conv_w"][i] for i in range(dc))
    xc = F.silu(conv + f["conv_b"])
    n = spec["d_state"]
    proj = xc @ f["x_proj"]
    dtr = proj.shape[-1] - 2 * n
    dt = rmsnorm(proj[..., :dtr], f["dt_norm"])
    bm = rmsnorm(proj[..., dtr:dtr + n], f["b_norm"])
    cm = rmsnorm(proj[..., dtr + n:], f["c_norm"])
    dt = F.softplus(dt @ f["dt_proj"] + f["dt_bias"])
    a = -torch.exp(f["A_log"])
    state = torch.zeros(b, xc.shape[-1], n)
    ys = []
    for t in range(s):
        state = torch.exp(dt[:, t, :, None] * a) * state + \
            (dt[:, t] * xc[:, t])[:, :, None] * bm[:, t, None, :]
        ys.append((state * cm[:, t, None, :]).sum(-1) + f["D"] * xc[:, t])
    y = torch.stack(ys, dim=1) * F.silu(z)
    return y @ f["out_proj"], state, xpad[:, s:]


def swiglu(h, w_gate, w_up, w_down):
    return (F.silu(h @ w_gate.float()) * (h @ w_up.float())) @ \
        w_down.float()


def experts(h, w, spec):
    """The held experts' part of a dropless top-k expert layer."""
    probs = torch.softmax(h @ w["router"].float(), dim=-1)
    gates, ids = torch.topk(probs, spec["top_k"], dim=-1)
    out = torch.zeros_like(h)
    for j, e in enumerate(spec["held"]):
        weight = (gates * (ids == e)).sum(-1, keepdim=True)
        out = out + weight * swiglu(h, w["w_gate"][j], w["w_up"][j],
                                    w["w_down"][j])
    return out


def forward(params, spec, tokens, states=None):
    """Logits (B, S, V) of ``tokens`` (B, S); ``states``, a list, receives
    each Mamba layer's (h_S, conv tail)."""
    x = params["embed"].float()[tokens]
    for i, lp in enumerate(params["layers"]):
        h = rmsnorm(x, lp["ln1"]["scale"])
        if i % spec["attn_period"] == spec["attn_offset"]:
            x = x + attention(h, lp["mix"], spec)
        else:
            out, state, tail = mamba(h, lp["mix"], spec)
            if states is not None:
                states.append((state, tail))
            x = x + out
        h = rmsnorm(x, lp["ln2"]["scale"])
        ffn = lp["ffn"]
        if i % spec["expert_period"] == spec["expert_offset"]:
            x = x + experts(h, ffn, spec)
        else:
            x = x + swiglu(h, ffn["w_gate"], ffn["w_up"], ffn["w_down"])
    x = rmsnorm(x, params["final_norm"]["scale"])
    return x @ params["unembed"].float()
