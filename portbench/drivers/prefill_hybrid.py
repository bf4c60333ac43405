"""Prefill of a hybrid Mamba-attention expert model (a Jamba
configuration): one request after another through the port's
``models.lm.prefill`` into a cache allocated in set-up, each request a
batch of text prompts of fixed length.

The port runs the configuration as ``model_config`` builds it: attention
without positional encoding, the Mamba mixer with its RMSNorms on dt, B
and C and the scan's kernel under the cache (``ssm_impl`` of the
traffic), and dropless top-k expert layers that hold the experts 0 to
``num_experts`` - 1 of the router's ``published["num_experts"]`` (one
card of an expert-parallel deployment).  A request is timed from its
issue, through the copy of its tokens to the card and the prefill, to its
greedy first tokens on the host.  The window keeps each request's
last-position logits, served tokens and expert routes (``moe.ROUTES``);
the check compares a sample of them (the last request and others drawn
from the seed), the last request's cached keys and values of every
attention layer, and its last Mamba states and conv tails, with the
float32 reference (``reference/hybrid.py``), the sampled requests batched
and routed as the program routed them: a token near a tie of two experts
may take either in bf16, and one flip moves everything after it, so the
routes are judged apart (``route_gap``) and the rest is judged on the
same routes."""

from __future__ import annotations

import random
import time

import torch

from .. import port, seeded
from ..loop import Item
from ..reference import hybrid as ref
from ..reference.lm import Precision, float32_only
from ..seeded_hybrid import dims, kinds, weights

def model_config(conf: dict, name: str, ssm_impl: str):
    """The port's ``ModelConfig`` of a Jamba configuration file; raises
    where the file asks for what the port does not compute."""
    port._on_path()
    from repro_torch.models.config import (AttentionConfig, ModelConfig,
                                           MoEConfig, SSMConfig)
    s = dims(conf)
    unsupported = {
        "rms_norm_eps": conf["rms_norm_eps"] != 1e-6,
        "mamba_conv_bias": not conf["mamba_conv_bias"],
        "mamba_proj_bias": conf["mamba_proj_bias"],
        "expert_layer_offset": s["expert_offset"] != s["expert_period"] - 1,
        "hidden_act": conf["hidden_act"] != "silu",
        "tie_word_embeddings": conf["tie_word_embeddings"],
    }
    bad = [k for k, v in unsupported.items() if v]
    if bad:
        raise ValueError(f"prefill_hybrid: the port does not run {bad} as "
                         f"the configuration states them")
    return ModelConfig(
        arch_id=name, family="hybrid", n_layers=s["layers"], d_model=s["d"],
        d_ff=s["ff"], vocab_size=s["vocab"],
        attention=AttentionConfig(kind="gqa", n_heads=s["heads"],
                                  n_kv_heads=s["kv_heads"],
                                  head_dim=s["head_dim"], rope=False),
        ssm=SSMConfig(d_state=s["d_state"], d_conv=s["d_conv"],
                      expand=conf["mamba_expand"], dt_rank=s["dt_rank"],
                      inner_norms=True),
        moe=MoEConfig(n_experts=s["experts"], top_k=s["top_k"],
                      d_expert=s["ff"], every=s["expert_period"],
                      renormalize=False, dropless=True,
                      held_experts=tuple(range(s["held"]))),
        attn_period=s["attn_period"], attn_offset=s["attn_offset"],
        norm="rmsnorm", activation="silu", tie_embeddings=False,
        param_dtype=conf["param_dtype"], compute_dtype=conf["compute_dtype"],
        ssm_impl=ssm_impl, source=conf["source"])


def _rows(run, i: int) -> int:
    """Prompt pool row of request ``i`` (a contiguous slice)."""
    return (i * run.traffic["batch"]) % run.traffic["prompt_pool"]


def _prompts(run) -> torch.Tensor:
    t = run.traffic
    return seeded.prompt_pool(run.seed, t["prompt_pool"], t["prompt_tokens"],
                              dims(run.conf)["vocab"])


def _weights(run):
    return weights(run.conf, run.seed, run.device,
                   seeded.DTYPES[run.conf["param_dtype"]])


class Program:
    def __init__(self, run):
        conf, t = run.conf, run.traffic
        self.cfg = model_config(conf, run.config_name, t["ssm_impl"])
        from repro_torch.kernels import flash_attention, selective_scan
        from repro_torch.models import lm, mamba, moe
        self.lm, self.fa, self.ss = lm, flash_attention, selective_scan
        self.mamba, self.moe = mamba, moe
        self.run, self.dev = run, run.device
        self.B, self.V = t["batch"], dims(conf)["vocab"]
        self.positions = t["prompt_tokens"]
        flat = _weights(run)
        self.params = port.lm(self.cfg, flat, conf)
        del flat
        run.mark("port and weights")
        slots = self.positions + t["reserve_tokens"]
        self.cache = lm.init_cache(self.cfg, self.B, slots, self.dev)
        self.scratch = (lm.init_cache(self.cfg, self.B, slots, self.dev)
                        if run.fault == "state_unchanged" else None)
        self.prompts = _prompts(run)
        self.kept, self.last, self.routes = [], self.cache, {}
        run.mark("cache and inputs")
        for i in range(t["warmup_requests"]):
            self._first_tokens(self._prefill(i))

    def _prefill(self, i: int) -> torch.Tensor:
        p, b = _rows(self.run, i), self.B
        tokens = self.prompts[p:p + b].to(self.dev)
        if self.run.fault == "half_batch":
            tokens = tokens[:b // 2]
        cache = self.cache if self.scratch is None else self.scratch
        self.moe.ROUTES = []
        logits, new = self.lm.prefill(self.params, self.cfg, tokens, cache,
                                      impl=self.run.traffic["impl"])
        # (expert layers, rows, top_k), kept on the card for the check
        self._routes = torch.stack(self.moe.ROUTES).to(torch.int16)
        self.moe.ROUTES = None
        # the caches the request left (the Mamba states are new tensors;
        # the keys and values are written in place)
        self.last = new if self.scratch is None else self.cache
        if self.run.fault == "half_batch":
            logits = torch.cat([logits, logits[:b - b // 2]])
        return logits

    def _first_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        token = logits[:, -1].argmax(-1)
        if self.run.fault == "answer_altered":
            token = (token + 1) % self.V
        return token.cpu()                     # the first tokens on the host

    def one(self, i: int) -> Item:
        issued = time.perf_counter()
        with torch.profiler.record_function("portbench.prefill"):
            logits = self._prefill(i)
        queued = time.perf_counter()
        token = self._first_tokens(logits)
        done = time.perf_counter()
        # kept on the host, so that the card's allocator reuses its blocks
        self.kept.append((i, logits[:, -1].cpu(), token))
        self.routes[i] = self._routes
        return Item(issued, done, self.B * self.positions, queued - issued)

    def counters(self) -> dict:
        out = dict(self.fa.VARIANT_LAUNCHES,
                   plain=self.fa.PLAIN_CALLS["flash_attention"])
        out.update({f"scan.{k}": v
                    for k, v in self.ss.VARIANT_LAUNCHES.items()})
        out["scan.plain"] = self.ss.PLAIN_CALLS["selective_scan"]
        out["mamba.CHUNKED_SCAN_CALLS"] = self.mamba.CHUNKED_SCAN_CALLS
        out["moe.DROPPED_SLOTS"] = self.moe.dropped_slots()
        out["moe.HELD_ROWS"] = self.moe.HELD_ROWS
        return out

    def outputs(self, sample) -> dict:
        """The sampled requests' logits and served tokens, the last
        request's cached keys and values and its Mamba states, and the
        count of requests whose logits are not all finite; frees the
        rest."""
        self.run.failed += sum(not bool(torch.isfinite(lg).all())
                               for _, lg, _ in self.kept)
        kept = {i: (lg, tok) for i, lg, tok in self.kept if i in sample}
        n = self.positions
        layers = kinds(self.run.conf)
        out = {"requests": {i: {"logits": kept[i][0].float(),
                                "tokens": kept[i][1],
                                "routes": self.routes[i]} for i in sample},
               "kv_request": sample[-1],
               "kv": {j: (c["k"][:, :n], c["v"][:, :n])
                      for j, (c, (m, _)) in enumerate(zip(self.cache,
                                                          layers))
                      if m == "attn"},
               "states": {j: (c["h"], c["conv"])
                          for j, (c, (m, _)) in enumerate(zip(self.last,
                                                              layers))
                          if m == "mamba"}}
        del self.params, self.kept, self.prompts, self.scratch, self.last
        del self.routes
        return out


def sample(run, n_done: int):
    """The last request and ``check_requests`` - 1 others drawn from the
    seed, in order."""
    k = min(run.traffic["check_requests"], n_done)
    rng = random.Random(seeded.derive(run.seed, "sample"))
    return sorted(rng.sample(range(n_done - 1), k - 1)) + [n_done - 1]


def _reference(run, requests, prec: Precision, kv=None, state=None,
               route=None):
    """The reference's last-position logits of the ``requests`` batched,
    (len(requests) × batch, V); ``kv`` and ``state`` receive the last
    request's rows, ``route`` every row (``reference.hybrid.prefill``'s
    hooks)."""
    float32_only()
    flat = _weights(run)
    prompts, b = _prompts(run), run.traffic["batch"]
    tokens = torch.cat([prompts[_rows(run, i):_rows(run, i) + b]
                        for i in requests]).to(run.device)
    last = slice(len(requests) * b - b, len(requests) * b)
    return ref.prefill(
        flat, run.conf, tokens, prec,
        kv=None if kv is None else (lambda j, k, v: kv(j, k[last], v[last])),
        state=None if state is None else (
            lambda j, h, tail: state(j, h[last], tail[last])),
        route=route)


def control(run, sample_) -> dict:
    """The reference in float8 products, in the program's place: the
    sampled requests' logits and first tokens, and the last request's
    keys, values (stored as the program stores its cache) and states."""
    store = seeded.DTYPES[run.conf["compute_dtype"]]
    out = {"requests": {}, "kv_request": sample_[-1], "kv": {},
           "states": {}}

    def kv(j, k, v):
        out["kv"][j] = (k.to(store), v.to(store))

    def state(j, h, tail):
        out["states"][j] = (h, tail.to(store))

    routes = []

    def route(j, probs, ids):
        routes.append(ids.to(torch.int16))
        return ids

    logits = _reference(run, sample_, Precision("fp8"), kv, state, route)
    b = run.traffic["batch"]
    rows = b * run.traffic["prompt_tokens"]
    for n, i in enumerate(sample_):
        last = logits[n * b:(n + 1) * b]
        out["requests"][i] = {
            "logits": last, "tokens": last.argmax(-1).cpu(),
            "routes": torch.stack([r[n * rows:(n + 1) * rows]
                                   for r in routes])}
    return out


def _rel(got, want) -> float:
    return float((got.float() - want).norm() / want.norm())


def judge(run, outputs) -> dict:
    """token_gap   the widest gap by which a served first token's reference
                   logit lies below the reference's best
    logits_err  the worst row's |logits - reference| / |reference| at the
                last position
    kv_err      the worst attention layer's |k - reference k| /
                |reference k| (and the same of v), over the last request's
                prompt positions
    state_err   the worst Mamba layer's |h_S - reference h_S| /
                |reference h_S| (and the same of the conv tail), for the
                last request
    first_state_err  the same as state_err of the first Mamba layer
                alone: what neither depth nor a route moves
    route_gap   the widest gap, in router logits, by which an expert the
                program routed a (token, slot) to lies below the
                reference's k-th choice for that token

    The reference takes the program's routes (a route it cannot read
    counts as infinitely far), so the other numbers see the arithmetic
    of the same model and not the flips of near ties.
    """
    numbers = {"token_gap": 0.0, "logits_err": 0.0, "kv_err": 0.0,
               "state_err": 0.0, "first_state_err": 0.0, "route_gap": 0.0}
    requests = sorted(outputs["requests"])
    layers = kinds(run.conf)
    expert_layers = [j for j, (_, e) in enumerate(layers) if e]
    first_mamba = min(j for j, (m, _) in enumerate(layers) if m == "mamba")

    def kv(j, k, v):
        for got, want in zip(outputs["kv"][j], (k, v)):
            numbers["kv_err"] = max(numbers["kv_err"], _rel(got, want))

    def state(j, h, tail):
        for got, want in zip(outputs["states"][j], (h, tail)):
            err = _rel(got, want)
            numbers["state_err"] = max(numbers["state_err"], err)
            if j == first_mamba:
                numbers["first_state_err"] = max(numbers["first_state_err"],
                                                 err)

    def route(j, probs, ids):
        q = expert_layers.index(j)
        got = [outputs["requests"][i]["routes"] for i in requests]
        if any(r.shape[0] <= q for r in got):
            numbers["route_gap"] = float("inf")
            return ids
        got = torch.cat([r[q] for r in got]).to(ids.device).long()
        if got.shape != ids.shape or not bool(
                ((got >= 0) & (got < probs.shape[-1])).all()):
            numbers["route_gap"] = float("inf")
            return ids
        gap = (probs.gather(-1, ids[:, -1:]).log()
               - probs.gather(-1, got).log()).max()
        numbers["route_gap"] = max(numbers["route_gap"], float(gap))
        return got

    want = _reference(run, requests, Precision(), kv, state, route)
    b = run.traffic["batch"]
    for n, i in enumerate(requests):
        got, w = outputs["requests"][i], want[n * b:(n + 1) * b]
        served = got["tokens"].to(w.device).long()
        gaps = w.max(-1).values - w.gather(-1, served[:, None])[:, 0]
        rows = (got["logits"].to(w.device) - w).norm(dim=-1) / \
            w.norm(dim=-1)
        numbers["token_gap"] = max(numbers["token_gap"], float(gaps.max()))
        numbers["logits_err"] = max(numbers["logits_err"], float(rows.max()))
    return numbers


def flops_per_item(run) -> float:
    from ..counts_hybrid import prefill_flops
    t = run.traffic
    return prefill_flops(run.conf, t["batch"], t["prompt_tokens"])
