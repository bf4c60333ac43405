"""Prefill: one request after another through the port's
``models.lm.prefill`` into a cache allocated in set-up, each request a
batch of prompts (patch embeddings, then text tokens) of fixed length.

A request is timed from its issue, through the copy of its tokens to the
card and the prefill, to its greedy first tokens on the host.  The window
keeps each request's last-position logits and served tokens; the check
compares a sample of them, drawn from the seed and always holding the
last request, and the last request's cached keys and values of every
layer, with the float32 reference."""

from __future__ import annotations

import random
import time

import torch

from .. import port, seeded
from ..loop import Item
from ..reference import lm as ref
from ..seeded import dims



def _rows(run, i: int):
    """Prompt and image pool rows of request ``i`` (a contiguous slice)."""
    b = run.traffic["batch"]
    return (i * b) % run.traffic["prompt_pool"], \
        (i * b) % run.traffic["image_pool"]


def _inputs(run):
    conf, t, s = run.conf, run.traffic, dims(run.conf)
    prompts = seeded.prompt_pool(run.seed, t["prompt_pool"],
                                 t["prompt_tokens"], s["vocab"])
    patches = (seeded.patch_pool(run.seed, t["image_pool"], s["patches"],
                                 s["d"], run.device,
                                 seeded.DTYPES[conf["compute_dtype"]])
               if s["patches"] else None)
    return prompts, patches


class Program:
    def __init__(self, run):
        conf, t = run.conf, run.traffic
        self.cfg = port.model_config(conf, run.config_name)
        from repro_torch.kernels import flash_attention
        from repro_torch.models import lm
        self.lm, self.fa = lm, flash_attention
        self.run, self.dev = run, run.device
        s = dims(conf)
        self.B, self.V = t["batch"], s["vocab"]
        self.positions = s["patches"] + t["prompt_tokens"]
        flat = seeded.weights(conf, run.seed, self.dev,
                              seeded.DTYPES[conf["param_dtype"]])
        self.params = port.lm(self.cfg, flat, conf)
        del flat
        run.mark("port and weights")
        slots = self.positions + t["reserve_tokens"]
        self.cache = lm.init_cache(self.cfg, self.B, slots, self.dev)
        self.scratch = (lm.init_cache(self.cfg, self.B, slots, self.dev)
                        if run.fault == "state_unchanged" else None)
        self.prompts, self.patches = _inputs(run)
        self.kept = []
        run.mark("cache and inputs")
        for i in range(t["warmup_requests"]):
            self._first_tokens(self._prefill(i))

    def _prefill(self, i: int) -> torch.Tensor:
        p, q = _rows(self.run, i)
        b = self.B
        tokens = self.prompts[p:p + b].to(self.dev)
        patches = None if self.patches is None else self.patches[q:q + b]
        cache = self.cache if self.scratch is None else self.scratch
        if self.run.fault == "half_batch":
            h = b // 2
            logits, _ = self.lm.prefill(
                self.params, self.cfg, tokens[:h], [
                    {k: (v[:h] if torch.is_tensor(v) and v.dim() == 4
                         else v) for k, v in c.items()} for c in cache],
                patches=None if patches is None else patches[:h],
                impl=self.run.traffic["impl"])
            return torch.cat([logits, logits[:b - h]])
        logits, _ = self.lm.prefill(self.params, self.cfg, tokens, cache,
                                    patches=patches,
                                    impl=self.run.traffic["impl"])
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
        return Item(issued, done, self.B * self.positions, queued - issued)

    def counters(self) -> dict:
        return dict(self.fa.VARIANT_LAUNCHES,
                    plain=self.fa.PLAIN_CALLS["flash_attention"])

    def outputs(self, sample) -> dict:
        """The sampled requests' logits and served tokens, the last
        request's cached keys and values, and the count of requests whose
        logits are not all finite; frees the rest."""
        self.run.failed += sum(not bool(torch.isfinite(lg).all())
                               for _, lg, _ in self.kept)
        kept = {i: (lg, tok) for i, lg, tok in self.kept if i in sample}
        n = self.positions
        out = {"requests": {i: {"logits": kept[i][0].float(),
                                "tokens": kept[i][1]} for i in sample},
               "kv_request": sample[-1],
               "kv": [(c["k"][:, :n], c["v"][:, :n]) for c in self.cache]}
        del self.params, self.kept, self.prompts, self.patches, self.scratch
        return out


def sample(run, n_done: int):
    """The last request and ``check_requests`` - 1 others drawn from the
    seed, in order."""
    k = min(run.traffic["check_requests"], n_done)
    rng = random.Random(seeded.derive(run.seed, "sample"))
    return sorted(rng.sample(range(n_done - 1), k - 1)) + [n_done - 1]


def _request_inputs(run, prompts, patches, i):
    p, q = _rows(run, i)
    b = run.traffic["batch"]
    tokens = prompts[p:p + b].to(run.device)
    return tokens, (None if patches is None else patches[q:q + b])


def control(run, sample_) -> dict:
    """The reference in float8 products, in the program's place: the
    sampled requests' last-position logits and first tokens, and the last
    request's keys and values (stored as the program stores its cache)."""
    ref.float32_only()
    flat = seeded.weights(run.conf, run.seed, run.device,
                          seeded.DTYPES[run.conf["param_dtype"]])
    prompts, patches = _inputs(run)
    store = seeded.DTYPES[run.conf["compute_dtype"]]
    kv = [None] * dims(run.conf)["layers"]
    out = {"requests": {}, "kv_request": sample_[-1], "kv": kv}
    for i in sample_:
        tokens, pt = _request_inputs(run, prompts, patches, i)
        hook = None
        if i == sample_[-1]:
            def hook(layer, k, v):
                kv[layer] = (k.to(store), v.to(store))
        last = ref.prefill(flat, run.conf, tokens, pt, ref.Precision("fp8"),
                           kv=hook)
        out["requests"][i] = {"logits": last, "tokens": last.argmax(-1).cpu()}
    return out


def judge(run, outputs) -> dict:
    """token_gap   the widest gap by which a served first token's reference
                   logit lies below the reference's best
    logits_err  the worst row's |logits - reference| / |reference| at the
                last position
    kv_err      the worst layer's |k - reference k| / |reference k| (and
                the same of v), over the last request's prompt positions
    """
    ref.float32_only()
    flat = seeded.weights(run.conf, run.seed, run.device,
                          seeded.DTYPES[run.conf["param_dtype"]])
    prompts, patches = _inputs(run)
    numbers = {"token_gap": 0.0, "logits_err": 0.0, "kv_err": 0.0}
    kv_out = outputs["kv"]

    def compare_kv(layer, k, v):
        for got, want in zip(kv_out[layer], (k, v)):
            err = float((got.float() - want).norm() / want.norm())
            numbers["kv_err"] = max(numbers["kv_err"], err)

    for i, got in outputs["requests"].items():
        tokens, pt = _request_inputs(run, prompts, patches, i)
        want = ref.prefill(flat, run.conf, tokens, pt, ref.Precision(),
                           kv=compare_kv if i == outputs["kv_request"]
                           else None)
        served = got["tokens"].to(want.device).long()
        gaps = want.max(-1).values - want.gather(-1, served[:, None])[:, 0]
        rows = (got["logits"].to(want.device) - want).norm(dim=-1) / \
            want.norm(dim=-1)
        numbers["token_gap"] = max(numbers["token_gap"], float(gaps.max()))
        numbers["logits_err"] = max(numbers["logits_err"], float(rows.max()))
        del want
    return numbers


def flops_per_item(run) -> float:
    from ..counts import prefill_flops
    t = run.traffic
    return prefill_flops(run.conf, t["batch"], t["prompt_tokens"])
