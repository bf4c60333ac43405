"""Step builders: train_step / prefill_step / decode_step per config, in
PyTorch (the port of ``repro.launch.steps``).

Each builder closes over the ``ModelConfig``; the steps take the model
(``LM``, or ``EncDec`` for whisper), the optimizer state and the batch.
The reference's one ``jax.jit`` per step has no counterpart: a step runs
eagerly, and its update is in place (``optim.adamw_update``), where the
reference donates its buffers.  While a profiler records, the train step
opens the spans ``repro_torch.forward`` (the loss inside it),
``repro_torch.backward`` and ``repro_torch.optimizer`` (``runtime.spans``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from .. import pspec
from ..device import DeviceLike, resolve_device
from ..models import get_model
from ..models.config import ModelConfig
from ..models.lm import LM
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..runtime.spans import span

__all__ = ["cross_entropy", "make_loss_fn", "make_train_step",
           "make_prefill_step", "make_decode_step", "init_train_state",
           "abstract_train_state"]


def _vocab_sharded(t: torch.Tensor) -> bool:
    """Whether ``t`` is a DTensor whose last (vocabulary) dim is split
    over a mesh dim of more than one rank."""
    return pspec.is_dtensor(t) and any(
        p.is_shard(t.dim() - 1) and t.device_mesh.size(i) > 1
        for i, p in enumerate(t.placements))


def cross_entropy(logits: torch.Tensor, labels) -> torch.Tensor:
    """Mean next-token negative log-likelihood, the log-softmax in
    float32.  Logits sharded over the vocabulary (a DTensor on a mesh)
    take the vocabulary-parallel form, log Σ exp less the label's logit,
    each a reduction across the shards (a max, then sums), where a
    log-softmax would gather the vocabulary onto every rank of the TP
    axis, and the gradient of the output projection with it."""
    if _vocab_sharded(logits):
        # partial sums of the output projection (whisper's tied embedding
        # contracts a data-sharded d) resolve onto the batch first
        z = pspec.shard(logits, "batch", None, "tp").float()
        # each reduction over the vocabulary resolves onto the batch
        # layout at once, so that the per-token terms, and the gradient
        # they send back into z, keep the sequence whole
        rows = lambda t: pspec.shard(t, "batch", None)  # noqa: E731
        m = rows(z.detach().amax(dim=-1))
        lse = torch.log(rows(torch.exp(z - m[..., None]).sum(dim=-1))) + m
        hit = torch.arange(z.shape[-1], device=z.device) == \
            labels.long()[..., None]
        return (lse - rows((z * hit).sum(dim=-1))).mean()
    lp = torch.log_softmax(logits.float(), dim=-1)
    labels = torch.as_tensor(labels, dtype=torch.long, device=lp.device)
    nll = -torch.gather(lp, -1, labels[..., None])[..., 0]
    return nll.mean()


def make_loss_fn(cfg: ModelConfig, remat: bool = True) -> Callable:
    model = get_model(cfg)

    def loss_fn(params: LM, batch: Dict[str, Any]):
        logits, aux = model.logits_and_aux(params, batch, remat=remat)
        if cfg.n_patches:  # VLM: patch prefix carries no LM loss
            logits = logits[:, cfg.n_patches:]
        # on a mesh the means are partial sums: resolve them to replicas,
        # so that the backward starts from a replica (DTensor cannot turn
        # a shard of the gradient back into a partial sum before 2.13)
        with span("repro_torch.loss"):
            loss = pspec.shard(cross_entropy(logits, batch["labels"]))
        aux = pspec.shard(aux)
        return loss + aux, {"loss": loss, "aux": aux}

    return loss_fn


def make_train_step(cfg: ModelConfig, opt: Optional[AdamWConfig] = None,
                    remat: bool = True) -> Callable:
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the gradient of the loss (+ MoE aux loss), then one AdamW
    update of ``params`` and ``opt_state`` in place.  With
    ``cfg.train_microbatches`` > 1 the batch is split along its first axis
    and the gradients are accumulated in float32 and averaged, as the
    reference's scan does; ``loss`` is then the mean over microbatches and
    the other loss metrics are the last microbatch's."""
    opt = opt or AdamWConfig()
    loss_fn = make_loss_fn(cfg, remat=remat)
    n_micro = max(1, cfg.train_microbatches)

    def grads_of(params: LM, weights: Dict[str, torch.Tensor], batch):
        with torch.enable_grad():
            with span("repro_torch.forward"):
                total, metrics = loss_fn(params, batch)
            with span("repro_torch.backward"):
                grads = torch.autograd.grad(total, list(weights.values()),
                                            allow_unused=True)
        grads = {n: torch.zeros_like(p) if g is None else g
                 for (n, p), g in zip(weights.items(), grads)}
        return total.detach(), {k: v.detach() for k, v in metrics.items()}, \
            grads

    def train_step(params: LM, opt_state: Dict[str, Any],
                   batch: Dict[str, Any]):
        weights = {n: p for n, p in params.named_parameters()
                   if p.requires_grad}
        if n_micro == 1:
            loss, metrics, grads = grads_of(params, weights, batch)
        else:
            micro = {k: _split(v, n_micro) for k, v in batch.items()}
            grads, loss = None, 0.0
            for i in range(n_micro):
                l, metrics, g = grads_of(
                    params, weights, {k: pspec.shard(v[i], "batch")
                                      for k, v in micro.items()})
                if grads is None:
                    grads = {n: torch.zeros_like(t, dtype=torch.float32)
                             for n, t in g.items()}
                for n in weights:
                    grads[n].add_(g[n])
                loss = loss + l
            grads = {n: g / n_micro for n, g in grads.items()}
            loss = loss / n_micro
        with span("repro_torch.optimizer"):
            _, opt_state, opt_metrics = adamw_update(opt, weights, grads,
                                                     opt_state)
        metrics = {**metrics, **opt_metrics, "loss": loss}
        return params, opt_state, metrics

    return train_step


def _split(v, n_micro: int) -> torch.Tensor:
    """(B, ...) -> (n_micro, B / n_micro, ...).  A batch sharded over the
    data axes is gathered first (DTensor cannot cut a sharded dim into
    microbatches that straddle ranks); the train step shards each
    microbatch again."""
    v = torch.as_tensor(v)
    if pspec.is_dtensor(v):
        v = pspec.shard(v, *[None] * v.dim())
    return v.reshape((n_micro, len(v) // n_micro) + tuple(v.shape[1:]))


def init_train_state(cfg: ModelConfig, generator: torch.Generator,
                     device: DeviceLike = None
                     ) -> Tuple[torch.nn.Module, Dict[str, Any]]:
    """Random parameters (trainable masters) drawn from ``generator`` on
    its device, moved to ``device`` (default: the generator's), and their
    AdamW state there."""
    params = get_model(cfg).init_params(generator)
    if device is not None:
        params = params.to(resolve_device(device))
    return params, adamw_init(dict(params.named_parameters()))


def abstract_train_state(cfg: ModelConfig) -> Tuple[Dict, Dict[str, Any]]:
    """The dry run's training state: the reference's parameter pytree
    (``Model.abstract_params``) and its AdamW state ``{"step": int32 (),
    "m", "v"}`` (float32 moments shaped like the parameters), every leaf a
    ``meta`` tensor: nothing is drawn and no storage is allocated."""
    params = get_model(cfg).abstract_params()
    opt_state = adamw_init(params)
    opt_state["step"] = torch.empty((), dtype=torch.int32, device="meta")
    return params, opt_state


def make_prefill_step(cfg: ModelConfig) -> Callable:
    model = get_model(cfg)

    def prefill_step(params: LM, cache, batch: Dict[str, Any]):
        return model.prefill(params, batch, cache)

    return prefill_step


def make_decode_step(cfg: ModelConfig) -> Callable:
    model = get_model(cfg)

    def decode_step(params: LM, cache, token):
        return model.decode_step(params, token, cache)

    return decode_step
