"""Unified model API in PyTorch (the port of ``repro.models.api``): family
dispatch and the dry run's input specs for every (arch x shape) cell.

``Model`` dispatches to ``lm`` (decoder-only) or ``encdec`` (whisper).  Its
entry points that create tensors (``init_params``, ``init_cache``) run on
``cuda`` unless the caller passes ``device="cpu"``; the others run where
the parameters are.  ``logits`` and ``logits_and_aux`` are recorded by
autograd when grad mode is on and the parameters are trainable (training;
``launch.steps``), and run under ``torch.inference_mode`` otherwise
(scoring); ``prefill`` and ``decode_step`` always run under it.

The dry run: ``Model.abstract_params`` and ``input_specs`` give the
reference's parameter pytree and step inputs as tensors on the ``meta``
device, with the reference's shapes and dtypes (``jax.ShapeDtypeStruct``'s
counterpart): nothing is drawn and no storage is allocated.  ``[audio]`` and
``[vlm]`` stubs: frames and patches arrive as precomputed embeddings.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from . import encdec, lm
from .config import ModelConfig, ShapeConfig
from ..device import DeviceLike, resolve_device

__all__ = ["Model", "get_model", "input_specs", "cell_is_runnable"]

META = torch.device("meta")


class Model:
    """Thin dispatcher: decoder-only LMs via ``lm``, whisper via
    ``encdec``."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.is_encdec = cfg.enc_dec is not None

    # -- params ---------------------------------------------------------------
    def init_params(self, key: Union[int, torch.Generator] = 0,
                    device: DeviceLike = None) -> Union[lm.LM,
                                                        encdec.EncDec]:
        """Random parameters from a seed (or a generator, whose device is
        then used) at the reference's init scales."""
        if isinstance(key, torch.Generator):
            gen = key
        else:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(key))
        if self.is_encdec:
            return encdec.init_params_encdec(self.cfg, gen)
        return lm.init_params(self.cfg, gen)

    def abstract_params(self) -> Dict:
        """The reference's parameter pytree as ``meta`` tensors."""
        if self.is_encdec:
            return encdec.abstract_params_encdec(self.cfg)
        return lm.abstract_params(self.cfg)

    # -- forward --------------------------------------------------------------
    def logits(self, params, batch: Dict[str, Any],
               remat: bool = True) -> torch.Tensor:
        return self.logits_and_aux(params, batch, remat)[0]

    def logits_and_aux(self, params, batch: Dict[str, Any],
                       remat: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        if self.is_encdec:
            lg = encdec.forward_encdec(params, cfg, batch["tokens"],
                                       batch["frames"])
            return lg, torch.zeros((), dtype=torch.float32,
                                   device=lg.device)
        return lm.forward_with_aux(params, cfg, batch["tokens"],
                                   patches=batch.get("patches"), remat=remat)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        dev = resolve_device(device)
        if self.is_encdec:
            return encdec.init_cache_encdec(self.cfg, batch, max_len, dev)
        return lm.init_cache(self.cfg, batch, max_len, dev)

    def prefill(self, params, batch: Dict[str, Any], cache):
        """The reference's prefill: ``impl="chunked"`` whatever
        ``cfg.attention_impl`` says (the kernel path of prefill is
        ``lm.prefill(..., impl="flash_pallas")``)."""
        if self.is_encdec:
            return encdec.prefill_encdec(params, self.cfg, batch["tokens"],
                                         batch["frames"], cache)
        return lm.prefill(params, self.cfg, batch["tokens"], cache,
                          patches=batch.get("patches"))

    def decode_step(self, params, token, cache):
        if self.is_encdec:
            return encdec.decode_step_encdec(params, self.cfg, token, cache)
        return lm.decode_step(params, self.cfg, token, cache)


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)


def cell_is_runnable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Shape-cell applicability: long_500k needs sub-quadratic attention
    (ssm / hybrid / SWA); enc-dec decoders are capped at max_seq_len."""
    if shape.name == "long_500k":
        subquadratic = (cfg.family in ("ssm", "hybrid")
                        or cfg.attention.window > 0)
        if not subquadratic:
            return False, ("pure full-attention arch: 500k dense KV decode "
                           "is excluded by the assignment's skip rule")
    if cfg.enc_dec is not None and shape.seq_len > cfg.max_seq_len:
        return False, f"decoder positions capped at {cfg.max_seq_len}"
    return True, ""


def _spec(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """The step function's data inputs as ``meta`` tensors: tokens (and
    labels when training) int32, patches and frames bfloat16; decode takes
    one new token against a ``seq_len``-deep cache."""
    B, S = shape.global_batch, shape.seq_len
    if shape.mode in ("train", "prefill"):
        n_text = S - cfg.n_patches if cfg.n_patches else S
        specs: Dict[str, Any] = {"tokens": _spec((B, n_text), torch.int32)}
        if shape.mode == "train":
            specs["labels"] = _spec((B, n_text), torch.int32)
        if cfg.n_patches:
            specs["patches"] = _spec((B, cfg.n_patches, cfg.d_model),
                                     torch.bfloat16)
        if cfg.enc_dec is not None:
            specs["frames"] = _spec((B, cfg.enc_dec.encoder_len,
                                     cfg.d_model), torch.bfloat16)
        return specs
    return {"token": _spec((B, 1), torch.int32)}
