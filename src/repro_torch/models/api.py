"""Unified model API in PyTorch (the port of ``repro.models.api``) for the
decoder-only families.

``Model`` dispatches to ``lm``.  Its entry points that create tensors
(``init_params``, ``init_cache``) run on ``cuda`` unless the caller passes
``device="cpu"``; the others run where the parameters are.  ``logits`` and
``logits_and_aux`` are recorded by autograd when grad mode is on and the
parameters are trainable (training; ``launch.steps``), and run under
``torch.inference_mode`` otherwise (scoring); ``prefill`` and
``decode_step`` always run under it.  Not ported yet, and raising
``NotImplementedError``: the encoder-decoder family (whisper) and the dry
run (``abstract_params``, ``input_specs``).
"""

from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch

from . import lm
from .config import ModelConfig, ShapeConfig
from ..device import DeviceLike, resolve_device

__all__ = ["Model", "get_model", "input_specs", "cell_is_runnable"]

_DRY_RUN = ("the dry run (abstract parameters, input specs) is not ported "
            "to repro_torch yet; see ROADMAP.md, queue A, item 10")


class Model:
    """Thin dispatcher over ``lm`` (the enc-dec family is not ported)."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.is_encdec = cfg.enc_dec is not None

    # -- params ---------------------------------------------------------------
    def init_params(self, key: Union[int, torch.Generator] = 0,
                    device: DeviceLike = None) -> lm.LM:
        """Random parameters from a seed (or a generator, whose device is
        then used) at the reference's init scales."""
        if isinstance(key, torch.Generator):
            gen = key
        else:
            gen = torch.Generator(device=resolve_device(device))
            gen.manual_seed(int(key))
        return lm.init_params(self.cfg, gen)

    def abstract_params(self):
        raise NotImplementedError(_DRY_RUN)

    # -- forward --------------------------------------------------------------
    def logits(self, params: lm.LM, batch: Dict[str, Any],
               remat: bool = True) -> torch.Tensor:
        return self.logits_and_aux(params, batch, remat)[0]

    def logits_and_aux(self, params: lm.LM, batch: Dict[str, Any],
                       remat: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        lm._check_supported(self.cfg)
        return lm.forward_with_aux(params, self.cfg, batch["tokens"],
                                   patches=batch.get("patches"), remat=remat)

    # -- serving ----------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   device: DeviceLike = None):
        return lm.init_cache(self.cfg, batch, max_len,
                             resolve_device(device))

    def prefill(self, params: lm.LM, batch: Dict[str, Any], cache):
        """The reference's prefill: ``impl="chunked"`` whatever
        ``cfg.attention_impl`` says (the kernel path of prefill is
        ``lm.prefill(..., impl="flash_pallas")``)."""
        lm._check_supported(self.cfg)
        return lm.prefill(params, self.cfg, batch["tokens"], cache,
                          patches=batch.get("patches"))

    def decode_step(self, params: lm.LM, token, cache):
        lm._check_supported(self.cfg)
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


def input_specs(cfg: ModelConfig, shape: ShapeConfig):
    raise NotImplementedError(_DRY_RUN)
