"""AdamW with decoupled weight decay and global-norm clipping, over a dict
of tensors, updated in place.

The reference's math step for step: the step count advances first, the
learning rate is ``lr · schedule(step)``, gradients are scaled by
``min(1, clip_norm / max(‖g‖, 1e-9))`` over all tensors together, the
moments are bias-corrected, and the weight decay is added to the Adam
direction (decoupled) before the step.  The step count is a Python int,
so a schedule runs on the host and an update never waits for the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # step (int, from 1) -> learning-rate factor
    schedule: Optional[Callable[[int], float]] = None


def adamw_init(params: Mapping[str, torch.Tensor]) -> Dict[str, Any]:
    """``{"step": 0, "m": zeros, "v": zeros}``, the moments float32 on each
    parameter's device."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    return {"step": 0, "m": zeros,
            "v": {k: z.clone() for k, z in zeros.items()}}


def global_norm(tensors: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ over all tensors of Σ g²), in float32 (a 0-d tensor)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in tensors.values()))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict[str, Any]
                 ) -> Tuple[Mapping[str, torch.Tensor], Dict[str, Any],
                            Dict[str, Any]]:
    """One step: ``params`` and the moments in ``state`` are updated in
    place; returns ``(params, state, {"grad_norm", "lr"})``."""
    if set(grads) != set(params):
        raise KeyError(f"gradients for {sorted(grads)} do not match the "
                       f"parameters {sorted(params)}")
    step = state["step"] + 1
    lr = cfg.lr * (float(cfg.schedule(step)) if cfg.schedule is not None
                   else 1.0)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                         max=1.0) if cfg.clip_norm > 0 else None)
    b1c = 1.0 - cfg.b1 ** step
    b2c = 1.0 - cfg.b2 ** step
    for k, p in params.items():
        g = grads[k].float()
        if scale is not None:
            g = g * scale
        m, v = state["m"][k], state["v"][k]
        m.mul_(cfg.b1).add_(g * (1.0 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g) * (1.0 - cfg.b2))
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
