"""Learning-rate schedules (multipliers on the base lr), as functions of the
host-side int step (the port's ``AdamWConfig.schedule``).

The reference's arithmetic in float32, step for step: a value here is
the reference's ``jnp`` value (``cos`` aside, which two float32 libraries
may round one ulp apart), returned as a Python float.
"""

from __future__ import annotations

import numpy as np

__all__ = ["cosine_schedule", "linear_warmup_cosine"]

_F = np.float32


def cosine_schedule(total_steps: int, final_frac: float = 0.1):
    def f(step: int) -> float:
        t = np.clip(_F(step) / _F(total_steps), _F(0.0), _F(1.0))
        cos = np.cos(_F(np.pi) * t)
        return float(_F(final_frac)
                     + _F((1 - final_frac) * 0.5) * (_F(1) + cos))
    return f


def linear_warmup_cosine(warmup_steps: int, total_steps: int,
                         final_frac: float = 0.1):
    cos = cosine_schedule(max(1, total_steps - warmup_steps), final_frac)

    def f(step: int) -> float:
        if step < warmup_steps:
            return float(_F(step) / _F(max(1, warmup_steps)))
        return cos(step - warmup_steps)
    return f
