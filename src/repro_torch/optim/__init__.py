"""Optimizer substrate of the port: AdamW with schedules, global-norm
clipping, and gradient compression for the cross-pod all-reduce, over
dicts of tensors (the reference's ``optim``).

Master weights stay in the params dtype (float32 by default); the
schedules are functions of the host-side int step.
"""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule, linear_warmup_cosine
from .compress import (compress_bf16, compress_int8, decompress_int8,
                       error_feedback_update)

__all__ = [
    "AdamWConfig", "adamw_init", "adamw_update", "global_norm",
    "cosine_schedule", "linear_warmup_cosine",
    "compress_bf16", "compress_int8", "decompress_int8",
    "error_feedback_update",
]
