"""Optimizer substrate of the port: AdamW with schedules and global-norm
clipping over dicts of tensors (the reference's ``optim.adamw``).

The reference's ``optim.schedule`` and ``optim.compress`` (cross-pod
gradient compression) belong to the LM training substrate and are not
ported yet (ROADMAP.md, queue A10).
"""

from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm"]
