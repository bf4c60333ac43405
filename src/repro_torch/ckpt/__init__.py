"""Fault-tolerant checkpointing: atomic manifests and auto-resume, in the
reference's on-disk layout."""

from .checkpoint import (CheckpointManager, latest_checkpoint, load_pytree,
                         manifest_extra, save_pytree)

__all__ = ["CheckpointManager", "save_pytree", "load_pytree",
           "latest_checkpoint", "manifest_extra"]
