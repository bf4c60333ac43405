"""Data pipeline: deterministic, resumable, per-host sharded token streams."""

from .pipeline import (DataConfig, TokenPipeline, memmap_source,
                       synthetic_source)

__all__ = ["DataConfig", "TokenPipeline", "synthetic_source", "memmap_source"]
