"""Hand-written Hopper kernels (sources in ``repro_torch/csrc``), each with
its plain PyTorch version beside it.  Ported so far: the max-plus matmul
and matvec (``maxplus``)."""

from .maxplus import (LAUNCHES, PLAIN_CALLS, maxplus_matmul, maxplus_matmul_torch,
                      maxplus_matvec, maxplus_matvec_torch, reset_counts)

__all__ = ["LAUNCHES", "PLAIN_CALLS", "maxplus_matmul", "maxplus_matvec",
           "maxplus_matmul_torch", "maxplus_matvec_torch", "reset_counts"]
