"""Hand-written Hopper kernels (sources in ``repro_torch/csrc``), each with
its plain PyTorch version beside it: the max-plus matmul and matvec
(``maxplus``), online-softmax attention (``flash_attention``), the Mamba-1
selective scan (``selective_scan``) and the dense GEMM with a fused ReLU
(``systolic_gemm``).  ``ops`` holds the reference's four public wrappers
and ``ref`` its plain oracles, as ``repro.kernels`` exports them.

Each kernel module keeps its own ``LAUNCHES`` and ``PLAIN_CALLS``
counters, keyed by kernel name, and a ``reset_counts``.  (The attention,
scan and GEMM wrappers are reached through their modules, e.g.
``kernels.systolic_gemm.systolic_gemm``, or through ``ops``.)
"""

from . import (flash_attention, maxplus, ops, ref, selective_scan,
               systolic_gemm)
from .maxplus import (maxplus_matmul, maxplus_matmul_torch, maxplus_matvec,
                      maxplus_matvec_torch)

__all__ = ["ops", "ref", "maxplus_matmul", "maxplus_matvec",
           "maxplus_matmul_torch", "maxplus_matvec_torch", "flash_attention",
           "maxplus", "selective_scan", "systolic_gemm"]
