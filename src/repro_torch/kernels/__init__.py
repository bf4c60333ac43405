"""Hand-written Hopper kernels (sources in ``repro_torch/csrc``), each with
its plain PyTorch version beside it: the max-plus matmul and matvec
(``maxplus``), online-softmax attention (``flash_attention``) and the
Mamba-1 selective scan (``selective_scan``).

Each module keeps its own ``LAUNCHES`` and ``PLAIN_CALLS`` counters, keyed
by kernel name, and a ``reset_counts``.  (The attention and scan wrappers
are reached through their modules, ``kernels.flash_attention.
flash_attention`` and ``kernels.selective_scan.selective_scan``, whose
names they share.)
"""

from . import flash_attention, maxplus, selective_scan
from .maxplus import (maxplus_matmul, maxplus_matmul_torch, maxplus_matvec,
                      maxplus_matvec_torch)

__all__ = ["maxplus_matmul", "maxplus_matvec", "maxplus_matmul_torch",
           "maxplus_matvec_torch", "flash_attention", "maxplus",
           "selective_scan"]
