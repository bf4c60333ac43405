"""Operator mapping: DNN operators -> ACADL instruction streams (paper §5)."""

from .gemm import (gamma_gemm, init_gemm_memory, oma_gemm_looped,
                   oma_gemm_unrolled, read_gemm_result)
from .systolic import (init_systolic_memory, read_systolic_result,
                       systolic_gemm_program)
from .workload import (OperatorCall, UMA_REGISTRY, extract_operators,
                       map_to_gamma, map_to_tpu, register_operator)
from .conv import eyeriss_conv2d, init_conv_memory, read_conv_result
from .patterns import (init_vector_memory, plasticine_map_reduce,
                       read_scalar)
from .fused import gamma_attention, gamma_scan

__all__ = [
    "oma_gemm_looped", "oma_gemm_unrolled", "gamma_gemm",
    "init_gemm_memory", "read_gemm_result",
    "systolic_gemm_program", "init_systolic_memory", "read_systolic_result",
    "OperatorCall", "extract_operators", "map_to_tpu", "map_to_gamma",
    "UMA_REGISTRY", "register_operator",
    "eyeriss_conv2d", "init_conv_memory", "read_conv_result",
    "plasticine_map_reduce", "init_vector_memory", "read_scalar",
    "gamma_attention", "gamma_scan",
]
