"""AIDG: Architectural Instruction Dependency Graph fast estimation —
numpy exact path (``builder``, copied from the reference), PyTorch
max-plus engines and their τ-soft family (``maxplus``), DSE sweeps,
network stacks, the packed matrix and their gradients (``dse``), the
Explorer and the gradient search (``gradient``)."""

from .builder import (
    AIDG,
    CompiledAIDG,
    CondensedAIDG,
    LevelSchedule,
    build_aidg,
    compile_aidg,
    compute_level_schedule,
    condense_aidg,
    estimate_cycles,
    longest_path,
    longest_path_fixed_point,
)
from .maxplus import (
    DEFAULT_ENGINE,
    ENGINES,
    fixed_point_batch,
    fixed_point_soft,
    fixed_point_torch,
    longest_path_blocked,
    longest_path_condensed,
    longest_path_scan,
    longest_path_soft,
    longest_path_wavefront,
    maxplus_closure,
    maxplus_matmul_torch,
    slot_queue_scan,
    slot_queue_soft,
    softmax_reduce,
    softmaximum,
)
from .dse import (DSEProblem, PackedMatrix, compiled_sweep, evaluate_theta,
                  evaluate_theta_soft, grad_sweep, make_problem, sweep)
from .gradient import GradientExplorer, GradientResult
from .explorer import (
    DEFAULT_SPACE,
    CompiledScenario,
    DesignSpace,
    ExplorationResult,
    Explorer,
    Knob,
    Scenario,
    clear_scenario_cache,
    compile_scenario,
    default_scenarios,
    grid_candidates,
    pareto_front,
    random_candidates,
)

__all__ = [
    "AIDG", "CompiledAIDG", "CondensedAIDG", "LevelSchedule", "build_aidg",
    "compile_aidg", "compute_level_schedule", "condense_aidg",
    "estimate_cycles", "longest_path", "longest_path_fixed_point",
    "ENGINES", "DEFAULT_ENGINE",
    "longest_path_wavefront", "longest_path_scan", "longest_path_blocked",
    "longest_path_condensed", "longest_path_soft", "fixed_point_torch",
    "fixed_point_batch", "fixed_point_soft", "maxplus_closure",
    "maxplus_matmul_torch",
    "slot_queue_scan", "slot_queue_soft", "softmaximum", "softmax_reduce",
    "DSEProblem", "PackedMatrix", "make_problem", "evaluate_theta",
    "evaluate_theta_soft", "grad_sweep", "compiled_sweep", "sweep",
    "GradientExplorer", "GradientResult",
    "Scenario", "CompiledScenario", "default_scenarios", "compile_scenario",
    "clear_scenario_cache", "Knob", "DesignSpace", "DEFAULT_SPACE",
    "grid_candidates", "random_candidates", "pareto_front",
    "Explorer", "ExplorationResult",
]
