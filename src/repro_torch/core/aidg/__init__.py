"""AIDG: Architectural Instruction Dependency Graph fast estimation —
numpy exact path (``builder``, copied from the reference), PyTorch
max-plus engines (``maxplus``), DSE sweeps, network stacks and the packed
matrix (``dse``) and the Explorer."""

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
    fixed_point_torch,
    longest_path_blocked,
    longest_path_condensed,
    longest_path_scan,
    longest_path_wavefront,
    maxplus_closure,
    maxplus_matmul_torch,
    slot_queue_scan,
)
from .dse import (DSEProblem, PackedMatrix, compiled_sweep, evaluate_theta,
                  make_problem, sweep)
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
    "longest_path_condensed", "fixed_point_torch", "fixed_point_batch",
    "maxplus_closure", "maxplus_matmul_torch", "slot_queue_scan",
    "DSEProblem", "PackedMatrix", "make_problem", "evaluate_theta",
    "compiled_sweep", "sweep",
    "Scenario", "CompiledScenario", "default_scenarios", "compile_scenario",
    "clear_scenario_cache", "Knob", "DesignSpace", "DEFAULT_SPACE",
    "grid_candidates", "random_candidates", "pareto_front",
    "Explorer", "ExplorationResult",
]
