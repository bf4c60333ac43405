"""Network-level mapping: lower whole DNNs onto ACADL accelerators.

The layer-graph frontend (``graph``) expands a model config into its
ordered per-layer operator sequence, the lowering table (``lowering``)
maps each operator onto every modeled architecture via the existing
``repro_torch.core.mapping`` builders, and the model layer (``model``) composes
the per-layer AIDG makespans in max-plus — sequentially or with
capacity-bounded double-buffered pipelining — and plugs the result into
the DSE stack as first-class Explorer cells (``Explorer(networks=True)``).

See ``docs/networks.md`` for the pipeline walkthrough and measured
numbers.
"""

from .graph import (LayerGraph, LayerInstance, NETWORK_SHAPE,
                    extract_layer_graph)
from .lowering import (ARCH_CAPACITY_WORDS, ARCH_TILE_TOL, LoweredLayer,
                       lower_call, lowerable_ops)
from .model import (CompiledNetwork, NETWORKS, NETWORK_ARCHS,
                    NetworkScenario, default_network_scenarios)

__all__ = [
    "LayerGraph", "LayerInstance", "NETWORK_SHAPE", "extract_layer_graph",
    "ARCH_CAPACITY_WORDS", "ARCH_TILE_TOL", "LoweredLayer", "lower_call",
    "lowerable_ops", "CompiledNetwork", "NETWORKS", "NETWORK_ARCHS",
    "NetworkScenario", "default_network_scenarios",
]
