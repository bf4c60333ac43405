"""The surrogate tier of the staged oracle hierarchy, in PyTorch.

``surrogate → packed → wavefront → event sim``: tiny monotone closed-form
models (:mod:`repro_torch.surrogate.model`) distilled from the packed
oracle's sweep outputs (:mod:`repro_torch.surrogate.train`), predicting
per-cell latency AND energy with calibrated per-cell confidence bounds.
``repro_torch.serve`` answers from this tier when every queried cell's
bound clears the service threshold and falls back to the packed dispatch
otherwise.
"""

from .model import (DEFAULT_GROUPS, DEFAULT_PATHS, init_cell_params,
                    init_stacked_params, predict_rel, predict_rel_cells)
from .train import (SurrogateBundle, SurrogateConfig, evaluate_surrogate,
                    train_surrogate)

__all__ = [
    "DEFAULT_GROUPS", "DEFAULT_PATHS", "init_cell_params",
    "init_stacked_params", "predict_rel", "predict_rel_cells",
    "SurrogateBundle", "SurrogateConfig", "evaluate_surrogate",
    "train_surrogate",
]
