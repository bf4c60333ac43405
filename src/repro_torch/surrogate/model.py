"""Monotone closed-form surrogate models for the packed oracle, in PyTorch.

The exact engines compute a cell's latency as a composition of ``max`` /
``sum`` / affine steps with nonnegative θ coefficients, so ``T(θ)`` is a
convex piecewise-linear, monotone-nondecreasing function of the knob
vector on the design box.  The surrogate mirrors that structure: per
cell, a *sum of softened maxima of affine functions*

``lat(θ) = Σ_g  τ_g · logsumexp_j[(a_gj + w_gj · θ) / τ_g]``,
``w = softplus(raw) ≥ 0``

(``G`` groups, ``J`` paths per group), so every prediction is monotone
nondecreasing in each knob for any parameter values.  Energy reuses the
engine's closed form with learned nonnegative coefficients:

``en(θ) = α · (1/θ) + β · lat(θ) + γ``,  ``α, β, γ ≥ 0``.

Both heads predict ratios relative to the θ = 1 reference machine.
Parameters are a dict of tensors; stacked parameters carry a leading
cell axis, and all cells train jointly
(:mod:`repro_torch.surrogate.train`).  The same closed form as the
reference's ``repro.surrogate.model``; random draws come from an explicit
``torch.Generator`` (the reference's JAX PRNG streams are not reproduced —
``convert.surrogate_params_from_numpy`` carries its parameters across).
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

__all__ = ["init_cell_params", "predict_rel", "predict_rel_cells",
           "init_stacked_params", "DEFAULT_GROUPS", "DEFAULT_PATHS"]

# Default surrogate shape: 4 composition groups x 8 affine paths covers
# the default matrix (single-operator cells use the spare groups as
# near-zero terms; deep network cells spread their run structure).
DEFAULT_GROUPS = 4
DEFAULT_PATHS = 8

_MIN_TAU = 1e-3       # LSE temperature floor (exact-max limit stays off)


def _inv_softplus(y: float) -> float:
    """The raw value whose softplus is ``y`` (for parameter init)."""
    return float(math.log(math.expm1(max(y, 1e-6))))


def init_stacked_params(gen: torch.Generator, n_cells: int, n_knobs: int,
                        groups: int = DEFAULT_GROUPS,
                        paths: int = DEFAULT_PATHS
                        ) -> Dict[str, torch.Tensor]:
    """Fresh per-cell parameters stacked along a leading cell axis, on the
    generator's device, initialized so the latency head predicts ≈ 1 at
    θ = 1 (each group contributes ≈ 1/G and path weights start near
    ``1 / (G · K)``) with small seeded jitter to break path symmetry."""
    S, G, J, K = n_cells, groups, paths, n_knobs
    dev = gen.device
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev,
                                       dtype=torch.float32)
    full = lambda shape, v: torch.full(shape, v, dtype=torch.float32,
                                       device=dev)
    return {
        "a": 0.02 * randn(S, G, J),
        "w_raw": _inv_softplus(1.0 / (G * K)) + 0.25 * randn(S, G, J, K),
        "tau_raw": full((S, G), _inv_softplus(0.05)),
        "alpha_raw": _inv_softplus(0.1 / K) + 0.1 * randn(S, K),
        "beta_raw": full((S,), _inv_softplus(0.5)),
        "gamma_raw": full((S,), _inv_softplus(0.1)),
    }


def init_cell_params(gen: torch.Generator, n_knobs: int,
                     groups: int = DEFAULT_GROUPS,
                     paths: int = DEFAULT_PATHS) -> Dict[str, torch.Tensor]:
    """Fresh single-cell parameters (:func:`init_stacked_params` for one
    cell, the cell axis dropped)."""
    return {k: v[0] for k, v in init_stacked_params(
        gen, 1, n_knobs, groups, paths).items()}


def predict_rel_cells(params: Dict[str, torch.Tensor], kt: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked-cell forward pass: params carry a leading cell axis S, the
    ``(B, K)`` candidate batch is shared -> ``((S, B) latency ratios,
    (S, B) energy ratios)``, every cell in one batched einsum."""
    kt = torch.as_tensor(kt, dtype=torch.float32,
                         device=params["a"].device)
    w = F.softplus(params["w_raw"])                   # (S, G, J, K) >= 0
    tau = F.softplus(params["tau_raw"]) + _MIN_TAU    # (S, G)
    # affine paths: (S, B, G, J) = a + kt . w
    z = params["a"][:, None] + torch.einsum("bk,sgjk->sbgj", kt, w)
    lat = (tau[:, None, :]
           * torch.logsumexp(z / tau[:, None, :, None], dim=3)).sum(dim=2)
    alpha = F.softplus(params["alpha_raw"])           # (S, K) >= 0
    beta = F.softplus(params["beta_raw"])             # (S,)
    gamma = F.softplus(params["gamma_raw"])
    en = torch.einsum("bk,sk->sb", 1.0 / kt, alpha) \
        + beta[:, None] * lat + gamma[:, None]
    return lat, en


def predict_rel(params: Dict[str, torch.Tensor], kt: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cell's forward pass: ``(B, K)`` knob candidates → ``((B,)
    latency ratio, (B,) energy ratio)`` relative to θ = 1.  Monotone
    nondecreasing in every knob for any parameter values (``softplus``
    weights); the energy head's ``α/θ`` term falls and its ``β · lat``
    term rises with θ, like the exact objective."""
    lat, en = predict_rel_cells({k: v[None] for k, v in params.items()},
                                kt)
    return lat[0], en[0]
