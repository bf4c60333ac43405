"""Train and calibrate the surrogate tier on packed-oracle sweeps, in
PyTorch.

The pipeline (driven by one fixed seed, so artifacts are reproducible):

1. **Sample** — log-uniform knob candidates over the design box
   (``random_candidates``, row 0 = θ = 1), evaluated by the packed
   oracle's sweep export (:meth:`PackedMatrix.export_training_table`):
   one evaluation of every cell × every sample, both objectives.
2. **Fit** — every cell's monotone closed form
   (:mod:`repro_torch.surrogate.model`) trains *jointly* as one stacked
   dict of tensors: ``cfg.steps`` AdamW steps (``repro_torch.optim``) by
   autograd on the explorer's device, minimizing mean squared *relative*
   error of both heads against the baseline-normalized sweep outputs.
3. **Calibrate** — residual quantiles on a held-out split become each
   cell's stated confidence bound: ``err_bound = margin · q(residuals)``.
   The serving tier answers from the surrogate only where that bound
   clears its threshold.

The :class:`SurrogateBundle` is the deployable artifact: stacked
parameters (numpy), per-cell baselines, calibrated bounds, and
denormalizing predictors — savable to one ``.npz`` in the same format as
the reference's bundle, so a bundle saved by either package loads in the
other.
"""

from __future__ import annotations

import json
import math
from dataclasses import asdict, dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..optim.adamw import AdamWConfig, adamw_init, adamw_update
from .model import (DEFAULT_GROUPS, DEFAULT_PATHS, _MIN_TAU,
                    init_stacked_params, predict_rel_cells)

__all__ = ["SurrogateConfig", "SurrogateBundle", "train_surrogate",
           "evaluate_surrogate"]


def _np_softplus(x: np.ndarray) -> np.ndarray:
    """Overflow-stable host-side softplus (float32 in, float32 out)."""
    return np.logaddexp(np.float32(0.0), x, dtype=np.float32)


@dataclass(frozen=True)
class SurrogateConfig:
    """Training/calibration hyperparameters (all defaults fixed-seed
    reproducible).  ``n_samples`` log-uniform sweep draws (row 0 = θ = 1)
    split ``holdout`` to the calibration set; ``steps`` AdamW steps at
    ``lr`` with cosine decay; ``quantile`` × ``bound_margin`` turn
    held-out residuals into each cell's stated confidence bound;
    ``chunk`` bounds the export's device batch (memory cap)."""

    groups: int = DEFAULT_GROUPS
    paths: int = DEFAULT_PATHS
    n_samples: int = 192
    holdout: float = 0.25
    steps: int = 1500
    lr: float = 0.03
    seed: int = 0
    quantile: float = 0.95
    bound_margin: float = 1.5
    chunk: Optional[int] = 64


class SurrogateBundle:
    """The trained surrogate tier for one served matrix: stacked per-cell
    parameters, θ = 1 baselines (denormalization), and the calibrated
    per-cell confidence bounds the staged router checks.

    ``predict_full`` mirrors ``PackedMatrix.evaluate_full`` — ``(B, K)``
    candidates → ``((B, S) cycles, (B, S) energy pJ)`` — as a pure NumPy
    closed form on the host.  That is the tier's design, as in the
    reference, not a fallback to the CPU: a few tens of thousands of flops
    with NO device dispatch, where a device call would cost more in
    launches and copies than the whole prediction."""

    def __init__(self, cell_names: Sequence[str], knob_names: Sequence[str],
                 params: Dict[str, np.ndarray], cycles_base: np.ndarray,
                 energy_base: np.ndarray, err_latency: np.ndarray,
                 err_energy: np.ndarray, err_bound: np.ndarray,
                 meta: Optional[Dict] = None):
        self.cell_names = tuple(cell_names)
        self.knob_names = tuple(knob_names)
        self.params = {k: np.asarray(v, np.float32)
                       for k, v in params.items()}
        self.cycles_base = np.asarray(cycles_base, np.float64)
        self.energy_base = np.asarray(energy_base, np.float64)
        self.err_latency = np.asarray(err_latency, np.float64)
        self.err_energy = np.asarray(err_energy, np.float64)
        self.err_bound = np.asarray(err_bound, np.float64)
        self.meta = dict(meta or {})
        # serving-path fast weights: softplus applied once, host numpy
        p = self.params
        self._np_a = p["a"]                                   # (S, G, J)
        self._np_w = _np_softplus(p["w_raw"])                 # (S, G, J, K)
        self._np_tau = _np_softplus(p["tau_raw"]) + _MIN_TAU  # (S, G)
        self._np_alpha = _np_softplus(p["alpha_raw"])         # (S, K)
        self._np_beta = _np_softplus(p["beta_raw"])           # (S,)
        self._np_gamma = _np_softplus(p["gamma_raw"])         # (S,)

    # -- shape ---------------------------------------------------------------

    @property
    def n_cells(self) -> int:
        """Matrix cells this bundle predicts (leading params axis)."""
        return len(self.cell_names)

    @property
    def n_knobs(self) -> int:
        """Design-space knobs the surrogate was trained over."""
        return len(self.knob_names)

    # -- prediction ----------------------------------------------------------

    def predict_rel(self, knob_thetas: np.ndarray
                    ) -> Tuple[np.ndarray, np.ndarray]:
        """``(B, K)`` candidates → ``((B, S), (B, S))`` latency/energy
        ratios relative to the θ = 1 reference machine.  Pure host
        NumPy — the closed form of :func:`repro_torch.surrogate.model
        .predict_rel_cells`, float32 throughout."""
        kt = np.atleast_2d(np.asarray(knob_thetas, np.float32))
        # affine paths: (S, B, G, J) = a + kt . softplus(w)
        z = (self._np_a[:, None]
             + np.einsum("bk,sgjk->sbgj", kt, self._np_w))
        # stable logsumexp over the path axis, temperature per (S, G)
        zt = z / self._np_tau[:, None, :, None]
        m = zt.max(axis=3, keepdims=True)
        lse = np.squeeze(m, 3) + np.log(
            np.exp(zt - m).sum(axis=3, dtype=np.float32))
        lat = (self._np_tau[:, None, :] * lse).sum(axis=2)    # (S, B)
        en = ((1.0 / kt) @ self._np_alpha.T).T \
            + self._np_beta[:, None] * lat + self._np_gamma[:, None]
        return (lat.T.astype(np.float32, copy=False),
                en.T.astype(np.float32, copy=False))

    def predict_full(self, knob_thetas: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray]:
        """``(B, K)`` candidates → ``((B, S) cycles, (B, S) energy pJ)``
        — the surrogate's drop-in analogue of the packed oracle's
        ``evaluate_full``, denormalized by the recorded baselines."""
        lat, en = self.predict_rel(knob_thetas)
        return (np.asarray(lat * self.cycles_base[None, :], np.float32),
                np.asarray(en * self.energy_base[None, :], np.float32))

    # -- confidence ----------------------------------------------------------

    def confident(self, cols: Optional[Sequence[int]] = None,
                  max_err: float = 0.02) -> bool:
        """Whether EVERY cell in ``cols`` (default: all) carries a stated
        confidence bound at or under ``max_err`` — the staged router's
        per-cell threshold check."""
        b = self.err_bound if cols is None \
            else self.err_bound[np.asarray(cols, np.int64)]
        return bool(b.size) and bool(np.all(b <= max_err))

    # -- persistence ---------------------------------------------------------

    def save(self, path) -> None:
        """Serialize to one ``.npz`` (parameters, baselines, bounds, and
        a JSON metadata record) — ``load`` restores an identical bundle."""
        flat = {f"param.{k}": np.asarray(v) for k, v in self.params.items()}
        np.savez(
            path, **flat,
            cycles_base=self.cycles_base, energy_base=self.energy_base,
            err_latency=self.err_latency, err_energy=self.err_energy,
            err_bound=self.err_bound,
            cell_names=np.asarray(self.cell_names),
            knob_names=np.asarray(self.knob_names),
            meta=np.asarray(json.dumps(self.meta)))

    @classmethod
    def load(cls, path) -> "SurrogateBundle":
        """Restore a bundle saved by :meth:`save` (or by the reference's
        ``SurrogateBundle.save``: the format is the same)."""
        with np.load(path, allow_pickle=False) as z:
            params = {k[len("param."):]: np.asarray(z[k])
                      for k in z.files if k.startswith("param.")}
            return cls(
                cell_names=[str(s) for s in z["cell_names"]],
                knob_names=[str(s) for s in z["knob_names"]],
                params=params, cycles_base=z["cycles_base"],
                energy_base=z["energy_base"],
                err_latency=z["err_latency"], err_energy=z["err_energy"],
                err_bound=z["err_bound"],
                meta=json.loads(str(z["meta"])))


def _fit(params: Dict[str, torch.Tensor], kt: np.ndarray, y_lat: np.ndarray,
         y_en: np.ndarray, cfg: SurrogateConfig
         ) -> Tuple[Dict[str, np.ndarray], np.ndarray]:
    """Joint fit of all cells from the stacked initial ``params`` (tensors
    on the device to train on; not modified): ``cfg.steps`` AdamW steps
    minimizing the mean over cells of the mean squared relative error of
    both heads, under a cosine schedule, clip 1.0, no weight decay.
    Returns the fitted parameters as numpy and the loss of every step."""
    dev = params["a"].device
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in params.items()}
    ktt = torch.as_tensor(kt, dtype=torch.float32, device=dev)
    yl = torch.as_tensor(y_lat.T, dtype=torch.float32, device=dev)  # (S, N)
    ye = torch.as_tensor(y_en.T, dtype=torch.float32, device=dev)
    total = max(1, cfg.steps)
    opt = AdamWConfig(
        lr=cfg.lr, weight_decay=0.0, clip_norm=1.0,
        schedule=lambda step: 0.5 * (1.0 + math.cos(
            math.pi * min(step / total, 1.0))))
    state = adamw_init(p)
    losses = torch.empty(cfg.steps, dtype=torch.float32, device=dev)
    for i in range(cfg.steps):
        pl, pe = predict_rel_cells(p, ktt)
        loss = (torch.square((pl - yl) / yl).mean(dim=1)
                + torch.square((pe - ye) / ye).mean(dim=1)).mean()
        grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
        adamw_update(opt, p, grads, state)
        losses[i] = loss.detach()
    return ({k: v.detach().cpu().numpy() for k, v in p.items()},
            losses.cpu().numpy())


def _rel_err(pred: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """Elementwise |pred − truth| / truth (truth is strictly positive —
    cycle counts and pJ)."""
    return np.abs(pred - truth) / np.maximum(np.abs(truth), 1e-12)


def train_surrogate(explorer, config: Optional[SurrogateConfig] = None
                    ) -> SurrogateBundle:
    """Train + calibrate a :class:`SurrogateBundle` for ``explorer``'s
    packed matrix (the module-docstring pipeline), on the explorer's
    device.  Deterministic given ``config.seed`` (the initial parameters
    come from a CPU ``torch.Generator`` seeded with it, so every device
    starts from the same ones); the explorer must use the packed engine
    (it is the training oracle)."""
    from ..core.aidg.explorer import random_candidates

    cfg = config or SurrogateConfig()
    pm = explorer.packed_matrix()
    kt = random_candidates(explorer.space, cfg.n_samples, seed=cfg.seed)
    table = pm.export_training_table(kt, chunk=cfg.chunk)
    y_lat = table["cycles"] / table["cycles_base"][None, :]
    y_en = table["energy"] / table["energy_base"][None, :]

    # held-out split: seeded permutation of the non-reference rows (the
    # θ = 1 row always trains — the bundle must be anchored at 1.0)
    n = kt.shape[0]
    rng = np.random.default_rng(cfg.seed + 1)
    perm = 1 + rng.permutation(n - 1)
    n_hold = max(1, int(round(cfg.holdout * n)))
    hold, tr = perm[:n_hold], np.concatenate([[0], perm[n_hold:]])

    gen = torch.Generator().manual_seed(cfg.seed)
    init = init_stacked_params(gen, y_lat.shape[1], kt.shape[1],
                               cfg.groups, cfg.paths)
    params, _ = _fit({k: v.to(explorer.device) for k, v in init.items()},
                     kt[tr], y_lat[tr], y_en[tr], cfg)

    # calibration: held-out residual quantiles -> stated per-cell bounds
    dev = explorer.device
    with torch.no_grad():
        pl, pe = predict_rel_cells(
            {k: torch.from_numpy(v).to(dev) for k, v in params.items()},
            torch.from_numpy(kt[hold]).to(dev))
    e_lat = _rel_err(pl.cpu().numpy().T, y_lat[hold])   # (H, S)
    e_en = _rel_err(pe.cpu().numpy().T, y_en[hold])
    q_lat = np.quantile(e_lat, cfg.quantile, axis=0)
    q_en = np.quantile(e_en, cfg.quantile, axis=0)
    bound = cfg.bound_margin * np.maximum(q_lat, q_en)

    names = [cs.name for cs in explorer.compiled]
    return SurrogateBundle(
        cell_names=names, knob_names=explorer.space.names, params=params,
        cycles_base=table["cycles_base"], energy_base=table["energy_base"],
        err_latency=q_lat, err_energy=q_en, err_bound=bound,
        meta={"config": asdict(cfg), "n_train": int(tr.size),
              "n_holdout": int(hold.size)})


def evaluate_surrogate(bundle: SurrogateBundle, explorer, n: int = 48,
                       seed: int = 1234) -> Dict[str, object]:
    """Fresh-sample evaluation report: ``n`` seeded draws the training
    never saw, scored against the packed oracle.  Returns per-cell
    relative-error arrays plus the matrix-wide medians and the per-cell
    within-stated-bound coverage."""
    from ..core.aidg.explorer import random_candidates

    kt = random_candidates(explorer.space, n, seed=seed,
                           include_baseline=False)
    cyc, en = explorer.evaluate_full(kt)
    p_cyc, p_en = bundle.predict_full(kt)
    e_lat = _rel_err(np.asarray(p_cyc, np.float64),
                     np.asarray(cyc, np.float64))       # (n, S)
    e_en = _rel_err(np.asarray(p_en, np.float64),
                    np.asarray(en, np.float64))
    cover = np.mean(e_lat <= bundle.err_bound[None, :], axis=0)
    return {
        "err_latency": e_lat, "err_energy": e_en,
        "median_latency_err": float(np.median(e_lat)),
        "median_energy_err": float(np.median(e_en)),
        "bound_coverage": cover,
        "cells": list(bundle.cell_names),
    }
