"""Dynamic-energy folding: per-op-class coefficients -> per-knob vectors.

The energy objective is evaluated *inside* the packed latency trace (see
``dse.PackedMatrix``), which never materializes per-node arrays — so the
coefficients must be pre-folded to the same granularity the trace works
at: one dynamic-energy scalar per design-space knob.  That fold is exact
because instruction counts are θ-independent:

    E_dyn(θ) = Σ_k edyn[k] / θ_k        (DVFS-style: faster units burn
                                         more energy per issued op)
    E(θ)     = E_dyn(θ) + P_static · T(θ)

``fold_dyn_energy`` computes ``edyn`` (a ``(n_knobs + 1,)`` vector, last
column the identity knob) for one per-layer problem by

* counting instructions per op class — through
  ``CondensedAIDG.op_class_counts`` (absorbed nodes) plus a bincount over
  the kept nodes when a condensation is supplied, or a plain bincount
  over the raw AIDG otherwise; absorbed ∪ kept = all nodes, so both
  routes produce identical integer counts — pinned by
  ``tests/test_energy.py``;
* crediting per-storage word traffic (``AIDG.mem_words``) to the knob
  scaling that storage, mirroring ``CompiledScenario.accumulate_weights``
  (storage accessors are never absorbed, so this is condensation-
  invariant).

``energy_bottleneck_report`` is the ZigZag-style read of the same data:
storage-node traffic x per-level access energy, grouped by storage class
— where the joules go, before any θ search.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..archs.energy import EnergyModel, energy_model

__all__ = ["fold_dyn_energy", "energy_bottleneck_report"]


def fold_dyn_energy(prob, proj, n_knobs: int, model: EnergyModel,
                    cond=None) -> np.ndarray:
    """(n_knobs + 1,) dynamic pJ per knob for one problem at θ = 1.

    ``proj`` is the design-space projection ``(op_idx, st_idx)`` mapping
    op-class / storage-class ids to knob columns (value ``n_knobs`` = the
    identity column).  With ``cond`` (a ``CondensedAIDG``) the op counts
    are reassembled from the condensed representation — super-edge count
    vectors plus the kept nodes — instead of the raw node array.
    """
    a = prob.aidg
    op_idx = np.asarray(proj[0], np.int64)
    st_idx = np.asarray(proj[1], np.int64)
    n_cls = max(1, len(a.classes))
    if cond is not None:
        counts = np.zeros(n_cls, np.int64)
        occ = cond.op_class_counts()
        if occ.size:
            counts += occ.sum(axis=0)
        counts += np.bincount(a.op_class[cond.kept], minlength=n_cls)
    else:
        counts = np.bincount(a.op_class, minlength=n_cls)

    edyn = np.zeros(n_knobs + 1, np.float64)
    for name, cid in a.classes.items():
        edyn[int(op_idx[cid])] += float(counts[cid]) * model.op_pj(name)
    for st_name, cid in prob.node_storage.items():
        words = float(a.mem_words[a.storage_nodes[st_name]].sum())
        edyn[int(st_idx[cid])] += words * model.word_pj(st_name)
    return edyn


def _cell_problems(cell) -> Tuple[Sequence, np.ndarray]:
    """(problems, per-problem composition weight) of any matrix cell."""
    if hasattr(cell, "stack"):          # CompiledNetwork
        return cell.stack.problems, np.asarray(cell.reps_per_layer,
                                               np.float64)
    return (cell.problem,), np.ones(1, np.float64)


def energy_bottleneck_report(cell, model: Optional[EnergyModel] = None
                             ) -> List[Dict[str, object]]:
    """Per-memory-level energy bottlenecks of one matrix cell (à la
    ZigZag): storage-node word traffic x per-level access energy, grouped
    by storage class, sorted by energy descending.

    Works on any cell implementing the Explorer protocol — operator cells
    (one problem) and network cells (unique tile problems weighted by
    their composed instance counts).  Rows carry ``storage_class``,
    the member ``storages``, total ``words`` moved, ``pj_per_word``, the
    class ``energy_pj`` and its ``share`` of the cell's total access
    energy.
    """
    model = model or energy_model(cell.arch)
    probs, reps = _cell_problems(cell)
    words_by_cls: Dict[str, float] = {}
    names_by_cls: Dict[str, set] = {}
    for prob, r in zip(probs, reps):
        a = prob.aidg
        for st_name in prob.node_storage:
            cls = model.storage_class(st_name)
            w = float(a.mem_words[a.storage_nodes[st_name]].sum()) * float(r)
            words_by_cls[cls] = words_by_cls.get(cls, 0.0) + w
            names_by_cls.setdefault(cls, set()).add(st_name)
    rows = []
    for cls, words in words_by_cls.items():
        pj = float(model.word_table[cls])
        rows.append({"storage_class": cls,
                     "storages": tuple(sorted(names_by_cls[cls])),
                     "words": words, "pj_per_word": pj,
                     "energy_pj": words * pj})
    total = sum(r["energy_pj"] for r in rows) or 1.0
    for r in rows:
        r["share"] = r["energy_pj"] / total
    rows.sort(key=lambda r: -r["energy_pj"])
    return rows
