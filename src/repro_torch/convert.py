"""Carrying an AIDG across from the reference package.

In this system the AIDG plays the part that weights play in a model: the
graph the evaluators run on.  ``aidg_from_numpy`` rebuilds the port's
``AIDG`` from plain numpy arrays and dicts — the fields of any AIDG, for
instance the reference package's — so one graph can be fed to both.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .core.aidg.builder import AIDG

__all__ = ["ARRAY_FIELDS", "DICT_FIELDS", "aidg_from_numpy"]

# field -> dtype of the port's AIDG
ARRAY_FIELDS: Dict[str, type] = {
    "work": np.float32, "fu_lat": np.float32, "mem_lat": np.float32,
    "base": np.float32, "preds": np.int32, "pred_extra": np.float32,
    "op_class": np.int32, "op_scale": np.float32, "mem_words": np.float32,
}
DICT_FIELDS = ("storage_nodes", "storage_lat", "storage_slots", "classes")


def aidg_from_numpy(fields: Mapping[str, object]) -> AIDG:
    """``fields`` holds every name of ``ARRAY_FIELDS`` (array-likes) and
    ``DICT_FIELDS`` (dicts keyed by storage or class name); returns a fresh
    port ``AIDG`` that owns copies of them."""
    missing = [k for k in (*ARRAY_FIELDS, *DICT_FIELDS) if k not in fields]
    if missing:
        raise KeyError(f"aidg_from_numpy: missing fields {missing}")
    arr = {k: np.array(fields[k], dtype=dt) for k, dt in ARRAY_FIELDS.items()}
    n = arr["work"].shape[0]
    if arr["preds"].ndim != 2 or arr["preds"].shape != \
            arr["pred_extra"].shape or arr["preds"].shape[0] != n:
        raise ValueError(f"preds/pred_extra must both be (n={n}, P), got "
                         f"{arr['preds'].shape} and "
                         f"{arr['pred_extra'].shape}")
    return AIDG(
        n=n, **arr,
        storage_nodes={k: np.array(v, dtype=np.int64)
                       for k, v in fields["storage_nodes"].items()},
        storage_lat={k: np.array(v, dtype=np.float32)
                     for k, v in fields["storage_lat"].items()},
        storage_slots={k: int(v) for k, v in fields["storage_slots"].items()},
        classes={k: int(v) for k, v in fields["classes"].items()})
