"""The system under test: the port's ``ModelConfig`` for a configuration
file, and the port's LM built over weights this benchmark made.  The only
file of the yardstick besides the drivers that imports ``repro_torch``."""

from __future__ import annotations

import sys

from .manifest import ROOT

_SRC = str(ROOT / "src")


def _on_path() -> None:
    if _SRC not in sys.path:
        sys.path.insert(0, _SRC)


def model_config(conf: dict, name: str):
    """The port's ``ModelConfig`` of a decoder-only LM configuration file."""
    _on_path()
    from repro_torch.models.config import AttentionConfig, ModelConfig
    from .seeded import dims
    s = dims(conf)
    act = {"silu": "silu", "gelu_pytorch_tanh": "gelu"}[conf["hidden_act"]]
    return ModelConfig(
        arch_id=name,
        family="vlm" if s["patches"] else "dense",
        n_layers=s["layers"], d_model=s["d"], d_ff=s["ff"],
        vocab_size=s["vocab"],
        attention=AttentionConfig(
            kind="gqa", n_heads=s["heads"], n_kv_heads=s["kv_heads"],
            head_dim=s["head_dim"], window=conf.get("window", 0),
            rope_theta=float(conf["rope_theta"])),
        norm=conf["norm"], activation=act,
        tie_embeddings=bool(conf.get("tie_word_embeddings", False)),
        n_patches=s["patches"],
        param_dtype=conf["param_dtype"],
        compute_dtype=conf["compute_dtype"],
        source=conf["source"])


def lm(cfg, flat: dict, conf: dict):
    """The port's ``LM`` over the tensors in ``flat`` (no copies)."""
    _on_path()
    from repro_torch.models.lm import LM
    from .seeded import tree
    return LM(cfg, tree(flat, conf))
