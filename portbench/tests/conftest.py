"""Shared fixtures of the benchmark's own tests (run them with
``python -m pytest portbench/tests`` from the repository's root)."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=4, vocab_size=256)


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none (decided here, at run
    time, never while the module is imported)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; torch.cuda.is_available() is "
                    "false")
    return torch.device("cuda", 0)


@pytest.fixture
def bench():
    from portbench import manifest
    return manifest.Manifest()


def tiny_cell(bench, cell_name):
    """(cell, configuration, traffic) of a cell cut to a few thousand
    parameters and positions, for a run on the CPU."""
    cell = bench.cell(cell_name)
    conf = dict(bench.config(cell.config), **TINY)
    if conf.get("n_patches"):
        conf["n_patches"] = 8
    traffic = bench.traffic(cell.traffic)
    if traffic["driver"] == "train":
        traffic.update(batch=2, seq_len=64)
    else:
        b = min(traffic["batch"], 4)
        traffic.update(batch=b if b > 1 else 1, prompt_tokens=56,
                       prompt_pool=4 * b, image_pool=4 * b)
    return cell, conf, traffic
