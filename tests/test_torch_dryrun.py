"""The dry run in the port: abstract parameters, training state and input
specs as ``meta`` tensors, held against the reference's
``jax.ShapeDtypeStruct``s (``jax.eval_shape``) at every arch's full size.

For every arch: ``Model.abstract_params`` and
``launch.steps.abstract_train_state`` have the reference's leaves, shapes
and dtypes, and every leaf is on the ``meta`` device.  For every arch x
``SHAPES`` cell that ``cell_is_runnable`` admits (both packages admit the
same cells): ``input_specs`` likewise.  Exact equality; no tolerance.
Nothing may be allocated: mistral-large-123b's float32 training state
alone is ~1.5 TB.
"""

import jax
import pytest
import torch

from repro.configs import all_arch_ids
from repro.configs import get_config as ref_config
from repro.launch.steps import abstract_train_state as ref_abstract_state
from repro.models import api as ref_api
from repro.models.config import SHAPES
from repro_torch.configs import get_config as port_config
from repro_torch.launch.steps import abstract_train_state
from repro_torch.models import api as port_api
from repro_torch.models import get_model as port_get_model

ARCHS = all_arch_ids()
CELLS = [(arch, shape) for arch in ARCHS for shape in SHAPES]


def _port_leaf(tree, path):
    node = tree
    for k in path:
        node = node[getattr(k, "key", getattr(k, "idx", None))]
    return node


def _assert_same_specs(ref_tree, port_tree):
    """Every reference leaf has a port leaf at its path with its shape and
    dtype, on ``meta``; both trees have the same number of leaves."""
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_tree)[0]
    port_leaves = jax.tree.leaves(port_tree)
    assert len(port_leaves) == len(ref_leaves)
    assert all(isinstance(t, torch.Tensor) and t.is_meta
               for t in port_leaves)
    for path, r in ref_leaves:
        p = _port_leaf(port_tree, path)
        key = jax.tree_util.keystr(path)
        assert tuple(p.shape) == tuple(r.shape), key
        assert str(p.dtype).replace("torch.", "") == str(r.dtype), key


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_and_train_state_match_reference(arch):
    rcfg, pcfg = ref_config(arch), port_config(arch)
    r_params, r_opt = ref_abstract_state(rcfg)
    _assert_same_specs(ref_api.get_model(rcfg).abstract_params(),
                       port_get_model(pcfg).abstract_params())
    p_params, p_opt = abstract_train_state(pcfg)
    _assert_same_specs(r_params, p_params)
    _assert_same_specs(r_opt, p_opt)
    n = sum(t.numel() for t in jax.tree.leaves(p_params))
    assert n == sum(r.size for r in jax.tree.leaves(r_params))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_reference(arch, shape):
    rcfg, pcfg = ref_config(arch), port_config(arch)
    sh = SHAPES[shape]
    runnable = port_api.cell_is_runnable(pcfg, sh)
    assert runnable == ref_api.cell_is_runnable(rcfg, sh)
    if not runnable[0]:
        return
    _assert_same_specs(ref_api.input_specs(rcfg, sh),
                       port_api.input_specs(pcfg, sh))


def _rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def test_dry_run_allocates_nothing():
    """Every arch's abstract training state, built twice: the process's
    resident memory grows by less than 256 MiB (olmo-1b's float32
    parameters alone would take 4.7 GB)."""
    abstract_train_state(port_config(ARCHS[0]))     # imports, first calls
    before = _rss_bytes()
    for _ in range(2):
        for arch in ARCHS:
            params, opt = abstract_train_state(port_config(arch))
            assert all(t.is_meta for t in jax.tree.leaves((params, opt)))
    assert _rss_bytes() - before < 256 * 2 ** 20
