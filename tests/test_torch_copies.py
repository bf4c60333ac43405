"""The PyTorch port's copied modules and its boundaries, held against the
JAX reference package.

(a) the port's builder gives AIDG and CompiledAIDG arrays equal
    (``np.array_equal``, dtypes included) to the reference's for every
    default scenario, and ``aidg_from_numpy`` carries a reference AIDG
    across unchanged;
(b) ``DEFAULT_SPACE``, the candidate generators and ``pareto_front`` are
    identical;
(c) the port imports neither ``jax`` nor ``repro`` (AST scan of every
    file, and a subprocess that runs a tiny CPU explore);
(d) entry points run on ``cuda`` by default and raise without a card.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core.aidg import explorer as ref_ex
from repro_torch.convert import ARRAY_FIELDS, DICT_FIELDS, aidg_from_numpy
from repro_torch.core.aidg import builder as port_builder
from repro_torch.core.aidg import dse as port_dse
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.core.aidg import maxplus as port_mp

ROOT = Path(__file__).resolve().parents[1]
REF_SCEN = ref_ex.default_scenarios()
PORT_SCEN = port_ex.default_scenarios()
IDS = [s.name for s in REF_SCEN]


def _fields(aidg):
    return {k: getattr(aidg, k) for k in (*ARRAY_FIELDS, *DICT_FIELDS)}


def _assert_same_array(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert np.array_equal(a, b), what


def _assert_same_aidg(r, p):
    assert r.n == p.n
    for k in ARRAY_FIELDS:
        _assert_same_array(getattr(r, k), getattr(p, k), k)
    for k in ("storage_nodes", "storage_lat"):
        rd, pd = getattr(r, k), getattr(p, k)
        assert list(rd) == list(pd), k
        for name in rd:
            _assert_same_array(rd[name], pd[name], f"{k}[{name}]")
    assert r.storage_slots == p.storage_slots
    assert r.classes == p.classes


def _assert_same_compiled(r, p):
    for k in ("depth", "level_nodes", "order", "rank", "starts"):
        _assert_same_array(getattr(r.schedule, k), getattr(p.schedule, k), k)
    _assert_same_array(r.preds_lv, p.preds_lv, "preds_lv")
    _assert_same_array(r.extra_lv, p.extra_lv, "extra_lv")
    assert r.storage_order == p.storage_order
    for name in r.storage_order:
        _assert_same_array(r.storage_scatter[name], p.storage_scatter[name],
                           f"storage_scatter[{name}]")


# ---------------------------------------------------------------------------
# (a) copies of the builder path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(len(REF_SCEN)), ids=IDS)
def test_builder_copy_matches_reference(i):
    ref = ref_ex.compile_scenario(REF_SCEN[i])
    port = port_ex.compile_scenario(PORT_SCEN[i])
    assert ref.name == port.name
    _assert_same_aidg(ref.aidg, port.aidg)
    _assert_same_compiled(ref.compiled_aidg, port.compiled_aidg)
    assert ref.baseline == port.baseline
    assert ref.problem.op_names == port.problem.op_names
    assert ref.problem.storage_names == port.problem.storage_names
    # the copied event simulator agrees cycle for cycle
    assert ref.simulate() == port.simulate()


@pytest.mark.parametrize("i", range(len(REF_SCEN)), ids=IDS)
def test_aidg_from_numpy_carries_reference_graph(i):
    ref = ref_ex.compile_scenario(REF_SCEN[i])
    port = port_ex.compile_scenario(PORT_SCEN[i])
    carried = aidg_from_numpy(_fields(ref.aidg))
    _assert_same_aidg(ref.aidg, carried)
    _assert_same_compiled(port.compiled_aidg,
                          port_builder.compile_aidg(carried))
    # the copy owns its arrays
    assert carried.work is not ref.aidg.work


def test_aidg_from_numpy_rejects_missing_and_misshapen_fields():
    fields = _fields(ref_ex.compile_scenario(REF_SCEN[2]).aidg)
    with pytest.raises(KeyError, match="work"):
        aidg_from_numpy({k: v for k, v in fields.items() if k != "work"})
    bad = dict(fields, preds=fields["preds"][:-1])
    with pytest.raises(ValueError, match="preds"):
        aidg_from_numpy(bad)


# ---------------------------------------------------------------------------
# (b) design space, candidates, Pareto front
# ---------------------------------------------------------------------------


def test_design_space_and_candidates_identical():
    assert [vars(k) for k in port_ex.DEFAULT_SPACE.knobs] == \
        [vars(k) for k in ref_ex.DEFAULT_SPACE.knobs]
    for seed in (0, 1, 7):
        for n in (1, 8, 4096):
            assert np.array_equal(
                port_ex.random_candidates(port_ex.DEFAULT_SPACE, n, seed),
                ref_ex.random_candidates(ref_ex.DEFAULT_SPACE, n, seed))
    assert np.array_equal(port_ex.grid_candidates(port_ex.DEFAULT_SPACE, 3),
                          ref_ex.grid_candidates(ref_ex.DEFAULT_SPACE, 3))
    rng = np.random.default_rng(0)
    for _ in range(5):
        objs = rng.integers(0, 6, size=(64, 3)).astype(np.float64)
        assert np.array_equal(port_ex.pareto_front(objs),
                              ref_ex.pareto_front(objs))
    # projections agree cell by cell
    for r, p in zip(REF_SCEN, PORT_SCEN):
        rp = ref_ex.DEFAULT_SPACE.projection(ref_ex.compile_scenario(r).problem)
        pp = port_ex.DEFAULT_SPACE.projection(
            port_ex.compile_scenario(p).problem)
        assert all(np.array_equal(a, b) for a, b in zip(rp, pp))


# ---------------------------------------------------------------------------
# (c) the port stands alone
# ---------------------------------------------------------------------------


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_port_files_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    bad = {str(f.relative_to(ROOT)): m for f in files
           for m in _imported_modules(f) if _forbidden(m)}
    assert not bad, bad


def test_port_runs_without_jax_or_repro_loaded():
    code = (
        "import sys\n"
        "import repro_torch.core.aidg.explorer as E\n"
        "ex = E.Explorer(E.default_scenarios()[5:7], engine='blocked', "
        "device='cpu')\n"
        "res = ex.explore(E.random_candidates(E.DEFAULT_SPACE, 4))\n"
        "assert res.cycles.shape == (4, 2) and len(res.pareto) >= 1\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# ---------------------------------------------------------------------------
# (d) device defaults
# ---------------------------------------------------------------------------


def test_entry_points_default_to_cuda_and_raise_without_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cs = port_ex.compile_scenario(PORT_SCEN[6])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_ex.Explorer(PORT_SCEN[6:7], engine="blocked")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_dse.sweep(cs.problem, np.ones((1, cs.problem.n_op)),
                       np.ones((1, cs.problem.n_st)))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mp.longest_path_wavefront(cs.aidg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_mp.fixed_point_torch(cs.aidg, engine="blocked")
    # asking for the CPU explicitly works
    t = port_mp.longest_path_wavefront(cs.aidg, device="cpu")
    assert t.device.type == "cpu"
