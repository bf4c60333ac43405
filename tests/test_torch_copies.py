"""The PyTorch port's copied modules and its boundaries, held against the
JAX reference package.

(a) the port's builder gives AIDG and CompiledAIDG arrays equal
    (``np.array_equal``, dtypes included) to the reference's for every
    default scenario, and ``aidg_from_numpy`` carries a reference AIDG
    across unchanged;
(b) ``DEFAULT_SPACE``, the candidate generators and ``pareto_front`` are
    identical;
(c) the port imports neither ``jax`` nor ``repro`` nor ``ml_dtypes``
    (AST scan of every file, and a subprocess that runs a tiny CPU
    explore);
(d) entry points run on ``cuda`` by default and raise without a card;
(e) the LM slice: the ten config modules equal the reference's, the
    reference's parameter pytree carries across (``lm_params_from_numpy``)
    with every leaf checked, and ``Model.logits`` runs with neither
    ``jax`` nor ``repro`` loaded;
(f) the packed slice: the copied ``core/network`` tables and layer graphs
    equal the reference's, and every operator and network cell's
    CompiledAIDG / CondensedAIDG (with its prologue boundary) and layer
    stack are array-equal to the reference's;
(g) the serving slice: the six framework-free ``serve`` modules are the
    reference's files, byte for byte, and ``serve``, ``surrogate`` and
    ``optim`` run with neither ``jax`` nor ``repro`` loaded;
(h) the training slice: ``data`` and ``runtime`` (numpy and threads only)
    are the reference's files, byte for byte, and ``launch.train`` trains
    and resumes with neither ``jax`` nor ``repro`` loaded;
(i) distributed launch: the port's copies of the reference's tables (the
    sharding rules, the logical axes, the ring factors, the dtype sizes)
    equal the reference's.
"""

import ast
import os
import subprocess
import sys
from dataclasses import asdict, replace
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as ref_configs
import repro_torch.configs as port_configs
import repro.core.network as ref_net
from repro.core.aidg import explorer as ref_ex
from repro.core.aidg.builder import condense_aidg as ref_condense
from repro.core.network import lowering as ref_lowering
from repro.models import get_model as ref_get_model
import repro_torch.core.network as port_net
from repro_torch.convert import (ARRAY_FIELDS, DICT_FIELDS, aidg_from_numpy,
                                 cast_params, lm_params_from_numpy,
                                 surrogate_params_from_numpy)
from repro_torch.core.aidg import builder as port_builder
from repro_torch.core.aidg import dse as port_dse
from repro_torch.core.aidg import explorer as port_ex
from repro_torch.core.aidg import maxplus as port_mp
from repro_torch.core.network import lowering as port_lowering
from repro_torch.models import get_model as port_get_model
from repro_torch.models import lm as port_lm
from repro_torch.serve import DSEService

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
    return top in ("jax", "jaxlib", "repro", "ml_dtypes")


def test_port_files_import_no_jax_and_no_repro():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 30
    scanned = {f.parent.name for f in files}
    assert {"serve", "surrogate", "optim", "launch", "ckpt", "data",
            "runtime"} <= scanned, scanned
    for name in ("models/encdec.py", "models/api.py", "models/layers.py",
                 "launch/steps.py", "optim/adamw.py", "convert.py",
                 "pspec.py", "launch/mesh.py", "launch/sharding.py",
                 "launch/dryrun.py", "launch/roofline.py",
                 "launch/roofline_report.py"):
        assert ROOT / "src" / "repro_torch" / name in files, name
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
        "net = E.Explorer(networks='olmo_1b', device='cpu')\n"
        "assert net.engine == 'packed' and len(net.scenario_names) == 16\n"
        "res = net.explore(E.random_candidates(E.DEFAULT_SPACE, 4))\n"
        "assert res.cycles.shape == (4, 16) and len(res.pareto) >= 1\n"
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
        DSEService(scenarios=PORT_SCEN[6:7])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        surrogate_params_from_numpy({})
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


# ---------------------------------------------------------------------------
# (e) the LM slice: config copies, parameter conversion, standing alone
# ---------------------------------------------------------------------------


# the port's options the reference has not, each at the value that keeps
# the reference's computation (the Jamba2 path sets them otherwise)
PORT_ONLY = {("attention", "rope"): True, ("ssm", "inner_norms"): False,
             ("moe", "renormalize"): True, ("moe", "dropless"): False,
             ("moe", "held_experts"): ()}


def _shared_fields(port: dict) -> dict:
    """``asdict`` of a port config without the port-only options, each
    checked to hold its default."""
    out = {k: dict(v) if isinstance(v, dict) else v for k, v in port.items()}
    for (group, name), default in PORT_ONLY.items():
        if out.get(group) is not None:
            assert out[group].pop(name) == default, (group, name)
    return out


@pytest.mark.parametrize("arch", ref_configs.all_arch_ids())
def test_config_copies_equal_reference(arch):
    assert port_configs.all_arch_ids() == ref_configs.all_arch_ids()
    assert port_configs.ALIASES == ref_configs.ALIASES
    for getter in ("get_config", "get_smoke_config"):
        ref = getattr(ref_configs, getter)(arch)
        port = getattr(port_configs, getter)(arch)
        assert type(port).__module__.startswith("repro_torch.")
        assert _shared_fields(asdict(port)) == asdict(ref)
    for alias, name in ref_configs.ALIASES.items():
        assert _shared_fields(asdict(port_configs.get_config(alias))) == \
            asdict(ref_configs.get_config(name))


def _ref_tree(arch, **over):
    cfg = replace(ref_configs.get_smoke_config(arch), **over)
    params = ref_get_model(cfg).init_params(jax.random.key(0))
    return (replace(port_configs.get_smoke_config(arch), **over),
            jax.tree.map(np.asarray, params))


def test_lm_params_from_numpy_round_trip():
    """Every leaf lands where the reference keeps it (layer r*P + pos <-
    blocks[pos][...][r]).  A 4-layer jamba-shaped stack with attention
    every 2 layers has P = 2 pattern positions x R = 2 repeats."""
    cfg, tree = _ref_tree("jamba_v01_52b", n_layers=4, attn_period=2,
                          attn_offset=1)
    model = lm_params_from_numpy(cfg, tree, device="cpu")
    P = port_lm.pattern_period(cfg)
    assert (P, cfg.n_layers // P) == (2, 2)
    n_ref = sum(a.size for a in jax.tree.leaves(tree))
    assert sum(p.numel() for p in model.parameters()) == n_ref
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[0] == "layers":
            r, pos = divmod(int(parts[1]), P)
            node = tree["blocks"][pos]
            for key in parts[2:]:
                node = node[key]
            want = node[r]
        else:
            want = tree[parts[0]]
            for key in parts[1:]:
                want = want[key]
        assert p.dtype == torch.float32
        assert np.array_equal(p.detach().numpy(), want), name
    # the float32 leaves survive a cast, the rest is cast once, in place
    cast_params(model, torch.bfloat16)
    assert model.layers[0].mix.A_log.dtype == torch.float32
    assert model.layers[1].ffn.router.dtype == torch.float32
    assert model.layers[0].mix.in_proj.dtype == torch.bfloat16
    assert model.embed.dtype == torch.bfloat16


def test_lm_params_from_numpy_checks_leaves():
    cfg, tree = _ref_tree("olmo_1b")
    blocks = [dict(b) for b in tree["blocks"]]
    mix = {k: v for k, v in blocks[0]["mix"].items() if k != "wq"}
    missing = dict(tree, blocks=tuple([dict(blocks[0], mix=mix)]))
    with pytest.raises(KeyError, match="blocks\\[0\\]/mix/wq"):
        lm_params_from_numpy(cfg, missing, device="cpu")
    wide = dict(tree, embed=np.zeros((cfg.vocab_size, cfg.d_model + 1),
                                     np.float32))
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_numpy(cfg, wide, device="cpu")
    f64 = dict(tree, embed=tree["embed"].astype(np.float64))
    with pytest.raises(ValueError, match="float64"):
        lm_params_from_numpy(cfg, f64, device="cpu")
    extra = dict(tree, extra_leaf=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="extra_leaf"):
        lm_params_from_numpy(cfg, extra, device="cpu")
    # bf16 leaves (ml_dtypes) come across too
    bf_cfg = replace(cfg, param_dtype="bfloat16")
    bf_tree = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                           tree)
    model = lm_params_from_numpy(bf_cfg, bf_tree, device="cpu")
    assert model.embed.dtype == torch.bfloat16
    assert np.array_equal(model.embed.detach().float().numpy(),
                          np.asarray(bf_tree["embed"], np.float32))


def test_lm_runs_without_jax_or_repro_loaded():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.models import get_model\n"
        "cfg = get_smoke_config('jamba_v01_52b')\n"
        "m = get_model(cfg)\n"
        "params = m.init_params(0, device='cpu')\n"
        "toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 8))\n"
        "lg = m.logits(params, {'tokens': toks})\n"
        "assert lg.shape == (2, 8, cfg.vocab_size)\n"
        "assert bool(lg.float().isfinite().all())\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


def test_lm_entry_points_default_to_cuda_and_raise_without_card(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_configs.get_smoke_config("olmo_1b")
    model = port_get_model(cfg)
    for call in (lambda: model.init_params(0),
                 lambda: model.init_cache(1, 8),
                 lambda: lm_params_from_numpy(cfg, {})):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert model.init_params(0, device="cpu").embed.device.type == "cpu"
    # the enc-dec family: the same default, and the CPU when asked
    whisper = port_get_model(port_configs.get_smoke_config("whisper_small"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        whisper.init_params(0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        whisper.init_cache(1, 8)
    params = whisper.init_params(0, device="cpu")
    assert {p.device.type for p in params.parameters()} == {"cpu"}
    # the dry run needs no card: every leaf on the meta device
    for m in (model, whisper):
        leaves = jax.tree.leaves(m.abstract_params())
        assert leaves and all(t.is_meta for t in leaves)


# ---------------------------------------------------------------------------
# (f) the packed slice: network tables, condensed arrays, layer stacks
# ---------------------------------------------------------------------------

_COND_ARRAYS = ("kept", "kept_rank", "absorbed", "ab_anchor", "ab_const",
                "ab_segstart", "preds_lv", "const_lv", "pidx_lv",
                "v_const_lv", "v_pidx_lv", "kept_perm", "ab_anchor_perm")


def _assert_same_condensed(r, p, what):
    assert (r.n_kept, r.boundary) == (p.n_kept, p.boundary), what
    for k in _COND_ARRAYS:
        _assert_same_array(getattr(r, k), getattr(p, k), f"{what}: {k}")
    for k in ("depth", "level_nodes", "order", "rank", "starts"):
        _assert_same_array(getattr(r.schedule, k), getattr(p.schedule, k),
                           f"{what}: schedule.{k}")
    assert r.stats == p.stats, what


@pytest.mark.parametrize("i", range(len(REF_SCEN)), ids=IDS)
def test_operator_cell_condensed_arrays_match_reference(i):
    ref = ref_ex.compile_scenario(REF_SCEN[i])
    port = port_ex.compile_scenario(PORT_SCEN[i])
    _assert_same_condensed(ref_condense(ref.aidg),
                           port_builder.condense_aidg(port.aidg), IDS[i])
    assert ref.stats_row() == port.stats_row()


def test_network_tables_equal_reference():
    assert port_net.NETWORKS == ref_net.NETWORKS
    assert port_net.NETWORK_ARCHS == ref_net.NETWORK_ARCHS
    assert port_net.ARCH_TILE_TOL == ref_net.ARCH_TILE_TOL
    assert port_net.ARCH_CAPACITY_WORDS == ref_net.ARCH_CAPACITY_WORDS
    assert asdict(port_net.NETWORK_SHAPE) == asdict(ref_net.NETWORK_SHAPE)
    for arch in ref_net.NETWORK_ARCHS:
        assert port_net.lowerable_ops(arch) == ref_net.lowerable_ops(arch)
    assert list(port_lowering._TILES) == list(ref_lowering._TILES)
    for key, (rf, rmacs, rwords) in ref_lowering._TILES.items():
        pf, pmacs, pwords = port_lowering._TILES[key]
        assert (pmacs, pwords) == (rmacs, rwords), key
        assert pf().params[1:] == rf().params[1:], key
    ref_cells = ref_net.default_network_scenarios()
    port_cells = port_net.default_network_scenarios()
    assert [(c.name, c.mode) for c in port_cells] == \
        [(c.name, c.mode) for c in ref_cells]
    assert len(port_cells) == 21
    # the layer graph of every config, in execution order
    for arch in ref_configs.all_arch_ids():
        r = ref_net.extract_layer_graph(ref_configs.get_config(arch))
        p = port_net.extract_layer_graph(port_configs.get_config(arch))
        assert [(x.tag, x.unique) for x in p.instances] == \
            [(x.tag, x.unique) for x in r.instances], arch
        assert [asdict(c) for c in p.unique] == \
            [asdict(c) for c in r.unique], arch
        assert p.runs == r.runs and p.ops == r.ops, arch


_NET_CELLS = ref_net.default_network_scenarios()


@pytest.mark.parametrize("i", range(len(_NET_CELLS)),
                         ids=[c.name for c in _NET_CELLS])
def test_network_cell_arrays_match_reference(i):
    """Every tile program of the cell: AIDG, CompiledAIDG and the
    CondensedAIDG the packed matrix builds (prologue boundary included);
    then the cell's layer stack and its pack spec's composition arrays."""
    rs = _NET_CELLS[i]
    ref = rs.compile()
    port = port_net.NetworkScenario(rs.arch, rs.network).compile()
    assert port.name == ref.name
    assert len(port.cells) == len(ref.cells)
    for k, (rc, pc) in enumerate(zip(ref.cells, port.cells)):
        what = f"{ref.name} tile {k}"
        _assert_same_aidg(rc.aidg, pc.aidg)
        _assert_same_compiled(rc.compiled_aidg, pc.compiled_aidg)
        assert rc.baseline == pc.baseline, what
        kb = int(ref.stack.prologue_len[k])
        _assert_same_condensed(ref_condense(rc.aidg, kb or None),
                               port_builder.condense_aidg(pc.aidg,
                                                          kb or None), what)
    for k in ("prologue_len", "run_layer", "run_reps", "fits_within",
              "fits_between"):
        _assert_same_array(getattr(ref.stack, k), getattr(port.stack, k),
                           f"{ref.name}: stack.{k}")
    assert np.array_equal(port.reps_per_layer, ref.reps_per_layer)
    assert port.stats_row() == ref.stats_row()
    rp = ref.pack_spec(ref.projection(ref_ex.DEFAULT_SPACE), n_knobs=5)
    pp = port.pack_spec(port.projection(port_ex.DEFAULT_SPACE), n_knobs=5)
    for k in ("prologue_len", "run_layer", "run_reps", "fits_within",
              "fits_between"):
        _assert_same_array(getattr(rp, k), getattr(pp, k), k)
    assert all(np.array_equal(a, b) for a, b in zip(rp.edyn, pp.edyn))
    assert rp.static_pj == pp.static_pj


# ---------------------------------------------------------------------------
# (g) the serving slice
# ---------------------------------------------------------------------------

SERVE_COPIES = ("errors", "query", "policy", "faults", "batcher", "frontend")


@pytest.mark.parametrize("name", SERVE_COPIES)
def test_serve_copies_equal_reference(name):
    ref = ROOT / "src" / "repro" / "serve" / f"{name}.py"
    port = ROOT / "src" / "repro_torch" / "serve" / f"{name}.py"
    assert port.read_bytes() == ref.read_bytes()


def test_serve_and_surrogate_run_without_jax_or_repro_loaded():
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import repro_torch.core.aidg.explorer as E\n"
        "from repro_torch.serve import DSEService\n"
        "from repro_torch.surrogate import SurrogateConfig, train_surrogate\n"
        "from repro_torch.optim import AdamWConfig\n"
        "ex = E.Explorer(E.default_scenarios()[:2], device='cpu')\n"
        "b = train_surrogate(ex, SurrogateConfig(n_samples=16, steps=20))\n"
        "with DSEService(ex, pool=4, surrogate=b, surrogate_max_err=1e9) \\\n"
        "        as svc:\n"
        "    assert svc.query(workload='gemm').tier == 'surrogate'\n"
        "    assert svc.query(workload='gemm', archs=['oma'],\n"
        "                     top_k=1).cells == ('oma/gemm',)\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# ---------------------------------------------------------------------------
# (h) the training slice
# ---------------------------------------------------------------------------

TRAIN_COPIES = ("data/__init__.py", "data/pipeline.py",
                "runtime/__init__.py", "runtime/monitor.py")


@pytest.mark.parametrize("name", TRAIN_COPIES)
def test_training_copies_equal_reference(name):
    ref = ROOT / "src" / "repro" / name
    port = ROOT / "src" / "repro_torch" / name
    assert port.read_bytes() == ref.read_bytes()


def test_train_runs_without_jax_or_repro_loaded(tmp_path):
    code = (
        "import sys\n"
        "from repro_torch.configs import get_smoke_config\n"
        "from repro_torch.launch.train import train_loop\n"
        "cfg = get_smoke_config('olmoe_1b_7b')\n"
        f"kw = dict(steps=4, batch=2, seq=16, ckpt_dir={str(tmp_path)!r},\n"
        "          ckpt_every=2, print_fn=lambda *a: None, device='cpu')\n"
        "_, a = train_loop(cfg, fail_at_step=-1, **kw)\n"
        "_, b = train_loop(cfg, **dict(kw, steps=6))\n"
        "assert [r['step'] for r in b.rows] == [4, 5], b.rows\n"
        "print(sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout


# ---------------------------------------------------------------------------
# (i) distributed launch: the copied tables
# ---------------------------------------------------------------------------


def test_launch_tables_equal_reference():
    from repro import pspec as ref_pspec
    from repro.launch import roofline as ref_roofline
    from repro.launch import sharding as ref_sharding
    from repro_torch import pspec as port_pspec
    from repro_torch.launch import roofline as port_roofline
    from repro_torch.launch import sharding as port_sharding
    assert port_sharding._RULES == ref_sharding._RULES
    assert port_sharding._MOE_EXPERT_RULES == ref_sharding._MOE_EXPERT_RULES
    assert port_pspec._LOGICAL == ref_pspec._LOGICAL
    assert port_pspec._ALLOW_UNEVEN == ref_pspec._ALLOW_UNEVEN
    assert port_roofline._FACTOR == ref_roofline._FACTOR
    assert port_roofline.COLLECTIVES == ref_roofline._COLL_KINDS
    # the HLO type names the reference keys its sizes by, as torch dtypes
    hlo = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16,
           "f16": torch.float16, "s64": torch.int64, "s32": torch.int32,
           "s16": torch.int16, "s8": torch.int8, "u8": torch.uint8,
           "pred": torch.bool}
    assert {dt: ref_roofline._DTYPE_BYTES[n] for n, dt in hlo.items()} == \
        port_roofline._DTYPE_BYTES
