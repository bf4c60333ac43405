"""The blocked engine's closure plan: why lower mode is exact, and that
the port picks it only where it is.

The closure kernel's lower mode computes, per squaring, only the entries
i >= j of P ⊗ P and only over k in [j, i], as 8 x 8 tiles cut into the
pieces of ``kernels.maxplus.closure_pieces``; its closure matvec reads
only the lower triangle and folds the rest in from a suffix max of the
vector.  Here both are emulated on the CPU from the same work list and
held against the plain versions BIT FOR BIT (max-plus is one float32 add
and a max: no tolerance applies), on the diagonal blocks of all 10 cells
of the reference's ``default_scenarios()`` carried across with
``aidg_from_numpy``, with random work from a numpy seed.  The kernels
themselves are held against the same plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax  # noqa: F401  (both frameworks in one process; JAX on the CPU)
import numpy as np
import pytest
import torch

from repro.core.aidg import explorer as ref_ex
from repro.core.aidg import maxplus as ref_mp
from repro_torch.convert import ARRAY_FIELDS, DICT_FIELDS, aidg_from_numpy
from repro_torch.core.aidg import builder as port_builder
from repro_torch.core.aidg import maxplus as port_mp
from repro_torch.kernels import maxplus as K

NEG = np.float32(-1e18)
CELLS = [s.name for s in ref_ex.default_scenarios()]
_BY_NAME = {s.name: s for s in ref_ex.default_scenarios()}
STEPS = 7          # ceil(log2(128)): the Solver's squarings at block 128
N_WORK = 2         # random work vectors per cell


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Several worker processes share a few cores: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_PAIRS = {}


def _pair(name):
    """(reference CompiledAIDG, the port's CompiledAIDG of the same graph),
    built once per cell."""
    if name not in _PAIRS:
        ref = ref_ex.compile_scenario(_BY_NAME[name]).compiled_aidg
        fields = {k: getattr(ref.aidg, k)
                  for k in (*ARRAY_FIELDS, *DICT_FIELDS)}
        _PAIRS[name] = (ref, port_builder.compile_aidg(aidg_from_numpy(fields)))
    return _PAIRS[name]


def _work(a, seed):
    """(N_WORK, nb, 128) work blocks: the AIDG's work scaled by
    log-uniform factors in [1/4, 4], at least 1 cycle, padded with 0."""
    rng = np.random.default_rng(seed)
    f = np.exp(rng.uniform(np.log(0.25), np.log(4.0), (N_WORK, a.n)))
    w = np.maximum(1.0, a.work[None] * f).astype(np.float32)
    nb = -(-a.n // 128)
    wp = np.zeros((N_WORK, nb * 128), np.float32)
    wp[:, :a.n] = w
    return wp.reshape(N_WORK, nb, 128).transpose(1, 0, 2).copy()


def _lower_product(P, table):
    """One squaring's Q = P ⊗ P as lower mode computes it: every piece
    (row0, col0, k0, k1) takes the max over its k range of its 8 x 8 tile,
    the pieces of a tile fold together, tiles no piece covers stay NEG."""
    Q = torch.full_like(P, float(NEG))
    for row0, col0, k0, k1, *_ in table:
        if row0 < 0:
            continue
        r, c = slice(row0, row0 + 8), slice(col0, col0 + 8)
        part = (P[:, r, k0:k1, None] + P[:, None, k0:k1, c]).amax(dim=2)
        Q[:, r, c] = torch.maximum(Q[:, r, c], part)
    return Q


def _lower_matvec(C, h):
    """The lower closure matvec as the kernel computes it: row i reads
    C[i, 0..i] and folds the skipped terms in as fl(NEG + max_{k>i} h_k)."""
    n = C.shape[-1]
    lower = torch.tril(torch.ones(n, n, dtype=torch.bool))
    terms = torch.where(lower, C + h[:, None, :], float("-inf"))
    acc = torch.maximum(torch.full_like(h, float(NEG)), terms.amax(dim=2))
    suf = torch.cat([torch.flip(torch.cummax(torch.flip(h, [1]), 1).values,
                                [1])[:, 1:],
                     torch.full_like(h[:, :1], float("-inf"))], dim=1)
    return torch.maximum(acc, NEG + suf)


# ---------------------------------------------------------------------------
# the structure
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("block", [16, 32, 128])
@pytest.mark.parametrize("cell", CELLS)
def test_every_diagonal_block_is_strictly_lower_triangular(cell, block):
    """``compile_aidg`` numbers nodes level-major, so every predecessor has
    a lower index: the reference's diagonal blocks are all NEG on and above
    the diagonal, and the port's cached facts say so."""
    ref, port = _pair(cell)
    Dd = np.asarray(ref_mp._blocked_structure(ref, block)[0])
    upper = np.triu(np.ones((block, block), dtype=bool))
    assert (Dd[:, upper] == NEG).all()
    lower, dmax = port_mp._diagonal_facts(port, block)
    assert lower
    fin = Dd[Dd > NEG / 2]
    assert dmax == (float(np.abs(fin).max()) if fin.size else 0.0)


# ---------------------------------------------------------------------------
# the squarings: lower mode's work list against the full product
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_lower_squarings_equal_the_full_product(cell):
    """At each of the 7 squarings from P = max(D + w, I): the product lower
    mode's pieces compute equals the full plain product, and max(P, P ⊗ P)
    equals P ⊗ P, bit for bit; the emulated closure equals
    ``maxplus_closure_torch``."""
    _, port = _pair(cell)
    Dd = torch.from_numpy(port_mp._blocked_structure(port, 128)[0])
    wb = torch.from_numpy(_work(port.aidg, seed=CELLS.index(cell)))
    table, _ = K.closure_pieces(128, "closure_lower")
    n = 128
    eye = torch.full((n, n), float(NEG))
    eye.fill_diagonal_(0.0)
    P = torch.maximum(Dd[:, None] + wb[..., None], eye).reshape(-1, n, n)
    for _ in range(STEPS):
        Q = K.maxplus_matmul_torch(P, P)
        assert torch.equal(_lower_product(P, table), Q)
        assert torch.equal(torch.maximum(P, Q), Q)
        P = Q
    want = K.maxplus_closure_torch(Dd, STEPS, wb)
    assert torch.equal(P.reshape(want.shape), want)


@pytest.mark.parametrize("n,variant", [(128, "closure_lower"),
                                       (128, "closure_full"),
                                       (100, "closure_lower"),
                                       (77, "closure_full"),
                                       (16, "closure_lower")])
def test_work_list_covers_each_entry_once_per_k(n, variant):
    """Every (i, j) the mode computes gets every k of its range exactly
    once over its tile's pieces (lower: i >= j, k in [j, i] within the
    8-tiles; full: all, k in [0, n)), each piece holds at most 32 values of
    k, the table fits the kernel's thread limit, and a tile's first piece
    folds the scratch slots its other pieces leave their results in."""
    table, nslots = K.closure_pieces(n, variant)
    assert len(table) % 32 == 0 and len(table) <= K.CLOSURE_MAX_THREADS
    T = -(-n // 8)
    seen = {}
    for row0, col0, k0, k1, slot, *xs in table:
        if row0 < 0:
            continue
        assert k1 - k0 <= (8 * K.PIECE_UNITS if variant == "closure_lower"
                           else n)
        seen.setdefault((row0, col0), []).append((k0, k1, slot, xs))
    tiles = {(8 * ti, 8 * tj) for ti in range(T) for tj in range(T)
             if variant == "closure_full" or tj <= ti}
    assert set(seen) == tiles
    used = []
    for (row0, col0), parts in seen.items():
        parts.sort(key=lambda p: p[0])
        lo, hi = (col0, min(row0 + 8, n)) if variant == "closure_lower" \
            else (0, n)
        assert parts[0][0] == lo and parts[-1][1] == hi
        assert all(a[1] == b[0] for a, b in zip(parts, parts[1:]))
        first = [p for p in parts if p[2] < 0]
        assert len(first) == 1
        others = sorted(p[2] for p in parts if p[2] >= 0)
        assert sorted(x for x in first[0][3] if x >= 0) == others
        used += others
    assert sorted(used) == list(range(nslots))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cell", CELLS)
def test_solver_plans_lower_mode_for_the_cells(cell):
    _, port = _pair(cell)
    solver = port_mp.Solver(port, "blocked", "cpu")
    work = torch.from_numpy(_work(port.aidg, 7)).permute(1, 0, 2) \
        .reshape(N_WORK, -1)[:, :port.aidg.n].contiguous()
    solver.relax_for(work)
    assert solver.closure_variant == "closure_lower"


def test_solver_plans_full_mode_past_the_magnitude_bound():
    """Work of 2^30 cycles: 128 x (max |d| + 2^30) >= 2^35, so the plan
    falls back to full mode, and the path still equals the reference."""
    ref, port = _pair("gamma/gemm")
    solver = port_mp.Solver(port, "blocked", "cpu")
    work = torch.full((1, port.aidg.n), 2.0 ** 30)
    relax = solver.relax_for(work)
    assert solver.closure_variant == "closure_full"
    base = torch.from_numpy(np.asarray(port.aidg.base, np.float32))[None]
    want = ref_mp.longest_path_blocked(ref, work=work[0].numpy(),
                                       base=base[0].numpy())
    assert np.array_equal(relax(base)[0].numpy(), np.asarray(want))


def test_public_closure_matches_reference():
    """``maxplus_closure(M, steps)`` takes full mode whatever M is: dense
    input, strictly lower input, and strictly lower input with a value of
    2^40 (past the magnitude bound) all equal the reference."""
    rng = np.random.default_rng(5)
    n = 32
    dense = rng.uniform(-500, 500, (3, n, n)).astype(np.float32)
    dense[rng.random(dense.shape) < 0.5] = NEG
    low = np.where(np.tril(np.ones((n, n), bool), -1), dense, NEG)
    big = low.copy()
    big[0, 5, 1] = 2.0 ** 40
    for M in (dense, low, big):
        out = port_mp.maxplus_closure(torch.from_numpy(M), 5).numpy()
        for i in range(3):
            assert np.array_equal(out[i], np.asarray(
                ref_mp.maxplus_closure(jax.numpy.asarray(M[i]), 5)))


def test_the_magnitude_guard_is_needed():
    """With a value of 2^40 the terms lower mode skips stop rounding back to
    NEG (NEG + 2^40 > NEG): the restricted product differs from the full
    one, and the plan refuses lower mode."""
    n = 16
    P = torch.full((1, n, n), float(NEG))
    P[0].fill_diagonal_(0.0)
    P[0, 9, 3] = 2.0 ** 40
    assert K.plan_closure(n, True, n * 2.0 ** 40) == "closure_full"
    assert K.plan_closure(n, True, n * 2.0 ** 30) == "closure_lower"
    table, _ = K.closure_pieces(n, "closure_lower")
    full = K.maxplus_matmul_torch(P, P)
    assert not torch.equal(_lower_product(P, table), full)
    # the skipped term NEG + 2^40 wins where the restricted product has NEG
    assert float(full[0, 2, 3]) == float(NEG + np.float32(2.0 ** 40))


def test_plan_refuses_blocks_above_128():
    with pytest.raises(ValueError, match="outside"):
        K.plan_closure(129, True, 0.0)
    with pytest.raises(ValueError, match="outside"):
        K.maxplus_closure(torch.zeros((1, 129, 129)), 1)


# ---------------------------------------------------------------------------
# the closure matvec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scale", [1.0, 2.0 ** 35, 2.0 ** 40])
@pytest.mark.parametrize("cell", CELLS)
def test_lower_matvec_fold_equals_the_full_matvec(cell, scale):
    """On real closures of the cell (lower mode's output: NEG above the
    diagonal), the lower-triangle matvec with its suffix-max fold equals
    ``maxplus_matvec_torch`` on the whole block, also for vectors h whose
    entries reach and pass 2^35 -- the fold needs no bound on h."""
    _, port = _pair(cell)
    Dd = torch.from_numpy(port_mp._blocked_structure(port, 128)[0])
    wb = torch.from_numpy(_work(port.aidg, seed=11))
    clo = K.maxplus_closure_torch(Dd, STEPS, wb).reshape(-1, 128, 128)
    rng = np.random.default_rng(int(scale) % 997 + CELLS.index(cell))
    h = rng.uniform(-1.0, 1.0, (clo.shape[0], 128)) * scale
    h[rng.random(h.shape) < 0.2] = NEG
    h = torch.from_numpy(h.astype(np.float32))
    want = K.maxplus_matvec_torch(clo, h)
    assert torch.equal(_lower_matvec(clo, h), want)
    assert torch.equal(K.maxplus_matvec_lower(clo, h), want)


def test_folded_matvec_equals_the_written_operand():
    """The folded matvec's plain version is today's two steps -- the (b, n,
    n) operand D + w written out, the matvec, the max with h0 -- also with
    the all-NEG structure of block 0."""
    rng = np.random.default_rng(3)
    n, b = 40, 5
    D = rng.uniform(0, 9, (n, n)).astype(np.float32)
    D[rng.random(D.shape) < 0.7] = NEG
    w, prev, h0 = (torch.from_numpy(rng.uniform(1, 500, (b, n))
                                    .astype(np.float32)) for _ in range(3))
    for Dt in (torch.from_numpy(D), torch.full((n, n), float(NEG))):
        want = torch.maximum(h0, K.maxplus_matvec_torch(Dt + w[:, :, None],
                                                        prev))
        assert torch.equal(K.maxplus_matvec_folded(Dt, w, prev, h0), want)
