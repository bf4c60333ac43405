#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases — any failure exits non-zero; no phase is caught and passed over:

1. the card's name and power limit (``nvidia-smi``);
2. build ``src/repro_torch/csrc/maxplus.cu`` with ``nvcc`` (sm_90a) into
   ``build/repro_torch/``; print the build time and the ``-Xptxas -v``
   register and shared-memory summary;
3. each kernel against its plain PyTorch version on the card, bit for bit
   (``torch.equal``: max-plus is exact), at the main path's shapes (the
   largest cell's closure squarings and the per-block matvec at 4096
   candidates, NEG entries mixed in) and at ragged shapes; CUDA-event
   times (after a warm-up call) of the kernel and of the plain version
   beside the bound;
4. the main path: ``Explorer(default_scenarios(), engine="blocked",
   device="cuda")``, ``explore`` over 4096 random candidates and a short
   coordinate-descent ``refine``, with the launch counters zeroed just
   before and read just after (every kernel must have launched, no plain
   version may have run); two more timed explores for the spread, the
   same explore with the wavefront engine, and one blocked explore under
   ``torch.profiler`` for the device time by kernel;
5. the result: the θ = 1 row equals the golden cycles exactly, every
   baseline lies within its cell's ``sim_tol`` of the event simulator,
   and 256 candidates agree with the wavefront engine within rtol 1e-5;

then one ``{"kernels": [...]}`` line, the card line again, and as the last
line ``{"ok": true, "device": {...}}``.  It needs one card; without one it
exits non-zero before printing any result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

N_CAND = 4096          # candidates per explore call
N_CROSS = 256          # candidates held against the wavefront engine
CROSS_RTOL = 1e-5      # blocked vs wavefront (closure squaring reassociates)
# H100 SXM, published: 132 SMs x 128 FP32 lanes x 1.98 GHz = 33.5 T
# lane-instructions/s (the 67 TFLOP/s of the data sheet counts an FMA as
# two); device memory 3.35 TB/s.  Both assume the full 700 W power limit.
FP32_INSTR_PER_S = 33.5e12
HBM_BYTES_PER_S = 3.35e12
BLOCK = 128            # the blocked engine's block size

# θ = 1 cycles of the 10 default cells, pinned in the reference's tests
GOLDEN_THETA1_CYCLES = {
    "oma/gemm": 3832.0,
    "systolic/gemm": 1187.0,
    "gamma/gemm": 2954.0,
    "gamma/attention": 980.0,
    "gamma/scan": 2753.0,
    "eyeriss/conv": 91.0,
    "plasticine/reduce": 91.0,
    "tpu_v5e/gemm": 3881.0,
    "tpu_v5e/attention": 225.0,
    "tpu_v5e/scan": 613.0,
}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int) -> float:
    """Mean CUDA-event time of ``fn()`` over ``reps`` calls, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def timed(fn) -> float:
    """Host seconds of ``fn()``; the explorer returns host arrays, so the
    device work is complete when it returns."""
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t


def fmt(xs) -> str:
    return "[" + ", ".join(f"{x:.3f}" for x in xs) + "]"


def rate(cells: int, secs) -> float:
    return cells * N_CAND / float(np.median(secs))


def profile_explore(ex, cand) -> None:
    """One explore under ``torch.profiler``: device time by kernel and the
    share of the host-clock span the device was busy.  Prints "not
    measured" when the profiler records no device time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        ex.explore(cand)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev_us = {}
    for evt in prof.key_averages():
        # kernel events only: an operator's entry repeats its kernels' time
        if str(evt.device_type).split(".")[-1] != "CUDA":
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        if us > 0:
            dev_us[evt.key] = dev_us.get(evt.key, 0.0) + us
    total = sum(dev_us.values())
    if total <= 0:
        print("profile: device time not measured (the profiler recorded "
              "no device events)", flush=True)
        return
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:8]
    print(f"profile (blocked explore, profiler on): span {wall_us / 1e3:.1f}"
          f" ms, device busy {total / 1e3:.1f} ms = "
          f"{100 * total / wall_us:.1f}% (idle {100 - 100 * total / wall_us:.1f}"
          f"%); by kernel:", flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms {100 * us / total:5.1f}%  {name[:90]}",
              flush=True)


def bound(triples: int, nbytes: int):
    """(least ms, "operations" | "bytes"): two FP32 instructions (add,
    max) per (i, j, k) triple, each input read and each output written
    once."""
    t_ops = 2.0 * triples / FP32_INSTR_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def operand(gen, shape, dev, neg_frac=0.5):
    """Closure-like float32 operands: path lengths in [0, 4096) with a
    ``neg_frac`` share of NEG (no edge)."""
    from repro_torch.kernels.maxplus import NEG
    x = torch.rand(shape, generator=gen, device=dev) * 4096.0
    x.masked_fill_(torch.rand(shape, generator=gen, device=dev) < neg_frac,
                   NEG)
    return x


def plain_in_chunks(plain, A, X, chunk: int) -> torch.Tensor:
    """The plain version over the whole batch, ``chunk`` items at a time
    (its k-slab intermediate would not fit the card in one piece)."""
    return torch.cat([plain(A[s:s + chunk], X[s:s + chunk])
                      for s in range(0, A.shape[0], chunk)])


def kernel_phase(K, path_batch: int, dev):
    """Phase 3: kernels vs plain versions; returns the kernels' rows."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    rows = {}

    # -- matmul at the closure-squaring shape, then ragged shapes --------
    b, m = path_batch, BLOCK
    A = operand(gen, (b, m, m), dev)
    B = operand(gen, (b, m, m), dev)
    out = K.maxplus_matmul(A, B)
    ref = plain_in_chunks(K.maxplus_matmul_torch, A, B, 2048)
    check(torch.equal(out, ref), f"maxplus_matmul != plain at {(b, m, m)}")
    err = float((out - ref).abs().max())
    del ref
    plain_ms = cuda_ms(lambda: plain_in_chunks(K.maxplus_matmul_torch, A, B,
                                               2048), reps=1)
    ms = cuda_ms(lambda: K.maxplus_matmul(A, B), reps=5)
    bms, by = bound(b * m * m * m, 3 * b * m * m * 4)
    for shape in ((7, 100, 70, 130), (3, 33, 17, 5), (2, 1, 1, 1)):
        bb, mm, kk, nn = shape
        a = operand(gen, (bb, mm, kk), dev, 0.2)
        x = operand(gen, (bb, kk, nn), dev, 0.2)
        check(torch.equal(K.maxplus_matmul(a, x),
                          K.maxplus_matmul_torch(a, x)),
              f"maxplus_matmul != plain at ragged {shape}")
    rows["maxplus_matmul"] = dict(
        shape=[b, m, m, m], ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, max_abs_err=err)
    print(f"maxplus_matmul ({b}, {m}, {m}) x ({b}, {m}, {m}): kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bms:.3f} ms "
          f"({by}), {100 * bms / ms:.1f}% of bound; equal bit for bit, "
          f"ragged shapes too", flush=True)
    del A, B, out

    # -- matvec at the per-block propagation shape, then ragged shapes ---
    b = N_CAND
    A = operand(gen, (b, m, m), dev)
    v = operand(gen, (b, m), dev)
    out = K.maxplus_matvec(A, v)
    ref = K.maxplus_matvec_torch(A, v)
    check(torch.equal(out, ref), f"maxplus_matvec != plain at {(b, m, m)}")
    err = float((out - ref).abs().max())
    plain_ms = cuda_ms(lambda: K.maxplus_matvec_torch(A, v), reps=5)
    ms = cuda_ms(lambda: K.maxplus_matvec(A, v), reps=20)
    bms, by = bound(b * m * m, (b * m * m + b * m + b * m) * 4)
    for shape in ((5, 70, 33), (3, 1, 300), (2, 1, 1)):
        bb, mm, kk = shape
        a = operand(gen, (bb, mm, kk), dev, 0.2)
        x = operand(gen, (bb, kk), dev, 0.2)
        check(torch.equal(K.maxplus_matvec(a, x),
                          K.maxplus_matvec_torch(a, x)),
              f"maxplus_matvec != plain at ragged {shape}")
    rows["maxplus_matvec"] = dict(
        shape=[b, m, m], ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, max_abs_err=err)
    print(f"maxplus_matvec ({b}, {m}, {m}) x ({b}, {m}): kernel {ms:.4f} ms,"
          f" plain {plain_ms:.3f} ms, bound {bms:.4f} ms ({by}), "
          f"{100 * bms / ms:.1f}% of bound; equal bit for bit, ragged "
          f"shapes too", flush=True)
    del A, v, out, ref
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    from repro_torch.core.aidg.explorer import (DEFAULT_SPACE, Explorer,
                                                compile_scenario,
                                                default_scenarios,
                                                random_candidates)
    from repro_torch.kernels import maxplus as K

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)

    # -- 2. build ---------------------------------------------------------
    t = time.perf_counter()
    lib = K.build()
    build_s = time.perf_counter() - t
    print(f"built {lib.name} in {build_s:.1f} s; nvcc -Xptxas -v said:",
          flush=True)
    print(lib.with_suffix(".log").read_text().strip(), flush=True)

    # -- 3. kernels vs plain versions --------------------------------------
    scen = default_scenarios()
    blocks = {sc.name: math.ceil(compile_scenario(sc).aidg.n / BLOCK)
              for sc in scen}
    path_batch = max(blocks.values()) * N_CAND
    print(f"blocks of {BLOCK} per cell: {blocks}", flush=True)
    rows = kernel_phase(K, path_batch, dev)

    # -- 4. the main path ---------------------------------------------------
    cand = random_candidates(DEFAULT_SPACE, N_CAND, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_counts()
    t = time.perf_counter()
    ex = Explorer(scen, engine="blocked", device=dev)
    init_s = time.perf_counter() - t
    t = time.perf_counter()
    res = ex.explore(cand)
    explore_s = time.perf_counter() - t
    t = time.perf_counter()
    inc = ex.refine(rounds=1, points=3)
    refine_s = time.perf_counter() - t
    launches, plain = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    print(f"launches {launches}, plain calls {plain} (Explorer build, "
          f"one explore, one refine)", flush=True)
    for name in K.LAUNCHES:
        check(launches[name] > 0, f"{name} never launched on the main path")
        check(plain[name] == 0, f"plain {name} ran on the main path")
    S = len(ex.compiled)
    blocked_s = [explore_s] + [timed(lambda: ex.explore(cand))
                               for _ in range(2)]
    print(f"blocked explore: {S} cells x {N_CAND} candidates, 3 runs "
          f"{fmt(blocked_s)} s -> median {rate(S, blocked_s):.0f} "
          f"cell-candidates/s; Explorer build + θ=1 baselines "
          f"{init_s:.3f} s; Pareto size {len(res.pareto)}; "
          f"refine(rounds=1, points=3) {refine_s:.3f} s -> "
          f"{np.round(inc, 4).tolist()}; peak device memory "
          f"{peak / 2**30:.2f} GiB", flush=True)

    t = time.perf_counter()
    ex_wf = Explorer(scen, engine="wavefront", device=dev)
    wf_init_s = time.perf_counter() - t
    t = time.perf_counter()
    res_wf = ex_wf.explore(cand)
    wf_s = [time.perf_counter() - t] + [timed(lambda: ex_wf.explore(cand))
                                        for _ in range(2)]
    print(f"wavefront explore: {S} cells x {N_CAND} candidates, 3 runs "
          f"{fmt(wf_s)} s -> median {rate(S, wf_s):.0f} cell-candidates/s "
          f"(Explorer build {wf_init_s:.3f} s)", flush=True)
    profile_explore(ex, cand)

    # -- 5. hold the result --------------------------------------------------
    golden = list(GOLDEN_THETA1_CYCLES.values())
    check(ex.scenario_names == list(GOLDEN_THETA1_CYCLES), "cell order")
    check(res.cycles[0].tolist() == golden,
          f"θ=1 row {res.cycles[0].tolist()} != golden {golden}")
    check(ex.baselines.tolist() == golden, "θ=1 baselines != golden")
    check(res_wf.cycles[0].tolist() == golden, "wavefront θ=1 != golden")
    for cs, est in zip(ex.compiled, ex.baselines):
        sim = cs.simulate()
        tol = cs.scenario.sim_tol
        ok = round(est) == sim if tol == 0.0 else abs(est - sim) / sim <= tol
        check(ok, f"{cs.name}: estimate {est} vs event simulator {sim}, "
                  f"sim_tol {tol}")
    check(np.isfinite(res.cycles).all() and res.cycles.shape == (N_CAND, S),
          "cycles finite, (candidates, cells)")
    rel = np.abs(res.cycles - res_wf.cycles) / np.abs(res_wf.cycles)
    cross = float(rel[:N_CROSS].max())
    check(cross <= CROSS_RTOL, f"blocked vs wavefront on {N_CROSS} "
                               f"candidates: rtol {cross} > {CROSS_RTOL}")
    per_cell = {n: f"{float(r):.2e}" for n, r in
                zip(ex.scenario_names, rel.max(axis=0))}
    print(f"θ=1 equals the golden cycles; baselines within sim_tol of the "
          f"event simulator; blocked vs wavefront max rel. difference "
          f"{cross:.3e} on {N_CROSS} candidates; on all {N_CAND}, by cell: "
          f"{per_cell}", flush=True)

    replaces = "src/repro/kernels/maxplus.py:29"
    source = "src/repro_torch/csrc/maxplus.cu"
    kernels = [dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=None,
                    shape=r["shape"], equal=True)
               for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
