#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one NVIDIA GPU and check it.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases — any failure exits non-zero; no phase is caught and passed over:

1. the card's name and power limit (``nvidia-smi``);
2. build every kernel source (``src/repro_torch/csrc/{maxplus,
   flash_attention,selective_scan,systolic_gemm}.cu``, the last two
   including ``csrc/hopper.cuh``) with ``nvcc`` (sm_90a) into
   ``build/repro_torch/``, one ``nvcc`` per source, all started together;
   print the build times and the ``-Xptxas -v`` register and
   shared-memory summaries;
3. each max-plus kernel against its plain PyTorch version on the card,
   bit for bit (``torch.equal``: max-plus is exact): the general matmul
   and matvec at the squaring loop's shapes (86016 closure squarings, the
   per-block matvec at 4096 candidates, NEG entries mixed in) and at
   ragged shapes; the blocked engine's entries -- the one-launch closure
   in lower mode on the real closure inputs of oma/gemm (its 21 diagonal
   structure blocks and the work of the 4096 seed-0 candidates, held
   chunk by chunk; full mode on the same inputs must equal it), full mode
   on dense operands (n 128, 100, 77, 32, 16, ragged batches), lower mode
   on random strictly-lower operands (n 128, 77, 16); the lower closure
   matvec on a real closure block at 4096 candidates and ragged shapes
   (vectors past 2^35 too); the folded sub-diagonal matvec at 4096 and
   ragged shapes and with block 0's all-NEG structure -- with the
   ``-Xptxas -v`` summary of each new entry point; CUDA-event times
   (after a warm-up call) of every kernel and plain version beside the
   bound, and for the blocked engine's entries also beside the dense
   bound (closure) and the general-kernel path on the same inputs (input
   passes + 7 x (general matmul + ``torch.maximum``); the general matvec;
   the written ``D + w`` operand + general matvec + ``torch.maximum``), and
   the two matvecs also as device time (CUDA-graph replay);
4. the Explorer path: ``Explorer(default_scenarios(), engine="blocked",
   device="cuda")``, ``explore`` over 4096 random candidates and a short
   coordinate-descent ``refine``, with the launch counters zeroed just
   before and read just after (the closure in lower mode, the lower and
   the folded matvec must have launched; no full mode, no general matmul
   or matvec, no plain version); two more timed explores for the spread,
   the same explore with the wavefront engine, and one blocked explore
   under ``torch.profiler`` for the device time by kernel;
5. its result: the θ = 1 row equals the golden cycles exactly, every
   baseline lies within its cell's ``sim_tol`` of the event simulator,
   and 256 candidates agree with the wavefront engine within rtol 1e-5;
   4b. the general kernels' path: ``longest_path_blocked`` at block 256
   (above the closure kernel's 128) on oma/gemm, counters zeroed just
   before and read just after (general matmul and matvec launched, none
   of the block-128 entries), equal on integer work to block 128;
6. flash attention and the selective scan against their plain versions
   on the card (TF32 off): flash at the LM path's shape (4 x 32 query
   heads over 4 x 8 KV heads, S = 2048, D = 128) in bf16 and in f32, at
   the prefill shape (S = 512) in bf16, ragged S = 1000, window 256 at S =
   1024, non-causal, Dv != Dq; the kernel ``flash_attention.plan`` picks
   for each case printed and checked against ``VARIANT_LAUNCHES`` (every
   bf16 D = 128 case on ``wgmma``); the scan at (4, 2048, 8192, 16) and
   (1, 1024, 8192, 16), jamba's two mamba shapes, and at (2, 33, 100, 8),
   the plan ``selective_scan.plan`` picks printed and checked against
   ``VARIANT_LAUNCHES`` (all three on the ring kernel), two calls equal
   bit for bit, the PR 12 kernel (private launcher) held to the same
   tolerance; float32 and scan tolerances from the reference's kernel
   tests, bf16 flash within ``bf16_error_bound`` (derived from bf16
   rounding); what ``-Xptxas -v`` said of the ``wgmma`` kernel and of the
   ring scan's planned instance (registers, spills, shared memory);
   CUDA-event times of kernel, plain version and, for flash,
   ``scaled_dot_product_attention`` beside the bound, at the two bf16
   shapes the PR 12 ``mma.sync`` kernel too (through the private launcher,
   held to the same bound), and at the scan's two jamba shapes the PR 12
   scan kernel, both also as device time (CUDA-graph replay);
7. jamba-v0.1-52b at full width, layers 0-7 (one pattern period: 1
   attention, 7 mamba, 4 MoE layers), float32 weights from a seed, B = 1,
   S = 1024: ``lm.forward`` with the kernel impls against the plain impls
   (``chunked``/``chunked_scan``) within the reference integration
   test's atol 3e-4, rtol 1e-3;
8. the LM serving path in bf16 (weights cast once, in place): each
   attention and mamba block with the kernel impls against the plain
   impls on the same bf16 input (within one bf16 unit in the last place,
   relative, in RMS and two at the largest element), and the kernel
   path's logits as near the float32 logits as the plain path's; scoring
   with ``Model.logits`` at B = 4, S = 2048 through the kernels (timed 3
   times), then generation as ``examples/serve.py`` does it --
   ``init_cache``, ``lm.prefill(impl="flash_pallas")`` on a 512-token
   prompt, 32 greedy ``decode_step``s -- with the counters zeroed just
   before and read just after each (flash once -- on the ``wgmma`` kernel
   -- and the scan 7 times per forward, on the ring kernel, no plain
   version on the card);
   peak memory, and one scoring forward under ``torch.profiler``;
9. the systolic GEMM through ``kernels.ops.gemm`` at olmo-1b's distinct
   GEMM shapes, as the port's ``extract_operators`` gives them (decode at
   the network cells' shape, M = 8, and prefill at 4 x 2048, M = 8192; K
   = 2048, N in {2048, 4096, 24576, 50304}): bf16 in, float32 out at
   every shape, ReLU at the ``mlp`` shape, and at the prefill ``mlp``
   shape also float32 in and out (TF32 off) and bf16 in and out; the
   kernel ``plan`` picks for each (``wgmma`` at prefill, ``splitk`` at
   decode); the counters zeroed just before and read just after (each
   product on its planned kernel, none on ``mma_sync``); each result held
   element by element within ``systolic_gemm.error_bound`` of the plain
   version, the ``mma.sync`` kernel on the same bf16 inputs too; times of
   the kernel, the ``mma.sync`` kernel and ``torch.matmul`` through CUDA
   events around back-to-back calls and as device time (CUDA-graph
   replay; decode rotating B through copies beyond the L2), and of the
   plain version, beside the bound;
10. the default packed Explorer over the 10 operator cells and the 21
   network cells, ``Explorer(networks=True, device="cuda")``: θ = 1 equal
   to the operator goldens and within rel 1e-4 of the network goldens,
   packed against the blocked engine of phase 4 on 256 candidates within
   ``PACKED_VS_BLOCKED``; build time, ``PackedMatrix.stats()``, explore
   rate over 4096 candidates (median of 3 after a warm-up), the device's
   idle share from one profiled explore and peak memory; no plain version
   of any kernel may run;
11. the DSE query service (``repro_torch.serve``) over phase 10's
   Explorer, the kernels' counters zeroed just before and read just after
   (the serving path reaches no kernel and no plain version): (a) 8 client
   threads x 168 queries (the 21 distinct questions of
   ``benchmarks/bench_serve.py``'s CPU row, 8 times each) on a fresh
   service (pool 128, chunk 128, max batch 8, window 5 ms) after a warm
   one -- q/s, hit ratio, windows, device dispatches, mean batch,
   configs/s, cells -- every answer equal to a direct ``evaluate_full``
   plus ranking of the same block and to a sequential replay; (b) the
   surrogate trained on the card (``train_surrogate``, default config),
   held on 48 fresh draws to ``tests/test_oracle_chain.py``'s bounds
   (each cell's coverage >= 0.85 and median within its bound, matrix-wide
   medians <= 2%, cells over the 2% routing bound <= 30%), the
   surrogate-only and packed-only cold streams timed per query; (c) a
   fault plan that opens the breaker: covered queries answered
   ``surrogate-degraded`` with the widened bound, uncovered ones
   ``OracleUnavailable``, exact packed answers after the probe, equal to
   those before; (d) ``n_shards()`` against ``torch.cuda.device_count()``,
   ``evaluate_full(sharded=True)`` and the split forced over four slices
   of the card, bit for bit the unsharded evaluation;

each phase's time, then one ``{"kernels": [...]}`` line, the card line
again, and as the last line ``{"ok": true, "device": {...}}``.  It needs
one card; without one it exits non-zero before printing any result.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
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
BF16_FLOP_PER_S = 989e12   # tensor cores, dense (H100 SXM data sheet)
FP32_FLOP_PER_S = 67e12    # CUDA cores (same data sheet; an FMA counts as two)
# special-function unit: 16 exponentials per clock per SM (H100 SXM: 132
# SMs at 1.98 GHz)
EXP_PER_S = 132 * 16 * 1.98e9
BLOCK = 128            # the blocked engine's block size

# -- the LM path: jamba-v0.1-52b at full width, one pattern period --------
LM_ARCH = "jamba_v01_52b"
LM_LAYERS = 8          # layers 0-7: attention at 3, MoE at 1, 3, 5, 7
F32_B, F32_S = 1, 1024
SCORE_B, SCORE_S = 4, 2048
PROMPT, GEN = 512, 32
FLASH_F32_TOL = (2e-4, 1e-3)  # the reference's kernel tests
# bf16 flash: element by element within FA.bf16_error_bound (bf16 rounding)
SCAN_TOL = (1e-4, 1e-4)
LOGITS_TOL = (3e-4, 1e-3)  # tests/test_kernel_integration.py
# bf16 serving: the kernel path's logits may lie at most this factor
# further (RMS) from the float32 logits than the plain path's
BF16_PARITY = 1.1

# -- the systolic GEMM at olmo-1b's shapes ----------------------------------
GEMM_ARCH = "olmo_1b"
PREFILL_B, PREFILL_S = 4, 2048
# -- the packed Explorer: packed vs the blocked engine of phase 4, relative;
# the two order a queue's tied arrivals differently (the reference's own
# notes allow about 0.3%)
PACKED_VS_BLOCKED = 3e-3

# -- the DSE query service over phase 10's Explorer --------------------------
# benchmarks/bench_serve.py's serve/throughput row: 8 clients, each distinct
# question 8 times, a pool of 128 candidates evaluated 128 rows at a time
SERVE_KW = dict(pool=128, chunk=128, max_batch=8, window_s=0.005)
SERVE_CLIENTS = 8
SERVE_REPS = 8
# the surrogate against fresh draws: tests/test_oracle_chain.py's bounds
N_FRESH = 48
FRESH_SEED = 20260808
COVERAGE_MIN = 0.85    # share of draws inside each cell's own bound
MEDIAN_MAX = 0.02      # matrix-wide median relative error
INELIGIBLE_MAX = 0.30  # share of cells over the default routing bound
# the sharded evaluator's split, one card standing in for four
SHARD_SLICES = 4
SHARD_BATCH = 1003     # not a multiple of 4: the split pads

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
# θ = 1 end-to-end cycles of the 21 network cells, pinned in the
# reference's tests (tests/test_network.py), held within rel 1e-4
GOLDEN_E2E_THETA1 = {
    "oma/whisper_small": 9.2163109e+12,
    "systolic/whisper_small": 2.0121045e+12,
    "gamma/whisper_small": 1.0193998e+11,
    "eyeriss/whisper_small": 1.5446227e+11,
    "plasticine/whisper_small": 9.1819614e+10,
    "tpu_v5e/whisper_small": 1.7191464e+07,
    "oma/olmo_1b": 7.1448527e+10,
    "systolic/olmo_1b": 1.5598639e+10,
    "gamma/olmo_1b": 8.8078502e+08,
    "eyeriss/olmo_1b": 1.1975136e+09,
    "plasticine/olmo_1b": 7.1182234e+08,
    "tpu_v5e/olmo_1b": 5.3353780e+06,
    "oma/olmoe_1b_7b": 7.1562822e+10,
    "systolic/olmoe_1b_7b": 1.5623592e+10,
    "gamma/olmoe_1b_7b": 8.8229747e+08,
    "eyeriss/olmoe_1b_7b": 1.1994728e+09,
    "plasticine/olmoe_1b_7b": 7.1296102e+08,
    "tpu_v5e/olmoe_1b_7b": 2.2523700e+06,
    "gamma/falcon_mamba_7b": 4.9923226e+09,
    "plasticine/falcon_mamba_7b": 3.7337580e+09,
    "tpu_v5e/falcon_mamba_7b": 3.1134014e+07,
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


def profile_call(fn, label: str, watch=()) -> None:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    and the share of the host-clock span the device was busy, and the
    summed device time of the kernels whose names hold each string of
    ``watch``.  Prints "not measured" when the profiler records no device
    time."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
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
        print(f"profile ({label}): device time not measured (the profiler "
              f"recorded no device events)", flush=True)
        return
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:10]
    print(f"profile ({label}, profiler on): span {wall_us / 1e3:.1f}"
          f" ms, device busy {total / 1e3:.1f} ms = "
          f"{100 * total / wall_us:.1f}% (idle {100 - 100 * total / wall_us:.1f}"
          f"%); by kernel:", flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms {100 * us / total:5.1f}%  {name[:90]}",
              flush=True)
    for part in watch:
        us = sum(v for k, v in dev_us.items() if part in k)
        print(f"  kernels named *{part}*: {us / 1e3:.2f} ms "
              f"{100 * us / total:.1f}% of the device time", flush=True)


def bound(triples: int, nbytes: int):
    """(least ms, "operations" | "bytes"): two FP32 instructions (add,
    max) per (i, j, k) triple, each input read and each output written
    once."""
    return bound_instr(2 * triples, nbytes)


def bound_instr(instr: int, nbytes: int):
    """(least ms, "operations" | "bytes") of ``instr`` FP32 instructions
    moving ``nbytes``."""
    t_ops = instr / FP32_INSTR_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def closure_useful_instr(n: int) -> int:
    """FP32 instructions one squaring ``P <- max(P, P ⊗ P)`` of a strictly
    lower-triangular n x n block needs: P_kk stays 0, so only the triples
    j < k < i can change an entry (an add and a max each, C(n, 3) of
    them), and every entry with i >= j takes one max with the old P."""
    return 2 * math.comb(n, 3) + n * (n + 1) // 2


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
    rows.update(closure_phase(K, gen, dev))
    for r in rows.values():     # no PyTorch call computes a max-plus product
        r.update(source="src/repro_torch/csrc/maxplus.cu",
                 replaces="src/repro/kernels/maxplus.py:29", library_ms=None)
    return rows


def path_closure_inputs(dev):
    """The blocked engine's closure inputs for the path's largest cell,
    oma/gemm, at block 128: its diagonal and sub-diagonal structure
    blocks (nb, 128, 128), and the work of the N_CAND seed-0 random
    candidates, blocks-major (nb, N_CAND, 128), as ``Solver.relax_for``
    builds them from ``dse._reweight``."""
    from repro_torch.core.aidg import dse as DSE
    from repro_torch.core.aidg.explorer import (DEFAULT_SPACE,
                                                compile_scenario,
                                                default_scenarios,
                                                random_candidates)
    from repro_torch.core.aidg.maxplus import _blocked_structure
    sc = next(s for s in default_scenarios() if s.name == "oma/gemm")
    cs = compile_scenario(sc)
    cand = random_candidates(DEFAULT_SPACE, N_CAND, seed=0)
    to, ts = DEFAULT_SPACE.theta_for(cs.problem, cand)
    T = lambda x: torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                  device=dev)
    work = DSE._reweight(cs.problem, T(to), T(ts))[0]
    Dd, Ds = _blocked_structure(cs.compiled_aidg, BLOCK)[:2]
    nb, n = Dd.shape[0], work.shape[1]
    wp = torch.cat([work, torch.zeros((N_CAND, nb * BLOCK - n), device=dev)],
                   dim=1)
    wb = wp.view(N_CAND, nb, BLOCK).permute(1, 0, 2).contiguous()
    return cs, T(Dd), T(Ds), wb


def strictly_lower(x):
    """``x`` with NEG on and above the diagonal of every block."""
    n = x.shape[-1]
    upper = torch.ones((n, n), dtype=torch.bool, device=x.device).triu()
    return x.masked_fill(upper, -1e18)


def squaring_loop_closure(K, Dd, wb, steps):
    """The closure as a loop over the general matmul computes it (the
    blocked engine's path before the closure kernel): the (nb, B, n, n) input
    ``Dd + w`` and ``max(M, I)`` written out, then per squaring one general
    matmul launch and a ``torch.maximum``."""
    n = Dd.shape[-1]
    eye = torch.full((n, n), -1e18, device=Dd.device)
    eye.fill_diagonal_(0.0)
    P = torch.maximum(Dd[:, None] + wb[..., None], eye).reshape(-1, n, n)
    for _ in range(steps):
        Q = K.maxplus_matmul(P, P)
        P = torch.maximum(P, Q, out=Q)
    return P


def closure_phase(K, gen, dev):
    """Phase 3, the blocked engine's redesigned entries: the closure kernel
    (lower mode on the real oma/gemm closure inputs at N_CAND candidates,
    full mode on dense operands, lower mode on random strictly-lower
    operands) and the two propagation matvecs, each bit for bit against its
    plain version, timed beside its bound, the dense bound and the path
    before them (one general kernel launch per squaring or matvec) on the
    same inputs.  Returns their rows."""
    from repro_torch.core.aidg.maxplus import _diagonal_facts
    rows = {}
    cs, Dd, Ds, wb = path_closure_inputs(dev)
    nb, n = Dd.shape[0], BLOCK
    steps = int(math.ceil(math.log2(n)))
    items = nb * N_CAND
    lower, dmax = _diagonal_facts(cs.compiled_aidg, n)
    variant = K.plan_closure(n, lower, n * (dmax + float(wb.abs().max())))
    check(variant == "closure_lower", f"oma/gemm planned {variant}")

    # -- the closure, lower mode, on the path's inputs ---------------------
    out = K.maxplus_closure(Dd, steps, wb, variant="closure_lower")
    chunk = 96
    err = 0.0
    for s in range(0, N_CAND, chunk):
        ref = K.maxplus_closure_torch(Dd, steps, wb[:, s:s + chunk])
        check(torch.equal(out[:, s:s + chunk], ref),
              f"maxplus_closure (lower) != plain at candidates {s}..")
        err = max(err, float((out[:, s:s + chunk] - ref).abs().max()))
    del ref
    full = K.maxplus_closure(Dd, steps, wb, variant="closure_full")
    check(torch.equal(full, out), "closure full mode != lower mode on the "
                                  "path's inputs")
    del full
    C_last = out[nb - 1].clone()        # a real closure block for the matvec
    del out
    torch.cuda.empty_cache()
    ms = cuda_ms(lambda: K.maxplus_closure(Dd, steps, wb,
                                           variant="closure_lower"), reps=5)
    full_ms = cuda_ms(lambda: K.maxplus_closure(Dd, steps, wb,
                                                variant="closure_full"),
                      reps=2)
    old_ms = cuda_ms(lambda: squaring_loop_closure(K, Dd, wb, steps),
                     reps=2)
    plain_ms = cuda_ms(lambda: [K.maxplus_closure_torch(Dd, steps,
                                                        wb[:, s:s + chunk])
                                for s in range(0, N_CAND, chunk)], reps=1)
    torch.cuda.empty_cache()
    useful = steps * items * closure_useful_instr(n)
    nbytes = (items * n * n + Dd.numel() + wb.numel()) * 4
    bms, by = bound_instr(useful, nbytes)
    dense_ms, _ = bound(steps * items * n ** 3, nbytes)
    # full mode, dense operands with NEG mixed in, ragged n and batches
    for nn, bb in ((128, 333), (100, 7), (32, 1000), (16, 5)):
        st = int(math.ceil(math.log2(nn)))
        M = operand(gen, (bb, nn, nn), dev)
        check(torch.equal(K.maxplus_closure(M, st, variant="closure_full"),
                          K.maxplus_closure_torch(M, st)),
              f"maxplus_closure (full) != plain at ({bb}, {nn}, {nn})")
    D3 = operand(gen, (3, 77, 77), dev, 0.7)
    w3 = operand(gen, (3, 111, 77), dev, 0.0)
    check(torch.equal(K.maxplus_closure(D3, 7, w3, variant="closure_full"),
                      K.maxplus_closure_torch(D3, 7, w3)),
          "maxplus_closure (full, structure + work) != plain")
    # lower mode, random strictly-lower structure + work
    for nn, g, bb in ((128, 2, 333), (77, 3, 50), (16, 1, 7)):
        st = int(math.ceil(math.log2(nn)))
        D = strictly_lower(operand(gen, (g, nn, nn), dev, 0.7))
        w = operand(gen, (g, bb, nn), dev, 0.0)
        check(torch.equal(K.maxplus_closure(D, st, w,
                                            variant="closure_lower"),
                          K.maxplus_closure_torch(D, st, w)),
              f"maxplus_closure (lower) != plain at ({g}, {bb}, {nn})")
    rows["maxplus_closure"] = dict(
        shape=[items, n, n, steps], ms=ms, plain_ms=plain_ms, bound_ms=bms,
        bound_by=by, max_abs_err=err, variant="closure_lower",
        full_mode_ms=full_ms, dense_bound_ms=dense_ms, old_path_ms=old_ms)
    print(f"maxplus_closure lower mode, oma/gemm's {nb} blocks x {N_CAND} "
          f"candidates = ({items}, {n}, {n}) x {steps} squarings: kernel "
          f"{ms:.3f} ms, {100 * bms / ms:.1f}% of the useful-triple bound "
          f"{bms:.3f} ms ({by}), {100 * dense_ms / ms:.1f}% of the dense "
          f"bound {dense_ms:.3f} ms; full mode {full_ms:.3f} ms "
          f"({100 * dense_ms / full_ms:.1f}% of the dense bound); squaring "
          f"loop (input passes + {steps} x (general matmul + torch.maximum)) "
          f"{old_ms:.3f} ms = {old_ms / ms:.2f}x; plain {plain_ms:.1f} ms; "
          f"equal to plain bit for bit (both modes), ragged and random "
          f"operands too", flush=True)
    del Dd, wb
    torch.cuda.empty_cache()

    # -- the closure matvec on a real closure block --------------------------
    b = N_CAND
    h = operand(gen, (b, n), dev, 0.2)
    out = K.maxplus_matvec_lower(C_last, h)
    ref = K.maxplus_matvec_torch(C_last, h)
    check(torch.equal(out, ref),
          "maxplus_matvec_lower != plain at the path shape")
    err = float((out - ref).abs().max())
    ms = cuda_ms(lambda: K.maxplus_matvec_lower(C_last, h), reps=50)
    dev_ms = graph_ms([lambda: K.maxplus_matvec_lower(C_last, h)], reps=50)
    old_ms = cuda_ms(lambda: K.maxplus_matvec(C_last, h), reps=50)
    plain_ms = cuda_ms(lambda: K.maxplus_matvec_torch(C_last, h), reps=5)
    bms, by = bound(b * n * (n + 1) // 2,
                    (b * n * (n + 1) // 2 + 2 * b * n) * 4)
    for nn, bb in ((77, 5), (16, 300), (128, 3)):
        D = strictly_lower(operand(gen, (1, nn, nn), dev, 0.7))
        C = K.maxplus_closure(D, 7, operand(gen, (1, bb, nn), dev, 0.0),
                              variant="closure_lower")[0]
        hh = operand(gen, (bb, nn), dev, 0.2) * 2.0 ** 30   # past 2^35 too
        check(torch.equal(K.maxplus_matvec_lower(C, hh),
                          K.maxplus_matvec_torch(C, hh)),
              f"maxplus_matvec_lower != plain at ({bb}, {nn})")
    rows["maxplus_matvec_lower"] = dict(
        shape=[b, n, n], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        max_abs_err=err, old_path_ms=old_ms, device_ms=dev_ms)
    print(f"maxplus_matvec_lower ({b}, {n}, {n}) x ({b}, {n}), a real "
          f"closure block: kernel {ms:.4f} ms, device {dev_ms:.4f} ms "
          f"({100 * bms / dev_ms:.1f}% of bound {bms:.4f} ms, {by}); "
          f"general matvec {old_ms:.4f} "
          f"ms = {old_ms / ms:.2f}x; plain {plain_ms:.3f} ms; equal bit for "
          f"bit, ragged shapes and |h| past 2^35 too", flush=True)
    del C_last, h, out, ref

    # -- the folded sub-diagonal matvec -------------------------------------
    Db = Ds[nb - 1].contiguous()
    w = operand(gen, (b, n), dev, 0.0)
    prev, h0 = operand(gen, (b, n), dev, 0.1), operand(gen, (b, n), dev, 0.5)
    out = K.maxplus_matvec_folded(Db, w, prev, h0)
    ref = K.maxplus_matvec_folded_torch(Db, w, prev, h0)
    check(torch.equal(out, ref),
          "maxplus_matvec_folded != plain at the path shape")
    err = float((out - ref).abs().max())
    ms = cuda_ms(lambda: K.maxplus_matvec_folded(Db, w, prev, h0), reps=50)
    dev_ms = graph_ms([lambda: K.maxplus_matvec_folded(Db, w, prev, h0)],
                      reps=50)
    old_ms = cuda_ms(lambda: torch.maximum(
        h0, K.maxplus_matvec(Db + w[:, :, None], prev)), reps=20)
    plain_ms = cuda_ms(lambda: K.maxplus_matvec_folded_torch(Db, w, prev, h0),
                       reps=5)
    t_ops = 3.0 * b * n * n / FP32_INSTR_PER_S * 1e3
    t_bytes = (n * n + 4 * b * n) * 4 / HBM_BYTES_PER_S * 1e3
    bms, by = (t_ops, "operations") if t_ops >= t_bytes else (t_bytes,
                                                              "bytes")
    for nn, bb, all_neg in ((77, 33, False), (16, 7, False), (128, 5, True)):
        D = (torch.full((nn, nn), -1e18, device=dev) if all_neg
             else operand(gen, (nn, nn), dev, 0.8))
        ww, pp, hh = (operand(gen, (bb, nn), dev, f) for f in (0.0, 0.1, 0.5))
        check(torch.equal(K.maxplus_matvec_folded(D, ww, pp, hh),
                          K.maxplus_matvec_folded_torch(D, ww, pp, hh)),
              f"maxplus_matvec_folded != plain at ({bb}, {nn}), all-NEG "
              f"{all_neg}")
    rows["maxplus_matvec_folded"] = dict(
        shape=[b, n, n], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
        max_abs_err=err, old_path_ms=old_ms, device_ms=dev_ms)
    print(f"maxplus_matvec_folded (D {n} x {n}) + ({b}, {n}) work, ({b}, "
          f"{n}) prev: kernel {ms:.4f} ms, device {dev_ms:.4f} ms "
          f"({100 * bms / dev_ms:.1f}% of bound {bms:.4f} ms, {by}); "
          f"unfolded step (D + w written, general matvec, "
          f"torch.maximum) {old_ms:.4f} ms = {old_ms / ms:.2f}x; plain "
          f"{plain_ms:.3f} ms; equal bit for bit, ragged shapes and block "
          f"0's all-NEG D too", flush=True)
    del Ds, Db, w, prev, h0, out, ref
    torch.cuda.empty_cache()
    return rows


def general_path_phase(K, dev):
    """Phase 4b: ``longest_path_blocked`` at block 256 -- above the closure
    kernel's 128, so every squaring takes the general matmul and every
    propagation the general matvec -- on oma/gemm, N_CROSS candidates of
    integer work (the AIDG's own scaled by 1..4, so every sum is exact):
    equal to the block-128 path (the redesigned entries) exactly, with the
    launch counters zeroed just before and read just after.  Returns the
    general kernels' launches."""
    from repro_torch.core.aidg.explorer import (compile_scenario,
                                                default_scenarios)
    from repro_torch.core.aidg.maxplus import longest_path_blocked
    sc = next(s for s in default_scenarios() if s.name == "oma/gemm")
    ca = compile_scenario(sc).compiled_aidg
    rng = np.random.default_rng(0)
    work = (ca.aidg.work[None]
            * rng.integers(1, 5, (N_CROSS, ca.aidg.n))).astype(np.float32)
    K.reset_counts()
    t = time.perf_counter()
    t256 = longest_path_blocked(ca, block=256, work=work, device=dev)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t
    launches, plain = dict(K.LAUNCHES), dict(K.PLAIN_CALLS)
    for name in ("maxplus_matmul", "maxplus_matvec"):
        check(launches[name] > 0, f"{name} never launched at block 256")
    for name in ("maxplus_closure", "maxplus_matvec_lower",
                 "maxplus_matvec_folded"):
        check(launches[name] == 0, f"{name} ran at block 256")
    check(sum(plain.values()) == 0, f"plain versions ran: {plain}")
    t128 = longest_path_blocked(ca, block=128, work=work, device=dev)
    check(torch.equal(t256, t128), "block 256 != block 128 on integer work")
    print(f"blocked engine at block 256 (oma/gemm, {N_CROSS} candidates of "
          f"integer work): {secs:.3f} s, launches {launches}; equal to the "
          f"block-128 path", flush=True)
    return {name: launches[name] for name in ("maxplus_matmul",
                                              "maxplus_matvec")}


# ---------------------------------------------------------------------------
# the LM path: flash attention, the selective scan, jamba at full width
# ---------------------------------------------------------------------------


def within(out: torch.Tensor, want: torch.Tensor, tol) -> tuple:
    """(max |out - want|, elements outside atol + rtol |want|)."""
    atol, rtol = tol
    out, want = out.float(), want.float()
    err = (out - want).abs()
    bad = int((err > atol + rtol * want.abs()).sum())
    return float(err.max()), bad


def flash_bound(q, k, v, causal: bool):
    """(least ms, "operations" | "bytes") of attention on these inputs:
    the multiply-adds the mask leaves (rows i keep i + 1 keys when causal)
    at the peak rate of the inputs' type, or the bytes of q, k, v and o."""
    bh, s, dq = q.shape
    dv = v.shape[2]
    pairs = bh * (s * (s + 1) // 2 if causal else s * k.shape[1])
    flops = 2.0 * pairs * (dq + dv)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + bh * s * dv)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def scan_bound(x, b):
    """(least ms, ...) of the scan: one exponential per (step, channel,
    state) at the special-function units' rate (the FP32 work, 6 flops per
    state, is below it), or one read of every input and one write of y."""
    bsz, s, dm = x.shape
    exps = bsz * s * dm * b.shape[-1]
    t_ops = max(exps / EXP_PER_S, 6.0 * exps / FP32_FLOP_PER_S) * 1e3
    nbytes = (3 * x.numel() + 2 * b.numel() + b.shape[-1] * dm + dm) * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def ptxas_summary(log: str, kernel: str) -> str:
    """What ``nvcc -Xptxas -v`` said of the entry points whose mangled
    name holds ``kernel``: registers, spills, stack, shared memory."""
    out, take = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            take = kernel in line
            continue
        if take and "Function properties" not in line:
            out.append(line.replace("ptxas info    :", "").strip())
    return "; ".join(out) or "not found in the build log"


def lm_kernel_phase(FA, SS, dev):
    """Phase 6: flash attention and the scan vs their plain versions."""
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import _build
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    a = get_config(LM_ARCH).attention
    H, KV, D = a.n_heads, a.n_kv_heads, a.head_dim
    rows = {}

    def rand(shape, dtype=torch.float32, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale
                ).to(dtype)

    def flash_case(label, bh, bkv, s, dq, dv, dtype, causal=True, window=0):
        q, k, v = (rand((bh, s, dq), dtype), rand((bkv, s, dq), dtype),
                   rand((bkv, s, dv), dtype))
        variant = FA.plan(dq, dv, dtype, FA._aligned16(q, k, v))
        before = dict(FA.VARIANT_LAUNCHES)
        out = FA.flash_attention(q, k, v, causal=causal, window=window)
        ran = [n for n in FA.VARIANTS if FA.VARIANT_LAUNCHES[n] != before[n]]
        check(ran == [variant], f"flash {label}: planned {variant}, ran {ran}")
        if dtype == torch.bfloat16 and dq == dv == D:
            check(variant == "wgmma", f"flash {label}: {variant} on a bf16 "
                                      f"D = {D} case, not wgmma")
        want = FA.flash_attention_torch(q, k, v, causal=causal,
                                        window=window)
        if dtype == torch.float32:
            err, bad = within(out, want, FLASH_F32_TOL)
            limit = f"atol/rtol {FLASH_F32_TOL}"
        else:
            diff = (out.float() - want.float()).abs()
            bnd = FA.bf16_error_bound(q, k, v, causal=causal, window=window)
            err, bad = float(diff.max()), int((diff > bnd).sum())
            limit = (f"the bf16 bound (max |err| / bound "
                     f"{float((diff / bnd).max()):.3f}; RMS of plain "
                     f"{float(want.float().square().mean().sqrt()):.3e})")
            del diff, bnd
        check(bad == 0, f"flash {label}: {bad} elements outside {limit}, "
                        f"max |err| {err:.3e}")
        print(f"flash_attention {label} (BH {bh}/{bkv}, S {s}, Dq {dq}, Dv "
              f"{dv}, {str(dtype)[6:]}, causal {causal}, window {window}) "
              f"[{variant}]: max |kernel - plain| {err:.3e} within {limit}",
              flush=True)
        return q, k, v, err

    def sdpa(q, k, v):
        """``scaled_dot_product_attention`` on the same (B, H, S, D)
        views, GQA without copies -- the yardstick, never the port."""
        b = SCORE_B
        q4, k4, v4 = (t.view(b, t.shape[0] // b, t.shape[1], t.shape[2])
                      for t in (q, k, v))
        return lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)

    def bf16_times(label, q, k, v):
        """The wgmma kernel (through ``flash_attention``), the PR 12
        mma.sync kernel (private launcher, held against the plain version
        too), SDPA and the bound, at one causal shape."""
        ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True),
                     reps=20)
        old = FA._launch(q, k, v, True, 0, None, "mma_sync")
        diff = (old.float() - FA.flash_attention_torch(q, k, v).float()).abs()
        bnd = FA.bf16_error_bound(q, k, v)
        check(bool((diff <= bnd).all()),
              f"flash {label}: the mma.sync kernel beyond the bf16 bound")
        old_worst = float((diff / bnd).max())
        del old, diff, bnd
        old_ms = cuda_ms(lambda: FA._launch(q, k, v, True, 0, None,
                                            "mma_sync"), reps=20)
        lib_ms = cuda_ms(sdpa(q, k, v), reps=20)
        bms, by = flash_bound(q, k, v, causal=True)
        print(f"flash_attention {label} bfloat16 [wgmma]: kernel {ms:.4f} ms"
              f" ({100 * bms / ms:.1f}% of bound {bms:.4f} ms, {by}); "
              f"mma.sync kernel {old_ms:.4f} ms ({old_ms / ms:.2f}x the "
              f"wgmma kernel's time; max |err| / bf16 bound "
              f"{old_worst:.3f}); scaled_dot_product_attention "
              f"{lib_ms:.4f} ms (kernel / SDPA {ms / lib_ms:.3f})",
              flush=True)
        return dict(label=label, shape=list(q.shape) + [k.shape[0]], ms=ms,
                    old_kernel_ms=old_ms, library_ms=lib_ms, bound_ms=bms,
                    bound_by=by, old_kernel_err_over_bound=old_worst)

    log = _build.library_path(FA.SOURCE).with_suffix(".log").read_text()
    smem = _build.load(FA.SOURCE, FA._bind).flash_attention_wgmma_smem_bytes()
    print(f"flash_attention_wgmma_kernel, nvcc -Xptxas -v: "
          f"{ptxas_summary(log, 'flash_attention_wgmma_kernel')}; dynamic "
          f"shared memory {smem} B", flush=True)
    # the path shape: B x H query heads over B x KV key/value heads
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v, err = flash_case("path shape", SCORE_B * H, SCORE_B * KV,
                                  SCORE_S, D, D, dtype)
        plain_ms = cuda_ms(lambda: FA.flash_attention_torch(q, k, v,
                                                            causal=True),
                           reps=2)
        if dtype == torch.bfloat16:
            cases = [bf16_times("path shape", q, k, v)]
            del q, k, v
            q, k, v, _ = flash_case("prefill shape", SCORE_B * H,
                                    SCORE_B * KV, PROMPT, D, D, dtype)
            cases.append(bf16_times("prefill shape", q, k, v))
            rows["flash_attention"] = dict(
                cases[0], dtype="bfloat16", plain_ms=plain_ms,
                max_abs_err=err, variant="wgmma", cases=cases,
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:32")
        else:
            ms = cuda_ms(lambda: FA.flash_attention(q, k, v, causal=True),
                         reps=10)
            bms, by = flash_bound(q, k, v, causal=True)
            print(f"flash_attention path shape float32 [cuda_core]: kernel "
                  f"{ms:.3f} ms, plain {plain_ms:.3f} ms, "
                  f"scaled_dot_product_attention "
                  f"{cuda_ms(sdpa(q, k, v), reps=3):.3f} ms, bound "
                  f"{bms:.4f} ms ({by}), {100 * bms / ms:.1f}% of bound",
                  flush=True)
        del q, k, v
    for dtype in (torch.float32, torch.bfloat16):
        flash_case("ragged", 8, 2, 1000, D, D, dtype)
        flash_case("window 256", 8, 2, 1024, D, D, dtype, window=256)
        flash_case("non-causal", 8, 2, 1000, D, D, dtype, causal=False)
        flash_case("Dv != Dq", 8, 2, 1024, D, 64, dtype)

    # the scan at jamba's two mamba shapes (scoring, the float32 check),
    # then a ragged one
    di = get_config(LM_ARCH).ssm.d_inner(get_config(LM_ARCH).d_model)
    n = get_config(LM_ARCH).ssm.d_state
    ss_log = _build.library_path(SS.SOURCE).with_suffix(".log").read_text()
    cases = []
    for (bsz, s, dm, ns) in ((SCORE_B, SCORE_S, di, n), (F32_B, F32_S, di, n),
                             (2, 33, 100, 8)):
        x = rand((bsz, s, dm), scale=0.5)
        dt = rand((bsz, s, dm), scale=0.1).abs()
        b, c = rand((bsz, s, ns)), rand((bsz, s, ns))
        A = -(rand((dm, ns)).abs() + 0.1)
        d = rand((dm,))
        ins = (x, dt, b, c, A, d)
        p = SS.plan(bsz, s, dm, ns, SS._aligned16(x, dt))
        label = f"selective_scan ({bsz}, {s}, {dm}, {ns})"
        check(p.variant == "ring", f"{label}: planned {p.variant}, not ring")
        before = dict(SS.VARIANT_LAUNCHES)
        out = SS.selective_scan(*ins)
        again = SS.selective_scan(*ins)
        ran = {v: SS.VARIANT_LAUNCHES[v] - before[v] for v in SS.VARIANTS}
        check(ran == {v: 2 * (v == p.variant) for v in SS.VARIANTS},
              f"{label}: planned {p.variant}, ran {ran}")
        check(torch.equal(out, again), f"{label}: two calls differ")
        want = SS.selective_scan_torch(*ins)
        err, bad = within(out, want, SCAN_TOL)
        old_err, old_bad = within(SS._launch(*ins, "pr12"), want, SCAN_TOL)
        print(f"{label} {p}: max |kernel - plain| {err:.3e}, {bad} elements "
              f"outside atol/rtol {SCAN_TOL}; two calls bit for bit equal; "
              f"the PR 12 kernel {old_err:.3e}, {old_bad} outside",
              flush=True)
        check(bad == 0 and old_bad == 0,
              f"{label}: {bad} (PR 12 kernel: {old_bad}) elements outside "
              f"{SCAN_TOL}, max |err| {err:.3e} ({old_err:.3e})")
        if dm == di:
            ms = cuda_ms(lambda: SS.selective_scan(*ins), reps=10)
            old_ms = cuda_ms(lambda: SS._launch(*ins, "pr12"), reps=10)
            dev_ms = graph_ms([lambda: SS.selective_scan(*ins)], 10)
            old_dev_ms = graph_ms([lambda: SS._launch(*ins, "pr12")], 10)
            plain_ms = cuda_ms(lambda: SS.selective_scan_torch(*ins), reps=1)
            bms, by = scan_bound(x, b)
            print(f"{label} [ring, {p.lanes} lanes]: kernel {ms:.4f} ms "
                  f"(device {dev_ms:.4f}; {100 * bms / ms:.1f}% of bound "
                  f"{bms:.4f} ms, {by}); PR 12 kernel {old_ms:.4f} ms (device "
                  f"{old_dev_ms:.4f}; {old_ms / ms:.2f}x the ring kernel's "
                  f"time); plain {plain_ms:.3f} ms; no PyTorch call computes "
                  f"this scan", flush=True)
            cases.append(dict(
                shape=[bsz, s, dm, ns], plan=list(p[:5]) + [list(p.grid)],
                ms=ms, device_ms=dev_ms, pr12_ms=old_ms,
                pr12_device_ms=old_dev_ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, max_abs_err=err))
        del x, dt, b, c, A, d, ins, out, again, want
    kern = (f"selective_scan_ring_kernelILi{cases[0]['plan'][1]}ELi"
            f"{SS.padded_states(n)}E")
    print(f"selective_scan ring kernel at the path shape ({kern}), nvcc "
          f"-Xptxas -v: {ptxas_summary(ss_log, kern)}; dynamic shared memory "
          f"{SS.ring_smem_bytes(cases[0]['plan'][1], n)} B", flush=True)
    rows["selective_scan"] = dict(
        cases[0], dtype="float32", library_ms=None, variant="ring",
        cases=cases, source="src/repro_torch/csrc/selective_scan.cu",
        replaces="src/repro/kernels/selective_scan.py:29")
    torch.cuda.empty_cache()
    return rows


def lm_counts(FA, SS) -> dict:
    return {"flash_attention": FA.LAUNCHES["flash_attention"],
            "flash_wgmma": FA.VARIANT_LAUNCHES["wgmma"],
            "selective_scan": SS.LAUNCHES["selective_scan"],
            "scan_ring": SS.VARIANT_LAUNCHES["ring"],
            "plain": FA.PLAIN_CALLS["flash_attention"]
            + SS.PLAIN_CALLS["selective_scan"]}


def check_forward_counts(counts: dict, what: str, wgmma: int) -> None:
    """One forward of layers 0-7: flash once (through the wgmma kernel
    ``wgmma`` times: once in bf16, never in float32), the scan 7 times,
    all on the ring kernel."""
    check(counts == {"flash_attention": 1, "flash_wgmma": wgmma,
                     "selective_scan": LM_LAYERS - 1,
                     "scan_ring": LM_LAYERS - 1, "plain": 0},
          f"{what}: launches {counts}, expected flash attention once "
          f"({wgmma} times the wgmma kernel), the scan {LM_LAYERS - 1} times "
          f"on the ring kernel and no plain version")


def bf16_agreement(lm, params, plain_cfg, kern_cfg, toks, f32_logits):
    """The bf16 serving path at full width, weights already cast.

    1. Mixer by mixer -- attention and mamba blocks, the only code the two
       impl pairs do not share -- on the same bf16 input (the plain path's
       activations at that layer): RMS of kernel - plain within 2^-7 (one
       bf16 unit in the last place, relative) of the plain output's RMS,
       the largest within 2^-6 of its largest.
    2. End to end: the kernel path's logits lie as near the float32
       logits as the plain path's (RMS within ``BF16_PARITY``).  The two
       paths' logits are not held to each other: the MoE router turns
       bf16-sized differences into another expert for a few tokens, and
       the next layers spread that."""
    from repro_torch.models import layers as L
    from repro_torch.models.mamba import mamba_block
    rms = lambda t: float(t.float().square().mean().sqrt())  # noqa: E731
    dtype = torch.bfloat16
    x = lm._embed(params, plain_cfg, lm._tokens(params, toks), None, dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    shares = []
    for i, (layer, lp) in enumerate(lm._layers(params, dtype)):
        h = L.norm(plain_cfg.norm, x, lp["ln1"])
        outs = []
        for cfg in (plain_cfg, kern_cfg):
            if layer.kind == "attn":
                outs.append(L.attention_block(
                    lp["mix"], h, cfg.attention, positions=pos, causal=True,
                    impl=cfg.attention_impl)[0].float())
            else:
                outs.append(mamba_block(lp["mix"], h, cfg.ssm,
                                        impl=cfg.ssm_impl)[0].float())
        plain, kern = outs
        d = kern - plain
        share = (rms(d) / rms(plain) / 2.0 ** -7,
                 float(d.abs().max() / plain.abs().max()) / 2.0 ** -6)
        shares.append(f"{i} {layer.kind} {share[0]:.3f}/{share[1]:.3f}")
        check(max(share) <= 1.0, f"bf16 layer {i} ({layer.kind}) mixer: "
                                 f"kernel vs plain at {share} of the limits")
        x = lm._layer_apply(plain_cfg, layer.kind, layer.is_moe, lp, x, pos,
                            None, plain_cfg.attention_impl, 1024)[0]
    print(f"bf16 mixers, kernel vs plain on the same input, share of the "
          f"limits (RMS/max): {'; '.join(shares)}", flush=True)

    plain = lm.forward(params, plain_cfg, toks).float()
    kern = lm.forward(params, kern_cfg, toks).float()
    check(bool(torch.isfinite(kern).all()), "bf16 kernel logits finite")
    err_p, err_k = rms(plain - f32_logits), rms(kern - f32_logits)
    print(f"bf16 forward B={toks.shape[0]} S={toks.shape[1]}: RMS distance "
          f"from the float32 logits, kernel impls {err_k:.4e}, plain impls "
          f"{err_p:.4e} (ratio {err_k / err_p:.4f}, limit {BF16_PARITY}); "
          f"plain vs float32 max {float((plain - f32_logits).abs().max()):.3e}"
          f"; kernel vs plain max {float((kern - plain).abs().max()):.3e}, "
          f"RMS {rms(kern - plain):.3e}", flush=True)
    check(err_k <= BF16_PARITY * err_p,
          f"bf16 kernel logits {err_k:.4e} from float32, more than "
          f"{BF16_PARITY} x the plain path's {err_p:.4e}")


def jamba_phases(FA, SS, dev) -> dict:
    """Phases 7 and 8: the full-width float32 check, then serving in bf16.
    Returns the LM main path's launch counts."""
    from repro_torch.configs import get_config
    from repro_torch.convert import cast_params
    from repro_torch.models import get_model
    from repro_torch.models import lm

    base = replace(get_config(LM_ARCH), n_layers=LM_LAYERS)
    kern = dict(attention_impl="flash_pallas", ssm_impl="pallas")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)

    # -- 7. float32 weights: kernel impls against the plain impls ---------
    cfg32 = replace(base, compute_dtype="float32")
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = get_model(cfg32).init_params(0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    print(f"{LM_ARCH} layers 0-{LM_LAYERS - 1} at full width: "
          f"{n_params / 1e9:.2f} G parameters, float32, initialised from "
          f"seed 0 on the card in {time.perf_counter() - t:.1f} s "
          f"({torch.cuda.memory_allocated() / 2**30:.1f} GiB)", flush=True)
    toks = torch.randint(0, base.vocab_size, (F32_B, F32_S), generator=gen,
                         device=dev)
    FA.reset_counts()
    SS.reset_counts()
    t = time.perf_counter()
    out_k = lm.forward(params, replace(cfg32, **kern), toks)
    torch.cuda.synchronize()
    kern_s = time.perf_counter() - t
    check_forward_counts(lm_counts(FA, SS), "float32 kernel forward", 0)
    t = time.perf_counter()
    out_p = lm.forward(params, cfg32, toks)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    check(out_k.shape == (F32_B, F32_S, base.vocab_size)
          and bool(torch.isfinite(out_k).all()), "f32 logits finite, shaped")
    err, bad = within(out_k, out_p, LOGITS_TOL)
    print(f"float32 forward B={F32_B} S={F32_S}: kernel impls {kern_s:.3f} "
          f"s, plain impls {plain_s:.3f} s; logits max |kernel - plain| "
          f"{err:.3e} (max |logit| {float(out_p.abs().max()):.3e}), {bad} "
          f"outside atol/rtol {LOGITS_TOL}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    check(bad == 0, f"float32 jamba logits: {bad} outside {LOGITS_TOL}, max "
                    f"|err| {err:.3e}")
    del out_k

    # -- 8. bf16: agreement, scoring, then generation ------------------------
    t = time.perf_counter()
    cast_params(params, torch.bfloat16)
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"cast to bf16 in place in {time.perf_counter() - t:.1f} s: "
          f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB of weights",
          flush=True)
    cfg = replace(base, **kern)
    bf16_agreement(lm, params, base, cfg, toks, out_p)
    del out_p
    model = get_model(cfg)
    batch = {"tokens": torch.randint(0, base.vocab_size, (SCORE_B, SCORE_S),
                                     generator=gen, device=dev)}
    torch.cuda.reset_peak_memory_stats()
    FA.reset_counts()
    SS.reset_counts()
    t = time.perf_counter()
    logits = model.logits(params, batch)
    torch.cuda.synchronize()
    score_s = [time.perf_counter() - t]
    score_counts = lm_counts(FA, SS)
    check_forward_counts(score_counts, "scoring forward", 1)
    check(logits.shape == (SCORE_B, SCORE_S, base.vocab_size)
          and logits.dtype == torch.bfloat16
          and bool(torch.isfinite(logits).all()),
          "scoring logits finite, (B, S, V), bf16")
    del logits
    score_s += [timed(lambda: model.logits(params, batch)) for _ in range(2)]
    print(f"scoring: Model.logits at B={SCORE_B} S={SCORE_S}, 3 runs "
          f"{fmt(score_s)} s -> median "
          f"{SCORE_B * SCORE_S / float(np.median(score_s)):.0f} tokens/s; "
          f"launches {score_counts}", flush=True)

    prompt = batch["tokens"][:, :PROMPT]
    FA.reset_counts()
    SS.reset_counts()
    t = time.perf_counter()
    cache = model.init_cache(SCORE_B, PROMPT + GEN, device=dev)
    lg, cache = lm.prefill(params, cfg, prompt, cache, impl="flash_pallas")
    tok = lg[:, -1].argmax(-1)[:, None]
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    gen_toks = [tok]
    t = time.perf_counter()
    for _ in range(GEN):
        lg, cache = model.decode_step(params, tok, cache)
        tok = lg[:, -1].argmax(-1)[:, None]
        gen_toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    gen_counts = lm_counts(FA, SS)
    check(gen_counts == {"flash_attention": 1, "flash_wgmma": 1,
                         "selective_scan": 0, "scan_ring": 0, "plain": 0},
          f"generation: launches {gen_counts}, expected flash attention "
          f"once, through the wgmma kernel (prefill; the scan runs chunked "
          f"under a cache, decode has no kernel) and no plain version")
    out = torch.cat(gen_toks, dim=1)
    check(out.shape == (SCORE_B, GEN + 1) and bool(torch.isfinite(lg).all())
          and int(out.min()) >= 0 and int(out.max()) < base.vocab_size,
          "generated tokens in range, logits finite")
    print(f"generation: B={SCORE_B}, prefill {PROMPT} tokens "
          f"(impl=flash_pallas) {1e3 * prefill_s:.1f} ms, {GEN} decode steps "
          f"{1e3 * decode_s / GEN:.2f} ms/token; launches {gen_counts}; "
          f"first row {out[0, :8].tolist()}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    profile_call(lambda: model.logits(params, batch),
                 f"jamba scoring forward B={SCORE_B} S={SCORE_S}",
                 watch=("selective_scan", "flash_attention"))
    return {k: score_counts[k] + gen_counts[k]
            for k in ("flash_attention", "selective_scan")}


# ---------------------------------------------------------------------------
# phase 9: the systolic GEMM at olmo-1b's GEMM shapes
# ---------------------------------------------------------------------------


def olmo_gemm_shapes():
    """[(label, M, K, N)]: the distinct GEMMs of olmo-1b as the port's
    ``extract_operators`` gives them, at the network cells' decode shape
    and at a 4 x 2048 prefill."""
    from repro_torch.configs import get_config
    from repro_torch.core.mapping.workload import extract_operators
    from repro_torch.core.network import NETWORK_SHAPE
    from repro_torch.models.config import ShapeConfig
    cfg = get_config(GEMM_ARCH)
    prefill = ShapeConfig("prefill", seq_len=PREFILL_S,
                          global_batch=PREFILL_B, mode="prefill")
    out, seen = [], set()
    for shape in (NETWORK_SHAPE, prefill):
        for c in extract_operators(cfg, shape):
            if c.op == "gemm" and (c.m, c.k, c.n) not in seen:
                seen.add((c.m, c.k, c.n))
                out.append((f"{shape.mode} {c.tag}", c.m, c.k, c.n))
    return out


def gemm_bound(m, k, n, in_dtype, out_dtype):
    """(least ms, "operations" | "bytes"): 2 m k n flops at the peak rate
    of the input type (tensor cores for bf16, CUDA cores for float32), or
    one read of A and B and one write of C."""
    flops = 2.0 * m * k * n
    peak = BF16_FLOP_PER_S if in_dtype == torch.bfloat16 else FP32_FLOP_PER_S
    size = lambda dt: torch.finfo(dt).bits // 8  # noqa: E731
    nbytes = (m * k + k * n) * size(in_dtype) + m * n * size(out_dtype)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def graph_ms(calls, reps: int) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph (call
    i runs ``calls[i % len(calls)]``), replayed once to warm up, then timed
    over one replay with CUDA events -- no host work inside the window."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for call in calls:          # builds, workspaces, counter buffers
            call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for i in range(reps):
            calls[i % len(calls)]()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / reps


def gemm_phase(ops, SG, dev, shapes):
    """Phase 9: ``ops.gemm`` at ``shapes``: the plan of each product, the
    main-path run (counters zeroed just before, read just after; each
    product must run the kernel its plan names), then each result against
    the plain version, then times: through ``ops.gemm`` and through the
    private launcher (CUDA events around back-to-back calls; at decode they
    measure the host) and on the device (CUDA-graph replay) for the
    kernel, the mma.sync kernel on the same inputs (launcher and device)
    and ``torch.matmul``.  Decode operands rotate through copies
    of B larger than twice the L2, as a decode step finds B in device
    memory.  Returns (row for the kernels line, launches on the main
    path)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    f32, bf16 = torch.float32, torch.bfloat16
    top_m = max(s[1] for s in shapes)
    # (label, m, k, n, input type, activation, output type)
    cases = [(label, m, k, n, bf16, 1 if label.endswith("mlp") else 0, f32)
             for label, m, k, n in shapes]
    cases += [(label, m, k, n, dt, 1, odt)
              for label, m, k, n in shapes
              if label.endswith("mlp") and m == top_m
              for dt, odt in ((f32, f32), (bf16, bf16))]
    inputs = [(torch.randn((m, k), generator=gen, device=dev).to(dt),
               torch.randn((k, n), generator=gen, device=dev).to(dt))
              for _, m, k, n, dt, _, _ in cases]
    props = torch.cuda.get_device_properties(dev)
    plans = [SG.plan(m, k, n, dt, SG._aligned16(a, b),
                     sms=props.multi_processor_count)
             for (_, m, k, n, dt, _, _), (a, b) in zip(cases, inputs)]
    for (label, m, k, n, dt, act, odt), p in zip(cases, plans):
        print(f"systolic_gemm plan {label} ({m}, {k}, {n}) {str(dt)[6:]} -> "
              f"{str(odt)[6:]}: {p.variant}, tile {p.tile}, splits "
              f"{p.splits}, grid {p.grid}", flush=True)
    torch.cuda.synchronize()
    SG.reset_counts()
    outs, ran = [], []
    for (a, b), (*_, act, odt) in zip(inputs, cases):
        before = dict(SG.VARIANT_LAUNCHES)
        outs.append(ops.gemm(a, b, activation=act, out_dtype=odt))
        ran.append([v for v in SG.VARIANTS
                    if SG.VARIANT_LAUNCHES[v] != before[v]])
    torch.cuda.synchronize()
    launches, plain = (SG.LAUNCHES["systolic_gemm"],
                       SG.PLAIN_CALLS["systolic_gemm"])
    variants = dict(SG.VARIANT_LAUNCHES)
    check(launches == len(cases) and plain == 0,
          f"ops.gemm main path: {launches} launches, {plain} plain calls "
          f"for {len(cases)} products")
    for (label, m, k, n, dt, _, _), p, r in zip(cases, plans, ran):
        check(r == [p.variant], f"systolic_gemm {label} {str(dt)[6:]}: "
                                f"planned {p.variant}, ran {r}")
        if dt == bf16:
            want = "splitk" if m <= SG.SPLITK_MAX_M else "wgmma"
            check(p.variant == want, f"systolic_gemm {label}: {p.variant} "
                                     f"at an olmo-1b shape, not {want}")
    check(variants["mma_sync"] == 0, "mma_sync ran on the main path")
    print(f"systolic_gemm main path: {launches} launches by kernel "
          f"{variants}, {plain} plain calls", flush=True)
    l2 = props.L2_cache_size
    results = []
    for (label, m, k, n, dt, act, odt), (a, b), out, p in zip(
            cases, inputs, outs, plans):
        name = f"{label} ({m}, {k}, {n}) {str(dt)[6:]} -> {str(odt)[6:]}"
        want = SG.systolic_gemm_torch(a, b, activation=act, out_dtype=odt)
        bnd = SG.error_bound(a, b, want)
        err = (out.float() - want.float()).abs_()
        bad, worst = int((err > bnd).sum()), float((err / bnd).max())
        max_err = float(err.max())
        finite = bool(torch.isfinite(out).all())
        old_plan = SG.plan(m, k, n, dt, False)
        old_worst = None
        if dt == bf16:                # the mma.sync kernel, held the same
            old = SG._launch(a, b, act, odt, old_plan)
            old_err = (old.float() - want.float()).abs_()
            check(bool((old_err <= bnd).all()),
                  f"systolic_gemm {name}: the mma.sync kernel beyond the "
                  f"bound")
            old_worst = float((old_err / bnd).max())
            del old, old_err
        del err, bnd, want
        check(finite and bad == 0,
              f"systolic_gemm {name}: {bad} elements beyond the bound (max "
              f"|err| / bound {worst:.3f}), finite {finite}")
        big = m * k * n > 1e11
        reps = 3 if dt == f32 else (10 if big else 50)
        ms = cuda_ms(lambda: ops.gemm(a, b, activation=act, out_dtype=odt),
                     reps=reps)
        # the same kernel through the private launcher, as the mma.sync
        # kernel is timed: the host work of the two then matches
        launch_ms = cuda_ms(lambda: SG._launch(a, b, act, odt, p), reps=reps)
        plain_ms = cuda_ms(lambda: SG.systolic_gemm_torch(
            a, b, activation=act, out_dtype=odt), reps=2 if big else 10)
        lib_ms = cuda_ms(lambda: torch.matmul(a, b), reps=reps)
        # device time; decode rotates B (and A) through copies > 2 x L2
        copies = (1 if m > SG.SPLITK_MAX_M
                  else max(1, math.ceil(2 * l2 / b.nbytes)))
        ops_in = [(a, b)] + [(a.clone(), b.clone())
                             for _ in range(copies - 1)]
        dreps = 3 if dt == f32 else (5 if big else 4 * copies + 36)
        dev_ms = graph_ms([lambda x=x, y=y: ops.gemm(
            x, y, activation=act, out_dtype=odt) for x, y in ops_in], dreps)
        lib_dev_ms = graph_ms([lambda x=x, y=y: torch.matmul(x, y)
                               for x, y in ops_in], dreps)
        old_ms = old_dev_ms = None
        if dt == bf16:
            old_ms = cuda_ms(lambda: SG._launch(a, b, act, odt, old_plan),
                             reps=reps)
            old_dev_ms = graph_ms([lambda x=x, y=y: SG._launch(
                x, y, act, odt, old_plan) for x, y in ops_in], dreps)
        del ops_in
        bms, by = gemm_bound(m, k, n, dt, odt)
        results.append(dict(
            label=label, shape=[m, k, n], dtype=str(dt)[6:],
            out_dtype=str(odt)[6:], activation=act, variant=p.variant,
            tile=list(p.tile), splits=p.splits, grid=list(p.grid),
            ms=ms, launch_ms=launch_ms, device_ms=dev_ms, plain_ms=plain_ms,
            library_ms=lib_ms,
            library_device_ms=lib_dev_ms, old_kernel_ms=old_ms,
            old_kernel_device_ms=old_dev_ms, bound_ms=bms, bound_by=by,
            max_abs_err=max_err, err_over_bound=worst,
            old_kernel_err_over_bound=old_worst, b_copies=copies))
        old_txt = ("" if old_ms is None else
                   f"; mma.sync kernel {old_ms:.4f} ms (launcher), device "
                   f"{old_dev_ms:.4f} ms ({old_dev_ms / dev_ms:.2f}x the "
                   f"new one's device time), max |err| / bound "
                   f"{old_worst:.4f}")
        print(f"systolic_gemm {name}, ReLU {act} [{p.variant}]: kernel "
              f"{ms:.4f} ms (ops.gemm), {launch_ms:.4f} ms (launcher), "
              f"device {dev_ms:.4f} ms ({100 * bms / dev_ms:.1f}"
              f"% of bound {bms:.4f} ms, {by}){old_txt}; torch.matmul "
              f"({str(dt)[6:]}) {lib_ms:.4f} ms, device {lib_dev_ms:.4f} ms "
              f"(kernel / matmul device {dev_ms / lib_dev_ms:.3f}); plain "
              f"{plain_ms:.4f} ms; max |err| {max_err:.3e}, max |err| / "
              f"bound {worst:.4f}; B copies {copies}", flush=True)
    del inputs, outs
    torch.cuda.empty_cache()
    # the kernels line carries the bf16 prefill mlp product (float32 out),
    # the path's largest; every case rides along under "cases"
    row = next(r for r in results if r["dtype"] == "bfloat16"
               and r["out_dtype"] == "float32"
               and r["label"] == "prefill mlp")
    row = dict(row, cases=results,
               source="src/repro_torch/csrc/systolic_gemm.cu",
               replaces="src/repro/kernels/systolic_gemm.py:29")
    return row, launches


# ---------------------------------------------------------------------------
# phase 10: the default packed Explorer over the operator + network matrix
# ---------------------------------------------------------------------------


def packed_phase(modules, dev, blocked_cycles):
    """Phase 10: ``Explorer(networks=True)`` with the default engine, its
    goldens, packed vs the blocked engine on the operator cells, rate,
    idle share and memory.  ``blocked_cycles``: phase 4's (N_CROSS, 10)
    blocked cycles on the same seed-0 candidates.  Returns the Explorer
    (phase 11 serves it)."""
    from repro_torch.core.aidg.explorer import (DEFAULT_SPACE, Explorer,
                                                random_candidates)
    cand = random_candidates(DEFAULT_SPACE, N_CAND, seed=0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for mod in modules:
        mod.reset_counts()
    t = time.perf_counter()
    ex = Explorer(networks=True, device=dev)
    build_s = time.perf_counter() - t
    check(ex.engine == "packed", f"default engine {ex.engine}")
    t = time.perf_counter()
    res = ex.explore(cand)
    first_s = time.perf_counter() - t
    plain = {k: v for mod in modules for k, v in mod.PLAIN_CALLS.items()}
    check(sum(plain.values()) == 0, f"plain versions ran on the packed "
                                    f"path: {plain}")
    stats = ex.packed_matrix().stats()
    S = len(ex.compiled)
    print(f"packed Explorer: {S} cells ({len(GOLDEN_THETA1_CYCLES)} "
          f"operator + {S - len(GOLDEN_THETA1_CYCLES)} network), build + "
          f"θ=1 baselines {build_s:.3f} s; PackedMatrix.stats() {stats}; "
          f"plain calls {plain}", flush=True)
    names = ex.scenario_names
    golden = list(GOLDEN_THETA1_CYCLES.values())
    nop = len(golden)
    check(names[:nop] == list(GOLDEN_THETA1_CYCLES)
          and names[nop:] == list(GOLDEN_E2E_THETA1),
          f"cell order {names}")
    check(ex.baselines[:nop].tolist() == golden
          and res.cycles[0, :nop].tolist() == golden,
          f"packed θ=1 {ex.baselines[:nop].tolist()} != golden {golden}")
    rel_net = {n: abs(float(b) - GOLDEN_E2E_THETA1[n]) / GOLDEN_E2E_THETA1[n]
               for n, b in zip(names[nop:], ex.baselines[nop:])}
    worst = max(rel_net.values())
    check(worst <= 1e-4, f"network θ=1 off the goldens: {rel_net}")
    check(np.isfinite(res.cycles).all() and res.cycles.shape == (N_CAND, S)
          and np.isfinite(res.energy).all(), "cycles finite, shaped")
    rel = (np.abs(res.cycles[:N_CROSS, :nop] - blocked_cycles)
           / np.abs(blocked_cycles))
    cross = float(rel.max())
    check(cross <= PACKED_VS_BLOCKED,
          f"packed vs blocked on {N_CROSS} candidates: {cross} > "
          f"{PACKED_VS_BLOCKED}")
    print(f"packed θ=1: operator cells equal the golden cycles; network "
          f"cells within {worst:.3e} of theirs (limit 1e-4); packed vs "
          f"blocked max rel. difference {cross:.3e} on {N_CROSS} "
          f"candidates (limit {PACKED_VS_BLOCKED}), by cell "
          f"{[f'{x:.1e}' for x in rel.max(axis=0)]}", flush=True)
    secs = [timed(lambda: ex.explore(cand)) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    print(f"packed explore: {S} cells x {N_CAND} candidates, first call "
          f"{first_s:.3f} s, then 3 runs {fmt(secs)} s -> median "
          f"{rate(S, secs):.0f} cell-candidates/s; Pareto size "
          f"{len(res.pareto)}; peak device memory {peak / 2**30:.2f} GiB",
          flush=True)
    profile_call(lambda: ex.explore(cand), "packed explore, 31 cells")
    return ex

# ---------------------------------------------------------------------------
# phase 11: the DSE query service over the packed Explorer
# ---------------------------------------------------------------------------


def serve_stream(ex) -> list:
    """``benchmarks/bench_serve.py::_query_stream``'s questions: per
    workload a full-matrix, a top-3 and an override query, and one query
    per architecture -- over the operator cells' workloads and
    architectures, the 21 distinct questions of the reference's CPU row
    (an architecture query resolves over its network cells too)."""
    from repro_torch.serve import Query
    op = [cs for cs in ex.compiled if cs.name in GOLDEN_THETA1_CYCLES]
    knob = ex.space.names[0]
    qs = []
    for w in sorted({cs.workload for cs in op}):
        qs += [Query.make(workload=w), Query.make(workload=w, top_k=3),
               Query.make(workload=w, overrides={knob: 2.0})]
    return qs + [Query.make(archs=[a]) for a in sorted({cs.arch
                                                        for cs in op})]


def direct_answer(ex, pool, q, evaluated):
    """The oracle of ``tests/test_torch_serve.py``: the answer re-derived
    from a direct ``evaluate_full`` of the query's candidate block (no
    service, no batching, no cache) and the documented ranking.
    ``evaluated`` caches the evaluation per override signature."""
    from repro_torch.core.aidg.explorer import pareto_front, resolve_cells
    from repro_torch.serve import Answer, Design
    cand = pool.copy()
    for name, val in q.overrides:
        cand[:, ex.space.names.index(name)] = val
    if q.overrides not in evaluated:
        evaluated[q.overrides] = ex.evaluate_full(cand)
    cycles, energy_pj = evaluated[q.overrides]
    cols = np.asarray(resolve_cells(ex.compiled, workload=q.workload,
                                    archs=q.archs))
    rel = cycles[:, cols] / ex.baselines[None, cols]
    latency = rel.mean(axis=1)
    energy = (energy_pj[:, cols]
              / ex.energy_baselines[None, cols]).mean(axis=1)
    cost = ex.cost_proxy(cand)
    top = pareto_front(np.stack([latency, energy, cost], axis=1))[: q.top_k]
    designs = tuple(
        Design(theta=tuple(float(v) for v in cand[i]),
               latency=float(latency[i]), energy=float(energy[i]),
               cost=float(cost[i]),
               cycles=tuple(float(c) for c in cycles[i, cols]))
        for i in top)
    lead = int(top[0]) if len(top) else int(np.argmin(latency))
    best_arch = ex.compiled[int(cols[int(np.argmin(rel[lead]))])].arch
    return Answer(query=q, cells=tuple(ex.compiled[i].name for i in cols),
                  designs=designs, best_arch=best_arch)


def serve_throughput(ex, distinct):
    """(a) 8 client threads over the stream on a fresh service after a
    warm one; every answer held to the direct oracle and to a sequential
    replay."""
    from repro_torch.serve import DSEService
    stream = distinct * SERVE_REPS
    with DSEService(ex, **SERVE_KW) as warm:
        warm.query_many(distinct)
    svc = DSEService(ex, **SERVE_KW)
    try:
        t = time.perf_counter()
        with ThreadPoolExecutor(SERVE_CLIENTS) as tp:
            answers = list(tp.map(svc.query, stream))
        dt = time.perf_counter() - t
        st = svc.stats()
    finally:
        svc.close()
    pool = svc.pool
    n, cs = len(stream), st["cache"]
    check(cs["hits"] + cs["coalesced"] + cs["misses"] == n,
          f"cache counters {cs} do not account for {n} queries")
    check(cs["misses"] == len(distinct) and st["hit_ratio"] > 0.0,
          f"each distinct question is evaluated once: {cs}")
    check(st["cells"] == len(ex.compiled) and all(
        a.tier == "packed" for a in answers), "packed answers, all cells")
    configs = st["dispatched_candidates"] * st["cells"]
    print(f"serve throughput: {SERVE_CLIENTS} clients, {n} queries "
          f"({len(distinct)} distinct), pool {SERVE_KW['pool']}, "
          f"{st['cells']} cells: {dt:.3f} s -> {n / dt:.1f} q/s; hit ratio "
          f"{st['hit_ratio']:.3f} ({cs}); windows {st['windows']}, device "
          f"dispatches {st['device_dispatches']}, mean batch "
          f"{st['mean_batch']:.2f}; {configs / dt:.0f} configs/s "
          f"(cell-candidates)", flush=True)
    with DSEService(ex, **SERVE_KW) as ref:
        replay = ref.query_many(stream)
    check(answers == replay, "threaded answers equal the sequential replay")
    evaluated = {}
    for q, a in zip(stream, answers):
        check(a == direct_answer(ex, pool, q, evaluated),
              f"served answer != direct evaluate_full + ranking for {q}")
    print(f"serve: all {n} answers equal a direct evaluate_full + ranking "
          f"of the same block bit for bit, and the sequential replay",
          flush=True)
    secs = [timed(lambda: ex.evaluate_full(pool)) for _ in range(3)]
    print(f"serve: one {len(pool)}-row packed chunk over {len(ex.compiled)} "
          f"cells, 3 runs {fmt(secs)} s", flush=True)
    profile_call(lambda: ex.evaluate_full(pool),
                 f"serve: one {len(pool)}-row packed chunk")


def serve_surrogate(ex, distinct):
    """(b) train the surrogate on the card (default config), hold it to
    the oracle-chain bounds on fresh draws, and time the surrogate-only
    and packed-only cold streams."""
    from repro_torch.serve import DSEService
    from repro_torch.surrogate import evaluate_surrogate, train_surrogate
    torch.cuda.synchronize()
    t = time.perf_counter()
    bundle = train_surrogate(ex)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    rep = evaluate_surrogate(bundle, ex, n=N_FRESH, seed=FRESH_SEED)
    bound = bundle.err_bound[None, :]
    cov_lat = np.mean(rep["err_latency"] <= bound, axis=0)
    cov_en = np.mean(rep["err_energy"] <= bound, axis=0)
    med_cell = np.median(rep["err_latency"], axis=0)
    inelig = float(np.mean(bundle.err_bound > 0.02))
    print(f"surrogate: trained on the card in {train_s:.2f} s "
          f"({bundle.meta['n_train']} train / {bundle.meta['n_holdout']} "
          f"held out, {bundle.meta['config']['steps']} steps); "
          f"{N_FRESH} fresh draws: median latency error "
          f"{rep['median_latency_err']:.5f}, energy "
          f"{rep['median_energy_err']:.5f}; coverage min latency "
          f"{cov_lat.min():.3f}, energy {cov_en.min():.3f}; cells over "
          f"the 2% routing bound {inelig:.3f} "
          f"({int(np.sum(bundle.err_bound > 0.02))} of {bundle.n_cells})",
          flush=True)
    for i, name in enumerate(bundle.cell_names):
        check(bundle.err_bound[i] > 0.0, f"{name}: bound 0")
        check(cov_lat[i] >= COVERAGE_MIN and cov_en[i] >= COVERAGE_MIN,
              f"{name}: coverage {cov_lat[i]:.3f} / {cov_en[i]:.3f} < "
              f"{COVERAGE_MIN} inside bound {bundle.err_bound[i]:.4f}")
        check(med_cell[i] <= bundle.err_bound[i],
              f"{name}: median error {med_cell[i]} over its bound")
    check(rep["median_latency_err"] <= MEDIAN_MAX
          and rep["median_energy_err"] <= MEDIAN_MAX,
          f"matrix-wide medians {rep['median_latency_err']}, "
          f"{rep['median_energy_err']} > {MEDIAN_MAX}")
    check(inelig <= INELIGIBLE_MAX,
          f"{inelig:.3f} of the cells over the routing bound")

    kw = {k: v for k, v in SERVE_KW.items() if k != "window_s"}
    with DSEService(ex, surrogate=bundle, surrogate_max_err=np.inf,
                    **kw) as warm:
        warm.query_many(distinct)

    def cold_run(**extra):
        svc = DSEService(ex, **kw, **extra)
        try:
            t = time.perf_counter()
            svc.query_many(distinct)
            return time.perf_counter() - t, svc.stats()
        finally:
            svc.close()

    n = len(distinct)
    t_sur, st_sur = cold_run(surrogate=bundle, surrogate_max_err=np.inf)
    t_pkd, st_pkd = cold_run()
    _, st_def = cold_run(surrogate=bundle)
    check(st_sur["tiers"]["surrogate"] == n and st_pkd["tiers"]["packed"]
          == n, f"tier routing: {st_sur['tiers']} / {st_pkd['tiers']}")
    print(f"surrogate tier: {t_sur / n * 1e6:.0f} us/query against packed "
          f"{t_pkd / n * 1e6:.0f} us/query over {n} cold queries -> "
          f"{t_pkd / t_sur:.1f}x; the stream's fallback rate at the default "
          f"threshold ({st_def['surrogate_max_err']}) "
          f"{st_def['fallback_rate']:.3f}", flush=True)
    return bundle


def serve_faults(ex, bundle):
    """(c) a fault plan opens the breaker: covered queries degrade to the
    surrogate with the widened bound, uncovered ones fail fast; after the
    probe the exact packed answers return, equal to those before."""
    from repro_torch.core.aidg.explorer import resolve_cells
    from repro_torch.serve import (DEGRADED_WIDEN, CircuitBreaker,
                                   DSEService, OracleUnavailable, Query,
                                   RetryPolicy)
    op = [cs for cs in ex.compiled if cs.name in GOLDEN_THETA1_CYCLES]
    queries = [Query.make(workload=cs.workload, archs=[cs.arch])
               for cs in op]
    # cover the cells whose bound is at or under the median: both sides
    # of the ladder are taken
    col = lambda q: resolve_cells(ex.compiled, workload=q.workload,
                                  archs=q.archs)
    bounds = np.array([bundle.err_bound[col(q)].max() for q in queries])
    cut = float(np.median(bounds))
    covered = bounds <= cut
    check(covered.any() and not covered.all(), f"bounds {bounds}")
    kw = {k: v for k, v in SERVE_KW.items() if k != "window_s"}
    with DSEService(ex, **kw) as clean:
        before = clean.query_many(queries)
    svc = DSEService(ex, **kw, surrogate=bundle, surrogate_max_err=-1.0,
                     degraded_max_err=cut,
                     retry=RetryPolicy(max_attempts=1, base_s=0.0),
                     breaker=CircuitBreaker(open_after=1, probe_after=1),
                     fault_plan="packed[0]=error")
    try:
        out = svc.query_many(queries, return_exceptions=True)
        check(svc.breaker.state == "open", f"breaker {svc.breaker.state}")
        for q, o, cov, b in zip(queries, out, covered, bounds):
            if cov:
                check(not isinstance(o, BaseException)
                      and o.tier == "surrogate-degraded"
                      and o.err_bound == DEGRADED_WIDEN * b,
                      f"{q}: {o!r} is not a degraded answer with bound "
                      f"{DEGRADED_WIDEN * b}")
            else:
                check(isinstance(o, OracleUnavailable),
                      f"{q}: {o!r}, expected OracleUnavailable")
        probe = svc.query_many([Query.make(workload="gemm", top_k=17)])[0]
        check(probe.tier == "packed" and svc.breaker.state == "closed",
              f"probe tier {probe.tier}, breaker {svc.breaker.state}")
        after = svc.query_many(queries)
        check(all(a.tier == "packed" for a in after) and after == before,
              "exact packed answers after recovery equal those before")
        st = svc.stats()
    finally:
        svc.close()
    print(f"faults: breaker {st['breaker']['transitions']}; "
          f"{int(covered.sum())} covered queries answered surrogate-degraded "
          f"(bound x{DEGRADED_WIDEN}), {int((~covered).sum())} failed fast "
          f"(OracleUnavailable); after the probe {len(after)} exact packed "
          f"answers equal to those before the faults; tiers {st['tiers']}",
          flush=True)


def serve_sharded(ex):
    """(d) the sharded evaluator on this card, and its split forced over
    four slices of the one card, bit for bit the unsharded result."""
    from repro_torch.core.aidg.explorer import random_candidates
    pm = ex.packed_matrix()
    n = pm.n_shards()
    check(n == torch.cuda.device_count(), f"n_shards {n}")
    cand = random_candidates(ex.space, SHARD_BATCH, seed=2)
    cycles, energy = pm.evaluate_full(cand)
    c, e = pm.evaluate_full(cand, sharded=True)
    check(np.array_equal(c, cycles) and np.array_equal(e, energy),
          "evaluate_full(sharded=True) != unsharded")
    dev = pm.device
    c, e = pm._evaluate_split(cand, None, [dev] * SHARD_SLICES)
    check(np.array_equal(c, cycles) and np.array_equal(e, energy),
          f"the split over {SHARD_SLICES} slices != unsharded")
    print(f"sharded: {n} device(s) (torch.cuda.device_count() "
          f"{torch.cuda.device_count()}); evaluate_full(sharded=True) and "
          f"the split forced over {SHARD_SLICES} slices of {dev} equal the "
          f"unsharded evaluation bit for bit at B = {SHARD_BATCH}, "
          f"{pm.n_cells} cells", flush=True)


def serve_phase(ex, modules):
    """Phase 11: the DSE query service over phase 10's Explorer, with the
    kernels' counters zeroed just before and read just after (the serving
    path reaches no kernel and no plain version)."""
    for mod in modules:
        mod.reset_counts()
    distinct = serve_stream(ex)
    serve_throughput(ex, distinct)
    bundle = serve_surrogate(ex, distinct)
    serve_faults(ex, bundle)
    serve_sharded(ex)
    counts = {f"{kind}{k}": v for mod in modules
              for kind, d in (("", mod.LAUNCHES), ("plain ", mod.PLAIN_CALLS))
              for k, v in d.items()}
    check(sum(counts.values()) == 0, f"kernels or plain versions ran on "
                                     f"the serving path: {counts}")
    print(f"serve: kernel launches and plain calls across phase 11 "
          f"{counts}", flush=True)



# what a kernel's row may carry beside the contract's keys (the chosen
# kernel of the GEMM, flash attention and the scan, the scan's plan, device
# times, the mma.sync kernels' and the PR 12 scan kernel's times, every
# case; the closure's full mode and dense bound, and the time of the
# general-kernel path each of the blocked engine's entries replaced)
EXTRA_KEYS = ("variant", "plan", "launch_ms", "device_ms",
              "library_device_ms", "old_kernel_ms", "old_kernel_device_ms",
              "pr12_ms", "pr12_device_ms", "cases", "full_mode_ms",
              "dense_bound_ms", "old_path_ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "false); nothing was run", file=sys.stderr)
        return 1
    from repro_torch.core.aidg.explorer import (DEFAULT_SPACE, Explorer,
                                                compile_scenario,
                                                default_scenarios,
                                                random_candidates)
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import maxplus as K
    from repro_torch.kernels import ops
    from repro_torch.kernels import selective_scan as SS
    from repro_torch.kernels import systolic_gemm as SG

    # every float32 comparison below runs in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}", flush=True)
    clock = [time.perf_counter()]

    def phase_done(label: str) -> None:
        now = time.perf_counter()
        print(f"-- phase {label} took {now - clock[0]:.1f} s", flush=True)
        clock[0] = now

    # -- 2. build, one nvcc per source, all started together ---------------
    builders = {"maxplus": K.build, "flash_attention": FA.build,
                "selective_scan": SS.build, "systolic_gemm": SG.build}

    def timed_build(fn):
        t0 = time.perf_counter()
        path = fn()
        return path, time.perf_counter() - t0

    t = time.perf_counter()
    with ThreadPoolExecutor(len(builders)) as pool:
        futures = {name: pool.submit(timed_build, fn)
                   for name, fn in builders.items()}
        built = {name: f.result() for name, f in futures.items()}
    print(f"built {len(built)} kernel libraries in parallel in "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    for name, (lib, secs) in built.items():
        print(f"{lib.name} ({secs:.1f} s); nvcc -Xptxas -v said:", flush=True)
        print(lib.with_suffix(".log").read_text().strip(), flush=True)
    mp_log = built["maxplus"][0].with_suffix(".log").read_text()
    for kern in ("maxplus_closure_kernel", "maxplus_matvec_lower_kernel",
                 "maxplus_matvec_folded_kernel"):
        print(f"{kern}, nvcc -Xptxas -v: {ptxas_summary(mp_log, kern)}",
              flush=True)
    print(f"maxplus_closure_kernel dynamic shared memory at n = {BLOCK}: "
          f"{2 * BLOCK * (BLOCK + 4) * 4} B (P and its transpose)",
          flush=True)
    phase_done("2 (build)")

    # -- 3. kernels vs plain versions --------------------------------------
    scen = default_scenarios()
    blocks = {sc.name: math.ceil(compile_scenario(sc).aidg.n / BLOCK)
              for sc in scen}
    path_batch = max(blocks.values()) * N_CAND
    print(f"blocks of {BLOCK} per cell: {blocks}", flush=True)
    rows = kernel_phase(K, path_batch, dev)
    phase_done("3 (max-plus kernels)")

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
    modes = dict(K.VARIANT_LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    print(f"launches {launches}, closure modes {modes}, plain calls {plain} "
          f"(Explorer build, one explore, one refine)", flush=True)
    # the blocked engine's entries ran, the closure in lower mode only; the
    # general matmul and matvec (phase 4b's path) and no plain version
    for name in ("maxplus_closure", "maxplus_matvec_lower",
                 "maxplus_matvec_folded"):
        check(launches[name] > 0, f"{name} never launched on the main path")
    check(modes["closure_lower"] > 0 and modes["closure_full"] == 0,
          f"closure modes on the main path: {modes}")
    for name in ("maxplus_matmul", "maxplus_matvec"):
        check(launches[name] == 0, f"general {name} ran on the main path")
    check(sum(plain.values()) == 0, f"plain versions ran on the main path: "
                                    f"{plain}")
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
    profile_call(lambda: ex.explore(cand), "blocked explore")

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
    blocked_cycles = res.cycles[:N_CROSS].copy()

    del ex, ex_wf, res, res_wf
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("4-5 (blocked Explorer)")

    # -- 4b. the general kernels' path: blocks above the closure's 128 -------
    general = general_path_phase(K, dev)
    launches.update(general)
    phase_done("4b (blocked engine at block 256)")

    # -- 6.-8. the LM path ---------------------------------------------------
    rows.update(lm_kernel_phase(FA, SS, dev))
    phase_done("6 (flash attention, selective scan)")
    launches.update(jamba_phases(FA, SS, dev))
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("7-8 (jamba)")

    # -- 9. the systolic GEMM through ops.gemm ------------------------------
    rows["systolic_gemm"], launches["systolic_gemm"] = gemm_phase(
        ops, SG, dev, olmo_gemm_shapes())
    phase_done("9 (systolic GEMM)")

    # -- 10. the default packed Explorer, 31 cells ---------------------------
    ex = packed_phase((K, FA, SS, SG), dev, blocked_cycles)
    phase_done("10 (packed Explorer)")

    # -- 11. the DSE query service over it -----------------------------------
    serve_phase(ex, (K, FA, SS, SG))
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("11 (serve)")

    kernels = [dict(name=name, route="cuda", source=r["source"],
                    replaces=r["replaces"], launches=launches[name],
                    max_abs_err=r["max_abs_err"], ms=r["ms"],
                    plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                    bound_by=r["bound_by"], library_ms=r["library_ms"],
                    shape=r["shape"],
                    **{key: r[key] for key in EXTRA_KEYS if key in r})
               for name, r in rows.items()]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
