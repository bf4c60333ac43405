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
6. flash attention and the selective scan against their plain versions on
   the card (TF32 off): flash at the LM path's shape (4 x 32 query heads
   over 4 x 8 KV heads, S = 2048, D = 128) in bf16 and in f32, at the
   prefill shape (S = 512) in bf16, ragged S = 1000, window 256 at S =
   1024, non-causal, Dv != Dq, and at MLA's heads (40 heads, S 2048, Dq 96,
   Dv 64) in bf16; the kernel ``flash_attention.plan`` picks for each case
   printed and checked against ``VARIANT_LAUNCHES`` (every bf16 D = 128
   case on ``wgmma``, the MLA case on ``wgmma_dv``); the scan at (4, 2048,
   8192, 16) and (1, 1024, 8192, 16), jamba's two mamba shapes, and at (2,
   33, 100, 8), the plan ``selective_scan.plan`` picks printed and checked
   against ``VARIANT_LAUNCHES`` (all three on the ring kernel), two calls
   equal bit for bit, the first port's scan kernel (``pr12``, private
   launcher) held to the same tolerance; float32 and scan tolerances from
   the reference's kernel tests, bf16 flash within ``bf16_error_bound``
   (derived from bf16 rounding); what ``-Xptxas -v`` said of the ``wgmma``
   kernel (D 128) and of the ring scan's planned instance (registers,
   spills, shared memory); CUDA-event times of kernel, plain version and,
   for flash, ``scaled_dot_product_attention`` beside the bound, at the two
   bf16 shapes the ``mma.sync`` kernel too (through the private launcher,
   held to the same bound), and at the scan's two jamba shapes the first
   scan kernel (``pr12``), both also as device time (CUDA-graph replay);
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
   peak memory, then one more decode step and one scoring forward
   under ``torch.profiler``, each with the port's spans (``decode``,
   ``attention``, ``mamba``, ``moe``, ...) beside the kernels;
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
12. the gradient search (the τ-soft family, autograd on the card) with
   the kernels' counters zeroed just before and read just after (no
   kernel and no plain version may run): (a) the reference's acceptance
   gate on the 10-cell ``Explorer()`` -- ``GradientExplorer(ex).refine()``
   at its defaults (2 starts x 22 steps + 2 = 46 evaluations) scores <=
   the coordinate-descent incumbent (100 evaluations) x 1.001, in the
   knob box, its score the hard evaluator's; (b) ``GradientExplorer`` over
   phase 10's 31-cell Explorer, objective ``product`` at
   ``GRAD_PRODUCT_STEPS`` steps and ``edp`` (through ``grad3_fn``) at
   ``GRAD_EDP_STEPS`` (both cut from the default 22 to keep the phase
   near ~180 s: 4 and 1 steps), each step's forward and backward seconds,
   τ and ``obj_min`` printed, a 31-cell step's peak memory and one
   10-cell step profiled (device idle share; a 31-cell step costs the
   profiler ~60 s of its own work);
   (c) central differences (τ 0.2, step 1e-2, every knob) against
   ``PackedMatrix.grad_fn`` on 31 cells and one network cell's
   ``CompiledNetwork.grad_fn`` within 5% (plus the differences' own
   float32 resolution, ``FD_ULPS``), every gradient and Jacobian entry
   finite at τ = 0.01, packed against the per-cell (wavefront) gradient
   on 10 cells (rel 2e-2; rtol 0.2, atol 5e-2); (d) the soft packed
   latency at τ = 0.01 and θ = 1 within 5e-3 of the hard one on every
   cell, and not below it (- 1e-3) on the sequential cells; (e) whether
   two identical gradient evaluations (31 cells) and two identical short
   refines (10 cells, ``GRAD_DETERMINISM_STEPS`` steps) are bit-equal (if
   not, the same under ``torch.use_deterministic_algorithms(True)``), the
   incumbents held to ``DETERMINISM_RTOL``;
13. training on the card (``repro_torch.launch``; autograd through the
   LM, no kernel of the table on this path), the four kernels' counters
   zeroed just before and read just after (no launch and no plain call):
   (a) olmo-1b at full width and depth (16 layers, d 2048), random
   float32 masters from seed 0, bf16 compute, remat on, B = 4, S = 4096
   (``train_4k``'s sequence; its global batch of 256 cut to 4 for one
   card), ``TRAIN_STEPS`` steps of ``train_loop`` over
   ``TokenPipeline(synthetic_source)`` with no checkpoint directory: each
   step's seconds (host clock around a synchronised step), loss, grad norm
   and lr; the median step (after the first), tokens/s and the model FLOP
   share of the card's dense bf16 peak (6·N·T plus causal attention,
   6·L·B·H·D·S², the remat forward not counted); peak memory; one step
   profiled (device activity only: idle share, device time by kernel,
   cuBLAS products summed) and the step's parts timed apart with CUDA
   events (chunked attention forward x 2 + backward x 16 layers,
   cross-entropy forward + backward, AdamW, the casts); losses and grad
   norms finite (a finite global norm means every gradient is); (b)
   olmo-1b at full width, depth cut to 2 layers, float32 compute, one
   fixed batch: 5 steps lower its loss, and ``train_microbatches`` 1 and 2
   give gradients within ``MICRO_TOL`` of each leaf's largest magnitude;
   (c) crash-resume (``tests/test_train_e2e.py``'s contract) at full
   width, depth 2, B = 2, S = 1024: 16 steps straight against a crash at
   step 12 after the step-8 checkpoint and a restart, step 15's loss
   within rtol 1e-5, checkpoints (~2.8 GB each) under ``build/`` and
   deleted after; (d) olmoe-1b-7b (64 experts, top 8) and falcon-mamba-7b
   at published widths, depth cut to 2 layers, ``FAMILY_STEPS`` steps on
   a fixed batch: losses finite and falling, grad norms finite, peak
   memory;
14. MLA, the encoder-decoder family and the dry run, the four kernels'
   counters zeroed before each path and read after it: (a) minicpm3-4b
   at full width and depth (62 layers, d 2560, 40 heads, q_lora 768,
   kv_lora 256, dn 64, dr 32, dv 64), bf16 weights drawn on the card from
   seed 3, B 1 x S ``MLA_S``: every MLA block with ``impl="flash_pallas"``
   against ``chunked`` on the same input (the kernel's attention output
   within ``FA.bf16_error_bound`` of its plain version on the same q, k,
   v; the block outputs within the bf16 RMS/max limits; each block's call
   on ``wgmma_dv``), layers 0-3 again in float32 (``FLASH_F32_TOL``,
   ``MLA_F32_TOL``; on ``cuda_core``); the scoring forward and
   ``lm.prefill`` on the kernel impl, each launching ``wgmma_dv`` once
   per layer and no other flash kernel (Dq 96, Dv 64); prefill, then
   ``MLA_GEN`` absorbed decode steps over the compressed cache (no
   launch), the greedy tokens against a chunked bf16 scoring pass over
   the same sequence (a token may differ only at a near-tie of the
   float32 logits; the decode's logits as near the float32 ones as the
   scoring pass's, ``BF16_PARITY``), ms/token, the compressed cache's
   bytes beside an expanded one's; 3 ``train_loop`` steps at 2 layers,
   finite, no launch; (b) whisper-small at full width and depth (12 + 12
   layers, d 768, 1500 frames): float32 ``Model.logits`` against prefill
   + 32 teacher-forced decode steps (``LOGITS_TOL``), bf16 encode,
   prefill and decode times, 3 ``train_loop`` steps with zero frames, no
   launch; (c) B2 at MLA's prefill shape (40 heads, S 2048, Dq 96, Dv 64,
   bf16, causal): the ``wgmma_dv`` kernel and the ``cuda_core`` kernel it
   replaced there (private launcher), each within ``FA.bf16_error_bound``
   of the plain version, the plain version and
   ``scaled_dot_product_attention`` (default dispatch, and each backend
   alone or why it refused), CUDA events and device time, beside the
   FLOP bound and the exponentials' floor, with what ``-Xptxas -v`` said
   of the ``wgmma_dv`` instance; (d)
   ``launch.steps.abstract_train_state`` of all 10 archs on the ``meta``
   device: parameter counts (less the leaves ``UNCOUNTED_LEAVES``, equal
   to ``cfg.n_params()``), training-state bytes, no CUDA byte allocated
   and host memory grown by < 256 MiB;
15. distributed launch (``repro_torch.launch.{mesh,sharding,dryrun,
   roofline,roofline_report}``, ``pspec``), the four kernels' counters
   zeroed before and read after (no launch, no plain call: the step
   builders take the chunked impls): (a) an NCCL process group of world
   size 1 on a free local port and ``make_local_mesh(1, 1)`` on the card;
   olmo-1b at full width and depth as in phase 13 (B 4 x S 4096, bf16,
   remat), ``SHARD_STEPS`` steps of ``make_train_step`` with parameters,
   AdamW state and batches as DTensors placed by ``param_specs`` and
   ``input_specs_sharding`` under ``pspec.activation_mesh``, then the same
   steps on plain tensors from the same weights and batches: losses and
   grad norms within ``SHARD_RTOL`` (and whether bit-equal), s per step on
   both paths (the difference is DTensor's host cost on one card), peak
   memory; one more sharded step under ``StepCounter``: its FLOPs within
   ``FLOP_TOL`` of ``analytic_train_flops`` (6·N·T + the remat forward +
   the chunked attention over all chunk pairs), its roofline terms on
   ``HW_H100`` and the measured step over the largest; (b) minicpm3-4b at
   full width and depth in bf16, B 1: a prefill of ``CACHE_PROMPT``
   tokens and ``CACHE_GEN`` absorbed decode steps through
   ``make_prefill_step``/``make_decode_step`` on plain tensors and on the
   mesh with the cache placed by ``cache_specs``: greedy tokens equal,
   logits within ``CACHE_RTOL``, ms/token on both; (c) the dry run of the
   production meshes, one ``python -m repro_torch.launch.dryrun`` process
   per cell of ``DRY_CELLS`` (with no card visible), all started together:
   every cell succeeds; per cell its seconds, per-device FLOPs, bytes,
   argument bytes, peak, collectives by kind and its ``roofline_report``
   row; the card's memory does not grow;
16. h2o-danube3-4b and phi3-vision-4b, B2's instances at (120, 120) and
   (96, 96), the four kernels' counters zeroed before each path and read
   after it: the 128 / 128 and 96 / 64 instances' outputs on
   ``PINNED_FLASH`` equal to ``PINNED_DIGESTS`` (the source's bits before
   the template took partial boxes), what ``-Xptxas -v`` said of the new
   instances; (a) h2o-danube3-4b at full width and depth (24 layers, d
   3840, 32 heads over 8, head dim 120, window 4096), bf16 weights drawn
   on the card from seed 5, B 1 x S 8192, and (b) phi3-vision-4b (32
   layers, d 3072, 32 heads, head dim 96; 256 random patch embeddings
   before 1792 tokens), seed 6, B 4: every attention block with
   ``impl="flash_pallas"`` against ``chunked`` on the same input (the
   kernel's output within ``FA.bf16_error_bound`` of its plain version,
   the blocks within the bf16 RMS/max limits), the scoring forward
   launching ``wgmma_120`` / ``wgmma_96`` once a layer and no other flash
   kernel nor the plain version, its logits as near the float32 ones as
   the chunked impl's (``BF16_PARITY``), tokens/s, one scoring forward
   profiled; ``lm.prefill`` on the kernel impl at the scoring shape (the
   same launches) and ``NEW_GEN`` greedy decode steps (h2o-danube3's over
   its 4096-slot ring; no launch), the tokens against a chunked bf16
   scoring pass over the same sequence up to near-ties
   (``greedy_parity``), prefill ms and ms/token; (c) B2 alone at each
   arch's layer shape, and h2o-danube3's causal only at
   ``CAUSAL_ONLY_S`` (where the window cuts nothing): the instance
   against the ``cuda_core`` kernel it replaced (private launcher), the
   plain version and ``scaled_dot_product_attention`` (GQA by
   ``enable_gqa``, the window as a boolean mask; default dispatch with the
   backend it took, and each backend alone or why it refused), CUDA
   events and device time, beside the bound and the exponentials' floor
   of the pairs the mask leaves (``mask_pairs``);

each phase's time and the whole script's, then one ``{"kernels": [...]}``
line (each of B2's ``wgmma_dv``, ``wgmma_120`` and ``wgmma_96`` instances
a row of its own, with the launches of the minicpm3-4b, h2o-danube3-4b
and phi3-vision-4b paths), the card line again, and as the last line ``{"ok":
true, "device": {...}}``.  It needs one card; without one it exits
non-zero before printing any result.
"""

from __future__ import annotations

import contextlib
import gc
import itertools
import json
import math
import os
import shutil
import subprocess
import sys
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.launch.roofline import HW_H100  # noqa: E402

N_CAND = 4096          # candidates per explore call
N_CROSS = 256          # candidates held against the wavefront engine
CROSS_RTOL = 1e-5      # blocked vs wavefront (closure squaring reassociates)
# H100 SXM, published: 132 SMs x 128 FP32 lanes x 1.98 GHz = 33.5 T
# lane-instructions/s (the 67 TFLOP/s of the data sheet counts an FMA as
# two); device memory and the dense bf16 tensor-core peak from the card's
# constants in launch.roofline.  All assume the full 700 W power limit.
FP32_INSTR_PER_S = 33.5e12
HBM_BYTES_PER_S = HW_H100["hbm_bytes_per_s"]
BF16_FLOP_PER_S = HW_H100["peak_bf16_flops"]
FP32_FLOP_PER_S = 67e12    # CUDA cores (same data sheet; an FMA counts as two)
# special-function unit: 16 exponentials per clock per SM (H100 SXM: 132
# SMs at 1.98 GHz)
EXP_PER_S = 132 * 16 * 1.98e9
BLOCK = 128            # the blocked engine's block size
# the flash kernel's wgmma instance at D 128, as nvcc mangles it
WGMMA_128 = "flash_attention_wgmma_kernelILi128ELi128ELb0E"

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

# -- the gradient search (tests/test_gradient_dse.py's gates) ---------------
GRAD_GATE = 1.001      # gradient incumbent <= coordinate descent x this
# refine steps on 31 cells, cut from the default 22 to keep phase 12 near
# its ~180 s: a step there takes ~5.4 s (product) and ~10 s (edp: two
# backward passes); the determinism check's two refines on 10 cells
GRAD_PRODUCT_STEPS = 4
GRAD_EDP_STEPS = 1
GRAD_DETERMINISM_STEPS = 2
GRAD_FD_TAU = 0.2      # finite differences: τ, step and the 5% gate
GRAD_FD_EPS = 1e-2
GRAD_FD_GATE = 5e-2
# a central difference of two float32 values resolves no less than
# FD_ULPS ulps of the value over 2·step (whole-network cycles run to 1e7+,
# where an ulp is 1 cycle and a knob's derivative can be a few hundred)
FD_ULPS = 8
SOFT_TAU = 0.01        # soft vs hard: τ, relative gap, the sequential floor
SOFT_HARD_REL = 5e-3
SOFT_FLOOR = 1e-3
# two identical refines on the card: atomics in the backward of the
# gathers (index_add_, scatter_add_) may reorder float32 sums; Adam moves
# each knob by at most lr a step, so a reordered sum can move an incumbent
# only where a gradient is near zero — held to this relative difference
DETERMINISM_RTOL = 1e-2

# -- training (phase 13) ------------------------------------------------------
TRAIN_ARCH = "olmo_1b"
TRAIN_B, TRAIN_S = 4, 4096   # train_4k's sequence; its batch 256 cut to 4
TRAIN_STEPS = 8
TRAIN_LR = 3e-4
# cuBLAS kernel names: all products, the float32 ones on the CUDA cores
# (the attention's score and P·V einsums), the rest
CUBLAS_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
F32_GEMM_NAMES = ("gemm_f32f32", "sgemm")
UPDATE_LAYERS = 2      # (b)-(d): depth cut to 2 layers
UPDATE_STEPS = 5
# fixed-batch steps at full width: Adam's first steps move every weight by
# ~lr, and at d 2048 lr 1e-3 (and 3e-4 after the first step) overshoots
# (the first chip run: 11.3 -> 13.0 -> 11.8 -> 18.4 at 1e-3)
UPDATE_LR = 3e-5
# microbatches 1 vs 2 at float32 (TF32 off): the same gradient summed in
# another order, held to this share of each leaf's largest magnitude
MICRO_TOL = 1e-4
RESUME_B, RESUME_S = 2, 1024
RESUME_RTOL = 1e-5     # tests/test_train_e2e.py
FAMILY_ARCHS = ("olmoe_1b_7b", "falcon_mamba_7b")
FAMILY_B, FAMILY_S = 2, 1024
FAMILY_STEPS = 5

# -- MLA, the enc-dec family and the dry run (phase 14) -----------------------
MLA_ARCH = "minicpm3_4b"
MLA_S = 2048           # B 1: scoring, prompt + generation, B2's timing
MLA_GEN = 32           # absorbed decode steps after a prompt of MLA_S - 32
MLA_F32_LAYERS = 4     # layers 0-3 checked again in float32
MLA_F32_TOL = (3e-4, 1e-3)
MLA_TRAIN_LAYERS = 2
MLA_TRAIN_B, MLA_TRAIN_S = 8, 512   # the config's 8 microbatches of 1
# a greedy token of the decode may differ from the scoring pass's only at a
# near-tie: the two tokens' float32 logits within this many times the RMS
# distance of the bf16 scoring logits from the float32 ones at that position
NEAR_TIE = 4.0
WHISPER_ARCH = "whisper_small"
WHISPER_B, WHISPER_PROMPT, WHISPER_GEN = 2, 32, 32
WHISPER_TRAIN_B, WHISPER_TRAIN_S = 4, 128   # the config's 4 microbatches
TRAIN_CHECK_STEPS = 3
# leaves that ModelConfig.n_params() does not count: norm scales and
# biases, the mamba conv bias, position tables, the VLM patch projection
UNCOUNTED_LEAVES = ("scale", "bias", "conv_b", "enc_pos", "dec_pos",
                    "patch_proj")

# -- h2o-danube3-4b and phi3-vision-4b (phase 16) -----------------------------
# (arch, B, text tokens, seed): h2o-danube3 at S 8192, so that half the rows
# see a full 4096-key window; phi3-vision's 256 patch positions before 1792
# tokens, B 4
NEW_ARCHS = (("h2o_danube3_4b", 1, 8192, 5), ("phi3_vision_4b", 4, 1792, 6))
NEW_GEN = 16           # greedy decode steps after the scoring-shape prefill
CAUSAL_ONLY_S = 4096   # B2 at (120, 120) where the window cuts nothing

# -- distributed launch (phase 15) --------------------------------------------
SHARD_STEPS = 3        # (a): phase 13's olmo-1b step on the (1, 1) mesh
SHARD_RTOL = 1e-5      # sharded vs plain losses and grad norms (crash-resume)
FLOP_TOL = 0.02        # the counted step against the analytic count
CACHE_ARCH = "minicpm3_4b"
CACHE_PROMPT = 2048    # Model.prefill's chunked attention: T % 1024 == 0
CACHE_GEN = 8          # absorbed decode steps
CACHE_RTOL = 1e-5      # sharded vs plain logits
# (c): the dry run's cells (arch, shape, mesh, depth: None = published),
# one process each, cut to keep the phase near 120 s: jamba's prefill to one pattern period,
# 8 of its 32 layers, mistral-large's training to 8 of its 88 layers (8
# microbatches of 88 layers, each op dispatched through DTensor on the
# host, take ~13 minutes)
DRY_CELLS = (("olmo-1b", "train_4k", "single", None),
             ("olmo-1b", "train_4k", "multi", None),
             ("minicpm3-4b", "decode_32k", "single", None),
             ("jamba-v0.1-52b", "prefill_32k", "single", 8),
             ("mistral-large-123b", "train_4k", "single", 8))
DRY_TIMEOUT = 900

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


PORT_SPAN = "repro_torch."   # the port's spans (``runtime.spans``)


def kernels_and_spans(averages) -> tuple:
    """Split ``torch.profiler``'s ``key_averages()`` into ({kernel: device
    us}, {port span: [calls, host us, device us]}).  A port span is a range
    on the host (``runtime.spans``); its host us are its inclusive time and
    its device us those of the kernels launched inside it on its thread.
    An entry of a span's name on the device's timeline (the copy a user
    annotation would have there) is no kernel."""
    kernels, spans = {}, {}
    for evt in averages:
        on_device = str(evt.device_type).split(".")[-1] == "CUDA"
        if evt.key.startswith(PORT_SPAN):
            if not on_device:
                spans[evt.key] = [evt.count, evt.cpu_time_total, getattr(
                    evt, "device_time_total",
                    getattr(evt, "cuda_time_total", 0.0))]
            continue
        us = getattr(evt, "self_device_time_total",
                     getattr(evt, "self_cuda_time_total", 0.0))
        # kernel events only: an operator's entry repeats its kernels' time
        if on_device and us > 0:
            kernels[evt.key] = kernels.get(evt.key, 0.0) + us
    return kernels, spans


def profile_call(fn, label: str, watch=(), cpu: bool = True,
                 top: int = 10) -> None:
    """One call of ``fn`` under ``torch.profiler``: device time by kernel
    and the share of the host-clock span the device was busy, and the
    summed device time of the kernels whose names hold each string of
    ``watch`` (or, for a tuple, any of its strings); then the port's spans
    (``kernels_and_spans``).  Prints "not measured" when the profiler
    records no device time.  ``cpu=False`` records the device's activity
    only (a call of ~10⁶ operator events costs minutes of the profiler's
    own work with the host's)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if cpu:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t) * 1e6
    dev_us, spans = kernels_and_spans(prof.key_averages())
    total = sum(dev_us.values())
    if total <= 0:
        print(f"profile ({label}): device time not measured (the profiler "
              f"recorded no device events)", flush=True)
        return
    top = sorted(dev_us.items(), key=lambda kv: -kv[1])[:top]
    print(f"profile ({label}, profiler on): span {wall_us / 1e3:.1f}"
          f" ms, device busy {total / 1e3:.1f} ms = "
          f"{100 * total / wall_us:.1f}% (idle {100 - 100 * total / wall_us:.1f}"
          f"%); by kernel:", flush=True)
    for name, us in top:
        print(f"  {us / 1e3:9.2f} ms {100 * us / total:5.1f}%  {name[:90]}",
              flush=True)
    for part in watch:     # a string, or a tuple of alternatives
        names = (part,) if isinstance(part, str) else part
        us = sum(v for k, v in dev_us.items() if any(n in k for n in names))
        print(f"  kernels named {' or '.join(f'*{n}*' for n in names)}: "
              f"{us / 1e3:.2f} ms {100 * us / total:.1f}% of the device "
              f"time", flush=True)
    if spans:
        print("  port spans (calls, host ms inclusive, device ms of the "
              "kernels launched inside): " + ", ".join(
                  f"{k[len(PORT_SPAN):]} {n} {h / 1e3:.2f} {d / 1e3:.2f}"
                  for k, (n, h, d) in sorted(spans.items())), flush=True)


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


def mask_pairs(sq: int, sk: int, causal: bool, window: int = 0) -> int:
    """The (query, key) pairs a head's mask leaves: row i keeps keys j < Sk
    with j <= i if causal and j > i - window if window > 0 (a window needs
    Sq == Sk, as the kernel's)."""
    if window <= 0 or window >= sk:
        return sq * (sq + 1) // 2 if causal else sq * sk
    w = window
    if causal:      # row i keeps min(i + 1, w) keys
        return w * (w + 1) // 2 + (sq - w) * w
    # row i keeps the keys from max(0, i - w + 1) to Sk - 1
    cut = (sq - w) * (sq - w + 1) // 2 if sq > w else 0
    return sq * sk - cut


def flash_bound(q, k, v, causal: bool, window: int = 0):
    """(least ms, "operations" | "bytes") of attention on these inputs:
    the multiply-adds of the pairs the mask leaves (``mask_pairs``) at the
    peak rate of the inputs' type, or the bytes of q, k, v and o."""
    bh, s, dq = q.shape
    dv = v.shape[2]
    pairs = bh * mask_pairs(s, k.shape[1], causal, window)
    flops = 2.0 * pairs * (dq + dv)
    peak = BF16_FLOP_PER_S if q.dtype == torch.bfloat16 else FP32_FLOP_PER_S
    nbytes = q.element_size() * (q.numel() + k.numel() + v.numel()
                                 + bh * s * dv)
    t_ops, t_bytes = flops / peak * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the inputs on which the 128 / 128 and 96 / 64 instances' outputs are
# pinned bit for bit, (BH, BKV, S, Dq, Dv, causal, window) each: a ragged
# causal call and a windowed GQA call per instance
PINNED_FLASH = {"wgmma": ((8, 2, 1000, 128, 128, True, 0),
                          (4, 2, 512, 128, 128, True, 100)),
                "wgmma_dv": ((40, 40, 2016, 96, 64, True, 0),
                             (4, 2, 512, 96, 64, True, 100))}


def pinned_flash_inputs(case, dev):
    """bf16 q, k, v of a ``PINNED_FLASH`` case from numpy's generator
    (seed 2025), the same bits on every machine."""
    bh, bkv, s, dq, dv = case[:5]
    rng = np.random.default_rng(2025)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(torch.bfloat16).to(dev)
                 for shape in ((bh, s, dq), (bkv, s, dq), (bkv, s, dv)))


# the SHA-256 of those outputs (``output_digest``), as the source gave them
# on an H100 before the template took partial boxes
# (``tools/flash_breakdown.py --against <that source> --digests``)
PINNED_DIGESTS = {
    ("wgmma", 0):
        "8ca1c5c1355bdba31ced39a2c721e1db812264a853fd98fcc8182f17d5a99b89",
    ("wgmma", 1):
        "593f21cdbadfd1bfa3fbbee3bb65cc891207d7ccb2ce9409d10993db0fb91ce8",
    ("wgmma_dv", 0):
        "ab4bfa6b77ece02235ecbbc59def17d9f88efd0ece0de8136a38023f7a18c139",
    ("wgmma_dv", 1):
        "1fd29cf04b79e61b7a96f0abfca69f0bcac705aec7b5a72e6737c7465ba3831e"}


def output_digest(t: torch.Tensor) -> str:
    """SHA-256 of a bf16 tensor's bits, for pinning a kernel's output."""
    import hashlib
    bits = t.detach().contiguous().view(torch.int16).cpu().numpy()
    return hashlib.sha256(bits.tobytes()).hexdigest()


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
        if dtype == torch.bfloat16 and (dq, dv) in FA.WGMMA_DV_HEAD_DIMS:
            check(variant == "wgmma_dv", f"flash {label}: {variant} on a "
                                         f"bf16 {dq}/{dv} case, not wgmma_dv")
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
    print(f"flash_attention_wgmma_kernel (D 128), nvcc -Xptxas -v: "
          f"{ptxas_summary(log, WGMMA_128)}; dynamic shared memory {smem} B",
          flush=True)
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
    # MLA's heads (minicpm3-4b: 40 heads, Dq 96, Dv 64) at the scoring S
    flash_case("MLA heads", 40, 40, SCORE_S, 96, 64, torch.bfloat16)

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
       the next layers spread that.

    The plain side takes no kernel: its attention impl is ``"dense"``, as
    the training flash kernels would take a chunked call here (checked:
    ``train_fwd`` never launches)."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    from repro_torch.models.mamba import mamba_block
    rms = lambda t: float(t.float().square().mean().sqrt())  # noqa: E731
    trained = FA.VARIANT_LAUNCHES["train_fwd"]
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
    check(FA.VARIANT_LAUNCHES["train_fwd"] == trained,
          "the bf16 agreement launched the training flash kernel")


@torch.no_grad()
def jamba_phases(FA, SS, dev) -> dict:
    """Phases 7 and 8: the full-width float32 check, then serving in bf16,
    with autograd off (the passes run under ``inference_mode``).  Returns
    the LM main path's launch counts."""
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
    # the plain side on dense attention: at F32_S (one chunk) the chunked
    # route would run it too, were its bf16 D 128 causal calls not sent to
    # the training flash kernels
    bf16_agreement(lm, params, replace(base, attention_impl="dense"), cfg,
                   toks, out_p)
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
    # one slot more than the timed steps fill: the profiled step's
    cache = model.init_cache(SCORE_B, PROMPT + GEN + 1, device=dev)
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
    profile_call(lambda: model.decode_step(params, tok, cache),
                 f"one jamba decode step B={SCORE_B}")
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



# ---------------------------------------------------------------------------
# phase 12: the gradient search over the packed Explorer
# ---------------------------------------------------------------------------


def lap_clock():
    """``lap(label)`` prints the seconds since the previous lap."""
    last = [time.perf_counter()]

    def lap(label: str) -> None:
        now = time.perf_counter()
        print(f"   ({label}: {now - last[0]:.1f} s)", flush=True)
        last[0] = now

    return lap


class StepClock:
    """Times each value-and-gradient evaluation of the gradient search on
    the card, forward and backward apart: wraps ``dse._rows_value_and_grad``
    (every gradient function of the port goes through it) while active."""

    def __init__(self):
        from repro_torch.core.aidg import dse
        self.dse, self.orig = dse, dse._rows_value_and_grad
        self.steps = []           # (forward s, backward s) per evaluation

    def __enter__(self):
        def timed(f, knobs, device):
            fwd = []

            def f_timed(k):
                t = time.perf_counter()
                v = f(k)
                torch.cuda.synchronize()
                fwd.append(time.perf_counter() - t)
                return v

            torch.cuda.synchronize()
            t = time.perf_counter()
            out = self.orig(f_timed, knobs, device)
            torch.cuda.synchronize()
            total = time.perf_counter() - t
            self.steps.append((fwd[0], total - fwd[0]))
            return out

        self.dse._rows_value_and_grad = timed
        return self

    def __exit__(self, *exc):
        self.dse._rows_value_and_grad = self.orig


def print_refine(label: str, out, clock: StepClock, secs: float) -> None:
    """A refine's steps (τ, forward and backward s, obj_min) and total."""
    for h, (fw, bw) in zip(out.history, clock.steps):
        print(f"  {label} step {h['step']:2d}: tau {h['tau']:.4f} forward "
              f"{fw:.3f} s backward {bw:.3f} s obj_min {h['obj_min']:.6f}",
              flush=True)
    fw = [f for f, _ in clock.steps]
    bw = [b for _, b in clock.steps]
    print(f"{label}: {len(out.history)} steps in {secs:.2f} s (median "
          f"forward {float(np.median(fw)):.3f} s, backward "
          f"{float(np.median(bw)):.3f} s), {out.evaluations} evaluations, "
          f"score {out.score:.6f}, theta {np.round(out.theta, 4).tolist()}",
          flush=True)


def central_differences(fn, k0: np.ndarray) -> tuple:
    """(gradient at k0 (K,), central differences (K,), their float32
    resolution) of ``fn(knobs, tau)`` at ``GRAD_FD_TAU``, from one call
    over k0 and its 2K steps."""
    K_ = k0.shape[1]
    rows = np.repeat(k0, 2 * K_ + 1, axis=0)
    rows[1 + np.arange(0, 2 * K_, 2), np.arange(K_)] += GRAD_FD_EPS
    rows[2 + np.arange(0, 2 * K_, 2), np.arange(K_)] -= GRAD_FD_EPS
    v, g = fn(rows, GRAD_FD_TAU)
    v = v.cpu().numpy().astype(np.float64)
    steps = (rows[1::2] - rows[2::2])[np.arange(K_), np.arange(K_)]
    ulp = float(np.spacing(np.float32(np.abs(v).max())))
    return (g[0].cpu().numpy().astype(np.float64),
            (v[1::2] - v[2::2]) / steps.astype(np.float64),
            FD_ULPS * ulp / (2 * GRAD_FD_EPS))


def check_fd(label: str, g: np.ndarray, fd: np.ndarray,
             resolution: float) -> None:
    gap = np.abs(fd - g)
    limit = GRAD_FD_GATE * np.maximum(1.0, np.abs(fd)) + resolution
    check(bool(np.all(gap <= limit)),
          f"{label}: gradient {g} vs central differences {fd} (limit "
          f"{limit})")
    print(f"{label}: gradient {np.round(g, 5).tolist()} vs central "
          f"differences {np.round(fd, 5).tolist()}, max rel. gap "
          f"{float((gap / np.maximum(1.0, np.abs(fd))).max()):.2e} (gate "
          f"{GRAD_FD_GATE} + the differences' resolution {resolution:.3g})",
          flush=True)


def grad_gate(dev):
    """12 (a): the reference's acceptance gate on the 10-cell Explorer."""
    from repro_torch.core.aidg.explorer import Explorer
    from repro_torch.core.aidg.gradient import GradientExplorer
    ex = Explorer(device=dev)
    t = time.perf_counter()
    cd = ex.refine()
    cd_s = time.perf_counter() - t
    res = ex.explore(cd[None, :])
    cd_score = float(res.latency[0] * res.cost[0])
    cd_evals = (9 + 1) * ex.space.n * 2
    with StepClock() as clock:
        t = time.perf_counter()
        out = GradientExplorer(ex).refine()
        gr_s = time.perf_counter() - t
    print_refine("gradient refine, 10 cells", out, clock, gr_s)
    check(out.evaluations == 46 and out.evaluations * 2 <= cd_evals,
          f"evaluations {out.evaluations} vs {cd_evals}")
    check(out.score <= cd_score * GRAD_GATE,
          f"gradient score {out.score} > coordinate descent {cd_score} x "
          f"{GRAD_GATE}")
    check(np.array_equal(ex.space.clip(out.theta), out.theta),
          f"incumbent {out.theta} outside the knob box")
    re = ex.explore(out.theta[None, :])
    again = float(re.latency[0] * re.cost[0])
    check(abs(again - out.score) <= 1e-6 * out.score,
          f"re-scored {again} != {out.score}")
    print(f"gate, 10 cells: gradient {out.score:.6f} ({out.evaluations} "
          f"evaluations, {gr_s:.2f} s) <= coordinate descent "
          f"{cd_score:.6f} ({cd_evals} evaluations, {cd_s:.2f} s) x "
          f"{GRAD_GATE}; in the box, re-scored equal (the reference's "
          f"TPU-era CPU row, for contrast only: 2.5714 at 46 against "
          f"2.5849 at 100, BENCH_dse.json dse/gradient)", flush=True)
    return ex


def grad_matrix(ex, ex10, dev):
    """12 (b): the gradient search over the 31-cell matrix; one 10-cell
    step profiled (the profiler's own work grows with the step's kernel
    count: ~60 s on a 31-cell step)."""
    from repro_torch.core.aidg.gradient import GradientExplorer
    from repro_torch.core.aidg.maxplus import _as_tau
    for objective, steps in (("product", GRAD_PRODUCT_STEPS),
                             ("edp", GRAD_EDP_STEPS)):
        ge = GradientExplorer(ex, objective=objective)
        with StepClock() as clock:
            t = time.perf_counter()
            out = ge.refine(steps=steps)
            secs = time.perf_counter() - t
        print_refine(f"gradient refine, {len(ex.compiled)} cells, "
                     f"{objective}", out, clock, secs)
        base = float(ge.hard_score(np.ones((1, ex.space.n),
                                           np.float32))[0])
        check(np.isfinite(out.score) and out.score <= base * (1 + 1e-6),
              f"{objective}: incumbent {out.score} worse than θ = 1 "
              f"{base}")
    lap = lap_clock()
    pm = ex.packed_matrix()
    fn = pm.grad_fn(ex.baselines)
    k = np.ones((2, ex.space.n), np.float32)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    fn(k, 0.05)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    print(f"one gradient step (2 candidates, {len(ex.compiled)} cells): "
          f"peak device memory {(peak - held) / 2**30:.3f} GiB above the "
          f"{held / 2**30:.3f} GiB held before it", flush=True)
    lap("one step for its peak memory")
    fn10 = ex10.packed_matrix().grad_fn(ex10.baselines)
    fn10(k, 0.05)
    profile_call(lambda: fn10(k, 0.05),
                 f"one gradient step, {len(ex10.compiled)} cells", cpu=False)
    lap("the profiled step, with the profiler's own work")
    with torch.no_grad():
        soft = pm._matrix(torch.ones((1, ex.space.n), device=dev),
                          _as_tau(SOFT_TAU, dev))[0][0].cpu().numpy()
    return soft


def grad_checks(ex, ex10, soft, dev):
    """12 (c)-(e): gradients against differences, finiteness, packed
    against per-cell, soft against hard, determinism."""
    from repro_torch.core.aidg.explorer import Explorer
    from repro_torch.core.aidg.gradient import GradientExplorer
    lap = lap_clock()
    pm = ex.packed_matrix()
    S, K_ = len(ex.compiled), ex.space.n
    k0 = np.asarray([[0.8, 1.2, 0.9, 1.1, 1.0]], np.float32)
    check_fd(f"packed grad_fn, {S} cells",
             *central_differences(pm.grad_fn(ex.baselines), k0))
    lap("packed differences")
    # one network cell (tpu_v5e's: its tile programs have the fewest
    # levels) through the stacked per-layer soft family
    ni = next(i for i, cs in enumerate(ex.compiled)
              if i >= len(GOLDEN_THETA1_CYCLES) and cs.arch == "tpu_v5e")
    net = ex.compiled[ni]
    check_fd(f"CompiledNetwork.grad_fn, {net.name}",
             *central_differences(net.grad_fn(ex._projections[ni],
                                              device=dev), k0))
    lap("network cell differences")
    k = np.ones((2, K_), np.float32)
    k[1] = k0[0]
    _, g = pm.grad_fn(ex.baselines)(k, SOFT_TAU)
    _, j = pm.grad3_fn(ex.baselines, ex.energy_baselines)(k, SOFT_TAU)
    check(bool(torch.isfinite(g).all() and torch.isfinite(j).all()),
          f"gradients at τ = {SOFT_TAU} not finite")
    print(f"τ = {SOFT_TAU}: grad_fn and grad3_fn finite on {S} cells "
          f"({g.numel() + j.numel()} entries)", flush=True)
    lap("finite at small τ")
    wf = Explorer(engine="wavefront", device=dev)
    kp = np.asarray([[0.9, 1.1, 1.0, 1.2, 0.8]], np.float32)
    vp, dp = GradientExplorer(ex10).value_and_grad(kp, 0.05)
    vc, dc = GradientExplorer(wf).value_and_grad(kp, 0.05)
    rel = abs(vp[0] - vc[0]) / abs(vc[0])
    check(rel <= 2e-2 and np.allclose(dp, dc, rtol=0.2, atol=5e-2),
          f"packed {vp, dp} vs per-cell {vc, dc}")
    print(f"packed vs per-cell (wavefront) value_and_grad, 10 cells, τ "
          f"0.05: value rel. gap {rel:.2e} (limit 2e-2), gradient max abs "
          f"gap {float(np.abs(dp - dc).max()):.2e} (rtol 0.2, atol 5e-2)",
          flush=True)
    lap("packed vs per-cell")
    # (d) soft against hard at θ = 1
    hard = np.asarray(ex.baselines, np.float64)
    gap = (soft - hard) / hard
    seq = np.asarray([getattr(cs.scenario, "mode", "sequential")
                      == "sequential" for cs in ex.compiled])
    check(bool(np.all(np.abs(gap) <= SOFT_HARD_REL)),
          f"soft vs hard at τ = {SOFT_TAU}: {gap}")
    check(bool(np.all(gap[seq] >= -SOFT_FLOOR)),
          f"soft below hard on a sequential cell: {gap[seq]}")
    print(f"soft vs hard, τ = {SOFT_TAU}, θ = 1: relative gap per cell "
          f"{[f'{x:.1e}' for x in gap]} (limit {SOFT_HARD_REL}; "
          f"{int(seq.sum())} sequential cells >= -{SOFT_FLOOR})", flush=True)
    # (e) determinism
    fn = pm.grad_fn(ex.baselines)
    a, b = fn(k, 0.05), fn(k, 0.05)
    same_v = torch.equal(a[0], b[0])
    same_g = torch.equal(a[1], b[1])
    print(f"two identical gradient evaluations: values bit-equal {same_v}, "
          f"gradients bit-equal {same_g} (max gap "
          f"{float((a[1] - b[1]).abs().max()):.3e})", flush=True)
    if not same_g:
        # the same under deterministic algorithms; ops that have none warn
        # (warn_only) and are named
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                a, b = fn(k, 0.05), fn(k, 0.05)
            finally:
                torch.use_deterministic_algorithms(False)
        named = sorted({str(w.message).split(" does not have")[0]
                        for w in caught})
        print(f"  under torch.use_deterministic_algorithms(True): gradients "
              f"bit-equal {torch.equal(a[1], b[1])}; operations without a "
              f"deterministic implementation: {named or 'none'}",
              flush=True)
    ge = GradientExplorer(ex10)
    r1 = ge.refine(starts=2, steps=GRAD_DETERMINISM_STEPS, seed=5)
    r2 = ge.refine(starts=2, steps=GRAD_DETERMINISM_STEPS, seed=5)
    same = (np.array_equal(r1.final_thetas, r2.final_thetas)
            and r1.history == r2.history)
    gap = float(np.max(np.abs(r1.final_thetas - r2.final_thetas)
                       / r2.final_thetas))
    check(gap <= DETERMINISM_RTOL
          and abs(r1.score - r2.score) <= DETERMINISM_RTOL * r2.score,
          f"two identical refines differ: {r1.final_thetas} vs "
          f"{r2.final_thetas}")
    print(f"two identical refines (2 starts, {GRAD_DETERMINISM_STEPS} "
          f"steps, 10 cells): "
          f"bit-equal {same}; incumbent thetas max rel. gap {gap:.3e}, "
          f"scores {r1.score:.9f} / {r2.score:.9f} (limit "
          f"{DETERMINISM_RTOL})", flush=True)
    lap("determinism")


def grad_phase(ex, modules, dev):
    """Phase 12: the gradient search on the card over phase 10's Explorer
    (and the 10-cell one), the kernels' counters zeroed just before and
    read just after — no kernel and no plain version may run."""
    for mod in modules:
        mod.reset_counts()
    lap = lap_clock()
    ex10 = grad_gate(dev)
    lap("(a) the gate")
    soft = grad_matrix(ex, ex10, dev)
    lap("(b) the 31-cell refines, profile and memory")
    grad_checks(ex, ex10, soft, dev)
    counts = {f"{kind}{k}": v for mod in modules
              for kind, d in (("", mod.LAUNCHES), ("plain ", mod.PLAIN_CALLS))
              for k, v in d.items()}
    check(sum(counts.values()) == 0, f"kernels or plain versions ran on "
                                     f"the gradient path: {counts}")
    print(f"gradient search: kernel launches and plain calls across phase "
          f"12 {counts}", flush=True)


# ---------------------------------------------------------------------------
# phase 13: training on the card
# ---------------------------------------------------------------------------


class TrainClock:
    """Times every step of ``launch.train.train_loop`` on the host clock
    around a synchronised call: wraps the ``make_train_step`` it builds
    its step with, while active."""

    def __init__(self):
        from repro_torch.launch import train
        self.train, self.orig = train, train.make_train_step
        self.secs = []

    def __enter__(self):
        def make(cfg, opt=None, remat=True):
            step = self.orig(cfg, opt, remat)

            def timed(params, opt_state, batch):
                torch.cuda.synchronize()
                t = time.perf_counter()
                out = step(params, opt_state, batch)
                torch.cuda.synchronize()
                self.secs.append(time.perf_counter() - t)
                return out

            return timed

        self.train.make_train_step = make
        return self

    def __exit__(self, *exc):
        self.train.make_train_step = self.orig


def fixed_batch(cfg, b: int, s: int, dev, seed: int = 0) -> dict:
    from repro_torch.data import DataConfig, synthetic_source
    src = synthetic_source(DataConfig(seq_len=s, global_batch=b,
                                      vocab_size=cfg.vocab_size, seed=seed))
    return {k: torch.from_numpy(v).to(dev) for k, v in src(0).items()}


def train_parts(cfg, params, dev) -> None:
    """The parts of a step timed apart with CUDA events, as separate calls
    at the step's shapes: the chunked route's attention (the training
    flash kernels; each layer's forward twice under remat, its backward
    once), cross-entropy forward + backward, one AdamW update, the casts
    to bf16."""
    from repro_torch.launch.steps import cross_entropy
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
    a, bf16 = cfg.attention, torch.bfloat16
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn((TRAIN_B, TRAIN_S, a.n_heads, a.head_dim),
                           generator=gen, device=dev, dtype=bf16)
               .requires_grad_() for _ in range(3))
    g = torch.randn(q.shape, generator=gen, device=dev, dtype=bf16)

    def attend():
        return L._attend(q, k, v, causal=True, window=0, impl="chunked",
                         chunk=1024)

    def attn_fwd():
        with torch.no_grad():
            attend()

    def attn_fwd_bwd():
        attend().backward(g)

    fwd, fwd_bwd = cuda_ms(attn_fwd, 2), cuda_ms(attn_fwd_bwd, 2)
    del q, k, v, g
    logits = torch.randn((TRAIN_B, TRAIN_S, cfg.vocab_size), generator=gen,
                         device=dev, dtype=bf16).requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_B, TRAIN_S),
                           generator=gen, device=dev)
    ce = cuda_ms(lambda: cross_entropy(logits, labels).backward(), 2)
    del logits
    weights = dict(params.named_parameters())
    state = adamw_init(weights)
    grads = {n: torch.full_like(p, 1e-3) for n, p in weights.items()}
    opt = AdamWConfig(lr=TRAIN_LR)
    adam = cuda_ms(lambda: adamw_update(opt, weights, grads, state), 2)
    del state, grads
    casts = cuda_ms(lambda: [lm.cast_tree(layer.tree(), bf16)
                             for layer in params.layers], 2)
    attn = cfg.n_layers * (fwd + fwd_bwd)
    print(f"step parts (CUDA events, separate calls at the step's shapes): "
          f"attention (the chunked route: the training flash kernels) "
          f"{attn:.1f} ms ({cfg.n_layers} layers x "
          f"(forward {fwd:.2f} + forward and backward {fwd_bwd:.2f} ms)); "
          f"cross-entropy forward + backward {ce:.1f} ms; AdamW update "
          f"{adam:.1f} ms; casts of the layers to bf16 {casts:.1f} ms; "
          f"together {attn + ce + adam + casts:.1f} ms", flush=True)


def train_full(dev) -> dict:
    """13 (a): olmo-1b at full width and depth through ``train_loop``.
    Returns the training attention kernels' launches in its steps."""
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.models import layers as L
    cfg = get_config(TRAIN_ARCH)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    FA.reset_counts()
    L.CHUNKED_CUDA_CALLS = 0
    with TrainClock() as clock:
        t = time.perf_counter()
        params, metrics = train.train_loop(
            cfg, steps=TRAIN_STEPS, batch=TRAIN_B, seq=TRAIN_S, lr=TRAIN_LR,
            print_fn=lines.append, device=dev)
        total = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated()
    n = sum(p.numel() for p in params.parameters())
    print(f"{TRAIN_ARCH} at full width and depth: {cfg.n_layers} layers, d "
          f"{cfg.d_model}, {n / 1e9:.3f} G parameters (float32 masters), "
          f"bf16 compute, remat on; B = {TRAIN_B}, S = {TRAIN_S} (cut from "
          f"train_4k's batch of 256); {TRAIN_STEPS} steps of train_loop in "
          f"{total:.1f} s, {total - sum(clock.secs):.1f} s of it set-up "
          f"(initialisation from a CPU generator, the copy to the card)",
          flush=True)
    for row, secs in zip(metrics.rows, clock.secs):
        print(f"  step {row['step']}: {secs:.3f} s, loss {row['loss']:.4f}, "
              f"grad norm {row['grad_norm']:.4f}, lr {row['lr']:.3e}",
              flush=True)
    check(len(clock.secs) == TRAIN_STEPS == len(metrics.rows),
          f"{len(clock.secs)} timed steps")
    # every layer's attention on the training kernels: its forward twice
    # (remat), its backward once; no chunked call on the card
    ran = {v: FA.VARIANT_LAUNCHES[v]
           for v in ("train_fwd", "train_dq", "train_dkdv")}
    per_step = {v: n / TRAIN_STEPS for v, n in ran.items()}
    chunked = L.CHUNKED_CUDA_CALLS
    print(f"attention over {TRAIN_STEPS} steps: VARIANT_LAUNCHES "
          f"{dict(FA.VARIANT_LAUNCHES)}, CHUNKED_CUDA_CALLS {chunked} "
          f"({per_step} a step)", flush=True)
    layers = cfg.n_layers
    check(per_step == {"train_fwd": 2 * layers, "train_dq": layers,
                       "train_dkdv": layers}
          and chunked == 0, f"training attention launches a step {per_step}"
                            f", chunked calls on the card {chunked}")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"])
              for r in metrics.rows), "losses and gradient norms finite")
    step_s = float(np.median(clock.secs[1:]))
    tokens = TRAIN_B * TRAIN_S
    a = cfg.attention
    dense = 6.0 * n * tokens
    attn = 6.0 * cfg.n_layers * TRAIN_B * a.n_heads * a.head_dim * TRAIN_S ** 2
    flops = dense + attn
    print(f"median step (steps 1-{TRAIN_STEPS - 1}) {step_s:.3f} s -> "
          f"{tokens / step_s:.0f} tokens/s; model FLOP 6·N·T {dense:.3e} + "
          f"causal attention 6·L·B·H·D·S² {attn:.3e} = {flops:.3e} a "
          f"step "
          f"(remat's second forward not counted) -> {flops / step_s:.3e} "
          f"FLOP/s = {100 * flops / step_s / BF16_FLOP_PER_S:.1f}% of the "
          f"dense bf16 peak ({BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s); peak "
          f"device memory {peak / 2**30:.2f} GiB", flush=True)
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
    state = adamw_init(dict(params.named_parameters()))
    batch = fixed_batch(cfg, TRAIN_B, TRAIN_S, dev)
    step(params, state, batch)
    profile_call(lambda: step(params, state, batch),
                 f"one {TRAIN_ARCH} training step", cpu=False, top=16,
                 watch=(CUBLAS_NAMES, F32_GEMM_NAMES, ("softmax", "SoftMax"),
                        ("copy", "Memcpy")))
    del state
    train_parts(cfg, params, dev)
    return ran


def train_update(dev) -> None:
    """13 (b): full width, 2 layers, float32: a fixed batch's loss falls;
    microbatches 1 and 2 give the same gradients."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    cfg = replace(get_config(TRAIN_ARCH), n_layers=UPDATE_LAYERS,
                  compute_dtype="float32")
    params, state = init_train_state(cfg, torch.Generator().manual_seed(1),
                                     dev)
    batch = fixed_batch(cfg, TRAIN_B, TRAIN_S, dev, seed=1)
    # the first moments after one step from the same start, clipping off:
    # (1 - b1) times the gradient
    opt = AdamWConfig(lr=UPDATE_LR, clip_norm=0.0)
    moments = {}
    for micro in (1, 2):
        model = copy.deepcopy(params)
        st = {"step": 0, "m": {k: t.clone() for k, t in state["m"].items()},
              "v": {k: t.clone() for k, t in state["v"].items()}}
        make_train_step(replace(cfg, train_microbatches=micro), opt)(
            model, st, batch)
        moments[micro] = st["m"]
        del model, st
    worst, worst_name = 0.0, ""
    for name, m1 in moments[1].items():
        gap = float((moments[2][name] - m1).abs().max()
                    / m1.abs().max().clamp(min=1e-30))
        if gap >= worst:
            worst, worst_name = gap, name
    check(worst <= MICRO_TOL, f"microbatches 1 vs 2: {worst_name} differs "
                              f"by {worst:.3e} of its largest gradient")
    del moments
    step = make_train_step(cfg, AdamWConfig(lr=UPDATE_LR))
    losses = []
    for _ in range(UPDATE_STEPS):
        _, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    check(all(map(math.isfinite, losses)) and losses[-1] < losses[0],
          f"fixed-batch losses {losses}")
    print(f"{TRAIN_ARCH} full width, {UPDATE_LAYERS} layers, float32 "
          f"compute, one batch of {TRAIN_B} x {TRAIN_S}: {UPDATE_STEPS} "
          f"steps at lr {UPDATE_LR}, losses {fmt(losses)}; "
          f"train_microbatches 1 vs 2, gradients' largest gap "
          f"{worst:.2e} of the leaf's largest magnitude ({worst_name}; "
          f"limit {MICRO_TOL})", flush=True)


def train_resume(dev) -> None:
    """13 (c): crash-resume at full width, 2 layers."""
    import shutil
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    cfg = replace(get_config(TRAIN_ARCH), n_layers=UPDATE_LAYERS)
    root = Path(__file__).resolve().parent / "build" / "chip_smoke_ckpt"
    shutil.rmtree(root, ignore_errors=True)
    kw = dict(steps=16, batch=RESUME_B, seq=RESUME_S, ckpt_every=8,
              print_fn=lambda *a: None, device=dev)
    try:
        t = time.perf_counter()
        _, m_a = train_loop(cfg, ckpt_dir=str(root / "a"), **kw)
        a_s = time.perf_counter() - t
        size = sum(f.stat().st_size for f in
                   (root / "a" / "step_000000016").iterdir())
        t = time.perf_counter()
        try:
            train_loop(cfg, ckpt_dir=str(root / "b"), fail_at_step=12, **kw)
        except RuntimeError as e:
            if "injected failure at step 12" not in str(e):
                raise
        else:
            raise RuntimeError("check failed: the failure was not injected")
        _, m_b = train_loop(cfg, ckpt_dir=str(root / "b"), **kw)
        b_s = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    la = [r["loss"] for r in m_a.rows if r["step"] == 15][0]
    lb = [r["loss"] for r in m_b.rows if r["step"] == 15][0]
    check([r["step"] for r in m_b.rows] == list(range(8, 16)),
          f"resumed steps {[r['step'] for r in m_b.rows]}")
    check(abs(la - lb) <= RESUME_RTOL * abs(la),
          f"crash-resume: step 15 loss {lb} vs {la}")
    same = all(ra == rb for ra, rb in zip(m_a.rows[8:], m_b.rows))
    print(f"crash-resume, {TRAIN_ARCH} full width, {UPDATE_LAYERS} layers, "
          f"B = {RESUME_B}, S = {RESUME_S}: 16 steps straight {a_s:.1f} s; "
          f"crash at step 12 after the step-8 checkpoint, restart, finish "
          f"{b_s:.1f} s; step 15 loss {la:.6f} / {lb:.6f} (rtol "
          f"{RESUME_RTOL}); steps 8-15 bit-equal {same}; a checkpoint "
          f"{size / 2**30:.2f} GiB", flush=True)


def train_families(dev) -> None:
    """13 (d): the MoE and Mamba families at published widths, 2 layers."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    for arch in FAMILY_ARCHS:
        cfg = replace(get_config(arch), n_layers=UPDATE_LAYERS)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        params, state = init_train_state(
            cfg, torch.Generator().manual_seed(2), dev)
        n = sum(p.numel() for p in params.parameters())
        batch = fixed_batch(cfg, FAMILY_B, FAMILY_S, dev, seed=2)
        step = make_train_step(cfg, AdamWConfig(lr=UPDATE_LR))
        losses, norms, secs = [], [], []
        for _ in range(FAMILY_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, state, m = step(params, state, batch)
            losses.append(float(m["loss"]))
            secs.append(time.perf_counter() - t)
            norms.append(float(m["grad_norm"]))
        check(all(map(math.isfinite, losses + norms)) and
              losses[-1] < losses[0],
              f"{arch}: losses {losses}, grad norms {norms}")
        print(f"{arch} at published width, {UPDATE_LAYERS} layers "
              f"({n / 1e9:.3f} G parameters), bf16 compute, one batch of "
              f"{FAMILY_B} x {FAMILY_S}: {FAMILY_STEPS} steps "
              f"{fmt(secs)} s, losses {fmt(losses)}, grad norms "
              f"{fmt(norms)}; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
              flush=True)
        del params, state
        gc.collect()
        torch.cuda.empty_cache()


def check_only_training_attention(modules, what: str) -> None:
    """Of the kernels and plain versions, only the training attention
    kernels ran since the counters were zeroed; prints every count."""
    from repro_torch.models import layers as L
    FA = modules[1]
    train = ("train_fwd", "train_dq", "train_dkdv")
    counts = {f"{kind}{k}": v for mod in modules
              for kind, d in (("", mod.LAUNCHES), ("plain ", mod.PLAIN_CALLS))
              for k, v in d.items() if not (mod is FA and kind == "")}
    counts.update({k: v for k, v in FA.VARIANT_LAUNCHES.items()
                   if k not in train})
    check(sum(counts.values()) == 0, f"kernels or plain versions other "
                                     f"than the training attention ran in "
                                     f"{what}: {counts}")
    print(f"{what}: training attention launches "
          f"{ {k: FA.VARIANT_LAUNCHES[k] for k in train} }, chunked calls on "
          f"the card {L.CHUNKED_CUDA_CALLS}; every other kernel "
          f"and plain version {counts}", flush=True)


def train_attention_kernels(FA, dev) -> dict:
    """The training attention kernels alone at olmo-1b's layer shape (B 4
    x 16 heads, S 4096, D 128, bf16, causal), through the module's own
    launchers (``_train_forward``, ``_train_backward`` and the latter's
    three launches one by one).  Their outputs
    against the plain versions, 8 heads at a time, as the card tests hold
    them: o within ``bf16_error_bound``, the log-sum-exp within 1e-5, dq,
    dk and dv within 2^-6 of the largest element.  Times by CUDA events
    over back-to-back calls: the forward, each launch of the backward (D =
    rowsum(dO o), ``train_dq``, ``train_dkdv``) and the whole backward;
    each beside its bound (the multiply-adds of the causal pairs at the bf16
    peak: 2 products forward, 5 backward -- S, dP, dV, dK, dQ -- of which
    3 are ``train_dkdv``'s and 2 ``train_dq``'s; the S and dP that
    ``train_dq`` makes again are the cost of a backward without atomics,
    not work the bound counts), the plain versions and SDPA's forward and
    backward (timed only, the library yardstick).  Returns the
    kernels-line rows."""
    from repro_torch.configs import get_config
    a = get_config(TRAIN_ARCH).attention
    bh, s, d = TRAIN_B * a.n_heads, TRAIN_S, a.head_dim
    gen = torch.Generator(device=dev).manual_seed(5)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev)
                   .to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = FA._train_forward(q, k, v, scale)
    dq, dk, dv = FA._train_backward(q, k, v, o, lse, do, scale)
    chunk = 8
    errs = {"o": 0.0, "lse": 0.0, "dq": 0.0, "dk": 0.0, "dv": 0.0}
    for h in range(0, bh, chunk):
        sl = slice(h, h + chunk)
        po, plse = FA.flash_attention_train_torch(q[sl], k[sl], v[sl],
                                                  scale=scale)
        err = (o[sl].float() - po.float()).abs()
        check(bool((err <= FA.bf16_error_bound(q[sl], k[sl], v[sl],
                                               causal=True)).all()),
              f"train_fwd o, heads {h}..: outside bf16_error_bound")
        errs["o"] = max(errs["o"], float(err.max()))
        err = float((lse[sl] - plse).abs().max())
        check(err <= 1e-5 * (1.0 + float(plse.abs().max())),
              f"train_fwd lse, heads {h}..: max |err| {err:.3e}")
        errs["lse"] = max(errs["lse"], err)
        want = FA.flash_attention_train_backward_torch(
            q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], scale=scale)
        for name, got, w in zip(("dq", "dk", "dv"),
                                (dq[sl], dk[sl], dv[sl]), want):
            err = float((got.float() - w.float()).abs().max())
            top = float(w.float().abs().max())
            check(err <= 2.0 ** -6 * top, f"{name}, heads {h}..: max |err| "
                                          f"{err:.3e} of {top:.3e}")
            errs[name] = max(errs[name], err)
        del po, plse, want
    print(f"flash_attention training kernels at ({bh}, {s}, {d}) bf16 "
          f"causal against the plain versions ({chunk} heads at a time): "
          f"max |err| " + ", ".join(f"{n} {e:.3e}" for n, e in errs.items()),
          flush=True)
    del dq, dk, dv

    fwd_ms = cuda_ms(lambda: FA._train_forward(q, k, v, scale), 10)
    dvec = FA._train_dot(o, do)
    part = {"dot": cuda_ms(lambda: FA._train_dot(o, do), 10),
            "train_dq": cuda_ms(lambda: FA._train_dq(
                q, k, v, do, lse, dvec, scale), 10),
            "train_dkdv": cuda_ms(lambda: FA._train_dkdv(
                q, k, v, do, lse, dvec, scale), 10)}
    bwd_ms = cuda_ms(lambda: FA._train_backward(q, k, v, o, lse, do, scale),
                     10)

    def plain_fwd():
        for h in range(0, bh, chunk):
            FA.flash_attention_train_torch(q[h:h + chunk], k[h:h + chunk],
                                           v[h:h + chunk], scale=scale)

    def plain_bwd():
        for h in range(0, bh, chunk):
            sl = slice(h, h + chunk)
            FA.flash_attention_train_backward_torch(
                q[sl], k[sl], v[sl], o[sl], lse[sl], do[sl], scale=scale)

    plain_fwd_ms, plain_bwd_ms = cuda_ms(plain_fwd, 1), cuda_ms(plain_bwd, 1)
    F = torch.nn.functional
    q4, k4, v4 = (t.view(TRAIN_B, a.n_heads, s, d) for t in (q, k, v))
    leaves = [t.clone().requires_grad_() for t in (q4, k4, v4)]
    g4 = do.view(TRAIN_B, a.n_heads, s, d)
    sdpa_fwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True), 10)
    sdpa_bwd = cuda_ms(lambda: F.scaled_dot_product_attention(
        *leaves, is_causal=True).backward(g4), 10) - sdpa_fwd
    pairs = bh * mask_pairs(s, s, True)

    def bound(products):
        return 2.0 * pairs * d * products / BF16_FLOP_PER_S * 1e3

    backward = dict(ms=bwd_ms, bound_ms=bound(5), plain_ms=plain_bwd_ms,
                    library_ms=sdpa_bwd, dot_ms=part["dot"])
    rows = {}
    for name, ms, products, plain_ms, library, err in (
            ("train_fwd", fwd_ms, 2, plain_fwd_ms, sdpa_fwd, errs["o"]),
            ("train_dq", part["train_dq"], 2, None, None, errs["dq"]),
            ("train_dkdv", part["train_dkdv"], 3, None, None,
             max(errs["dk"], errs["dv"]))):
        print(f"flash_attention {name} at ({bh}, {s}, {d}) bf16 causal: "
              f"{ms:.4f} ms, {100 * bound(products) / ms:.1f}% of its bound "
              f"{bound(products):.4f} ms ({products} products)", flush=True)
        rows[f"flash_attention_{name}"] = dict(
            shape=[bh, s, d], dtype="bfloat16", ms=ms,
            bound_ms=bound(products), bound_by="operations",
            plain_ms=plain_ms, library_ms=library, max_abs_err=err,
            variant=name, source="src/repro_torch/csrc/flash_attention.cu",
            replaces="none (the reference trains through plain attention)",
            **({} if name == "train_fwd" else {"backward": backward}))
    print(f"forward {fwd_ms:.4f} ms against plain {plain_fwd_ms:.2f} ms and "
          f"SDPA's {sdpa_fwd:.4f} ms; backward (D {part['dot']:.4f} + "
          f"train_dq + train_dkdv alone {sum(part.values()):.4f} ms) "
          f"{bwd_ms:.4f} ms, {100 * bound(5) / bwd_ms:.1f}% of its bound "
          f"{bound(5):.4f} ms (5 products), against plain "
          f"{plain_bwd_ms:.2f} ms and SDPA's {sdpa_bwd:.4f} ms; forward + "
          f"backward {fwd_ms + bwd_ms:.4f} ms against SDPA's "
          f"{sdpa_fwd + sdpa_bwd:.4f} ms", flush=True)
    return rows


def train_phase(modules, dev) -> dict:
    """Phase 13: training on the card, the kernels' counters zeroed just
    before and read just after (the training attention kernels are on
    this path, nothing else of the table); then those kernels alone.
    Returns their kernels-line rows, each with its launches in (a)'s
    olmo-1b steps (``path_launches``)."""
    from repro_torch.models import layers as L
    for mod in modules:
        mod.reset_counts()
    L.CHUNKED_CUDA_CALLS = 0
    lap = lap_clock()
    ran = train_full(dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("(a) olmo-1b at full width and depth")
    train_update(dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("(b) the update on a fixed batch, microbatches")
    train_resume(dev)
    lap("(c) crash-resume")
    train_families(dev)
    lap("(d) olmoe-1b-7b and falcon-mamba-7b")
    check_only_training_attention(modules, "phase 13")
    rows = train_attention_kernels(modules[1], dev)
    for row in rows.values():
        row["path_launches"] = ran[row["variant"]]
    lap("(e) the training attention kernels alone")
    return rows


# ---------------------------------------------------------------------------
# phase 14: MLA (minicpm3-4b), the enc-dec family (whisper-small), the dry run
# ---------------------------------------------------------------------------


class FlashSpy:
    """Records the inputs and output of every ``flash_attention`` call made
    through the kernel module while active (``layers._attend`` looks the
    function up at call time)."""

    def __init__(self, FA):
        self.FA, self.real, self.calls = FA, FA.flash_attention, []

    def __enter__(self):
        def spy(q, k, v, **kw):
            out = self.real(q, k, v, **kw)
            self.calls.append((q, k, v, out, kw))
            return out

        self.FA.flash_attention = spy
        return self

    def __exit__(self, *exc):
        self.FA.flash_attention = self.real


def attention_blocks(FA, params, cfg, toks, dtype, n_layers=None,
                     patches=None) -> None:
    """Each attention block (MLA or GQA, with the config's window) with
    ``impl="flash_pallas"`` against ``chunked`` on the same input (the
    chunked path's activations at that layer): the kernel's attention
    output against its plain version on the same q, k, v (bf16: within
    ``FA.bf16_error_bound``; float32: ``FLASH_F32_TOL``), and the block
    outputs (bf16: RMS of kernel - chunked within 2^-7 of the chunked
    output's RMS, the largest within 2^-6 of its largest, as
    ``bf16_agreement``; float32: ``MLA_F32_TOL``).  Each block's kernel
    call runs the kernel ``FA.plan`` picks for the head dims and type
    (MLA: ``wgmma_dv`` in bf16, ``cuda_core`` in float32)."""
    from repro_torch.models import layers as L
    from repro_torch.models import lm
    rms = lambda t: float(t.float().square().mean().sqrt())  # noqa: E731
    a = cfg.attention
    block = L.mla_block if a.kind == "mla" else L.attention_block
    dq, dv = ((a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim)
              if a.kind == "mla" else (a.head_dim, a.head_dim))
    x = lm._embed(params, cfg, toks, patches, dtype)
    pos = torch.arange(x.shape[1], device=x.device)[None]
    worst_attn, worst_block = 0.0, 0.0
    layers = itertools.islice(lm._layers(params, dtype), n_layers)
    before = dict(FA.VARIANT_LAUNCHES)
    with FlashSpy(FA) as spy:
        for i, (layer, lp) in enumerate(layers):
            h = L.norm(cfg.norm, x, lp["ln1"])
            kern = block(lp["mix"], h, a, positions=pos,
                         impl="flash_pallas")[0]
            plain = block(lp["mix"], h, a, positions=pos,
                          impl="chunked")[0]
            q, k, v, out, kw = spy.calls.pop()
            want = FA.flash_attention_torch(q, k, v, **kw)
            if dtype == torch.bfloat16:
                bnd = FA.bf16_error_bound(q, k, v, **kw)
                attn = float(((out.float() - want.float()).abs()
                              / bnd).max())
                d = kern.float() - plain.float()
                agree = max(rms(d) / rms(plain) / 2.0 ** -7,
                            float(d.abs().max() / plain.float().abs().max())
                            / 2.0 ** -6)
                del bnd, d
            else:
                err, bad = within(out, want, FLASH_F32_TOL)
                attn = float(bad)
                err, bad = within(kern, plain, MLA_F32_TOL)
                agree = float(bad)
            check(attn <= (1.0 if dtype == torch.bfloat16 else 0.0),
                  f"{cfg.arch_id} layer {i} ({dtype}): kernel attention vs "
                  f"plain at {attn}")
            check(agree <= (1.0 if dtype == torch.bfloat16 else 0.0),
                  f"{cfg.arch_id} layer {i} ({dtype}): block kernel vs "
                  f"chunked at {agree}")
            worst_attn, worst_block = max(worst_attn, attn), max(worst_block,
                                                                  agree)
            del q, k, v, out, want, kern, plain
            x = lm._layer_apply(cfg, layer.kind, layer.is_moe, lp, x, pos,
                                None, "chunked", 1024)[0]
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    variant = FA.plan(dq, dv, dtype, True)
    what = f"{cfg.arch_id} {a.kind} blocks 0-{i}"
    check(ran == {n: (i + 1) * (n == variant) for n in FA.VARIANTS},
          f"{what} ({dtype}): flash launches {ran}, want {variant} once a "
          f"block")
    if dtype == torch.bfloat16:
        print(f"{what}, bf16, B {x.shape[0]} x S {x.shape[1]}: flash_pallas "
              f"({variant}) vs chunked on the same input; kernel attention "
              f"vs plain at most {worst_attn:.3f} of FA.bf16_error_bound, "
              f"block outputs at most {worst_block:.3f} of the RMS/max "
              f"limits", flush=True)
    else:
        print(f"{what}, float32 ({variant}): kernel attention within "
              f"{FLASH_F32_TOL} of plain, block outputs within "
              f"{MLA_F32_TOL} of chunked, in every layer", flush=True)


def greedy_parity(dec_logits, bf16_logits, f32_logits) -> str:
    """The decode's greedy tokens against the bf16 scoring pass's argmax
    over the same sequence: a token may differ only at a near-tie (both
    tokens' float32 logits within ``NEAR_TIE`` x the position's RMS
    distance of the bf16 scoring logits from the float32 ones); the
    decode's logits as near the float32 logits as the scoring pass's
    (RMS within ``BF16_PARITY``).  Logits (N, V), one row a position."""
    rms = lambda t: float(t.float().square().mean().sqrt())  # noqa: E731
    dec, ref, f32 = (t.float() for t in (dec_logits, bf16_logits,
                                         f32_logits))
    g_dec, g_ref, g_f32 = dec.argmax(-1), ref.argmax(-1), f32.argmax(-1)
    diff = (g_dec != g_ref).nonzero().flatten().tolist()
    for i in diff:
        margin = float((f32[i, g_dec[i]] - f32[i, g_ref[i]]).abs())
        noise = rms(ref[i] - f32[i])
        check(margin <= NEAR_TIE * noise,
              f"greedy token {i}: decode {int(g_dec[i])}, scoring "
              f"{int(g_ref[i])}, float32 margin {margin:.3e} > {NEAR_TIE} x "
              f"{noise:.3e}")
    err_d, err_s = rms(dec - f32), rms(ref - f32)
    check(err_d <= BF16_PARITY * err_s,
          f"decode logits {err_d:.4e} from float32, more than "
          f"{BF16_PARITY} x the scoring pass's {err_s:.4e}")
    return (f"{len(diff)} of {len(g_dec)} greedy tokens differ from the bf16 "
            f"scoring pass's (each at a near-tie); the scoring pass differs "
            f"from float32 in {int((g_ref != g_f32).sum())}; RMS distance from "
            f"the float32 logits: decode {err_d:.4e}, scoring {err_s:.4e} "
            f"(ratio {err_d / err_s:.3f}, limit {BF16_PARITY})")


def check_losses(label: str, metrics, secs) -> None:
    losses = [r["loss"] for r in metrics.rows]
    norms = [r["grad_norm"] for r in metrics.rows]
    check(len(losses) == TRAIN_CHECK_STEPS
          and all(map(math.isfinite, losses + norms)),
          f"{label}: losses {losses}, grad norms {norms}")
    print(f"{label}: {TRAIN_CHECK_STEPS} steps of train_loop in {secs:.1f} s,"
          f" losses {fmt(losses)}, grad norms {fmt(norms)}", flush=True)


def minicpm3_phase(FA, dev) -> int:
    """14 (a): minicpm3-4b at full width and depth in bf16.  Returns the
    flash kernel's launches on its path (scoring + prefill)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train_loop
    from repro_torch.models import get_model
    from repro_torch.models import lm
    base = get_config(MLA_ARCH)
    a = base.attention
    dq, dv = a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim
    cfg = replace(base, param_dtype="bfloat16")
    kern_cfg = replace(cfg, attention_impl="flash_pallas")
    model = get_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = model.init_params(3, device=dev)
    params.requires_grad_(False)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(4)
    toks = torch.randint(0, base.vocab_size, (1, MLA_S), generator=gen,
                         device=dev)
    variant = FA.plan(dq, dv, torch.bfloat16, True)
    print(f"{MLA_ARCH} at full width and depth: {base.n_layers} layers, d "
          f"{base.d_model}, {a.n_heads} heads, q_lora {a.q_lora_rank}, "
          f"kv_lora {a.kv_lora_rank}, dn {a.qk_nope_head_dim}, dr "
          f"{a.qk_rope_head_dim}, dv {dv}, {n / 1e9:.3f} G parameters, bf16,"
          f" from seed 3 on the card in {time.perf_counter() - t:.1f} s; "
          f"flash plan at Dq {dq}, Dv {dv}, bf16: {variant}", flush=True)
    check(variant == "wgmma_dv", f"MLA's flash plan is {variant}")

    # per block, bf16 at full depth, then float32 on layers 0-3
    with torch.no_grad():
        attention_blocks(FA, params, cfg, toks, torch.bfloat16)
        attention_blocks(FA, params, replace(cfg, compute_dtype="float32"),
                         toks, torch.float32, MLA_F32_LAYERS)

    # the scoring forward and the prefill on the kernel impl
    FA.reset_counts()
    with torch.no_grad():
        t = time.perf_counter()
        kern = lm.forward(params, kern_cfg, toks)
        torch.cuda.synchronize()
        kern_s = time.perf_counter() - t
        score = dict(FA.VARIANT_LAUNCHES, plain=FA.PLAIN_CALLS[
            "flash_attention"])
        t = time.perf_counter()
        plain = lm.forward(params, cfg, toks)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t
    want = dict({n: base.n_layers * (n == "wgmma_dv") for n in FA.VARIANTS},
                plain=0)
    check(score == want, f"scoring forward: launches {score}, want {want}")
    check(bool(torch.isfinite(kern).all()), "minicpm3 scoring logits finite")
    d = (kern.float() - plain.float())
    print(f"scoring forward B 1 S {MLA_S}: kernel impl {kern_s:.3f} s, "
          f"chunked {plain_s:.3f} s; launches {score}; logits kernel vs "
          f"chunked RMS {float(d.square().mean().sqrt()):.3e}, max "
          f"{float(d.abs().max()):.3e} (max |logit| "
          f"{float(plain.float().abs().max()):.3e})", flush=True)
    del kern, d

    # prefill (kernel impl), then absorbed decode steps
    prompt = MLA_S - MLA_GEN
    FA.reset_counts()
    with torch.no_grad():
        cache = model.init_cache(1, MLA_S, device=dev)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = lm.prefill(params, cfg, toks[:, :prompt], cache,
                               impl="flash_pallas")
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        pre = dict(FA.VARIANT_LAUNCHES, plain=FA.PLAIN_CALLS[
            "flash_attention"])
        outs, tok = [lg[:, -1]], lg[:, -1].argmax(-1)[:, None]
        gen_toks = [tok]
        t = time.perf_counter()
        for _ in range(MLA_GEN):
            lg, cache = model.decode_step(params, tok, cache)
            tok = lg[:, -1].argmax(-1)[:, None]
            outs.append(lg[:, -1])
            gen_toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
        check(dict(FA.VARIANT_LAUNCHES, plain=FA.PLAIN_CALLS[
            "flash_attention"]) == pre == want,
              f"prefill and decode: launches {pre} (decode must launch "
              f"nothing)")
        cache_b = sum(c[k].numel() * c[k].element_size() for c in cache
                      for k in ("c_kv", "k_rope"))
        expanded_b = (base.n_layers * MLA_S * a.n_heads * (dq + dv)
                      * cache[0]["c_kv"].element_size())
        del cache
        seq = torch.cat([toks[:, :prompt]] + gen_toks[:-1], dim=1)
        scored = lm.forward(params, cfg, seq)[0, prompt - 1:]
        params32 = copy.deepcopy(params).float()
        f32 = lm.forward(params32, replace(base, compute_dtype="float32"),
                         seq)[0, prompt - 1:]
        del params32
    parity = greedy_parity(torch.cat(outs), scored, f32)
    print(f"generation: prefill {prompt} tokens (flash_pallas) "
          f"{1e3 * prefill_s:.1f} ms, {MLA_GEN} absorbed decode steps "
          f"{1e3 * decode_s / MLA_GEN:.2f} ms/token; launches {pre}; {parity}"
          f"; compressed cache {cache_b / 2**20:.1f} MiB, an expanded "
          f"per-head k/v cache {expanded_b / 2**20:.1f} MiB "
          f"({expanded_b / cache_b:.1f}x); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del params, plain, scored, f32, outs
    gc.collect()
    torch.cuda.empty_cache()

    # training at 2 layers through train_loop: no kernel
    FA.reset_counts()
    t = time.perf_counter()
    _, metrics = train_loop(replace(base, n_layers=MLA_TRAIN_LAYERS),
                            steps=TRAIN_CHECK_STEPS, batch=MLA_TRAIN_B,
                            seq=MLA_TRAIN_S, print_fn=lambda *a: None,
                            device=dev)
    check_losses(f"{MLA_ARCH} full width, {MLA_TRAIN_LAYERS} layers, B "
                 f"{MLA_TRAIN_B} x S {MLA_TRAIN_S}", metrics,
                 time.perf_counter() - t)
    check(FA.LAUNCHES["flash_attention"] + FA.PLAIN_CALLS[
        "flash_attention"] == 0, "training launched flash attention")
    return score["wgmma_dv"] + pre["wgmma_dv"]


def whisper_phase(FA, dev) -> None:
    """14 (b): whisper-small at full width and depth."""
    from repro_torch.configs import get_config
    from repro_torch.convert import cast_params
    from repro_torch.launch.train import train_loop
    from repro_torch.models import encdec, get_model
    base = get_config(WHISPER_ARCH)
    cfg32 = replace(base, compute_dtype="float32")
    model = get_model(cfg32)
    FA.reset_counts()
    params = model.init_params(5, device=dev)
    params.requires_grad_(False)
    n = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(6)
    e = base.enc_dec
    frames = torch.randn((WHISPER_B, e.encoder_len, base.d_model),
                         generator=gen, device=dev)
    total = WHISPER_PROMPT + WHISPER_GEN
    toks = torch.randint(0, base.vocab_size, (WHISPER_B, total),
                         generator=gen, device=dev)
    with torch.no_grad():
        full = model.logits(params, {"tokens": toks, "frames": frames})
        cache = model.init_cache(WHISPER_B, total, device=dev)
        lg, cache = model.prefill(
            params, {"tokens": toks[:, :WHISPER_PROMPT], "frames": frames},
            cache)
        steps = [lg[:, 0]]
        for i in range(WHISPER_PROMPT, total):
            lg, cache = model.decode_step(params, toks[:, i:i + 1], cache)
            steps.append(lg[:, 0])
    got = torch.stack(steps, dim=1)
    err, bad = within(got, full[:, WHISPER_PROMPT - 1:], LOGITS_TOL)
    print(f"{WHISPER_ARCH} at full width and depth: {e.n_encoder_layers} + "
          f"{base.n_layers} layers, d {base.d_model}, {e.encoder_len} frames,"
          f" {n / 1e6:.1f} M parameters; float32, B {WHISPER_B}: "
          f"Model.logits over {total} tokens against prefill "
          f"({WHISPER_PROMPT}) + {WHISPER_GEN} teacher-forced decode "
          f"steps, max |diff| {err:.3e}, {bad} outside atol/rtol "
          f"{LOGITS_TOL}", flush=True)
    check(bad == 0 and bool(torch.isfinite(full).all()),
          f"whisper decode vs logits: {bad} outside {LOGITS_TOL}")
    del full, cache, got, steps

    # bf16 serving times
    cast_params(params, torch.bfloat16)
    model = get_model(base)
    with torch.no_grad():
        enc_ms = cuda_ms(lambda: encdec.encode(params, base, frames), 5)
        torch.cuda.synchronize()
        t = time.perf_counter()
        cache = model.init_cache(WHISPER_B, total, device=dev)
        lg, cache = model.prefill(
            params, {"tokens": toks[:, :WHISPER_PROMPT], "frames": frames},
            cache)
        tok = lg[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t
        t = time.perf_counter()
        for _ in range(WHISPER_GEN):
            lg, cache = model.decode_step(params, tok, cache)
            tok = lg[:, -1].argmax(-1)[:, None]
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t
    check(bool(torch.isfinite(lg).all()), "whisper bf16 logits finite")
    print(f"{WHISPER_ARCH} bf16, B {WHISPER_B}: encode {enc_ms:.2f} ms (CUDA "
          f"events), prefill (encode + {WHISPER_PROMPT} tokens) "
          f"{1e3 * prefill_s:.1f} ms, {WHISPER_GEN} decode steps "
          f"{1e3 * decode_s / WHISPER_GEN:.2f} ms/token", flush=True)
    del params, cache
    gc.collect()
    torch.cuda.empty_cache()
    t = time.perf_counter()
    _, metrics = train_loop(base, steps=TRAIN_CHECK_STEPS,
                            batch=WHISPER_TRAIN_B, seq=WHISPER_TRAIN_S,
                            print_fn=lambda *a: None, device=dev)
    check_losses(f"{WHISPER_ARCH} full width and depth, B {WHISPER_TRAIN_B} "
                 f"x S {WHISPER_TRAIN_S}", metrics, time.perf_counter() - t)
    check(FA.LAUNCHES["flash_attention"] + FA.PLAIN_CALLS[
        "flash_attention"] == 0, "the whisper path ran flash attention")


def sdpa_attempt(fn):
    """``fn()``, or the reason PyTorch's attention refused: the warnings
    it gave (each backend says why it declined), else the error."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            return fn()
        except RuntimeError as e:
            why = [str(w.message).split(" (Triggered")[0] for w in caught]
            return "refused: " + ("; ".join(why) or str(e).splitlines()[0])


def exp_floor(q, k, causal: bool, window: int = 0) -> float:
    """Least ms of the softmax's exponentials on these inputs: one per
    score the mask leaves (``mask_pairs``), at the special-function units'
    rate."""
    bh, s = q.shape[:2]
    exps = bh * mask_pairs(s, k.shape[1], causal, window)
    return exps / EXP_PER_S * 1e3


def mla_flash_timing(FA, dev) -> dict:
    """14 (c): B2 at MLA's prefill shape (40 heads, S ``MLA_S``, Dq 96,
    Dv 64), bf16, causal, on the ``wgmma_dv`` instance (``b2_at_shape``),
    with what ``-Xptxas -v`` said of it."""
    from repro_torch.configs import get_config
    a = get_config(MLA_ARCH).attention
    dq, dv = a.qk_nope_head_dim + a.qk_rope_head_dim, a.v_head_dim
    print(instance_build_line(FA, dq, dv), flush=True)
    return b2_at_shape(FA, dev, "at MLA's prefill shape", 1, a.n_heads,
                       a.n_heads, MLA_S, dq, dv, 0, 7)


def leaf_items(tree, prefix=()):
    """(path, tensor) over nested dicts, lists and tuples."""
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for key, val in items:
        if isinstance(val, (dict, list, tuple)):
            yield from leaf_items(val, prefix + (key,))
        else:
            yield prefix + (key,), val


def rss_bytes() -> int:
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * 4096


def dry_run_phase() -> None:
    """14 (d): ``abstract_train_state`` of every arch on the meta device:
    parameter counts (less the leaves ``n_params`` leaves out, equal to
    ``cfg.n_params()``), training-state bytes, and no memory taken."""
    from repro_torch.configs import all_arch_ids, get_config
    from repro_torch.launch.steps import abstract_train_state
    torch.cuda.synchronize()
    cuda0, rss0 = torch.cuda.memory_allocated(), rss_bytes()
    t = time.perf_counter()
    lines = []
    for arch in all_arch_ids():
        cfg = get_config(arch)
        params, opt = abstract_train_state(cfg)
        leaves = list(leaf_items(params))
        state = [x for _, x in leaves] + [x for _, x in leaf_items(opt)]
        check(all(x.is_meta for x in state), f"{arch}: a leaf not on meta")
        n = sum(x.numel() for _, x in leaves)
        extra = sum(x.numel() for path, x in leaves
                    if path[-1] in UNCOUNTED_LEAVES)
        check(n - extra == cfg.n_params(),
              f"{arch}: {n} parameters, {extra} uncounted, n_params "
              f"{cfg.n_params()}")
        nbytes = sum(x.numel() * x.element_size() for x in state)
        lines.append(f"{arch} {n / 1e9:.3f} G ({n - extra} = n_params, + "
                     f"{extra}) {nbytes / 2**30:.1f} GiB")
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    grew = (torch.cuda.memory_allocated() - cuda0, rss_bytes() - rss0)
    print(f"dry run, abstract_train_state of {len(lines)} archs on meta in "
          f"{secs:.2f} s (parameters; training state: parameters + AdamW "
          f"m, v): {'; '.join(lines)}; CUDA memory grew {grew[0]} B, host "
          f"resident memory {grew[1] / 2**20:.1f} MiB", flush=True)
    check(grew[0] == 0 and grew[1] < 256 * 2**20,
          f"the dry run allocated: CUDA {grew[0]} B, host {grew[1]} B")


def mla_phase(modules, dev) -> tuple:
    """Phase 14: (a) minicpm3-4b, (b) whisper-small, (c) B2 at MLA's shape,
    (d) the dry run.  Returns (B2's ``wgmma_dv`` row, from its timing at
    MLA's shape, and its launches on the minicpm3 path); the counters are
    zeroed before each path and read after it."""
    FA = modules[1]
    for mod in modules:
        mod.reset_counts()
    lap = lap_clock()
    launches = minicpm3_phase(FA, dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("(a) minicpm3-4b")
    whisper_phase(FA, dev)
    gc.collect()
    torch.cuda.empty_cache()
    lap("(b) whisper-small")
    case = mla_flash_timing(FA, dev)
    torch.cuda.empty_cache()
    lap("(c) B2 at MLA's shape")
    dry_run_phase()
    lap("(d) the dry run")
    others = {f"{kind}{k}": v for mod in modules if mod is not FA
              for kind, d in (("", mod.LAUNCHES), ("plain ", mod.PLAIN_CALLS))
              for k, v in d.items()}
    check(sum(others.values()) == 0, f"other kernels ran in phase 14: "
                                     f"{others}")
    return case, launches


# ---------------------------------------------------------------------------
# phase 15: distributed launch -- the sharded step on a (1, 1) mesh, caches
# on the mesh, the dry run of the production meshes
# ---------------------------------------------------------------------------


def open_nccl_group(dev) -> None:
    """The process's default group: NCCL, world size 1, on a free local
    port."""
    import socket
    import torch.distributed as dist
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    torch.cuda.set_device(torch.cuda.current_device() if dev.index is None
                          else dev.index)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)


def value(t) -> float:
    """A 0-d tensor (a DTensor's whole value) as a float."""
    from repro_torch import pspec
    return float(t.full_tensor() if pspec.is_dtensor(t) else t)


def analytic_train_flops(cfg, b: int, s: int) -> dict:
    """The matmul FLOPs of one training step of a dense GQA LM with tied
    embeddings (olmo-1b), term by term: 6·N·T over every weight product
    (the tied unembedding included); the remat forward of every layer
    product but each checkpointed group's last (``w_down`` of its last
    layer: torch's non-reentrant checkpoint stops recomputing once the
    saved tensors it needs are back); the chunked attention over all of
    its chunk pairs (A13's skip of masked chunks is not done), q kᵀ and p
    v, forward twice (remat) and backward (twice a forward)."""
    from repro_torch.models import lm
    a, t = cfg.attention, b * s
    d, f = cfg.d_model, cfg.d_ff
    layer = d * a.n_heads * a.head_dim * 2 + d * a.n_kv_heads * \
        a.head_dim * 2 + 3 * d * f
    groups = cfg.n_layers // (max(1, cfg.remat_group)
                              * lm.pattern_period(cfg))
    terms = {
        "6NT": 6.0 * t * (cfg.n_layers * layer + cfg.vocab_size * d),
        "remat": 2.0 * t * (cfg.n_layers * layer - groups * f * d),
        "attention": 16.0 * cfg.n_layers * b * a.n_heads * a.head_dim
        * s * s,
    }
    terms["total"] = sum(terms.values())
    return terms


def sharded_train(dev, mesh) -> None:
    """15 (a): olmo-1b at full width and depth (phase 13's model, bf16
    compute, remat, B 4 x S 4096): ``SHARD_STEPS`` steps of
    ``make_train_step`` with parameters, AdamW state and batches as
    DTensors on the (1, 1) mesh, placed by ``param_specs`` and
    ``input_specs_sharding``, under ``pspec.activation_mesh``; the same
    steps on plain tensors from the same parameters and batches; one more
    sharded step counted by ``StepCounter``."""
    import copy
    from repro_torch import pspec
    from repro_torch.configs import get_config
    from repro_torch.launch.roofline import StepCounter, roofline_terms
    from repro_torch.launch.sharding import (distribute, distribute_params,
                                             input_specs_sharding)
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init
    cfg = get_config(TRAIN_ARCH)
    t = time.perf_counter()
    params, _ = init_train_state(cfg, torch.Generator().manual_seed(0), dev)
    sharded = distribute_params(copy.deepcopy(params), mesh)
    setup_s = time.perf_counter() - t
    batches = [fixed_batch(cfg, TRAIN_B, TRAIN_S, dev, seed=i)
               for i in range(SHARD_STEPS + 1)]
    step = make_train_step(cfg, AdamWConfig(lr=TRAIN_LR))
    runs = {}
    for path, model in (("plain", params), ("sharded", sharded)):
        state = adamw_init({n: p for n, p in model.named_parameters()
                            if p.requires_grad})
        feeds = batches
        if path == "sharded":
            placed = input_specs_sharding(mesh, batches[0])
            feeds = [{k: distribute(v, mesh, placed[k])
                      for k, v in bt.items()} for bt in batches]
        ctx = pspec.activation_mesh(mesh) if path == "sharded" else \
            contextlib.nullcontext()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        losses, norms, secs = [], [], []
        with ctx:
            for bt in feeds[:SHARD_STEPS]:
                torch.cuda.synchronize()
                t = time.perf_counter()
                _, state, m = step(model, state, bt)
                losses.append(value(m["loss"]))
                norms.append(value(m["grad_norm"]))
                secs.append(time.perf_counter() - t)
            peak = torch.cuda.max_memory_allocated()
            if path == "sharded":
                counter = StepCounter(device=dev.type)
                with counter:
                    step(model, state, feeds[SHARD_STEPS])
                torch.cuda.synchronize()
        runs[path] = (losses, norms, secs, peak)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    (pl, pn, ps, ppk), (sl, sn, ss, spk) = runs["plain"], runs["sharded"]
    check(all(map(math.isfinite, pl + pn + sl + sn)),
          f"losses {pl} {sl}, grad norms {pn} {sn}")
    for a, b in zip(pl + pn, sl + sn):
        check(abs(a - b) <= SHARD_RTOL * abs(a),
              f"sharded {b} vs plain {a} beyond rtol {SHARD_RTOL}")
    placements = sorted({str(tuple(p.placements))
                         for p in sharded.parameters()})
    print(f"{TRAIN_ARCH} at full width and depth on the (1, 1) NCCL mesh "
          f"(placements {placements}), B = {TRAIN_B}, S = {TRAIN_S}, bf16, "
          f"remat; set-up {setup_s:.1f} s; {SHARD_STEPS} steps: losses "
          f"plain {fmt(pl)} sharded {fmt(sl)}, grad norms plain {fmt(pn)} "
          f"sharded {fmt(sn)}; bit-equal {pl == sl and pn == sn}; s per step "
          f"plain {fmt(ps)} sharded {fmt(ss)} (DTensor's host cost "
          f"{float(np.median(ss)) - float(np.median(ps)):+.3f} s a step, "
          f"medians); peak device memory plain {ppk / 2**30:.2f} GiB, "
          f"sharded {spk / 2**30:.2f} GiB", flush=True)
    # the training attention runs in the flash kernels (ctypes launches),
    # which the counter, a dispatch mode over aten ops, does not see
    want = analytic_train_flops(cfg, TRAIN_B, TRAIN_S)
    want["counted"] = want["total"] - want["attention"]
    rel = (counter.flops - want["counted"]) / want["counted"]
    print(f"counted step (StepCounter, rank 0's shards): "
          f"{counter.flops:.6e} FLOP ({counter.flops_by_op}), bytes "
          f"{counter.bytes:.4e} (eager, no fusion), collectives "
          f"{counter.collective_counts} ({counter.collective_bytes:.4e} B); "
          f"analytic {want['counted']:.6e} = 6NT {want['6NT']:.6e} + remat "
          f"forward {want['remat']:.6e} (the chunked attention's "
          f"{want['attention']:.6e} runs in the training flash kernels, "
          f"outside the counter): counted/analytic - 1 = {rel:+.3e}",
          flush=True)
    check(abs(rel) <= FLOP_TOL, f"counted FLOPs {counter.flops} vs analytic "
                                f"{want['counted']}: {rel:+.3e}")
    terms = roofline_terms(counter.flops, counter.bytes,
                           counter.collective_bytes)
    largest = max(terms, key=terms.get)
    step_s = float(np.median(ss))
    print(f"roofline of the sharded step on HW_H100: "
          + ", ".join(f"{k} {v:.4f}" for k, v in terms.items())
          + f"; measured {step_s:.3f} s = {step_s / terms[largest]:.2f} x "
          f"the largest term ({largest})", flush=True)
    del params, sharded
    gc.collect()
    torch.cuda.empty_cache()


def sharded_cache(dev, mesh) -> None:
    """15 (b): minicpm3-4b at full width and depth in bf16, B 1: a prefill
    of ``CACHE_PROMPT`` tokens and ``CACHE_GEN`` absorbed decode steps
    through ``make_prefill_step``/``make_decode_step``, on plain tensors
    and on the (1, 1) mesh (parameters by ``param_specs``, the cache by
    ``cache_specs``)."""
    import copy
    from repro_torch import pspec
    from repro_torch.configs import get_config
    from repro_torch.launch.sharding import (cache_specs, distribute,
                                             distribute_params)
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import get_model
    from repro_torch.models.config import ShapeConfig
    cfg = replace(get_config(CACHE_ARCH), param_dtype="bfloat16")
    model = get_model(cfg)
    params = model.init_params(3, device=dev)
    params.requires_grad_(False)
    sharded = distribute_params(copy.deepcopy(params), mesh)
    gen = torch.Generator(device=dev).manual_seed(5)
    toks = torch.randint(0, cfg.vocab_size, (1, CACHE_PROMPT), generator=gen,
                         device=dev)
    max_len = CACHE_PROMPT + CACHE_GEN
    shape = ShapeConfig("phase15", max_len, 1, "decode")
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    runs = {}
    for path, p in (("plain", params), ("sharded", sharded)):
        cache = model.init_cache(1, max_len, device=dev)
        tk = toks
        if path == "sharded":
            specs = cache_specs(mesh, cfg, cache, shape)
            cache = [{k: distribute(v, mesh, specs[i][k])
                      if isinstance(v, torch.Tensor) else v
                      for k, v in c.items()} for i, c in enumerate(cache)]
        ctx = pspec.activation_mesh(mesh) if path == "sharded" else \
            contextlib.nullcontext()
        with ctx:
            torch.cuda.synchronize()
            t = time.perf_counter()
            lg, cache = prefill(p, cache, {"tokens": tk})
            torch.cuda.synchronize()
            pre_s = time.perf_counter() - t
            logits, tokens, secs = [lg], [], []
            for _ in range(CACHE_GEN):
                nxt = lg.argmax(-1)
                nxt = nxt.full_tensor() if pspec.is_dtensor(nxt) else nxt
                tokens.append(int(nxt[0, 0]))
                torch.cuda.synchronize()
                t = time.perf_counter()
                lg, cache = decode(p, cache, nxt)
                torch.cuda.synchronize()
                secs.append(time.perf_counter() - t)
                logits.append(lg)
        full = [x.full_tensor() if pspec.is_dtensor(x) else x
                for x in logits]
        runs[path] = (torch.cat(full, 1).float(), tokens, pre_s, secs)
        del cache
    (pl, pt, pp, ps), (sl, st, sp, ss) = runs["plain"], runs["sharded"]
    check(bool(torch.isfinite(sl).all()), "sharded logits finite")
    check(st == pt, f"greedy tokens: sharded {st} vs plain {pt}")
    rel = float(((sl - pl).abs() / pl.abs().clamp_min(1e-30)).max())
    ok = bool(torch.allclose(sl, pl, rtol=CACHE_RTOL, atol=0.0))
    print(f"{CACHE_ARCH} at full width and depth ({cfg.n_layers} layers), "
          f"bf16, B 1: prefill of {CACHE_PROMPT} tokens + {CACHE_GEN} "
          f"absorbed decode steps, the cache placed by cache_specs on the "
          f"(1, 1) mesh: greedy tokens equal {st == pt} ({st}); logits "
          f"bit-equal {bool(torch.equal(sl, pl))}, max relative difference "
          f"{rel:.3e} (rtol {CACHE_RTOL}); prefill plain {pp * 1e3:.1f} ms, "
          f"sharded {sp * 1e3:.1f} ms; decode plain "
          f"{float(np.median(ps)) * 1e3:.2f} ms/token, sharded "
          f"{float(np.median(ss)) * 1e3:.2f} ms/token (medians)", flush=True)
    check(ok, f"sharded logits beyond rtol {CACHE_RTOL} of the plain ones")
    del params, sharded
    gc.collect()
    torch.cuda.empty_cache()


def dry_run_cells(out_dir: Path) -> None:
    """15 (c): the dry run of the production meshes, one ``python -m
    repro_torch.launch.dryrun`` process per cell, all started together;
    every cell must succeed, and the card's memory must not grow."""
    from repro_torch.launch import roofline_report
    shutil.rmtree(out_dir, ignore_errors=True)
    torch.cuda.synchronize()
    used0 = torch.cuda.mem_get_info()
    alloc0 = torch.cuda.memory_allocated()
    # the fake process group needs no card: hide it from the processes
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    procs = []
    t = time.perf_counter()
    for arch, shape, mesh, layers in DRY_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--mesh", mesh, "--out",
               str(out_dir), "--force"]
        if layers:
            cmd += ["--layers", str(layers)]
        procs.append((cmd, subprocess.Popen(
            cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    try:
        outs = [proc.communicate(timeout=DRY_TIMEOUT)[0] for _, proc in procs]
    finally:
        for _, proc in procs:
            proc.kill()
    for (cmd, proc), out in zip(procs, outs):
        lines = [ln for ln in out.splitlines() if ln.startswith(("[", "="))]
        print("\n".join(f"  {ln}" for ln in lines), flush=True)
        check(proc.returncode == 0, f"{' '.join(cmd[2:])} exited "
                                    f"{proc.returncode}: {out[-3000:]}")
    secs = time.perf_counter() - t
    torch.cuda.synchronize()
    used1 = torch.cuda.mem_get_info()
    grew = (used0[0] - used1[0], torch.cuda.memory_allocated() - alloc0)
    for p in sorted(out_dir.glob("*.json")):
        rec = json.loads(p.read_text())
        check("memory" in rec, f"{p.name}: {rec.get('error', rec)}")
        cell = roofline_report.analyze(rec)
        colls = {k: (v["count"], f"{v['bytes']:.3e}")
                 for k, v in rec["collective_bytes"].items() if v["count"]}
        cut = f" ({rec['cut']})" if rec.get("cut") else ""
        if rec.get("stand_in"):
            cut += f" [stand-in: {rec['stand_in']}]"
        print(f"  {rec['arch']} {rec['shape']} {rec['mesh']}{cut}: "
              f"{rec['run_s']} s, {rec['flops_per_device']:.4e} FLOP/dev, "
              f"{rec['bytes_per_device']:.4e} B/dev (eager), argument bytes "
              f"{rec['memory']['argument_bytes']:.4e}, peak "
              f"{rec['memory']['peak_bytes']:.4e}; collectives (count, B) "
              f"{colls}", flush=True)
        print("  " + roofline_report.table([cell]).splitlines()[-1],
              flush=True)
    print(f"dry run: {len(DRY_CELLS)} processes in {secs:.1f} s; the "
          f"card's free memory fell {grew[0]} B, allocated grew {grew[1]} B",
          flush=True)
    check(grew[0] <= 0 and grew[1] == 0,
          f"the dry run took card memory: {grew}")


def sharded_phase(modules, dev) -> None:
    """Phase 15: (a) the sharded olmo-1b step and (b) minicpm3-4b's caches
    on a (1, 1) NCCL mesh, (c) the dry run of the production meshes; the
    kernels' counters zeroed before and read after (the step builders take
    the chunked impls: only the training attention kernels run, on
    olmo-1b's layers)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import layers as L
    for mod in modules:
        mod.reset_counts()
    L.CHUNKED_CUDA_CALLS = 0
    lap = lap_clock()
    open_nccl_group(dev)
    try:
        mesh = make_local_mesh(1, 1)
        sharded_train(dev, mesh)
        lap("(a) the sharded olmo-1b step")
        sharded_cache(dev, mesh)
        lap("(b) minicpm3-4b's caches on the mesh")
    finally:
        dist.destroy_process_group()
    dry_run_cells(Path(__file__).resolve().parent / "build" /
                  "dryrun_phase15")
    lap("(c) the dry run")
    check_only_training_attention(modules, "phase 15")


# ---------------------------------------------------------------------------
# phase 16: h2o-danube3-4b and phi3-vision-4b -- B2's instances at (120,
# 120) and (96, 96) on a served path at full width and depth
# ---------------------------------------------------------------------------


def sdpa_backend(q4, k4, v4, **kw) -> str:
    """The backend PyTorch's default dispatch of
    ``scaled_dot_product_attention`` picks for these inputs, or why it
    cannot say."""
    from torch.nn.attention import SDPBackend
    try:
        return SDPBackend(torch._fused_sdp_choice(q4, k4, v4, **kw)).name
    except (AttributeError, RuntimeError, TypeError, ValueError) as e:
        return f"not known ({type(e).__name__})"


def sdpa_call(q, k, v, b: int, window: int):
    """``scaled_dot_product_attention`` on (B, H, S, D) views of the
    kernel's (B * H, S, D) inputs, causal, GQA by ``enable_gqa``, the
    window as an explicit boolean mask: (the call, its keyword
    arguments)."""
    import torch.nn.functional as F
    s = q.shape[1]
    q4, k4, v4 = (t.view(b, t.shape[0] // b, s, t.shape[2])
                  for t in (q, k, v))
    kw = dict(enable_gqa=True) if k.shape[0] != q.shape[0] else {}
    if window:
        i = torch.arange(s, device=q.device)
        kw["attn_mask"] = (i[None] <= i[:, None]) & (i[None] > i[:, None]
                                                     - window)
    else:
        kw["is_causal"] = True
    return (lambda: F.scaled_dot_product_attention(q4, k4, v4, **kw)), (
        (q4, k4, v4), kw)


def b2_at_shape(FA, dev, label: str, b: int, h: int, kv: int, s: int,
                dq: int, dv: int, window: int, seed: int) -> dict:
    """B2 alone at one layer's shape, bf16, causal (and ``window``): the
    wgmma instance ``FA.plan`` picks (held within ``FA.bf16_error_bound``
    of the plain version, one launch of it), the ``cuda_core`` kernel it
    replaced there (private launcher, held the same way), the plain
    version and ``scaled_dot_product_attention`` (``sdpa_call``) by
    default dispatch (the backend it took named) and each backend alone
    or why it refused; CUDA events and device time (CUDA-graph replay),
    beside the FLOP bound and the exponentials' floor of the pairs the
    mask leaves."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    variant = FA.WGMMA_INSTANCES[(dq, dv)]
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(shape, generator=gen, device=dev).to(
        torch.bfloat16) for shape in ((b * h, s, dq), (b * kv, s, dq),
                                      (b * kv, s, dv)))
    want = FA.flash_attention_torch(q, k, v, causal=True, window=window)
    bnd = FA.bf16_error_bound(q, k, v, causal=True, window=window)

    def held(out, what):
        diff = (out.float() - want.float()).abs()
        worst = float((diff / bnd).max())
        check(worst <= 1.0, f"B2 {label}, {what}: {worst} of the bf16 bound")
        return float(diff.max()), worst

    before = dict(FA.VARIANT_LAUNCHES)
    kernel = lambda: FA.flash_attention(  # noqa: E731
        q, k, v, causal=True, window=window)
    err, worst = held(kernel(), variant)
    ran = {n: FA.VARIANT_LAUNCHES[n] - before[n] for n in FA.VARIANTS}
    check(ran == {n: int(n == variant) for n in FA.VARIANTS},
          f"B2 {label} ran {ran}, not {variant} once")
    old = lambda: FA._launch(q, k, v, True, window, None,  # noqa: E731
                             "cuda_core")
    _, old_worst = held(old(), "cuda_core")
    del want, bnd
    plain = lambda: FA.flash_attention_torch(  # noqa: E731
        q, k, v, causal=True, window=window)
    ms, dev_ms = cuda_ms(kernel, 20), graph_ms([kernel], 20)
    old_ms, old_dev_ms = cuda_ms(old, 3), graph_ms([old], 3)
    ms2 = cuda_ms(kernel, 20)
    plain_ms = cuda_ms(plain, 2)
    sdpa, (views, kw) = sdpa_call(q, k, v, b, window)
    backends = {}
    for name in ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH"):
        if not hasattr(SDPBackend, name):
            backends[name] = "not in this PyTorch"
            continue
        with sdpa_kernel([getattr(SDPBackend, name)]):
            backends[name] = sdpa_attempt(
                lambda: f"{cuda_ms(sdpa, 3 if name == 'MATH' else 10):.4f} "
                        f"ms")
    lib_ms = lib_dev_ms = None
    chosen = sdpa_backend(*views, **kw)
    def default_dispatch() -> None:
        sdpa()

    refusal = sdpa_attempt(default_dispatch)
    if refusal is None:
        lib_ms, lib_dev_ms = cuda_ms(sdpa, 10), graph_ms([sdpa], 10)
    else:
        backends["default"] = refusal
    bms, by = flash_bound(q, k, v, causal=True, window=window)
    floor = exp_floor(q, k, causal=True, window=window)
    lib_txt = ("refused" if lib_ms is None else
               f"{lib_ms:.4f} ms (device {lib_dev_ms:.4f}; {chosen}; kernel "
               f"/ SDPA {ms / lib_ms:.2f})")
    print(f"flash_attention {label} (B {b} x {h} heads over {kv} KV heads, S "
          f"{s}, Dq {dq}, Dv {dv}, bf16, causal, window {window}) "
          f"[{variant}]: kernel {ms:.4f} ms, again {ms2:.4f} (device "
          f"{dev_ms:.4f}; {100 * bms / ms:.1f}% of bound {bms:.4f} ms, {by}, "
          f"{mask_pairs(s, s, True, window)} pairs a head; exponentials' "
          f"floor {floor:.4f} ms); cuda_core kernel {old_ms:.4f} ms (device "
          f"{old_dev_ms:.4f}; {old_ms / ms:.2f}x the {variant} kernel's "
          f"time; {old_worst:.3f} of the bf16 bound); plain {plain_ms:.3f} "
          f"ms; scaled_dot_product_attention default {lib_txt}; by backend "
          f"{backends}; max |kernel - plain| {err:.3e} ({worst:.3f} of the "
          f"bf16 bound)", flush=True)
    return dict(label=label, shape=[b * h, s, dq, dv, b * kv, window],
                variant=variant, ms=ms, device_ms=dev_ms,
                old_kernel_ms=old_ms, old_kernel_device_ms=old_dev_ms,
                plain_ms=plain_ms, library_ms=lib_ms,
                library_device_ms=lib_dev_ms, sdpa_backends=backends,
                sdpa_default_backend=chosen, bound_ms=bms, bound_by=by,
                exp_floor_ms=floor, max_abs_err=err, err_over_bound=worst,
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:32")


def instance_build_line(FA, dq: int, dv: int) -> str:
    """What ``-Xptxas -v`` said of the wgmma instance at (dq, dv), with
    its shared memory and ring depth."""
    from repro_torch.kernels import _build
    log = _build.library_path(FA.SOURCE).with_suffix(".log").read_text()
    lib = _build.load(FA.SOURCE, FA._bind)
    variant = FA.WGMMA_INSTANCES[(dq, dv)]
    mangled = f"flash_attention_wgmma_kernelILi{dq}ELi{dv}ELb0E"
    return (f"{mangled}, nvcc -Xptxas -v: {ptxas_summary(log, mangled)}; "
            f"dynamic shared memory "
            f"{getattr(lib, f'flash_attention_{variant}_smem_bytes')()} B, "
            f"{getattr(lib, f'flash_attention_{variant}_stages')()} k/v "
            f"stages")


def scoring_chunk(total: int) -> int:
    """The chunked attention's chunk for a scoring pass over ``total``
    positions: the fewest chunks of at most ~1024 keys that divide it."""
    n = -(-total // 1024)
    while total % n:
        n += 1
    return total // n


@torch.no_grad()
def served_arch(FA, dev, arch: str, b: int, s_text: int, seed: int) -> tuple:
    """16 (a) or (b): one arch at full width and depth, bf16 weights drawn
    on the card from ``seed``, B ``b`` x ``s_text`` tokens (and the
    config's patch positions before them, random embeddings): each
    attention block on its wgmma instance against ``chunked`` on the same
    input (``attention_blocks``); the scoring forward on the kernel impl
    launching the instance once a layer and nothing else, its logits as
    near the float32 logits as the chunked impl's (``BF16_PARITY``); a
    prefill of the scoring shape (kernel impl, the same launches) and
    ``NEW_GEN`` greedy decode steps over the cache (a ring of the window
    where the config has one; no launch), the tokens against a chunked
    bf16 scoring pass over the same sequence (``greedy_parity``); one
    scoring forward under ``torch.profiler`` (device time by kernel).
    Returns (the instance, its launches on the path: scoring + prefill)."""
    import copy
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.models import lm
    rms = lambda t: float(t.float().square().mean().sqrt())  # noqa: E731
    base = get_config(arch)
    a = base.attention
    cfg = replace(base, param_dtype="bfloat16")
    kern_cfg = replace(cfg, attention_impl="flash_pallas")
    cfg32 = replace(base, compute_dtype="float32")
    model = get_model(cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    params = model.init_params(seed, device=dev)
    params.requires_grad_(False)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in params.parameters())
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    toks = torch.randint(0, base.vocab_size, (b, s_text), generator=gen,
                         device=dev)
    patches = (torch.randn((b, base.n_patches, base.d_model), generator=gen,
                           device=dev) if base.n_patches else None)
    s = s_text + base.n_patches
    variant = FA.plan(a.head_dim, a.head_dim, torch.bfloat16, True)
    print(f"{arch} at full width and depth: {base.n_layers} layers, d "
          f"{base.d_model}, {a.n_heads} heads over {a.n_kv_heads} KV heads, "
          f"head dim {a.head_dim}, window {a.window}, {base.n_patches} patch "
          f"positions, {n / 1e9:.3f} G parameters, bf16, from seed {seed} on "
          f"the card in {time.perf_counter() - t:.1f} s; B {b} x S {s}; "
          f"flash plan: {variant}", flush=True)
    check(variant != "cuda_core", f"{arch}'s flash plan is {variant}")
    attention_blocks(FA, params, cfg, toks, torch.bfloat16, patches=patches)

    want = dict({v: base.n_layers * (v == variant) for v in FA.VARIANTS},
                plain=0)
    counts = lambda: dict(FA.VARIANT_LAUNCHES,  # noqa: E731
                          plain=FA.PLAIN_CALLS["flash_attention"])
    secs = []
    for _ in range(2):         # the first pass warms up
        FA.reset_counts()
        t = time.perf_counter()
        kern = lm.forward(params, kern_cfg, toks, patches)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t)
        score = counts()
        check(score == want, f"{arch} scoring: launches {score}, want {want}")
    profile_call(lambda: lm.forward(params, kern_cfg, toks, patches),
                 f"{arch} scoring forward", cpu=False,
                 watch=("flash_attention_wgmma", CUBLAS_NAMES))
    t = time.perf_counter()
    plain = lm.forward(params, cfg, toks, patches)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t
    params32 = copy.deepcopy(params).float()
    f32 = lm.forward(params32, cfg32, toks, patches).float()
    check(bool(torch.isfinite(kern).all()) and kern.shape == (
        b, s, base.vocab_size), f"{arch} scoring logits {kern.shape}")
    err_k, err_p = rms(kern.float() - f32), rms(plain.float() - f32)
    print(f"{arch} scoring B {b} x S {s}: kernel impl {secs[-1]:.3f} s "
          f"({b * s / secs[-1]:.0f} tokens/s; first pass {secs[0]:.3f} s), "
          f"chunked {plain_s:.3f} s; launches {score}; RMS distance from "
          f"the float32 logits: kernel impl {err_k:.4e}, chunked "
          f"{err_p:.4e} (ratio {err_k / err_p:.4f}, limit {BF16_PARITY})",
          flush=True)
    check(err_k <= BF16_PARITY * err_p,
          f"{arch} bf16 kernel logits {err_k:.4e} from float32, more than "
          f"{BF16_PARITY} x the chunked impl's {err_p:.4e}")
    del kern, plain, f32

    FA.reset_counts()
    total = s + NEW_GEN
    cache = model.init_cache(b, total, device=dev)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, cache = lm.prefill(params, cfg, toks, cache, patches=patches,
                           impl="flash_pallas")
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    pre = counts()
    check(pre == want, f"{arch} prefill: launches {pre}, want {want}")
    outs, tok = [lg[:, -1]], lg[:, -1].argmax(-1)[:, None]
    gen_toks = [tok]
    t = time.perf_counter()
    for _ in range(NEW_GEN):
        lg, cache = model.decode_step(params, tok, cache)
        tok = lg[:, -1].argmax(-1)[:, None]
        outs.append(lg[:, -1])
        gen_toks.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t
    check(counts() == pre, f"{arch} decode launched: {counts()}")
    slots = cache[0]["k"].shape[1]
    del cache
    seq = torch.cat([toks] + gen_toks[:-1], dim=1)
    chunk = scoring_chunk(total)
    scored = lm.forward(params, cfg, seq, patches, chunk=chunk)[:, s - 1:]
    f32 = lm.forward(params32, cfg32, seq, patches, chunk=chunk)[:, s - 1:]
    parity = greedy_parity(torch.stack(outs, 1).flatten(0, 1),
                           scored.flatten(0, 1), f32.flatten(0, 1))
    print(f"{arch} generation: prefill B {b} x {s} (flash_pallas) "
          f"{1e3 * prefill_s:.1f} ms, {NEW_GEN} greedy decode steps over a "
          f"cache of {slots} slots {1e3 * decode_s / NEW_GEN:.2f} ms/token "
          f"({b * NEW_GEN / decode_s:.1f} tokens/s); launches {pre}; the "
          f"check's scoring pass over {total} positions in chunks of "
          f"{chunk}; {parity}; peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    del params, params32, scored, f32, outs
    return variant, score[variant] + pre[variant]


def new_dims_phase(modules, dev) -> tuple:
    """Phase 16: the pinned bits of the 128 / 128 and 96 / 64 instances;
    (a) h2o-danube3-4b and (b) phi3-vision-4b served at full width and
    depth (``served_arch``); (c) B2 alone at each arch's layer shape
    (``b2_at_shape``), h2o-danube3's also causal only at
    ``CAUSAL_ONLY_S``, where the window cuts nothing.  Returns ({row name:
    kernels-line row}, {row name: launches on the served paths}); the
    counters are zeroed before each path and read after it."""
    from repro_torch.configs import get_config
    FA = modules[1]
    for mod in modules:
        mod.reset_counts()
    lap = lap_clock()
    for variant, cases in PINNED_FLASH.items():
        for i, case in enumerate(cases):
            q, k, v = pinned_flash_inputs(case, dev)
            out = FA.flash_attention(q, k, v, causal=case[5],
                                     window=case[6])
            check(output_digest(out) == PINNED_DIGESTS[(variant, i)],
                  f"the {variant} instance's output on {case} is not the "
                  f"earlier source's")
    print(f"the wgmma (128 / 128) and wgmma_dv (96 / 64) instances give the "
          f"pinned bits on {sum(map(len, PINNED_FLASH.values()))} cases",
          flush=True)
    for d in (120, 96):
        print(instance_build_line(FA, d, d), flush=True)
    lap("pinned bits, build")
    launches = {}
    for part, (arch, b, s_text, seed) in zip("ab", NEW_ARCHS):
        FA.reset_counts()
        variant, n = served_arch(FA, dev, arch, b, s_text, seed)
        launches[f"flash_attention_{variant}"] = n
        gc.collect()
        torch.cuda.empty_cache()
        lap(f"({part}) {arch}")
    rows = {}
    for arch, b, s_text, seed in NEW_ARCHS:
        base = get_config(arch)
        a = base.attention
        s = s_text + base.n_patches
        case = b2_at_shape(FA, dev, f"at {arch}'s layer shape", b,
                           a.n_heads, a.n_kv_heads, s, a.head_dim,
                           a.head_dim, a.window, seed)
        cases = [case]
        if a.window:
            cases.append(b2_at_shape(
                FA, dev, f"at {arch}'s heads, causal only", b, a.n_heads,
                a.n_kv_heads, CAUSAL_ONLY_S, a.head_dim, a.head_dim, 0,
                seed))
        rows[f"flash_attention_{case['variant']}"] = dict(case, cases=cases)
        torch.cuda.empty_cache()
    lap("(c) B2 at the layer shapes")
    others = {f"{kind}{k}": v for mod in modules if mod is not FA
              for kind, d in (("", mod.LAUNCHES), ("plain ", mod.PLAIN_CALLS))
              for k, v in d.items()}
    check(sum(others.values()) == 0, f"other kernels ran in phase 16: "
                                     f"{others}")
    return rows, launches


# what a kernel's row may carry beside the contract's keys (the chosen
# kernel of the GEMM, flash attention and the scan, the scan's plan, device
# times, the mma.sync kernels', the cuda_core kernel's (at MLA's heads) and
# the first scan kernel's (``pr12``) times, every case; the closure's full
# mode and dense bound, and the time of the general-kernel path each of the
# blocked engine's entries replaced; the exponentials' floor and SDPA by
# backend)
EXTRA_KEYS = ("variant", "plan", "launch_ms", "device_ms",
              "library_device_ms", "old_kernel_ms", "old_kernel_device_ms",
              "pr12_ms", "pr12_device_ms", "cases", "full_mode_ms",
              "dense_bound_ms", "old_path_ms", "exp_floor_ms",
              "sdpa_backends", "sdpa_default_backend", "backward")


def main() -> int:
    start = time.perf_counter()
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
    phase_done("11 (serve)")

    # -- 12. the gradient search over it -------------------------------------
    grad_phase(ex, (K, FA, SS, SG), dev)
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("12 (gradient search)")

    # -- 13. training on the card --------------------------------------------
    train_rows = train_phase((K, FA, SS, SG), dev)
    rows.update(train_rows)
    launches.update({name: row.pop("path_launches")
                     for name, row in train_rows.items()})
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("13 (training)")

    # -- 14. MLA, whisper, the dry run ---------------------------------------
    # B2's wgmma_dv instance is a row of its own: its launches are the
    # minicpm3-4b path's, flash_attention's (wgmma) jamba's
    row, launches["flash_attention_wgmma_dv"] = mla_phase((K, FA, SS, SG),
                                                          dev)
    rows["flash_attention_wgmma_dv"] = row
    phase_done("14 (MLA, whisper, the dry run)")

    # -- 15. distributed launch ----------------------------------------------
    sharded_phase((K, FA, SS, SG), dev)
    phase_done("15 (distributed launch)")

    # -- 16. h2o-danube3-4b and phi3-vision-4b: B2 at (120, 120), (96, 96) --
    new_rows, new_launches = new_dims_phase((K, FA, SS, SG), dev)
    rows.update(new_rows)
    launches.update(new_launches)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("16 (h2o-danube3-4b, phi3-vision-4b)")
    print(f"-- the whole script took {time.perf_counter() - start:.1f} s",
          flush=True)

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
