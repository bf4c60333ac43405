#!/usr/bin/env python3
"""Where the port's ring selective-scan kernel spends its time, on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/scan_breakdown.py

It builds cuts of ``csrc/selective_scan.cu`` -- copies of the source with
one part of the ring kernel's work taken out, built beside the real
library under ``build/scan_breakdown/`` -- and times each against the real
kernel at the LM path's shape (jamba's mamba layers when scoring: batch 4,
S 2048, D 8192, N 16), with the lanes ``plan`` picks there:

* ``no_exp``: each exponential replaced by a multiply (no MUFU.EX2);
* ``no_store``: no y store (the y tiles are written to shared memory,
  never stored by TMA);
* ``loads_only``: the ring alone -- x and dt by TMA, B and C by the
  producer, the consumers waiting and releasing each tile, no arithmetic
  and no store;
* ``y_direct``: not a cut but the other way out for y -- a direct store
  from the first lane of each channel's group instead of the TMA store;
* ``poly_1of8``: not a cut but the trade the design left out -- every
  eighth exponential of a lane computed on the FMA pipe by a polynomial
  instead of the MUFU;
* ``stages_5``: not a cut but a deeper ring, five tiles instead of four;
* ``bc_once``: B and C read from shared memory once a tile instead of
  once a step (what their shared loads cost);
* ``bc_lds32``: not a cut but B and C by 4-byte shared loads instead of
  16-byte ones.

A cut kernel's output is wrong on purpose: only its time is read (the
outputs of ``y_direct``, ``poly_1of8``, ``stages_5`` and ``bc_lds32``
are right and are checked).  It also times the
real kernel with every lane count the library has (1, 2, 4, 8) at the
path shape and at the float32 check's (batch 1, S 1024) beside the PR 12
kernel, prints what ``nvcc -Xptxas -v`` said of the ring instances, the
SASS instruction counts of the planned instances by opcode class per
MUFU.EX2 (one MUFU.EX2 is one (step, state) of one lane: the loop over a
tile's steps is unrolled, so static counts are per-tile counts), and the
SM clock and power that ``nvidia-smi`` reads while the kernel runs.
Times are device times by CUDA-graph replay (``chip_smoke.graph_ms``),
each cut in turn with the real kernel.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import selective_scan as SS  # noqa: E402

OUT = ROOT / "build" / "scan_breakdown"
KERNEL = "selective_scan_ring_kernel"

NO_EXP = ('  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));',
          "  r = x * 0.999f;")
NO_STORE = ("if (lane == 0 && warp_live) {",
            "if (lane == 0 && warp_live && S < 0) {")
NO_STEPS = ("    for (int t = 0; t < T; ++t) {\n      const float xv",
            "    for (int t = 0; t < T && S < 0; ++t) {\n      const float xv")
# B and C read once a tile instead of once a step (the loads hoisted out
# of the step loop): what the shared loads of B and C cost
BC_ONCE = ("lds<SPL>(bv, tb + t * NP);\n      lds<SPL>(cv, tc + t * NP);",
           "lds<SPL>(bv, tb);\n      lds<SPL>(cv, tc);")
# not a cut: B and C by 4-byte shared loads instead of 16-byte ones
BC_LDS32 = ("  if constexpr (SPL % 4 == 0) {", "  if constexpr (false) {")
BC_LDS32_ELSE = ("    v[0] = p[0];\n",
                 "#pragma unroll\n    for (int j = 0; j < SPL; ++j) v[j] = p[j];\n")
# not a cut but the other way out for y: the first lane of each channel's
# group stores its tile's y directly, in place of the shared tile and the
# TMA store
Y_DIRECT = ("""    float* ty = ybuf + (i & 1) * (T * CW);
    if (i >= 2) {
      // the store of tile i - 2 has read this buffer
      if (lane == 0) tma_store_wait_read<1>();
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (k == 0) ty[t * CW + lane / L] = yt[t];
    fence_proxy_async();                 // the y tile is visible to TMA
    __syncwarp();
    if (lane == 0 && warp_live) {
      tma_store_3d(&map_y, smem_u32(ty), c0 + warp * CW, t0, b);
      tma_store_commit();
    }
""", """    float* yd = y + ((int64_t)b * S + t0) * D + ch;
#pragma unroll
    for (int t = 0; t < T; ++t)
      if (k == 0 && live && t0 + t < S) yd[(int64_t)t * D] = yt[t];
""")
# the optional trade the design left out: every eighth exponential on the
# FMA pipe (round to nearest by the 1.5 * 2^23 trick, a degree-6 Taylor
# polynomial of 2^f on [-1/2, 1/2], relative error ~2.4e-7, the exponent
# added as an integer) instead of the MUFU
POLY = ("// 4 bytes from global into shared memory", """\
__device__ __forceinline__ float ex2_poly(float x) {
  const float xc = fmaxf(x, -126.f);
  const float t = xc + 12582912.f;
  const float f = xc - (t - 12582912.f);
  float p = 1.54035304e-4f;
  p = fmaf(p, f, 1.33335581e-3f);
  p = fmaf(p, f, 9.61812911e-3f);
  p = fmaf(p, f, 5.55041087e-2f);
  p = fmaf(p, f, 2.40226507e-1f);
  p = fmaf(p, f, 6.93147181e-1f);
  p = fmaf(p, f, 1.f);
  return __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
}

// 4 bytes from global into shared memory""")
POLY_USE = ("dA_next[j] = ex2_ftz(dv_next * a2[j]);",
            "dA_next[j] = j % 8 == 7 ? ex2_poly(dv_next * a2[j])\n"
            "                                   : ex2_ftz(dv_next * a2[j]);")
# not a cut: a fifth ring tile for blocks of 1 or 2 lanes (at 1 lane two
# blocks still fit on an SM)
STAGES_5 = ("static constexpr int STAGES = L <= 2 ? 4 : 3;",
            "static constexpr int STAGES = L <= 2 ? 5 : 3;")
CUTS = {
    "no_exp": [NO_EXP],
    "no_store": [NO_STORE],
    "loads_only": [NO_STEPS, NO_STORE],
    "y_direct": [Y_DIRECT],
    "poly_1of8": [POLY, POLY_USE],
    "stages_5": [STAGES_5],
    "bc_once": [BC_ONCE],
    "bc_lds32": [BC_LDS32, BC_LDS32_ELSE],
}
# SASS opcode classes counted per MUFU.EX2
CLASSES = {
    "MUFU.EX2": r"MUFU\.EX2", "FFMA": r"FFMA", "FMUL": r"FMUL",
    "FADD": r"FADD", "LDS": r"LDS", "STS": r"STS", "SHFL": r"SHFL",
    "STG": r"STG", "SYNCS/BAR": r"SYNCS|BAR\b|WARPSYNC",
}


def build_cuts() -> dict:
    """{name: (library, path)} for the real source and each cut copy,
    built in parallel."""
    src = SS.SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {"full": SS.SOURCE}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"cut {name}: its anchor is not in the "
                                   f"source: {old!r}")
            text = text.replace(old, new)
        path = OUT / f"{name}.cu"
        path.write_text(text)
        paths[name] = path
    with ThreadPoolExecutor(len(paths)) as pool:
        built = dict(zip(paths, pool.map(_build.build, paths.values())))
    libs = {}
    for name, so in built.items():
        lib = ctypes.CDLL(str(so))
        SS._bind(lib)
        libs[name] = (lib, so)
    return libs


def sass_counts(so: Path, lanes: int, np_: int) -> str:
    """Instructions of the (lanes, np_) ring instance by opcode class, per
    MUFU.EX2, and the instance's total."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return f"cuobjdump failed: {proc.stderr.strip()[:200]}"
    want = f"{KERNEL}ILi{lanes}ELi{np_}E"
    body, keep = [], False
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            keep = want in line
        elif keep and re.search(r"/\*[0-9a-f]{4,}\*/", line):
            body.append(line)
    ops = Counter()
    for line in body:
        m = re.search(r"\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m:
            ops[m.group(2)] += 1
    total = sum(ops.values())
    ex2 = sum(n for op, n in ops.items() if re.match(CLASSES["MUFU.EX2"], op))
    if ex2 == 0:
        return f"{want}: no MUFU.EX2 found ({total} instructions)"
    parts = []
    for name, pat in CLASSES.items():
        n = sum(c for op, c in ops.items() if re.match(pat, op))
        parts.append(f"{name} {n} ({n / ex2:.3f})")
    return (f"lanes {lanes}, N {np_}: {total} instructions, "
            f"{total / ex2:.3f} per MUFU.EX2; by class (per MUFU.EX2): "
            + ", ".join(parts))


def launch(lib, p, ins) -> torch.Tensor:
    x, dt, b, c, a, d = ins
    bsz, s, dm = x.shape
    y = torch.empty_like(x)
    err = lib.selective_scan_f32_ring(
        *(t.data_ptr() for t in (x, dt, b, c, a, d, y)), bsz, s, dm,
        a.shape[1], p.lanes, torch.cuda.current_stream().cuda_stream)
    _build.launch_check("scan_breakdown", err)
    return y


def clocks_while(fn, secs: float = 2.0) -> str:
    """The SM clock and power draw ``nvidia-smi`` reads while ``fn`` runs
    back to back for ``secs`` seconds."""
    reads, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            out = subprocess.run(
                ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                 "--format=csv,noheader"], capture_output=True, text=True)
            reads.append(out.stdout.strip())
            time.sleep(0.2)

    th = threading.Thread(target=sample)
    th.start()
    t = time.perf_counter()
    while time.perf_counter() - t < secs:
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
    stop.set()
    th.join()
    return "; ".join(reads[1:-1] or reads)


def inputs(gen, dev, bsz, s, dm, ns):
    def rand(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale
    return (rand(bsz, s, dm, scale=0.5), rand(bsz, s, dm, scale=0.1).abs(),
            rand(bsz, s, ns), rand(bsz, s, ns), -(rand(dm, ns).abs() + 0.1),
            rand(dm))


def main() -> int:
    if not torch.cuda.is_available():
        print("scan_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    libs = build_cuts()
    full_so = libs["full"][1]
    log = full_so.with_suffix(".log").read_text()
    print(f"full: {cs.ptxas_summary(log, KERNEL)}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    shapes = ((cs.SCORE_B, cs.SCORE_S, 8192, 16),
              (cs.F32_B, cs.F32_S, 8192, 16))
    for lanes in sorted({SS.plan(b, s, d, n, True).lanes
                         for b, s, d, n in shapes} | {1, 2}):
        print(f"SASS {sass_counts(full_so, lanes, 16)}", flush=True)

    for bsz, s, dm, ns in shapes:
        ins = inputs(gen, dev, bsz, s, dm, ns)
        p = SS.plan(bsz, s, dm, ns, True)
        bms, by = cs.scan_bound(ins[0], ins[2])
        reps = 20 if bsz == cs.SCORE_B else 50
        lanes = {}
        for n_lanes in SS.RING_LANES:
            q = SS.ring_plan(bsz, dm, n_lanes)
            lanes[n_lanes] = cs.graph_ms(
                [lambda q=q: launch(libs["full"][0], q, ins)], reps)
        old = cs.graph_ms([lambda: SS._launch(*ins, "pr12")], reps)
        print(f"({bsz}, {s}, {dm}, {ns}) {p}: bound {bms:.4f} ms ({by}); "
              f"device ms by lanes " + ", ".join(
                  f"{n} {ms:.4f} ({100 * bms / ms:.1f}%)"
                  for n, ms in lanes.items())
              + f"; pr12 {old:.4f} ({old / lanes[p.lanes]:.2f}x the planned "
              f"kernel)", flush=True)
        if bsz != cs.SCORE_B:
            continue
        want = SS.selective_scan_torch(*ins)
        errs = {}
        for name in ("y_direct", "poly_1of8", "stages_5", "bc_lds32"):
            got = launch(libs[name][0], p, ins)
            errs[name] = cs.within(got, want, cs.SCAN_TOL)
            del got
        del want
        full = lambda: launch(libs["full"][0], p, ins)  # noqa: E731
        row = {"full": [cs.graph_ms([full], reps)]}
        for name in CUTS:
            cut = lambda lib=libs[name][0]: launch(lib, p, ins)  # noqa: E731
            row[name] = [cs.graph_ms([cut], reps)]
            row["full"].append(cs.graph_ms([full], reps))
        full_ms = sorted(row["full"])[len(row["full"]) // 2]
        print(f"  full {full_ms:.4f} ms (median of {len(row['full'])}, "
              f"range {min(row['full']):.4f}-{max(row['full']):.4f}); cuts "
              f"(device ms): " + ", ".join(f"{n} {row[n][0]:.4f}"
                                          for n in CUTS)
              + "; vs plain (max |err|, elements outside SCAN_TOL): "
              + ", ".join(f"{n} {e[0]:.3e}, {e[1]}" for n, e in errs.items()),
              flush=True)
        print(f"  nvidia-smi clocks.sm, power.draw while the kernel runs: "
              f"{clocks_while(full)}", flush=True)
        del ins
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
