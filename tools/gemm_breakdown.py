#!/usr/bin/env python3
"""Where the port's GEMM kernels spend their time, on one NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/gemm_breakdown.py

It prints, at olmo-1b's GEMM shapes (as ``chip_smoke.py`` phase 9 runs
them, bf16 in, float32 out):

1. cuts of ``csrc/systolic_gemm.cu``: copies of the source with the work
   stopped at one point, built beside the real library under
   ``build/gemm_breakdown/`` and timed against it -- the wgmma kernel
   without its epilogue stores and without its math (loads only), the
   split-K kernel without the last block's sum, without the count and
   without the partial stores.  A cut kernel's output is wrong on purpose:
   only its time is read;
2. the split-K kernel's device time at several split counts, beside the
   count ``plan()`` picks and ``torch.matmul``;
3. host time per call of the GEMM wrapper and of its parts at the decode
   q/o shape (host clock around 2000 back-to-back calls).

Device times are CUDA-graph replays as in ``chip_smoke.graph_ms``, with
decode operands rotated through copies of B beyond twice the L2.
"""

from __future__ import annotations

import ctypes
import math
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import systolic_gemm as SG  # noqa: E402

OUT = ROOT / "build" / "gemm_breakdown"
NO_MATH = ("        wgmma_ss<1>(acc, da, db, (kt | kk) != 0);\n",
           "        if (da == 1) wgmma_ss<1>(acc, da, db, (kt | kk) != 0);\n")
EPILOGUE = "    // epilogue: thread t holds rows r and r + 8 of each 8-column group.\n"
CUTS = {
    "wgmma_no_epilogue": (EPILOGUE,
                          EPILOGUE + "    if (acc[0] != 12345.f) continue;\n"),
    "wgmma_no_math": NO_MATH,
    "splitk_no_sum": ("  if (!last) return;\n",
                      "  if (!last) return;\n  if (threadIdx.x == 0) "
                      "counters[panel] = 0;\n  return;\n"),
    "splitk_no_count": ("  // one thread counts the block in: the barrier "
                        "orders the block's\n", "  return;\n"),
    "splitk_no_partials": ("  float* part = ws + (int64_t)split * M * N;\n",
                           "  if (acc[0][0] != 12345.f) return;\n"
                           "  float* part = ws + (int64_t)split * M * N;\n"),
}
DECODE = [(8, 2048, 2048), (8, 2048, 4096), (8, 2048, 24576),
          (8, 2048, 50304)]
PREFILL = [(8192, 2048, 2048), (8192, 2048, 24576), (8192, 2048, 50304)]


def build_cuts() -> dict:
    """{name: library} for the real source and each cut copy."""
    src = SG.SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {"full": _build.load(SG.SOURCE, SG._bind)}
    for name, (old, new) in CUTS.items():
        if src.count(old) != 1:
            raise RuntimeError(f"cut {name}: its anchor is not in the source")
        path = OUT / f"{name}.cu"
        path.write_text(src.replace(old, new))
        lib = ctypes.CDLL(str(_build.build(path)))
        SG._bind(lib)
        libs[name] = lib
    return libs


def operands(m, k, n, dev, gen, l2):
    copies = 1 if m > SG.SPLITK_MAX_M else max(1, math.ceil(2 * l2 / (k * n * 2)))
    return [(torch.randn((m, k), generator=gen, device=dev).bfloat16(),
             torch.randn((k, n), generator=gen, device=dev).bfloat16())
            for _ in range(copies)]


def launch(lib, a, b, p) -> None:
    """One launch of plan ``p`` through ``lib`` (float32 out, no ReLU)."""
    (m, k), n = a.shape, b.shape[1]
    out = torch.empty((m, n), device=a.device)
    err = SG._run(lib, a, b, out, 0, p)
    _build.launch_check("gemm_breakdown", err)


def device_us(calls, m) -> float:
    reps = 5 if m > SG.SPLITK_MAX_M else 4 * len(calls) + 36
    return cs.graph_ms(calls, reps) * 1e3


def host_us(fn, n: int = 2000) -> float:
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / n * 1e6


def main() -> int:
    if not torch.cuda.is_available():
        print("gemm_breakdown: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    l2 = torch.cuda.get_device_properties(dev).L2_cache_size
    libs = build_cuts()

    print("-- 1. cuts (device us)", flush=True)
    for m, k, n in PREFILL + DECODE[:2]:
        ins = operands(m, k, n, dev, gen, l2)
        p = SG.plan(m, k, n, torch.bfloat16, True)
        names = [x for x in libs if x == "full" or x.startswith(p.variant)]
        row = {x: device_us([lambda a=a, b=b, lib=libs[x]: launch(lib, a, b, p)
                             for a, b in ins], m) for x in names}
        mm = device_us([lambda a=a, b=b: torch.matmul(a, b) for a, b in ins], m)
        print(f"({m}, {k}, {n}) {p.variant} x{p.splits}: "
              + ", ".join(f"{x} {v:.1f}" for x, v in row.items())
              + f"; torch.matmul {mm:.1f}", flush=True)

    print("-- 2. split counts (device us)", flush=True)
    for m, k, n in DECODE:
        ins = operands(m, k, n, dev, gen, l2)
        p0 = SG.plan(m, k, n, torch.bfloat16, True)
        row = []
        for s in sorted({1, 2, 4, 8, 16, 32, p0.splits}):
            p = p0._replace(splits=s, grid=(p0.grid[0], s))
            us = device_us([lambda a=a, b=b: launch(libs["full"], a, b, p)
                            for a, b in ins], m)
            row.append(f"{s}{'*' if s == p0.splits else ''}: {us:.1f}")
        print(f"({m}, {k}, {n}) splits (* = plan): " + ", ".join(row),
              flush=True)

    print("-- 3. host us per call at (8, 2048, 2048)", flush=True)
    a, b = operands(8, 2048, 2048, dev, gen, l2)[0]
    p = SG.plan(8, 2048, 2048, torch.bfloat16, True)
    pieces = {
        "ops.gemm": lambda: ops.gemm(a, b),
        "systolic_gemm": lambda: SG.systolic_gemm(a, b),
        "_launch": lambda: SG._launch(a, b, 0, torch.float32, p),
        "torch.matmul": lambda: torch.matmul(a, b),
        "torch.empty": lambda: torch.empty((8, 2048), device=dev),
        "torch.cuda.current_stream()": lambda: torch.cuda.current_stream(),
        "plan()": lambda: SG.plan(8, 2048, 2048, torch.bfloat16, True),
    }
    for name, fn in pieces.items():
        print(f"{name}: {host_us(fn):.2f}", flush=True)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
