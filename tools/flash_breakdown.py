#!/usr/bin/env python3
"""Where the port's wgmma flash-attention kernel spends its time, on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/flash_breakdown.py

It builds cuts of ``csrc/flash_attention.cu`` -- copies of the source with
one part of the wgmma kernel's work taken out, built beside the real
library under ``build/flash_breakdown/`` -- and times each against the
real kernel, the PR 12 ``mma.sync`` kernel and
``scaled_dot_product_attention`` at the LM path's two shapes (bf16,
causal, BH 128 over 32 KV heads, D 128: S 2048 as ``chip_smoke.py`` phase
6 scores, S 512 as its prefill):

* ``overlap``: not a cut but the schedule the kernel does not use -- each
  tile's q k^T issued together with the last tile's P v, and the softmax
  run while that P v is on the tensor cores;
* ``no_pingpong``: the two consumer warpgroups issue their products
  without taking turns;
* ``no_softmax``: no scale, mask, max, exponentials or sums (P is the raw
  scores);
* ``no_pv``: no P v products;
* ``no_products``: neither product (loads, softmax on whatever the score
  registers hold, epilogue);
* ``loads_only``: neither product nor the softmax.

A cut kernel's output is wrong on purpose: only its time is read (the
``overlap`` kernel's output is right).  Times
are device times by CUDA-graph replay (``chip_smoke.graph_ms``), the
cuts in turns with the real kernel.  It also prints what ``nvcc -Xptxas
-v`` said of each build and, through ``cuobjdump -sass``, the real
kernel's local-memory (spill) instructions and highest register.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import flash_attention as FA  # noqa: E402

OUT = ROOT / "build" / "flash_breakdown"
KERNEL = "flash_attention_wgmma_kernel"

NO_PINGPONG = ("  auto my_turn = [&]() { named_bar_sync(PING + c, 256); };\n"
               "  auto your_turn = [&]() { named_bar_arrive(PING + 1 - c, "
               "256); };\n",
               "  auto my_turn = [&]() {};\n  auto your_turn = [&]() {};\n")
NO_SOFTMAX = ("      tile_softmax(s_acc, m, l, alpha, row, col, it.first + i * "
              "wgf::BK, lo,\n                   Sk, causal, window, scale2);\n",
              "      alpha[0] = alpha[1] = 1.f;\n")
NO_QK = ("  for (int kk = 0; kk < wgf::HD / 16; ++kk) {\n",
         "  for (int kk = 0; kk < wgf::HD / 16 && q != 1; ++kk) {\n")
NO_PV = ("  for (int kk = 0; kk < wgf::BK / 16; ++kk)\n    wgmma_rs<1>(",
         "  for (int kk = 0; kk < wgf::BK / 16 && v != 1; ++kk)\n"
         "    wgmma_rs<1>(")
# not a cut but the other schedule: this tile's q k^T issued together with
# the last tile's P v, and the softmax run while that P v is on the tensor
# cores (S, P and o then all hold registers at once)
OVERLAP = ("""      issue_pv(o, p, vs(sp));
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty(sp));
      issue_qk(s_acc, qa, ks(s));
      your_turn();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(k_empty(s));
      tile_softmax(s_acc, m, l, alpha, row, col, it.first + i * wgf::BK, lo,
                   Sk, causal, window, scale2);
""",
           """      issue_qk(s_acc, qa, ks(s));
      issue_pv(o, p, vs(sp));
      your_turn();
      wgmma_wait<1>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(k_empty(s));
      tile_softmax(s_acc, m, l, alpha, row, col, it.first + i * wgf::BK, lo,
                   Sk, causal, window, scale2);
      wgmma_wait<0>();
      fence_regs(o);
      if (lane == 0) mbar_arrive(v_empty(sp));
""")
CUTS = {
    "overlap": [OVERLAP],
    "no_pingpong": [NO_PINGPONG],
    "no_softmax": [NO_SOFTMAX],
    "no_pv": [NO_PV],
    "no_products": [NO_QK, NO_PV],
    "loads_only": [NO_QK, NO_PV, NO_SOFTMAX],
}


def build_cuts() -> dict:
    """{name: library} for the real source and each cut copy, built in
    parallel."""
    src = FA.SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {"full": FA.SOURCE}
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
        FA._bind(lib)
        libs[name] = (lib, so)
    return libs


def sass_report(so: Path) -> str:
    """Local-memory instructions, the highest register, and the wgmma
    instructions and the waits on them, of the wgmma kernel in the
    library's SASS."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return f"cuobjdump failed: {proc.stderr.strip()[:200]}"
    text, keep = [], False
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            keep = KERNEL in line
        elif keep:
            text.append(line)
    body = "\n".join(text)
    regs = [int(r) for r in re.findall(r"\bR(\d+)\b", body)]
    return (f"{len(re.findall(r'STL', body))} STL, "
            f"{len(re.findall(r'LDL', body))} LDL, highest register "
            f"R{max(regs) if regs else '?'}, "
            f"{len(re.findall(r'HGMMA', body))} HGMMA and "
            f"{len(re.findall(r'WARPGROUP.DEPBAR', body))} waits on them "
            f"(a wait after every HGMMA: ptxas serialised them)")


def launch(lib, q, k, v) -> torch.Tensor:
    bh, sq, d = q.shape
    out = torch.empty_like(q)
    err = lib.flash_attention_bf16_wgmma(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
        bh // k.shape[0], sq, k.shape[1], d, d, 1, 0, d ** -0.5,
        torch.cuda.current_stream().cuda_stream)
    _build.launch_check("flash_breakdown", err)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    libs = build_cuts()
    for name, (_, so) in libs.items():
        log = so.with_suffix(".log").read_text()
        print(f"{name}: {cs.ptxas_summary(log, KERNEL)}", flush=True)
        for line in log.splitlines():
            if "Performance" in line:    # ptxas' wgmma serialisation notes
                print(f"  {line.strip()}", flush=True)
    print(f"full, SASS: {sass_report(libs['full'][1])}", flush=True)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    b, h, kv, d = cs.SCORE_B, 32, 8, 128
    for s in (cs.SCORE_S, cs.PROMPT):
        q = torch.randn((b * h, s, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b * kv, s, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b * kv, s, d), generator=gen, device=dev).bfloat16()
        bms, by = cs.flash_bound(q, k, v, causal=True)
        err = (launch(libs["overlap"][0], q, k, v).float()
               - FA.flash_attention_torch(q, k, v).float()).abs()
        ok = bool((err <= FA.bf16_error_bound(q, k, v)).all())
        del err
        reps = 20 if s == cs.SCORE_S else 100
        full = lambda: launch(libs["full"][0], q, k, v)  # noqa: E731
        row = {"full": [cs.graph_ms([full], reps)]}
        for name in CUTS:
            cut = lambda lib=libs[name][0]: launch(lib, q, k, v)  # noqa: E731
            row[name] = [cs.graph_ms([cut], reps)]
            row["full"].append(cs.graph_ms([full], reps))
        old = cs.graph_ms([lambda: FA._launch(q, k, v, True, 0, None,
                                              "mma_sync")], reps)
        q4, k4, v4 = (t.view(b, t.shape[0] // b, s, d) for t in (q, k, v))
        lib_ms = cs.graph_ms([lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)], reps)
        full_ms = sorted(row["full"])[len(row["full"]) // 2]
        print(f"S {s} (BH {b * h}/{b * kv}, D {d}, bf16, causal; bound "
              f"{bms:.4f} ms, {by}): full {full_ms:.4f} ms (median of "
              f"{len(row['full'])}, range {min(row['full']):.4f}-"
              f"{max(row['full']):.4f}; {100 * bms / full_ms:.1f}% of bound)"
              f"; mma.sync {old:.4f}; scaled_dot_product_attention "
              f"{lib_ms:.4f} (full / SDPA {full_ms / lib_ms:.3f})",
              flush=True)
        print("  cuts (device ms): " + ", ".join(
            f"{name} {row[name][0]:.4f}" for name in CUTS)
            + f"; the overlap kernel within the bf16 bound: {ok}", flush=True)
        del q, k, v, q4, k4, v4
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
