#!/usr/bin/env python3
"""Where the blocked engine's max-plus kernels spend their time, on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/maxplus_breakdown.py

On the real closure inputs of the blocked path's largest cell (oma/gemm:
21 diagonal structure blocks x the work of 4096 seed-0 candidates, built
as ``chip_smoke.path_closure_inputs`` builds them) it times, by CUDA
events after a warm-up call:

* the closure kernel at 0, 1 and 7 squarings in lower and in full mode --
  0 squarings is the build of ``max(D + w, I)`` and the store alone, so
  (t7 - t0) / 7 is the cost of one squaring -- and the squaring loop it
  replaced (the input written out, 7 x (general matmul +
  ``torch.maximum``));
* cuts of the closure kernel, built from copies of ``csrc/maxplus.cu``
  under ``build/maxplus_breakdown/`` (their output is wrong on purpose,
  only the time is read): ``no_math`` (no k loop: the fold writes NEG
  back, so it times the build, the folds, the barriers and the store),
  ``no_row_xor`` (the shared-memory swizzle without its row term),
  ``no_store`` (the block is never written out), ``no_loads`` (the
  build reads neither D nor w) and ``no_early_stop`` (all 7 squarings
  run, changed or not), each at 0 and at 7 squarings;
* lower mode with work lists of other piece lengths (``closure_pieces``
  at 5, 6 and 8 x 8 values of k per piece, against the 4 it uses), and
  with its warps in plain longest-first order instead of placed on the
  four schedulers of the SM, three times in turn;
* the lower closure matvec on a real closure block at 4096 candidates
  beside the general matvec on the same block;
* the folded sub-diagonal matvec at 4096 candidates beside the unfolded
  step (``D + w`` written out, general matvec, ``torch.maximum``);
* the matvecs also as device time, by CUDA-graph replay
  (``chip_smoke.graph_ms``: no host work between launches);

each beside its bound, and what ``nvcc -Xptxas -v`` said of each entry.
The numbers are printed, one line each, and the last line is a JSON
object of them.
"""

from __future__ import annotations

import ctypes
import json
import math
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import maxplus as K  # noqa: E402

KERNELS = ("maxplus_closure_kernel", "maxplus_matvec_lower_kernel",
           "maxplus_matvec_folded_kernel")
OUT = ROOT / "build" / "maxplus_breakdown"
CUTS = {
    "no_math": [("      if (mine) {\n        // pieces start",
                 "      if (mine && steps < 0) {\n        // pieces start"),
                ("      if (!__syncthreads_or(changed)) break;",
                 "      if (!__syncthreads_or(changed) && steps < 0) break;")],
    "no_row_xor": [("(c ^ ((c >> 3) & 4) ^ ((r >> 1) & 28));",
                    "(c ^ ((c >> 3) & 4));")],
    "no_store": [("      for (int i = warp; i < n; i += nwarps)\n"
                  "        if (lane < nq)\n          o4[",
                  "      for (int i = warp; i < n && steps < 0; i += nwarps)\n"
                  "        if (lane < nq)\n          o4[")],
    "no_loads": [("            d[r] = D4[i * nq + lane];\n"
                  "            wv[r] = wm ? wm[i] : 0.0f;",
                  "            d[r] = make_float4(i, 0.f, 1.f, 2.f);\n"
                  "            wv[r] = 1.0f;")],
    "no_early_stop": [("      if (!__syncthreads_or(changed)) break;",
                       "      if (!__syncthreads_or(changed) && steps < 0) "
                       "break;")],
}


def build_cuts() -> dict:
    """{name: ctypes library} of each cut copy, built in parallel."""
    src = K.SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {}
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
        K._bind(lib)
        libs[name] = lib
    return libs


def closure_with(lib, D, steps, w, table, nslots):
    """One launch of ``lib``'s closure kernel with the work list
    ``table`` (on the device), as ``K.maxplus_closure`` launches it."""
    n = D.shape[-1]
    out = torch.empty((D.shape[0], w.shape[1], n, n), device=D.device)
    err = lib.maxplus_closure_f32(
        D.data_ptr(), w.data_ptr(), out.data_ptr(), D.shape[0] * w.shape[1],
        w.shape[1], n, steps, table.data_ptr(), table.shape[0], nslots,
        torch.cuda.current_stream().cuda_stream)
    _build.launch_check("closure (breakdown)", err)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("maxplus_breakdown: no CUDA device", file=sys.stderr)
        return 1
    print(f"card: {cs.card_line()}", flush=True)
    log = K.build().with_suffix(".log").read_text()
    for kern in KERNELS:
        print(f"{kern}: {cs.ptxas_summary(log, kern)}", flush=True)
    dev = torch.device("cuda")
    _, Dd, Ds, wb = cs.path_closure_inputs(dev)
    nb, n = Dd.shape[0], cs.BLOCK
    items = nb * cs.N_CAND
    steps = int(math.ceil(math.log2(n)))
    out = {}

    def closure(variant, st):
        return lambda: K.maxplus_closure(Dd, st, wb, variant=variant)

    for variant in K.CLOSURE_VARIANTS:
        t = {st: cs.cuda_ms(closure(variant, st), reps=5 if st < steps else 3)
             for st in (0, 1, steps)}
        per = (t[steps] - t[0]) / steps
        out[variant] = dict(ms0=t[0], ms1=t[1], ms7=t[steps], per_squaring=per)
        print(f"closure {variant} ({items}, {n}, {n}): 0 squarings {t[0]:.3f}"
              f" ms, 1: {t[1]:.3f} ms, {steps}: {t[steps]:.3f} ms -> "
              f"{per:.3f} ms per squaring", flush=True)
    torch.cuda.empty_cache()
    libs = build_cuts()
    real = K._load()
    for variant in K.CLOSURE_VARIANTS:
        table, nslots = K._pieces_on(n, variant, dev)
        for name, lib in libs.items():
            for st in (0, steps):
                t = cs.cuda_ms(lambda: closure_with(lib, Dd, st, wb, table,
                                                    nslots), reps=3)
                ref = cs.cuda_ms(lambda: closure_with(real, Dd, st, wb,
                                                      table, nslots), reps=3)
                out[f"{variant}_{name}_{st}"] = t
                print(f"closure {variant}, {st} squarings, cut {name}: "
                      f"{t:.3f} ms (the real kernel in turn {ref:.3f} ms)",
                      flush=True)
    unit = K.PIECE_UNITS
    for units in (5, 6, 8):
        K.PIECE_UNITS = units
        table, nslots = K.closure_pieces(n, "closure_lower")
        K.PIECE_UNITS = unit
        table = torch.from_numpy(table).to(dev)
        t = cs.cuda_ms(lambda: closure_with(real, Dd, steps, wb, table,
                                            nslots), reps=3)
        out[f"closure_lower_units{units}"] = t
        print(f"closure lower, pieces of <= {8 * units} k: {t:.3f} ms "
              f"({table.shape[0]} threads, {nslots} scratch slots)",
              flush=True)
    # the warps in plain longest-first order against the work list placed
    # on the schedulers, in turn
    placed = K._place_warps
    K._place_warps = lambda cost: list(range(len(cost)))
    table, nslots = K.closure_pieces(n, "closure_lower")
    K._place_warps = placed
    lists = {"placed": K._pieces_on(n, "closure_lower", dev),
             "longest_first": (torch.from_numpy(table).to(dev), nslots)}
    outs = [closure_with(real, Dd, steps, wb, *lists[k]) for k in lists]
    same = torch.equal(*outs)
    del outs
    times = {k: [] for k in lists}
    for _ in range(3):
        for k, (table, nslots) in lists.items():
            times[k].append(cs.cuda_ms(lambda: closure_with(
                real, Dd, steps, wb, table, nslots), reps=3))
    for k, ts in times.items():
        out[f"closure_lower_{k}"] = ts
    print(f"closure lower, warps placed on the schedulers: "
          f"{', '.join(f'{t:.3f}' for t in times['placed'])} ms; in plain "
          f"longest-first order: "
          f"{', '.join(f'{t:.3f}' for t in times['longest_first'])} ms "
          f"(in turn; outputs equal: {same})", flush=True)
    torch.cuda.empty_cache()
    useful = steps * items * cs.closure_useful_instr(n)
    nbytes = (items * n * n + Dd.numel() + wb.numel()) * 4
    bms, by = cs.bound_instr(useful, nbytes)
    dense, _ = cs.bound(steps * items * n ** 3, nbytes)
    store, _ = cs.bound(0, nbytes)
    old = cs.cuda_ms(lambda: cs.squaring_loop_closure(K, Dd, wb, steps),
                     reps=2)
    lo = out["closure_lower"]["ms7"]
    print(f"closure bounds: useful triples {bms:.3f} ms ({by}; lower mode at "
          f"{100 * bms / lo:.1f}%), dense {dense:.3f} ms (full mode at "
          f"{100 * dense / out['closure_full']['ms7']:.1f}%), bytes "
          f"{store:.3f} ms; squaring loop {old:.3f} ms = {old / lo:.2f}x "
          f"lower mode", flush=True)
    out.update(useful_bound_ms=bms, dense_bound_ms=dense, bytes_ms=store,
               squaring_loop_ms=old)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    C = K.maxplus_closure(Dd[nb - 1:], steps, wb[nb - 1:],
                          variant="closure_lower")[0]
    h = cs.operand(gen, (cs.N_CAND, n), dev, 0.2)
    lv = cs.cuda_ms(lambda: K.maxplus_matvec_lower(C, h), reps=100)
    gv = cs.cuda_ms(lambda: K.maxplus_matvec(C, h), reps=100)
    lv_dev = cs.graph_ms([lambda: K.maxplus_matvec_lower(C, h)], reps=100)
    gv_dev = cs.graph_ms([lambda: K.maxplus_matvec(C, h)], reps=100)
    b = cs.N_CAND
    lb, _ = cs.bound(0, (b * n * (n + 1) // 2 + 2 * b * n) * 4)
    print(f"closure matvec ({b}, {n}, {n}): lower {lv:.4f} ms, device "
          f"{lv_dev:.4f} ms ({100 * lb / lv_dev:.1f}% of {lb:.4f} ms, bytes)"
          f"; general {gv:.4f} ms, device {gv_dev:.4f} ms", flush=True)
    Db = Ds[nb - 1].contiguous()
    w = wb[nb - 1]
    prev, h0 = (cs.operand(gen, (b, n), dev, f) for f in (0.1, 0.5))
    fv = cs.cuda_ms(lambda: K.maxplus_matvec_folded(Db, w, prev, h0),
                    reps=100)
    ov = cs.cuda_ms(lambda: torch.maximum(
        h0, K.maxplus_matvec(Db + w[:, :, None], prev)), reps=50)
    fv_dev = cs.graph_ms([lambda: K.maxplus_matvec_folded(Db, w, prev, h0)],
                         reps=100)
    ov_dev = cs.graph_ms([lambda: torch.maximum(
        h0, K.maxplus_matvec(Db + w[:, :, None], prev))], reps=20)
    fb = 3.0 * b * n * n / cs.FP32_INSTR_PER_S * 1e3
    print(f"folded matvec ({b}, {n}, {n}): {fv:.4f} ms, device {fv_dev:.4f} "
          f"ms ({100 * fb / fv_dev:.1f}% of {fb:.4f} ms, operations); "
          f"unfolded step {ov:.4f} ms, device {ov_dev:.4f} ms", flush=True)
    out.update(matvec_lower_ms=lv, matvec_lower_device_ms=lv_dev,
               matvec_general_ms=gv, matvec_general_device_ms=gv_dev,
               matvec_lower_bound_ms=lb, folded_ms=fv, folded_device_ms=fv_dev,
               unfolded_ms=ov, unfolded_device_ms=ov_dev,
               folded_bound_ms=fb)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
