#!/usr/bin/env python3
"""Where the port's wgmma flash-attention kernel spends its time, on one
NVIDIA GPU.

Run from the repository root on a machine with a CUDA card and nvcc:

    python3 tools/flash_breakdown.py [--against OTHER/flash_attention.cu]

It builds cuts of ``csrc/flash_attention.cu`` -- copies of the source with
one part of the wgmma kernel's work taken out, built beside the real
library under ``build/flash_breakdown/`` -- and times each against the
real kernel, the PR 12 ``mma.sync`` kernel and
``scaled_dot_product_attention`` at the LM path's two shapes (bf16,
causal, BH 128 over 32 KV heads, D 128: S 2048 as ``chip_smoke.py`` phase
6 scores, S 512 as its prefill), and the ``wgmma_dv`` instance (Dq 96, Dv
64) the same way at MLA's shape (40 heads, S 2048, as phase 14 times it),
there beside the ``cuda_core`` kernel, SDPA, the FLOP bound and the
exponentials' floor.  A cut applies to both instances:

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
* ``loads_only``: neither product nor the softmax;
* ``forward_rounds``: not a cut but the item order the kernel does not
  use -- every round of items dealt to the blocks forwards;
* ``stages_2``: a k/v ring of 2 stages (the D 128 instance's depth; the
  ``wgmma_dv`` instance's is 3);
* ``pv_boxes``: not a cut but the P v width the kernel does not use at
  (120, 120) and (96, 96) -- the boxes' 128, m64n128k16 over the
  zero-filled v columns, instead of n = Dv (the 128 / 128 and 96 / 64
  instances are unchanged by it); its output is checked against the
  bf16 bound too.

The ``wgmma_120`` and ``wgmma_96`` instances are timed the same way at
h2o-danube3-4b's layer shape (32 heads over 8, S 8192, window 4096) and
phi3-vision-4b's (B 4 x 32 heads, S 2048), beside ``cuda_core`` and SDPA.

``--ds-split`` builds only the real source and a copy whose training
backward kernels split dS into a bf16 high part and a bf16 low part (dS -
bf16(dS)) and run one more product with the low part (``train_dq``: dQ +=
dS_lo k; ``train_dkdv``: dK += dS_lo^T q), so that dQ and dK see dS to
about float32's precision, as the chunked route kept it.  At olmo-1b's
layer shape (B 4 x 16 heads, S 4096, D 128, bf16, causal) it times both
kernels of both builds in turns and prints what the split would add to a
training step (olmo-1b's 16 layers run each once a step), and how far
each build's dq and dk lie from a float32 backward (no rounding of P or
dS) on 8 heads.

``--against`` builds another version of the source (an unpacked older
commit's, say) beside the real one, checks that the D 128 instance gives
the same bits at the two shapes and times the two in turns.  With
``--digests`` too it builds only those two and prints, for the D 128 and
the ``wgmma_dv`` instances of each, the SHA-256 of the output on every
case of ``chip_smoke.PINNED_FLASH`` (the digests
``tests/test_torch_cuda.py`` pins) and whether the two sources agree.

A cut kernel's output is wrong on purpose: only its time is read (the
``overlap`` and ``pv_boxes`` kernels' outputs are right).  Times
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
# the kernel at D 128 (its mangled name; the source instantiates it at
# (96, 64) too)
KERNEL = "flash_attention_wgmma_kernelILi128ELi128ELb0E"

NO_PINGPONG = ("  auto my_turn = [&]() { named_bar_sync(PING + c, 256); };\n"
               "  auto your_turn = [&]() { named_bar_arrive(PING + 1 - c, "
               "256); };\n",
               "  auto my_turn = [&]() {};\n  auto your_turn = [&]() {};\n")
NO_SOFTMAX = ("      tile_softmax(s_acc, m, l, alpha, row, col, it.first + i * "
              "wgf::BK, lo,\n                   Sk, causal, window, scale2);\n",
              "      alpha[0] = alpha[1] = 1.f;\n")
NO_QK = ("  for (int kk = 0; kk < STEPS; ++kk) {\n",
         "  for (int kk = 0; kk < STEPS && q != 1; ++kk) {\n")
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
      issue_qk<C::QK_STEPS>(s_acc, qa, ks(s));
      your_turn();
      wgmma_wait<0>();
      fence_regs(s_acc);
      if (lane == 0) mbar_arrive(k_empty(s));
      tile_softmax(s_acc, m, l, alpha, row, col, it.first + i * wgf::BK, lo,
                   Sk, causal, window, scale2);
""",
           """      issue_qk<C::QK_STEPS>(s_acc, qa, ks(s));
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
FORWARD_ROUNDS = ("  return n * gridDim.x + ((n & 1) ? gridDim.x - 1 - "
                  "blockIdx.x : blockIdx.x);\n",
                  "  return n * gridDim.x + blockIdx.x;\n")
STAGES_2 = ("  static constexpr int STAGES =\n      (SMEM_MAX - 1024 - 2 * "
            "QK_TILE - 8 * 4) / (QK_TILE + V_TILE + 8 * 4);\n",
            "  static constexpr int STAGES = 2;\n")



# not a cut but the other P v width at (120, 120) and (96, 96): the
# boxes' 128 columns, m64n128k16
PV_BOXES = [("  float o[DV / 2], s_acc[64];\n",
             "  float o[C::V_BOXES * 32], s_acc[64];\n"),
            ("    for (int i = 0; i < DV / 2; ++i) o[i] = 0.f;\n",
             "    for (int i = 0; i < C::V_BOXES * 32; ++i) o[i] = 0.f;\n"),
            ("      for (int j = 0; j < DV / 8; ++j) {\n",
             "      for (int j = 0; j < C::V_BOXES * 8; ++j) {\n")]
# the training backward with dS split into bf16 high and low parts: the
# low part's product after each dS product (``--ds-split``)
PACK_LO = ("// a warpgroup's 64 x 128 float32 accumulator times `scale`, as "
           "bf16 rows\n",
           """// the bf16 remainder s - bf16(s) of a 64-column float32 tile, as the
// A fragments of 4 k steps
__device__ __forceinline__ void pack_lo(uint32_t (&a)[4][4],
                                        const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x = s[8 * kk + 2 * r], y = s[8 * kk + 2 * r + 1];
      a[kk][r] = pack_bf16(x - __bfloat162float(__float2bfloat16_rn(x)),
                           y - __bfloat162float(__float2bfloat16_rn(y)));
    }
}

// a warpgroup's 64 x 128 float32 accumulator times `scale`, as bf16 rows
""")
SPLIT_DKDV = ("""    pack_a(da, dp_acc);
    wgmma_fence();
    issue_acc64(dv_acc, pa, dos(s));   // dV += P^T dO
    issue_acc64(dk_acc, da, qs(s));    // dK += dS^T q
""", """    pack_a(da, dp_acc);
    uint32_t dl[4][4];
    pack_lo(dl, dp_acc);
    wgmma_fence();
    issue_acc64(dv_acc, pa, dos(s));   // dV += P^T dO
    issue_acc64(dk_acc, da, qs(s));    // dK += dS^T q
    issue_acc64(dk_acc, dl, qs(s));
""")
SPLIT_DQ = ("""    pack_a(da, dp_acc);
    wgmma_fence();
    issue_acc64(dq_acc, da, ks(s));    // dQ += dS k
""", """    pack_a(da, dp_acc);
    uint32_t dl[4][4];
    pack_lo(dl, dp_acc);
    wgmma_fence();
    issue_acc64(dq_acc, da, ks(s));    // dQ += dS k
    issue_acc64(dq_acc, dl, ks(s));
""")
DS_SPLIT = {"ds_split": [PACK_LO, SPLIT_DKDV, SPLIT_DQ]}
CUTS = {
    "overlap": [OVERLAP],
    "no_pingpong": [NO_PINGPONG],
    "no_softmax": [NO_SOFTMAX],
    "no_pv": [NO_PV],
    "no_products": [NO_QK, NO_PV],
    "loads_only": [NO_QK, NO_PV, NO_SOFTMAX],
    "forward_rounds": [FORWARD_ROUNDS],
    "stages_2": [STAGES_2],
    "pv_boxes": PV_BOXES,
}
# the instances' mangled names (the source instantiates D 128, 96 / 64,
# 120 / 120 and 96 / 96)
DV_KERNEL = "flash_attention_wgmma_kernelILi96ELi64ELb0E"
NEW_KERNELS = ("flash_attention_wgmma_kernelILi120ELi120ELb0E",
               "flash_attention_wgmma_kernelILi96ELi96ELb0E")


def build_cuts(against=None, cuts=CUTS) -> dict:
    """{name: (library, path)} for the real source, each copy of ``cuts``
    (name -> its substitutions) and, if given, the ``against`` source (as
    ``"against"``), built in parallel."""
    src = FA.SOURCE.read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    paths = {"full": FA.SOURCE}
    if against is not None:
        paths["against"] = Path(against).resolve()
    for name, subs in cuts.items():
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
        if name == "against":     # an older source may lack entry points
            for entry in ("flash_attention_bf16_wgmma",
                          "flash_attention_bf16_wgmma_dv"):
                fn = getattr(lib, entry, None)
                if fn is None:
                    continue
                fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
                    ctypes.c_float, ctypes.c_void_p]
                fn.restype = ctypes.c_int
        else:
            FA._bind(lib)
        libs[name] = (lib, so)
    return libs


def sass_report(so: Path, kernel: str = KERNEL) -> str:
    """Local-memory instructions, the highest register, and the wgmma
    instructions and the waits on them, of the wgmma kernel instance
    ``kernel`` in the library's SASS."""
    tool = shutil.which("cuobjdump") or str(
        Path(_build._nvcc()).parent / "cuobjdump")
    proc = subprocess.run([tool, "-sass", str(so)], capture_output=True,
                          text=True)
    if proc.returncode != 0:
        return f"cuobjdump failed: {proc.stderr.strip()[:200]}"
    text, keep = [], False
    for line in proc.stdout.splitlines():
        if "Function :" in line:
            keep = kernel in line
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


def launch(lib, q, k, v, causal=True, window=0) -> torch.Tensor:
    """One call (causal unless told otherwise) of the library's wgmma
    instance at q's and v's head dims."""
    bh, sq, dq = q.shape
    dv = v.shape[2]
    out = torch.empty((bh, sq, dv), dtype=q.dtype, device=q.device)
    fn = getattr(lib, FA.ENTRY_POINTS[FA.WGMMA_INSTANCES[(dq, dv)]])
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), bh,
             bh // k.shape[0], sq, k.shape[1], dq, dv, int(causal), window,
             dq ** -0.5, torch.cuda.current_stream().cuda_stream)
    _build.launch_check("flash_breakdown", err)
    return out


def cut_times(libs, q, k, v, reps: int, window: int = 0) -> tuple:
    """({cut: device ms}, the real kernel's device ms: a median of its
    turns between the cuts, and their range)."""
    full = lambda: launch(libs["full"][0], q, k, v,  # noqa: E731
                          window=window)
    fulls, row = [cs.graph_ms([full], reps)], {}
    for name in CUTS:
        cut = lambda lib=libs[name][0]: launch(  # noqa: E731
            lib, q, k, v, window=window)
        row[name] = cs.graph_ms([cut], reps)
        fulls.append(cs.graph_ms([full], reps))
    return row, sorted(fulls)[len(fulls) // 2], (min(fulls), max(fulls))


def key_tiles(bh: int, s: int, blocks: int, backwards: bool) -> tuple:
    """(the busiest block's key tiles, all blocks' key tiles) of a causal
    call of the wgmma kernel: 128-row items, heaviest first, heads
    fastest, dealt to ``blocks`` blocks in rounds, every other round
    backwards if ``backwards`` (the kernel's ``item_of``)."""
    qtiles = -(-s // 128)
    items = bh * qtiles
    blocks = min(blocks, items)
    load = [0] * blocks
    for n in range(-(-items // blocks)):
        for b in range(blocks):
            w = n * blocks + (blocks - 1 - b if backwards and n % 2 else b)
            if w < items:
                r0 = (qtiles - 1 - w // bh) * 128
                load[b] += -(-min(s, r0 + 128) // 128)
    return max(load), sum(load)


def mla_shape(libs, gen, dev) -> None:
    """The wgmma_dv instance at MLA's shape: the cuts, the cuda_core
    kernel (private launcher), SDPA, the bound and the exponentials'
    floor."""
    import torch.nn.functional as F
    h, s, dq, dv = 40, cs.MLA_S, 96, 64
    q = torch.randn((h, s, dq), generator=gen, device=dev).bfloat16()
    k = torch.randn((h, s, dq), generator=gen, device=dev).bfloat16()
    v = torch.randn((h, s, dv), generator=gen, device=dev).bfloat16()
    bms, by = cs.flash_bound(q, k, v, causal=True)
    floor = cs.exp_floor(q, k, causal=True)
    err = (launch(libs["full"][0], q, k, v).float()
           - FA.flash_attention_torch(q, k, v).float()).abs()
    ok = bool((err <= FA.bf16_error_bound(q, k, v)).all())
    del err
    row, full_ms, (lo, hi) = cut_times(libs, q, k, v, 20)
    old = cs.graph_ms([lambda: FA._launch(q, k, v, True, 0, None,
                                          "cuda_core")], 5)
    q4, k4, v4 = (t[None] for t in (q, k, v))
    lib_ms = cs.graph_ms([lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True)], 20)
    print(f"MLA's shape (BH {h}, S {s}, Dq {dq}, Dv {dv}, bf16, causal; "
          f"bound {bms:.4f} ms, {by}; exponentials' floor {floor:.4f} ms): "
          f"wgmma_dv {full_ms:.4f} ms (median of {len(CUTS) + 1}, range "
          f"{lo:.4f}-{hi:.4f}; {100 * bms / full_ms:.1f}% of bound; within "
          f"the bf16 bound: {ok}); cuda_core {old:.4f}; "
          f"scaled_dot_product_attention {lib_ms:.4f} (wgmma_dv / SDPA "
          f"{full_ms / lib_ms:.3f})", flush=True)
    print("  cuts (device ms): " + ", ".join(
        f"{name} {row[name]:.4f}" for name in CUTS), flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    busiest, total = key_tiles(h, s, sms, backwards=True)
    forward = key_tiles(h, s, sms, backwards=False)[0]
    mb = total * 128 * (dq + dv) * 2 / 1e6
    print(f"  key tiles on {sms} SMs: {total} in all ({mb:.1f} MB of k and "
          f"v read), the busiest block {busiest} ({forward} with every "
          f"round forwards)", flush=True)


def new_shapes(libs, gen, dev) -> None:
    """The wgmma_120 and wgmma_96 instances at their archs' layer shapes:
    the cuts, the ``pv_boxes`` alternative (held to the bf16 bound), the
    cuda_core kernel, SDPA (cuDNN's, the window as a boolean mask), the
    bound and the exponentials' floor of the pairs the mask leaves."""
    from torch.nn.attention import SDPBackend, sdpa_kernel
    for (b, h, kv, s, d, window) in ((1, 32, 8, 8192, 120, 4096),
                                     (4, 32, 32, 2048, 96, 0)):
        q = torch.randn((b * h, s, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b * kv, s, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b * kv, s, d), generator=gen, device=dev).bfloat16()
        bms, by = cs.flash_bound(q, k, v, causal=True, window=window)
        floor = cs.exp_floor(q, k, causal=True, window=window)
        want = FA.flash_attention_torch(q, k, v, window=window).float()
        bnd = FA.bf16_error_bound(q, k, v, window=window)
        ok = {n: float(((launch(libs[n][0], q, k, v, window=window).float()
                         - want).abs() / bnd).max())
              for n in ("full", "pv_boxes")}
        del want, bnd
        row, full_ms, (lo, hi) = cut_times(libs, q, k, v, 10, window)
        old = cs.graph_ms([lambda: FA._launch(q, k, v, True, window, None,
                                              "cuda_core")], 3)
        sdpa, _ = cs.sdpa_call(q, k, v, b, window)
        with sdpa_kernel([SDPBackend.CUDNN_ATTENTION]):
            lib_ms = cs.graph_ms([sdpa], 10)
        variant = FA.WGMMA_INSTANCES[(d, d)]
        print(f"{variant} (B {b} x {h} heads over {kv}, S {s}, D {d}, "
              f"window {window}, bf16, causal; bound {bms:.4f} ms, {by}; "
              f"exponentials' floor {floor:.4f} ms): full {full_ms:.4f} ms "
              f"(median of {len(CUTS) + 1}, range {lo:.4f}-{hi:.4f}; "
              f"{100 * bms / full_ms:.1f}% of bound); cuda_core {old:.4f}; "
              f"cuDNN SDPA {lib_ms:.4f} (full / SDPA "
              f"{full_ms / lib_ms:.3f}); max |err| / bf16 bound: full "
              f"{ok['full']:.3f}, pv_boxes {ok['pv_boxes']:.3f}", flush=True)
        print("  cuts (device ms): " + ", ".join(
            f"{name} {row[name]:.4f}" for name in CUTS), flush=True)
        del q, k, v, sdpa


def against_parent(libs, gen, dev) -> None:
    """The D 128 instance of the real source against the ``against``
    source's: bit for bit, and device time in turns (against, real, real,
    against)."""
    b, h, kv, d = cs.SCORE_B, 32, 8, 128
    for s in (cs.SCORE_S, cs.PROMPT):
        q = torch.randn((b * h, s, d), generator=gen, device=dev).bfloat16()
        k = torch.randn((b * kv, s, d), generator=gen, device=dev).bfloat16()
        v = torch.randn((b * kv, s, d), generator=gen, device=dev).bfloat16()
        same = torch.equal(launch(libs["against"][0], q, k, v),
                           launch(libs["full"][0], q, k, v))
        reps = 20 if s == cs.SCORE_S else 100
        times = [cs.graph_ms([lambda lib=libs[n][0]: launch(lib, q, k, v)],
                             reps)
                 for n in ("against", "full", "full", "against")]
        print(f"D 128, S {s}: this source's kernel bit for bit the "
              f"--against source's: {same}; device ms against "
              f"{times[0]:.4f} {times[3]:.4f}, this source {times[1]:.4f} "
              f"{times[2]:.4f}", flush=True)


def ds_split(libs, dev) -> None:
    """The training backward kernels of the real source and of the
    ``ds_split`` copy at olmo-1b's layer shape: device times in turns
    (full, split, split, full), what the split adds to a step, and each
    build's dq and dk against a float32 backward on 8 heads."""
    for name, (_, so) in libs.items():
        log = so.with_suffix(".log").read_text()
        for kern in ("bwd_dq_kernel", "bwd_dkdv_kernel"):
            print(f"{name} {kern}: {cs.ptxas_summary(log, kern)}",
                  flush=True)
    bh, s, d, layers = 64, 4096, 128, 16
    gen = torch.Generator(device=dev).manual_seed(6)
    q, k, v, do = (torch.randn((bh, s, d), generator=gen, device=dev)
                   .bfloat16() for _ in range(4))
    scale = d ** -0.5
    o, lse = FA._train_forward(q, k, v, scale)
    dvec = torch.empty((bh, s), dtype=torch.float32, device=dev)
    libs["full"][0].flash_attention_train_bwd_dot(
        o.data_ptr(), do.data_ptr(), dvec.data_ptr(), bh * s,
        torch.cuda.current_stream().cuda_stream)
    ins = [t.data_ptr() for t in (q, k, v, do, lse, dvec)]
    outs = {n: [torch.empty_like(q) for _ in range(3)] for n in libs}

    # on the stream current at the call (graph_ms captures on its own)
    def dq_call(n):
        return lambda: libs[n][0].flash_attention_train_dq(
            *ins, outs[n][0].data_ptr(), bh, s, scale,
            torch.cuda.current_stream().cuda_stream)

    def dkdv_call(n):
        return lambda: libs[n][0].flash_attention_train_dkdv(
            *ins, outs[n][1].data_ptr(), outs[n][2].data_ptr(), bh, s,
            scale, torch.cuda.current_stream().cuda_stream)

    times = {}
    for kern, call in (("train_dq", dq_call), ("train_dkdv", dkdv_call)):
        runs = [cs.graph_ms([call(n)], 20)
                for n in ("full", "ds_split", "ds_split", "full")]
        times[kern] = ((runs[0] + runs[3]) / 2, (runs[1] + runs[2]) / 2)
        print(f"{kern} at ({bh}, {s}, {d}) bf16 causal, device ms in turns "
              f"(full, split, split, full): "
              + " ".join(f"{r:.4f}" for r in runs), flush=True)
    for n in libs:
        dq_call(n)()
        dkdv_call(n)()
    torch.cuda.synchronize()
    extra = sum(split - full for full, split in times.values())
    print(f"the split adds {extra:.4f} ms a layer's backward, "
          f"{layers * extra:.2f} ms an olmo-1b step of {layers} layers "
          f"(dq {times['train_dq'][0]:.4f} -> {times['train_dq'][1]:.4f}, "
          f"dkdv {times['train_dkdv'][0]:.4f} -> "
          f"{times['train_dkdv'][1]:.4f})", flush=True)
    sl = slice(0, 8)
    want = FA.flash_attention_train_backward_torch(
        *(t[sl].float() for t in (q, k, v, o)), lse[sl], do[sl].float(),
        scale=scale)
    for n in libs:
        errs = []
        for name, got, w in zip(("dq", "dk", "dv"),
                                (outs[n][0], outs[n][1], outs[n][2]), want):
            err = float((got[sl].float() - w).abs().max())
            errs.append(f"{name} {err:.3e} ({err / float(w.abs().max()):.2e}"
                        f" of the largest)")
        print(f"{n}: against a float32 backward, max |err| "
              + ", ".join(errs), flush=True)


def digests(libs, dev) -> None:
    """The SHA-256 of the D 128 and wgmma_dv instances' outputs on the
    pinned cases, from the real and the ``against`` source."""
    for variant, cases in cs.PINNED_FLASH.items():
        for case in cases:
            q, k, v = cs.pinned_flash_inputs(case, dev)
            causal, window = case[5:]
            got = {n: cs.output_digest(launch(libs[n][0], q, k, v, causal,
                                              window))
                   for n in ("against", "full")}
            print(f"pinned {variant} {case}: against {got['against']}, "
                  f"this source {got['full']}, equal "
                  f"{got['against'] == got['full']}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_breakdown: no CUDA device", file=sys.stderr)
        return 1
    import argparse
    import torch.nn.functional as F
    ap = argparse.ArgumentParser()
    ap.add_argument("--against", help="another flash_attention.cu")
    ap.add_argument("--digests", action="store_true",
                    help="with --against: only the pinned outputs' digests")
    ap.add_argument("--ds-split", action="store_true",
                    help="only the training backward with dS split in two")
    args = ap.parse_args()
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    if args.digests:
        digests(build_cuts(args.against, cuts={}), dev)
        return 0
    if args.ds_split:
        ds_split(build_cuts(cuts=DS_SPLIT), dev)
        return 0
    libs = build_cuts(args.against)
    for name, (_, so) in libs.items():
        log = so.with_suffix(".log").read_text()
        # an older source's kernel may not be a template
        kerns = ((KERNEL, DV_KERNEL) if name != "against"
                 else ("flash_attention_wgmma_kernel",))
        for kern in kerns:
            print(f"{name} {kern}: {cs.ptxas_summary(log, kern)}",
                  flush=True)
        for line in log.splitlines():
            if "Performance" in line:    # ptxas' wgmma serialisation notes
                print(f"  {line.strip()}", flush=True)
    for kern in (KERNEL, DV_KERNEL) + NEW_KERNELS:
        print(f"full {kern}, SASS: {sass_report(libs['full'][1], kern)}",
              flush=True)

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
        row, full_ms, (lo, hi) = cut_times(libs, q, k, v, reps)
        old = cs.graph_ms([lambda: FA._launch(q, k, v, True, 0, None,
                                              "mma_sync")], reps)
        q4, k4, v4 = (t.view(b, t.shape[0] // b, s, d) for t in (q, k, v))
        lib_ms = cs.graph_ms([lambda: F.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)], reps)
        print(f"S {s} (BH {b * h}/{b * kv}, D {d}, bf16, causal; bound "
              f"{bms:.4f} ms, {by}): full {full_ms:.4f} ms (median of "
              f"{len(CUTS) + 1}, range {lo:.4f}-{hi:.4f}; "
              f"{100 * bms / full_ms:.1f}% of bound)"
              f"; mma.sync {old:.4f}; scaled_dot_product_attention "
              f"{lib_ms:.4f} (full / SDPA {full_ms / lib_ms:.3f})",
              flush=True)
        print("  cuts (device ms): " + ", ".join(
            f"{name} {row[name]:.4f}" for name in CUTS)
            + f"; the overlap kernel within the bf16 bound: {ok}", flush=True)
        del q, k, v, q4, k4, v4
    mla_shape(libs, gen, dev)
    new_shapes(libs, gen, dev)
    if args.against:
        against_parent(libs, gen, dev)
    print(cs.card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
