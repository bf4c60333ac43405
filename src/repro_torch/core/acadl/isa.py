"""Instruction builders for the scalar and fused-tensor abstraction levels.

The scalar ISA follows the OMA example (paper Listing 5): ``mov``, ``addi``,
``add``, ``mac``, ``load``, ``store``, ``beqi``, ``jumpi``.  Branch offsets
are given in *instruction counts* relative to the next instruction (the
paper's listing uses byte offsets of 4-byte words; we normalize to
instruction indices to keep programs self-contained).

The fused-tensor ISA follows the Γ̈ example (paper Listing 4): ``t_load``,
``t_store``, ``t_gemm`` (with optional activation), ``t_add``, plus the
beyond-paper ``t_scan`` (chunked SSM recurrence) and ``t_attn`` (fused
attention tile) used by the operator-mapping layer for modern workloads.
Tensor instructions read/write *vector registers* (named ``r[<u>].<i>`` in
the paper) holding numpy arrays as payloads.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np

from .base import ExecutionEnv, Instruction

__all__ = [
    "mov", "movi", "addi", "add", "sub", "muli", "mac", "load", "store",
    "beqi", "bnei", "jumpi", "halt",
    "t_load", "t_store", "t_gemm", "t_add", "t_scan", "t_attn",
]


# ---------------------------------------------------------------------------
# scalar level (OMA)
# ---------------------------------------------------------------------------


def movi(dst: str, imm: Any) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, ins.immediates[0])
    return Instruction("mov", (), (dst,), immediates=(imm,), function=fn)


def mov(dst: str, src: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_reg(src))
    return Instruction("mov", (src,), (dst,), function=fn)


def addi(dst: str, src: str, imm: int) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_reg(src) + ins.immediates[0])
    return Instruction("addi", (src,), (dst,), immediates=(imm,), function=fn)


def add(dst: str, a: str, b: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_reg(a) + env.read_reg(b))
    return Instruction("add", (a, b), (dst,), function=fn)


def sub(dst: str, a: str, b: str) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_reg(a) - env.read_reg(b))
    return Instruction("sub", (a, b), (dst,), function=fn)


def muli(dst: str, src: str, imm: Any) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(dst, env.read_reg(src) * ins.immediates[0])
    return Instruction("muli", (src,), (dst,), immediates=(imm,), function=fn)


def mac(acc: str, a: str, b: str) -> Instruction:
    """Multiply-accumulate: acc += a * b (the OMA's built-in MAC)."""
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg(acc, env.read_reg(acc) + env.read_reg(a) * env.read_reg(b))
    return Instruction("mac", (a, b, acc), (acc,), function=fn)


def load(dst: str, addr: Any) -> Instruction:
    """``load [addr] => dst``; ``addr`` is an int or ``("reg", name)``."""
    reads = (addr[1],) if isinstance(addr, tuple) else ()

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        a = env.read_reg(addr[1]) if isinstance(addr, tuple) else addr
        env.write_reg(dst, env.read_mem(int(a)))
    return Instruction("load", reads, (dst,), read_addresses=(addr,), function=fn)


def store(src: str, addr: Any) -> Instruction:
    """``store src => [addr]``."""
    reads = (src,) + ((addr[1],) if isinstance(addr, tuple) else ())

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        a = env.read_reg(addr[1]) if isinstance(addr, tuple) else addr
        env.write_mem(int(a), env.read_reg(src))
    return Instruction("store", reads, (), write_addresses=(addr,), function=fn)


def beqi(src: str, imm: Any, offset: int) -> Instruction:
    """Branch if ``src == imm``: pc += offset (in instructions, relative to
    the *next* instruction).  Writes the ``pc`` register."""
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        if env.read_reg(src) == ins.immediates[0]:
            env.write_reg("pc", env.read_reg("__pc_next__") + ins.immediates[1])
    return Instruction("beqi", (src,), ("pc",), immediates=(imm, offset), function=_pc_rel(fn))


def bnei(src: str, imm: Any, offset: int) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        if env.read_reg(src) != ins.immediates[0]:
            env.write_reg("pc", env.read_reg("__pc_next__") + ins.immediates[1])
    return Instruction("bnei", (src,), ("pc",), immediates=(imm, offset), function=_pc_rel(fn))


def jumpi(offset: int) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg("pc", env.read_reg("__pc_next__") + ins.immediates[0])
    return Instruction("jumpi", (), ("pc",), immediates=(offset,), function=_pc_rel(fn))


def halt() -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_reg("pc", -2)  # jump out of the program
    return Instruction("halt", (), ("pc",), function=fn)


def _pc_rel(fn):
    """Wrap a branch function so it can read the fall-through pc.

    ``build_trace`` executes instructions knowing the next pc; we expose it
    through a pseudo-register resolved by the wrapper closure at trace time.
    The wrapper intercepts reads of ``__pc_next__``.
    """
    def wrapped(env: ExecutionEnv, ins: Instruction) -> None:
        next_holder = {}

        def read_reg(name: str):
            if name == "__pc_next__":
                return next_holder["v"]
            return env.read_reg(name)

        # the trace builder stores the fall-through index on the instruction
        next_holder["v"] = ins.tags.get("_pc_next", 0)
        inner_env = ExecutionEnv(read_reg, env.write_reg, env.read_mem, env.write_mem)
        fn(inner_env, ins)
    return wrapped


# ---------------------------------------------------------------------------
# fused-tensor level (Γ̈)
# ---------------------------------------------------------------------------


def t_load(dst: str, addr: int, shape: Tuple[int, ...], unit: Optional[str] = None) -> Instruction:
    """Load a tensor tile from ``addr`` into vector register ``dst``."""
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        v = env.read_mem(addr)
        if not isinstance(v, np.ndarray):
            v = None  # abstract tile: timing-only simulation (workloads)
        env.write_reg(dst, v)
    words = int(np.prod(shape))
    return Instruction("t_load", (), (dst,), read_addresses=(addr,), function=fn,
                       unit_hint=unit, tags={"words": words, "shape": shape})


def t_store(src: str, addr: int, shape: Tuple[int, ...] = (), unit: Optional[str] = None) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        env.write_mem(addr, env.read_reg(src))
    words = int(np.prod(shape)) if shape else 1
    return Instruction("t_store", (src,), (), write_addresses=(addr,), function=fn,
                       unit_hint=unit, tags={"words": words, "shape": shape})


def t_gemm(dst: str, a: str, b: str, activation: int = 0, acc: Optional[str] = None,
           unit: Optional[str] = None, tile: Tuple[int, int, int] = (8, 8, 8)) -> Instruction:
    """Fused GeMM tile: dst = act(a @ b [+ acc]); activation 1 = ReLU
    (paper Listing 4's trailing ``1: ReLU`` parameter).  ``tile`` = (m, k, n)
    tile extents; macs = m*k*n drives latency functions of compute units."""
    reads = (a, b) + ((acc,) if acc else ())

    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        va, vb = env.read_reg(a), env.read_reg(b)
        if va is None or vb is None:
            env.write_reg(dst, None)  # abstract tile (timing-only)
            return
        out = np.asarray(va) @ np.asarray(vb)
        if acc:
            out = out + np.asarray(env.read_reg(acc))
        if activation == 1:
            out = np.maximum(out, 0)
        env.write_reg(dst, out)
    m, k, n = tile
    return Instruction("gemm", reads, (dst,), immediates=(activation,), function=fn,
                       unit_hint=unit,
                       tags={"words": m * n, "macs": m * k * n, "tile": tile})


def t_add(dst: str, a: str, b: str, unit: Optional[str] = None,
          words: int = 64) -> Instruction:
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        va, vb = env.read_reg(a), env.read_reg(b)
        if va is None or vb is None:
            env.write_reg(dst, None)
            return
        env.write_reg(dst, np.asarray(va) + np.asarray(vb))
    return Instruction("matadd", (a, b), (dst,), function=fn, unit_hint=unit,
                       tags={"words": words, "macs": words})


def t_scan(dst: str, state: str, x: str, decay: str, unit: Optional[str] = None,
           words: int = 64) -> Instruction:
    """Beyond-paper fused-tensor op: chunked linear recurrence
    ``state = decay * state + x`` (SSM/Mamba chunk), enabling ACADL modeling
    of attention-free architectures (DESIGN.md §Arch-applicability)."""
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        s = env.read_reg(state)
        d_ = env.read_reg(decay)
        xx = env.read_reg(x)
        if s is None or d_ is None or xx is None:
            env.write_reg(dst, None)
            return
        env.write_reg(dst, np.asarray(d_) * np.asarray(s) + np.asarray(xx))
    return Instruction("scan", (state, x, decay), (dst,), function=fn, unit_hint=unit,
                       tags={"words": words, "macs": 2 * words})


def t_attn(dst: str, q: str, k: str, v: str, unit: Optional[str] = None,
           tile: Tuple[int, int, int] = (8, 8, 8)) -> Instruction:
    """Beyond-paper fused attention tile: dst = softmax(q k^T) v.
    ``tile`` = (q_len, kv_len, head_dim)."""
    def fn(env: ExecutionEnv, ins: Instruction) -> None:
        vals = [env.read_reg(r) for r in (q, k, v)]
        if any(x is None for x in vals):
            env.write_reg(dst, None)
            return
        Q, K, V = (np.asarray(x) for x in vals)
        s = Q @ K.T / np.sqrt(Q.shape[-1])
        s = s - s.max(axis=-1, keepdims=True)
        p = np.exp(s)
        p /= p.sum(axis=-1, keepdims=True)
        env.write_reg(dst, p @ V)
    tq, tk, hd = tile
    return Instruction("attn", (q, k, v), (dst,), function=fn, unit_hint=unit,
                       tags={"words": tq * hd, "macs": 2 * tq * tk * hd, "tile": tile})
