"""Mamba-1 selective scan: the hand-written Hopper kernel in
``csrc/selective_scan.cu`` and its plain PyTorch version.

Replaces the Pallas TPU kernel ``src/repro/kernels/selective_scan.py:29``
(``selective_scan_kernel``, reached through ``selective_scan_pallas`` and
``ops.selective_scan``)::

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t        h_0 = 0
    y_t = h_t . C_t + D * x_t

x, dt (B, S, D); B, C (B, S, N); A (D, N); D (D,) -> y (B, S, D), all
float32.  ``selective_scan_state`` starts from a given state h_0 (B, D, N)
and returns the last, h_S, beside y: a prefill into a cache.

Bound on the H100: one exponential per (step, channel, state), computed
by the special-function units at 16 per clock per SM, against one read of x
and dt and one write of y.  The kernel source explains the design.

Dispatch: a CUDA tensor launches a kernel or raises — there is no
fallback; only CPU tensors take the plain version.  Which kernel runs, and
how it is cut, is decided by ``plan`` from the shape and the pointers'
alignment alone:

* ``"ring"``: D % 4 == 0 and x, dt 16-byte aligned (what TMA can take; y
  is allocated aligned) — each channel's states split over ``lanes``
  lanes, x and dt (and y) moved by TMA through an asynchronous ring of
  ``stages`` tiles of ``steps`` steps (the LM path: jamba's and
  falcon-mamba's mamba layers);
* ``"pr12"``: everything else — the first port's kernel, one thread per
  channel.  The private ``_launch(..., "pr12")`` also reaches it on
  aligned inputs, as the yardstick timed beside the ring kernel;
* ``"ring_state"``: ``selective_scan_state``'s kernel, the ring kernel
  reading h_0 and writing h_S (the lanes ``plan`` would take; x and dt
  copied once where they are misaligned; D % 4 == 0).

``LAUNCHES`` counts every launch, ``VARIANT_LAUNCHES`` the launches of
each kernel, ``PLAIN_CALLS`` the plain version's calls.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, NamedTuple, Tuple, Union

import torch

from . import _build

__all__ = ["LAUNCHES", "PLAIN_CALLS", "VARIANT_LAUNCHES", "VARIANTS", "Plan",
           "plan", "ring_plan", "busiest_sm_channels", "padded_states",
           "ring_smem_bytes", "reset_counts", "selective_scan",
           "selective_scan_torch", "selective_scan_state",
           "selective_scan_state_torch", "build"]

MAX_STATE = 16         # the largest d_state of a ported config

VARIANTS = ("ring", "pr12", "ring_state")
LAUNCHES: Dict[str, int] = {"selective_scan": 0}
VARIANT_LAUNCHES: Dict[str, int] = {v: 0 for v in VARIANTS}
PLAIN_CALLS: Dict[str, int] = {"selective_scan": 0}

SOURCE = _build.CSRC / "selective_scan.cu"
H100_SMS = 132
# the ring kernel's constants (csrc/selective_scan.cu, namespace ring)
RING_CONSUMERS = 128   # consumer threads a block (+ one producer warp)
RING_STEPS = 16        # steps a ring tile
RING_LANES = (1, 2, 4, 8)   # the instances the library has
PLAN_LANES = (1, 2, 4)      # those ``plan`` picks from
# the pr12 kernel's: a thread a channel, B and C staged 64 steps at a time
PR12_CHANNELS, PR12_STEPS = 128, 64
MAX_GRID_Y = 65535


class Plan(NamedTuple):
    """Which kernel scans a (batch, S, D) x N problem, and how: ``lanes``
    lanes hold one channel's states, a block takes ``channels`` channels
    and its ring ``stages`` tiles of ``steps`` steps (pr12: B and C staged
    ``steps`` at a time, no ring), ``grid`` is (channel tiles, batch)."""
    variant: str
    lanes: int
    channels: int
    steps: int
    stages: int
    grid: Tuple[int, int]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def padded_states(n: int) -> int:
    """The state slots a channel holds for ``n`` states: 4, 8 or 16."""
    return 4 if n <= 4 else (8 if n <= 8 else 16)


def ring_stages(lanes: int) -> int:
    """Ring tiles a block of the ring kernel keeps (fewer where more
    blocks share an SM)."""
    return 4 if lanes <= 2 else 3


def ring_smem_bytes(lanes: int, n: int) -> int:
    """Dynamic shared memory of a ring block (the kernel's ``Cfg::SMEM``,
    checked against the library on the card): per stage an x and a dt tile
    (steps x channels) and a B and a C tile (steps x padded N), two y tiles
    per consumer warp, two mbarriers per stage, 128 bytes of alignment."""
    np_, stages = padded_states(n), ring_stages(lanes)
    channels = RING_CONSUMERS // lanes
    xt, bt = RING_STEPS * channels * 4, RING_STEPS * np_ * 4
    yt = RING_STEPS * (32 // lanes) * 4
    return stages * (2 * xt + 2 * bt) + 4 * 2 * yt + 16 * stages + 128


def plan(batch: int, s: int, d: int, n: int, aligned: bool, *,
         sms: int = H100_SMS) -> Plan:
    """The kernel for a scan of ``batch`` x ``s`` steps x ``d`` channels
    with ``n`` states on a card with ``sms`` SMs; ``aligned``: x and dt
    start on 16-byte boundaries.  Shape and alignment decide, nothing
    else."""
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: the kernels take 1 <= N <= "
                         f"{MAX_STATE}, got {n}")
    if not aligned or d % 4:
        return Plan("pr12", 1, PR12_CHANNELS, PR12_STEPS, 1,
                    (_cdiv(d, PR12_CHANNELS), batch))
    # the recurrence cannot be split across SMs, so the busiest SM's
    # channels set the time: take the lanes that put the fewest channels
    # on it (blocks spread evenly over the SMs), and of those the fewest
    # lanes -- each lane more adds shuffles and shared loads to every
    # (step, state) (tools/scan_breakdown.py sweeps the lanes at jamba's
    # two shapes)
    choices = [lanes for lanes in PLAN_LANES if lanes <= padded_states(n)]
    lanes = min(choices, key=lambda lanes: (
        busiest_sm_channels(batch, d, lanes, sms), lanes))
    return ring_plan(batch, d, lanes)


def busiest_sm_channels(batch: int, d: int, lanes: int,
                        sms: int = H100_SMS) -> int:
    """Channels on the busiest SM when the ring kernel's blocks of
    ``lanes`` lanes a channel are spread evenly over ``sms`` SMs."""
    channels = RING_CONSUMERS // lanes
    return _cdiv(_cdiv(d, channels) * batch, sms) * channels


def ring_plan(batch: int, d: int, lanes: int) -> Plan:
    """The ring kernel's plan with ``lanes`` lanes a channel (for timing
    scripts that sweep it; ``plan`` picks the lanes itself)."""
    if lanes not in RING_LANES:
        raise ValueError(f"selective_scan: the ring kernel has lanes "
                         f"{RING_LANES}, not {lanes}")
    channels = RING_CONSUMERS // lanes
    return Plan("ring", lanes, channels, RING_STEPS, ring_stages(lanes),
                (_cdiv(d, channels), batch))


def reset_counts() -> None:
    """Zero the launch, per-kernel and plain-call counters."""
    for counts in (LAUNCHES, VARIANT_LAUNCHES, PLAIN_CALLS):
        for k in counts:
            counts[k] = 0


def _aligned16(*tensors: torch.Tensor) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_shapes(x, dt, b, c, a, d, h0=None) -> None:
    if x.dim() != 3:
        raise ValueError(f"selective_scan: x must be (B, S, D), got "
                         f"{tuple(x.shape)}")
    bsz, s, dm = x.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    want = {"dt": (bsz, s, dm), "b": (bsz, s, n), "c": (bsz, s, n),
            "a": (dm, n), "d": (dm,), "h0": (bsz, dm, n)}
    got = {"dt": dt, "b": b, "c": c, "a": a, "d": d}
    if h0 is not None:
        got["h0"] = h0
    bad = {k: tuple(t.shape) for k, t in got.items()
           if tuple(t.shape) != want[k]}
    if n < 1 or bad:
        raise ValueError(f"selective_scan: x {tuple(x.shape)} wants dt, b, "
                         f"c, a, d of shapes {want}; got {bad}")


def _plain(x, dt, b, c, a, d, h0) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y, h_S) of the per-step recurrence from h0 (zeros where None)."""
    x, dt, b, c, a, d = (t.float() for t in (x, dt, b, c, a, d))
    bsz, s, dm = x.shape
    h = (torch.zeros((bsz, dm, a.shape[1]), dtype=torch.float32,
                     device=x.device) if h0 is None else h0.float())
    ys = []
    for t in range(s):
        dA = torch.exp(dt[:, t, :, None] * a[None])
        h = dA * h + (dt[:, t] * x[:, t])[:, :, None] * b[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, c[:, t]) + d[None] * x[:, t])
    if not ys:
        return torch.zeros_like(x), h.clone()
    return torch.stack(ys, dim=1), h


def selective_scan_torch(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, a: torch.Tensor,
                         d: torch.Tensor) -> torch.Tensor:
    """The per-step recurrence of ``ref.selective_scan_ref``, in float32."""
    _check_shapes(x, dt, b, c, a, d)
    return _plain(x, dt, b, c, a, d, None)[0]


def selective_scan_state_torch(x: torch.Tensor, dt: torch.Tensor,
                               b: torch.Tensor, c: torch.Tensor,
                               a: torch.Tensor, d: torch.Tensor,
                               h0: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same recurrence from the state h0 (B, D, N): (y, h_S), float32
    (h_S a new tensor)."""
    _check_shapes(x, dt, b, c, a, d, h0)
    return _plain(x, dt, b, c, a, d, h0)


def build() -> Path:
    """Compile ``csrc/selective_scan.cu`` (see ``_build.build``)."""
    return _build.build(SOURCE)


def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.selective_scan_f32.argtypes = [p, p, p, p, p, p, p, i, i, i, i, p]
    lib.selective_scan_f32.restype = i
    lib.selective_scan_f32_ring.argtypes = [p, p, p, p, p, p, p, i, i, i, i,
                                            i, p]
    lib.selective_scan_f32_ring.restype = i
    lib.selective_scan_f32_ring_state.argtypes = [p, p, p, p, p, p, p, p, p,
                                                  i, i, i, i, i, p]
    lib.selective_scan_f32_ring_state.restype = i
    lib.selective_scan_ring_smem_bytes.argtypes = [i, i]
    lib.selective_scan_ring_smem_bytes.restype = i
    lib.selective_scan_ring_steps.argtypes = []
    lib.selective_scan_ring_steps.restype = i


def selective_scan(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, a: torch.Tensor,
                   d: torch.Tensor) -> torch.Tensor:
    """y (B, S, D) float32.  CUDA tensors launch the kernel ``plan`` picks
    (float32, contiguous, one device, N <= 16); CPU tensors take
    ``selective_scan_torch``."""
    _check_shapes(x, dt, b, c, a, d)
    ts = (x, dt, b, c, a, d)
    if all(t.device.type == "cpu" for t in ts):
        PLAIN_CALLS["selective_scan"] += 1
        return selective_scan_torch(*ts)
    _check_card(ts)
    bsz, s, dm = x.shape
    return _launch(x, dt, b, c, a, d,
                   plan(bsz, s, dm, a.shape[1], _aligned16(x, dt)))


def selective_scan_state(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
                         c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
                         h0: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(y (B, S, D), h_S (B, D, N)), float32, from the state h0 (B, D, N):
    a prefill into a cache.  CUDA tensors launch the ``ring_state`` kernel
    (D % 4 == 0, otherwise as ``selective_scan``); CPU tensors take
    ``selective_scan_state_torch``.  h0 is read, not written."""
    _check_shapes(x, dt, b, c, a, d, h0)
    ts = (x, dt, b, c, a, d, h0)
    if all(t.device.type == "cpu" for t in ts):
        PLAIN_CALLS["selective_scan"] += 1
        return selective_scan_state_torch(*ts)
    _check_card(ts)
    bsz, s, dm = x.shape
    if dm % 4:
        raise ValueError(f"selective_scan_state: the kernel takes D % 4 == "
                         f"0, got D={dm}")
    if not _aligned16(x, dt):       # TMA's alignment: one aligned copy
        x, dt = x.clone(), dt.clone()
    p = plan(bsz, s, dm, a.shape[1], True)
    return _launch_state(x, dt, b, c, a, d, h0, p.lanes)


def _check_card(ts) -> None:
    """The kernels' conditions on CUDA tensors: one device, float32,
    contiguous, N <= MAX_STATE, batch <= MAX_GRID_Y."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"selective_scan: unsupported device {dev}")
    for t in ts:
        if t.device != dev:
            raise ValueError("selective_scan: tensors on different devices")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan: expects float32, got "
                            f"{t.dtype}")
        if not t.is_contiguous():
            raise ValueError("selective_scan: expects contiguous tensors")
    bsz, n = ts[0].shape[0], ts[4].shape[1]
    if n > MAX_STATE or bsz > MAX_GRID_Y:
        raise ValueError(f"selective_scan: the kernel takes N <= "
                         f"{MAX_STATE} and B <= {MAX_GRID_Y}, got N={n}, "
                         f"B={bsz}")


def _launch_state(x, dt, b, c, a, d, h0, lanes: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the ``ring_state`` kernel at ``lanes`` lanes on checked CUDA
    tensors (x, dt 16-byte aligned, D % 4 == 0)."""
    bsz, s, dm = x.shape
    y = torch.empty_like(x)
    h = torch.empty_like(h0)
    if y.numel() == 0:
        return y, h.copy_(h0)
    lib = _build.load(SOURCE, _bind)
    ptrs = [t.data_ptr() for t in (x, dt, b, c, a, d, y, h0, h)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.selective_scan_f32_ring_state(*ptrs, bsz, s, dm,
                                                a.shape[1], lanes, stream)
    _build.launch_check("selective_scan (ring_state)", err)
    LAUNCHES["selective_scan"] += 1
    VARIANT_LAUNCHES["ring_state"] += 1
    return y, h


def _launch(x: torch.Tensor, dt: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, a: torch.Tensor, d: torch.Tensor,
            p: Union[Plan, str]) -> torch.Tensor:
    """Launch the kernel of plan ``p`` on checked CUDA tensors.  Private:
    ``selective_scan`` passes its own plan; timing scripts and the card
    tests pass ``"pr12"`` (that kernel's plan) or a ``ring_plan`` with
    other lanes to run them on the same inputs."""
    bsz, s, dm = x.shape
    n = a.shape[1]
    if p == "pr12":
        p = plan(bsz, s, dm, n, False)
    if p.variant == "ring" and (dm % 4 or not _aligned16(x, dt)):
        raise ValueError("selective_scan: the ring kernel takes D % 4 == 0 "
                         "and 16-byte aligned x and dt")
    y = torch.empty_like(x)
    if y.numel() == 0:
        return y
    lib = _build.load(SOURCE, _bind)
    ptrs = [t.data_ptr() for t in (x, dt, b, c, a, d, y)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.variant == "ring":
            err = lib.selective_scan_f32_ring(*ptrs, bsz, s, dm, n, p.lanes,
                                              stream)
        else:
            err = lib.selective_scan_f32(*ptrs, bsz, s, dm, n, stream)
    _build.launch_check(f"selective_scan ({p.variant})", err)
    LAUNCHES["selective_scan"] += 1
    VARIANT_LAUNCHES[p.variant] += 1
    return y
