"""Cycle-accurate event-driven timing simulation (paper §6).

Semantics implemented:

* every latency-bearing object gets a counter ``t`` and a ``ready`` flag; the
  global simulation time ``T`` advances in whole clock cycles and all state
  transitions occur at cycle boundaries;
* the InstructionFetchStage fetches ``port_width`` instructions per
  transaction through its InstructionMemoryAccessUnit, stalls while the issue
  buffer lacks space, and forwards multiple instructions *out-of-order* (per
  target stage, FIFO within a target) in the same cycle (Fig. 9);
* an ExecuteStage hands a supported instruction to the contained
  FunctionalUnit and is busy until processing finishes (its own latency is
  not accumulated); otherwise it buffers the instruction ``latency`` cycles
  and forwards it to a ready connected stage — busy stages model structural
  hazards (Fig. 10);
* a FunctionalUnit/MemoryAccessUnit starts its ``latency`` countdown only
  after all previous in-order instructions modifying its accessed registers
  and addresses have finished — tracked through a global last-writer map
  built in program order (Fig. 11);
* DataStorages service up to ``max_concurrent_requests`` transactions, each
  request slot with its own counter; excess requests queue FIFO
  (Figs. 12/13).  DRAM row-buffer state and cache hit/miss state resolve
  latencies per access.

Functional simulation strategy: instructions are functionally executed *in
program order at fetch time* (trace construction), which resolves
register-indirect addresses, control flow and stateful memory latencies
deterministically; the timing simulation then replays the trace.  This is
exactly the AIDG trace discipline of the paper's fast path [16] and is
equivalent to execute-at-process for programs whose functional behaviour is
timing-independent (data races are excluded by the dependency semantics).
Branch handling: an in-flight pc-writing instruction blocks further fetch
(the fetch unit reads ``pc``), yielding a deterministic branch bubble; a
pc-writer also terminates its fetch group.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from .base import ExecutionEnv, Instruction
from .graph import ArchitectureGraph
from .pipeline import ExecuteStage, InstructionFetchStage, PipelineStage
from .storage import DataStorage, RegisterFile
from .units import FunctionalUnit, MemoryAccessUnit

__all__ = ["TraceEntry", "build_trace", "EventSimulator", "SimResult", "simulate"]

PC = "pc"


# ---------------------------------------------------------------------------
# Trace construction (functional pre-execution in program order)
# ---------------------------------------------------------------------------


@dataclass
class TraceEntry:
    idx: int                      # dynamic program-order index
    instr: Instruction
    deps: Tuple[int, ...]         # indices of RAW/WAW predecessors
    mem_latency: int              # total storage cycles (sum of mem_parts)
    route: Tuple[str, ...]        # pipeline stages after the fetch stage
    fu_name: Optional[str]        # executing FunctionalUnit (None = pass-through)
    is_pc_writer: bool = False
    # per-access storage charges: (storage name, latency) — each access
    # occupies a request slot of *its own* storage (paper Figs. 12/13)
    mem_parts: Tuple[Tuple[str, int], ...] = ()


class _FunctionalMachine:
    """Sequential functional executor over an AG (program order)."""

    def __init__(self, ag: ArchitectureGraph):
        self.ag = ag
        self.rfs: List[RegisterFile] = ag.of_type(RegisterFile)

    def _rf_for(self, reg: str) -> RegisterFile:
        for rf in self.rfs:
            if rf.has(reg):
                return rf
        raise KeyError(f"no RegisterFile holds register {reg!r}")

    def read_reg(self, reg: str) -> Any:
        return self._rf_for(reg).read(reg)

    def write_reg(self, reg: str, value: Any) -> None:
        self._rf_for(reg).write(reg, value)


def _resolve_addresses(addrs: Sequence[Any], machine: _FunctionalMachine) -> Tuple[int, ...]:
    out = []
    for a in addrs:
        if isinstance(a, tuple) and len(a) == 2 and a[0] == "reg":
            out.append(int(machine.read_reg(a[1])))
        else:
            out.append(int(a))
    return tuple(out)


def _find_unit_and_route(ag: ArchitectureGraph, fetch: InstructionFetchStage,
                         instr: Instruction) -> Tuple[Tuple[str, ...], Optional[str]]:
    """BFS the FORWARD graph from the fetch stage to a stage whose contained
    FunctionalUnit supports the instruction.  Deterministic: AG order."""
    frontier: deque = deque((t, (t.name,)) for t in fetch.forward_targets)
    seen: Set[str] = set()
    fallback: Optional[Tuple[Tuple[str, ...], None]] = None
    while frontier:
        stage, path = frontier.popleft()
        if stage.name in seen:
            continue
        seen.add(stage.name)
        if isinstance(stage, ExecuteStage):
            fu = stage.unit_for(instr)
            if fu is not None:
                return path, fu.name
        if fallback is None and not stage.forward_targets:
            fallback = (path, None)
        for t in stage.forward_targets:
            frontier.append((t, path + (t.name,)))
    if fallback is not None:
        return fallback
    raise LookupError(
        f"no FunctionalUnit reachable from {fetch.name!r} supports {instr!r} "
        f"(operation {instr.operation!r}, unit_hint={instr.unit_hint!r})"
    )


def build_trace(ag: ArchitectureGraph, program: Sequence[Instruction],
                entry: int = 0, max_instructions: int = 1_000_000) -> List[TraceEntry]:
    """Functionally execute ``program`` and emit the dynamic trace.

    ``program`` is addressed by instruction index; control flow works through
    the ``pc`` register semantics: a pc-writing instruction's function sets
    the next instruction index via ``env.write_reg("pc", target_idx)``.
    """
    ag.timing_reset()
    machine = _FunctionalMachine(ag)
    fetch_stages = ag.fetch_stages
    if not fetch_stages:
        raise ValueError("AG has no InstructionFetchStage")
    fetch = fetch_stages[0]
    route_cache: Dict[Any, Tuple[Tuple[str, ...], Optional[str]]] = {}

    # last-writer map in program order: resource key -> trace idx
    last_writer: Dict[Any, int] = {}
    trace: List[TraceEntry] = []
    pc = entry
    steps = 0
    while 0 <= pc < len(program):
        steps += 1
        if steps > max_instructions:
            raise RuntimeError(f"trace exceeded {max_instructions} instructions — runaway loop?")
        instr = program[pc]
        idx = len(trace)

        raddrs = _resolve_addresses(instr.read_addresses, machine)
        waddrs = _resolve_addresses(instr.write_addresses, machine)

        # ---- dependencies: RAW on reads, WAW on writes (paper Fig. 11) ----
        deps: Set[int] = set()
        for reg in instr.read_registers:
            if ("r", reg) in last_writer:
                deps.add(last_writer[("r", reg)])
        for reg in instr.write_registers:
            if ("r", reg) in last_writer:
                deps.add(last_writer[("r", reg)])
        for a in raddrs:
            if ("m", a) in last_writer:
                deps.add(last_writer[("m", a)])
        for a in waddrs:
            if ("m", a) in last_writer:
                deps.add(last_writer[("m", a)])

        rkey = (instr.operation, instr.unit_hint,
                instr.read_registers, instr.write_registers)
        if rkey not in route_cache:
            route_cache[rkey] = _find_unit_and_route(ag, fetch, instr)
        route, fu_name = route_cache[rkey]

        # ---- memory latency (program-order stateful resolution) ----
        mem_parts: List[Tuple[str, int]] = []
        words = int(instr.tags.get("words", 1))
        if fu_name is not None:
            fu = ag.by_name[fu_name]
            if isinstance(fu, MemoryAccessUnit):
                for a in raddrs:
                    for st in fu.storage_chain("read", a):
                        mem_parts.append((st.name, st.access_latency("read", a, words)))
                for a in waddrs:
                    for st in fu.storage_chain("write", a):
                        mem_parts.append((st.name, st.access_latency("write", a, words)))
        mem_lat = sum(l for _, l in mem_parts)

        is_pc_writer = PC in instr.write_registers

        # ---- functional execution (sequential) ----
        next_pc = pc + 1
        instr.tags["_pc_next"] = next_pc  # fall-through index for branches
        if instr.function is not None:
            executed_pc: Dict[str, int] = {}

            def write_reg(reg: str, value: Any) -> None:
                if reg == PC:
                    executed_pc["pc"] = int(value)
                else:
                    machine.write_reg(reg, value)

            fu_obj = ag.by_name[fu_name] if fu_name else None
            if isinstance(fu_obj, MemoryAccessUnit):
                env = ExecutionEnv(machine.read_reg, write_reg,
                                   fu_obj._read_mem, fu_obj._write_mem)
            else:
                def no_mem(*a: Any) -> Any:
                    raise TypeError(f"{instr!r} accesses memory but runs on a non-memory unit")
                env = ExecutionEnv(machine.read_reg, write_reg, no_mem, no_mem)
            instr.execute(env)
            if "pc" in executed_pc:
                next_pc = executed_pc["pc"]

        # ---- update last-writer map ----
        for reg in instr.write_registers:
            if reg != PC:
                last_writer[("r", reg)] = idx
        for a in waddrs:
            last_writer[("m", a)] = idx

        trace.append(TraceEntry(idx, instr, tuple(sorted(deps)), mem_lat, route,
                                fu_name, is_pc_writer, tuple(mem_parts)))
        pc = next_pc
    return trace


# ---------------------------------------------------------------------------
# Event-driven timing simulation over the trace
# ---------------------------------------------------------------------------


@dataclass
class SimResult:
    cycles: int
    issue_time: List[int]      # cycle at which the instruction left the issue buffer
    start_time: List[int]      # cycle at which FU processing began
    complete_time: List[int]   # cycle at which the instruction finished
    stats: Dict[str, Any] = field(default_factory=dict)

    @property
    def n_instructions(self) -> int:
        return len(self.complete_time)


class _StorageTiming:
    """Request-slot + FIFO timing for a DataStorage (Figs. 12/13)."""

    def __init__(self, storage: DataStorage):
        self.storage = storage
        self.slots: List[int] = [0] * max(1, storage.max_concurrent_requests)

    def service(self, at: int, latency: int) -> int:
        """Earliest completion of a request arriving at cycle ``at``:
        earliest-free slot (FIFO overflow queue semantics)."""
        i = min(range(len(self.slots)), key=lambda k: self.slots[k])
        begin = max(at, self.slots[i])
        done = begin + latency
        self.slots[i] = done
        return done

    def next_free(self) -> int:
        return min(self.slots)


class EventSimulator:
    """Replays a trace against the AG with cycle-accurate stage timing."""

    def __init__(self, ag: ArchitectureGraph, trace: Sequence[TraceEntry]):
        self.ag = ag
        self.trace = list(trace)
        fetches = ag.fetch_stages
        if not fetches:
            raise ValueError("AG has no InstructionFetchStage")
        self.fetch = fetches[0]
        imau = self.fetch.imau
        assert imau is not None and imau.instruction_memory is not None
        self.imem = imau.instruction_memory
        self.imau_latency = imau.latency.resolve()

    def run(self, max_cycles: int = 10_000_000) -> SimResult:
        trace = self.trace
        n = len(trace)
        issue_t = [-1] * n
        start_t = [-1] * n
        complete_t = [-1] * n
        if n == 0:
            return SimResult(0, issue_t, start_t, complete_t)

        port_width = max(1, self.imem.port_width)
        ibs = max(1, self.fetch.issue_buffer_size)
        imem_read_lat = self.imem.access_latency("read", 0)
        fetch_cost = max(1, imem_read_lat + self.imau_latency)

        # --- fetch groups: consecutive trace entries; a pc-writer ends its group ---
        groups: List[List[int]] = []
        cur: List[int] = []
        for e in trace:
            cur.append(e.idx)
            if len(cur) >= port_width or e.is_pc_writer:
                groups.append(cur)
                cur = []
        if cur:
            groups.append(cur)

        # --- dynamic state ---
        issue_buffer: List[int] = []             # visible, fetched order
        pending: deque = deque()                 # (visible_at, [idxs]) in flight
        next_group = 0
        fetch_port_free = 0                      # cycle the fetch port frees up
        pending_branch: Optional[int] = None     # unresolved pc-writer idx

        # per-stage occupancy: stage name -> (trace idx, phase, time)
        # phases: "buffer" (waiting own latency), "wait_next" (trying to
        # forward), "fu_wait" (deps unresolved), "fu_busy" (until time)
        occupant: Dict[str, Optional[Tuple[int, str, int]]] = {
            s.name: None for s in self.ag.of_type(PipelineStage)
        }
        storage_timing: Dict[str, _StorageTiming] = {
            st.name: _StorageTiming(st) for st in self.ag.storages
        }
        done: List[bool] = [False] * n

        T = 0
        completed = 0
        while completed < n:
            if T > max_cycles:
                raise RuntimeError(f"simulation exceeded {max_cycles} cycles")
            changed = False

            # ---- 0. fetched instructions become visible ----
            while pending and pending[0][0] <= T:
                _, idxs = pending.popleft()
                issue_buffer.extend(idxs)
                changed = True

            # ---- 1. completions & buffer-phase expirations ----
            for name, occ in list(occupant.items()):
                if occ is None:
                    continue
                idx, phase, t_ready = occ
                if phase == "fu_busy" and t_ready <= T:
                    complete_t[idx] = t_ready
                    done[idx] = True
                    completed += 1
                    occupant[name] = None
                    changed = True
                    if pending_branch == idx:
                        pending_branch = None
                elif phase == "buffer" and t_ready <= T:
                    occupant[name] = (idx, "wait_next", T)
                    changed = True

            # ---- 2. forwards along routes (fixed point -> simultaneous shift) ----
            moved = True
            while moved:
                moved = False
                for name, occ in list(occupant.items()):
                    if occ is None:
                        continue
                    idx, phase, t_ready = occ
                    if phase != "wait_next":
                        continue
                    e = trace[idx]
                    route = e.route
                    pos = route.index(name)
                    if pos + 1 >= len(route):
                        # pass-through instruction completes at route end
                        complete_t[idx] = T
                        done[idx] = True
                        completed += 1
                        occupant[name] = None
                        moved = changed = True
                        if pending_branch == idx:
                            pending_branch = None
                        continue
                    nxt = route[pos + 1]
                    if occupant[nxt] is None:
                        occupant[name] = None
                        self._receive(nxt, idx, T, occupant, trace)
                        moved = changed = True

            # ---- 3. issue from buffer: out-of-order, FIFO per target stage ----
            tried_targets: Set[str] = set()
            for idx in list(issue_buffer):
                first = trace[idx].route[0]
                if first in tried_targets:
                    continue
                tried_targets.add(first)
                if occupant[first] is None:
                    issue_buffer.remove(idx)
                    issue_t[idx] = T
                    self._receive(first, idx, T, occupant, trace)
                    changed = True

            # ---- 4. FU starts: deps resolved -> begin processing (runs after
            # forwards/issue so an instruction received this cycle can start
            # this cycle -> 1 op/cycle steady-state pipelines) ----
            for name, occ in list(occupant.items()):
                if occ is None:
                    continue
                idx, phase, _ = occ
                if phase != "fu_wait":
                    continue
                e = trace[idx]
                if all(done[d] for d in e.deps):
                    fu: FunctionalUnit = self.ag.by_name[e.fu_name]
                    tags = e.instr.tags
                    fu_lat = fu.latency.resolve(
                        operation=e.instr.operation,
                        words=int(tags.get("words", 1)),
                        macs=int(tags.get("macs", tags.get("words", 1))),
                    )
                    start_t[idx] = T
                    finish = T + fu_lat
                    if e.mem_parts:
                        # each access occupies a request slot of its own
                        # storage; the instruction finishes when the slowest
                        # of its transactions completes (Figs. 12/13)
                        finish_mem = T
                        for st_name, lat in e.mem_parts:
                            svc_done = storage_timing[st_name].service(T, lat)
                            finish_mem = max(finish_mem, svc_done)
                        finish = finish_mem + fu_lat
                    elif e.mem_latency > 0:
                        finish = T + e.mem_latency + fu_lat
                    occupant[name] = (idx, "fu_busy", max(finish, T + 1))
                    changed = True

            # ---- 5. fetch (Fig. 9) ----
            in_flight = sum(len(g) for _, g in pending)
            if (next_group < len(groups)
                    and fetch_port_free <= T
                    and pending_branch is None
                    and len(issue_buffer) + in_flight + len(groups[next_group]) <= ibs):
                g = groups[next_group]
                next_group += 1
                fetch_port_free = T + fetch_cost
                pending.append((T + fetch_cost, g))
                for idx in g:
                    if trace[idx].is_pc_writer:
                        pending_branch = idx
                changed = True

            # ---- 6. advance time (event skip when idle) ----
            if changed:
                T += 1
            else:
                nxt_times = [t for _, t in [(0, fetch_port_free)] if t > T]
                nxt_times += [t for t, _ in pending if t > T]
                for occ in occupant.values():
                    if occ is not None and occ[2] > T:
                        nxt_times.append(occ[2])
                if not nxt_times:
                    raise RuntimeError(
                        f"deadlock at T={T}: {completed}/{n} complete; "
                        f"buffer={issue_buffer[:8]} occupants="
                        f"{ {k: v for k, v in occupant.items() if v} }"
                    )
                T = max(T + 1, min(nxt_times))

        return SimResult(cycles=max(complete_t) if complete_t else 0,
                         issue_time=issue_t, start_time=start_t,
                         complete_time=complete_t,
                         stats={"instructions": n, "fetch_groups": len(groups)})

    def _receive(self, stage_name: str, idx: int, T: int,
                 occupant: Dict[str, Optional[Tuple[int, str, int]]],
                 trace: Sequence[TraceEntry]) -> None:
        stage = self.ag.by_name[stage_name]
        e = trace[idx]
        if isinstance(stage, ExecuteStage) and e.fu_name is not None \
                and stage_name == e.route[-1]:
            occupant[stage_name] = (idx, "fu_wait", T)
        else:
            lat = stage.latency.resolve()
            occupant[stage_name] = (idx, "buffer", T + lat)


def simulate(ag: ArchitectureGraph, program: Sequence[Instruction],
             entry: int = 0, max_cycles: int = 10_000_000) -> SimResult:
    """Functional + timing simulation of ``program`` on ``ag``."""
    trace = build_trace(ag, program, entry)
    sim = EventSimulator(ag, trace)
    return sim.run(max_cycles)
