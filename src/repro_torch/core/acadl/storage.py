"""ACADL storage classes: RegisterFile, DataStorage hierarchy (paper §3).

``DataStorage`` is the virtual base for all data storages.  ``data_width`` is
the bit-length of one data word, ``max_concurrent_requests`` the number of
simultaneously serviced read/write requests (request *slots*, each with its
own latency counter in the timing simulation), ``read_write_ports`` how many
MemoryAccessUnits may connect, and ``port_width`` how many data words move in
a single transaction.  ``data`` maps addresses to words.

``MemoryInterface`` adds read/write latencies and address ranges; ``DRAM``
and ``SRAM`` override the latencies with stateful functions (DRAM: row-buffer
model driven by ``bank_address_ranges``/``t_RCD``/``t_RP``/``t_RAS``);
``CacheInterface``/``SetAssociativeCache`` add the usual cache attributes and
an internal set-associative cache simulator (the paper defers to pycachesim —
we implement an equivalent LRU/FIFO model in-tree to stay dependency-free).
"""

from __future__ import annotations

from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from .base import ACADLObject, Data, latency_t, LatencyLike, _as_latency

__all__ = [
    "RegisterFile",
    "DataStorage",
    "MemoryInterface",
    "SRAM",
    "DRAM",
    "CacheInterface",
    "SetAssociativeCache",
]


class RegisterFile(ACADLObject):
    """Maps unique register names to values (paper §3)."""

    def __init__(self, name: str, data_width: int = 32,
                 registers: Optional[Dict[str, Data]] = None):
        super().__init__(name)
        self.data_width = data_width
        self.registers: Dict[str, Data] = dict(registers or {})

    def read(self, reg: str) -> Any:
        if reg not in self.registers:
            raise KeyError(f"register {reg!r} not in RegisterFile {self.name!r}")
        return self.registers[reg].payload

    def write(self, reg: str, value: Any) -> None:
        if reg not in self.registers:
            # registers are declared up-front; writing to an undeclared
            # register is a modeling error, except for auto-extensible files
            raise KeyError(f"register {reg!r} not in RegisterFile {self.name!r}")
        self.registers[reg].payload = value

    def has(self, reg: str) -> bool:
        return reg in self.registers


class DataStorage(ACADLObject):
    """Virtual base class for all data storages."""

    def __init__(self, name: str, data_width: int = 32,
                 max_concurrent_requests: int = 1,
                 read_write_ports: int = 1,
                 port_width: int = 1,
                 data: Optional[Dict[int, Any]] = None):
        if type(self) is DataStorage:
            raise TypeError("DataStorage is a virtual base class — instantiate a subclass")
        super().__init__(name)
        self.data_width = data_width
        self.max_concurrent_requests = max_concurrent_requests
        self.read_write_ports = read_write_ports
        self.port_width = port_width
        self.data: Dict[int, Any] = dict(data or {})

    # -- functional simulation -------------------------------------------------
    def read(self, address: int) -> Any:
        return self.data.get(address, 0)

    def write(self, address: int, value: Any) -> None:
        self.data[address] = value

    # -- timing model ------------------------------------------------------------
    def timing_reset(self) -> None:
        """Reset stateful latency models (row buffers, cache tags)."""

    def access_latency(self, kind: str, address: int, words: int = 1) -> int:
        """Latency in cycles of a ``read``/``write`` transaction of ``words``
        data words (tensor-level instructions move whole tiles; ``port_width``
        words transfer per cycle once the transaction is open).

        Stateful: calling order matters for DRAM row buffers and caches.
        """
        raise NotImplementedError

    def burst_cycles(self, words: int) -> int:
        """Extra cycles past the first transaction beat for a ``words``-word
        burst at ``port_width`` words/cycle."""
        if words <= self.port_width:
            return 0
        return (words + self.port_width - 1) // self.port_width - 1


class MemoryInterface(DataStorage):
    """Adds read/write latencies and address ranges to DataStorage."""

    def __init__(self, name: str,
                 read_latency: LatencyLike = 1,
                 write_latency: LatencyLike = 1,
                 address_ranges: Sequence[Tuple[int, int]] = ((0, 2 ** 32),),
                 **kw):
        super().__init__(name, **kw)
        self.read_latency = _as_latency(read_latency)
        self.write_latency = _as_latency(write_latency)
        self.address_ranges: Tuple[Tuple[int, int], ...] = tuple(tuple(r) for r in address_ranges)

    def covers(self, address: int) -> bool:
        return any(lo <= address < hi for lo, hi in self.address_ranges)

    def access_latency(self, kind: str, address: int, words: int = 1) -> int:
        lat = self.read_latency if kind == "read" else self.write_latency
        return lat.resolve(address=address) + self.burst_cycles(words)


class SRAM(MemoryInterface):
    """SRAM: constant-latency memory (scratchpads, instruction memories)."""


class DRAM(MemoryInterface):
    """DRAM with a stateful open-row latency model (paper §3).

    ``bank_address_ranges`` partitions the address space into banks; each
    bank has an open-row register.  A row holds ``row_size`` words.

    Latency of an access (simplified DDR timing, consistent with the paper's
    ``t_RCD``/``t_RP``/``t_RAS`` attributes):

    * row hit   : base latency (CAS, = read/write_latency)
    * row miss  : t_RP (precharge) + t_RCD (activate) + base
    * bank idle : t_RCD (activate) + base
    """

    def __init__(self, name: str,
                 bank_address_ranges: Sequence[Tuple[int, int]] = ((0, 2 ** 32),),
                 t_RCD: int = 8, t_RP: int = 8, t_RAS: int = 20,
                 row_size: int = 1024, **kw):
        kw.setdefault("read_latency", 10)
        kw.setdefault("write_latency", 10)
        super().__init__(name, **kw)
        self.bank_address_ranges = tuple(tuple(r) for r in bank_address_ranges)
        self.t_RCD = t_RCD
        self.t_RP = t_RP
        self.t_RAS = t_RAS
        self.row_size = row_size
        self._open_rows: Dict[int, Optional[int]] = {}

    def timing_reset(self) -> None:
        self._open_rows = {}

    def _bank_of(self, address: int) -> int:
        for i, (lo, hi) in enumerate(self.bank_address_ranges):
            if lo <= address < hi:
                return i
        return len(self.bank_address_ranges)  # out-of-range: synthetic bank

    def access_latency(self, kind: str, address: int, words: int = 1) -> int:
        base = (self.read_latency if kind == "read" else self.write_latency).resolve(address=address)
        bank = self._bank_of(address)
        row = address // self.row_size
        open_row = self._open_rows.get(bank)
        if open_row is None:
            lat = self.t_RCD + base
        elif open_row == row:
            lat = base
        else:
            lat = self.t_RP + self.t_RCD + base
        self._open_rows[bank] = row
        return lat + self.burst_cycles(words)


class CacheInterface(DataStorage):
    """Adds common cache attributes to DataStorage (paper §3)."""

    def __init__(self, name: str,
                 write_allocate: bool = True,
                 write_back: bool = True,
                 miss_latency: LatencyLike = 10,
                 hit_latency: LatencyLike = 1,
                 cache_line_size: int = 8,
                 replacement_policy: str = "LRU",
                 **kw):
        if type(self) is CacheInterface:
            raise TypeError("CacheInterface is abstract — use SetAssociativeCache")
        super().__init__(name, **kw)
        self.write_allocate = write_allocate
        self.write_back = write_back
        self.miss_latency = _as_latency(miss_latency)
        self.hit_latency = _as_latency(hit_latency)
        self.cache_line_size = cache_line_size
        self.replacement_policy = replacement_policy
        self.backing: Optional[DataStorage] = None  # wired from the AG fill edges

    # functional read-through / write-through against the backing store, so
    # caches are transparent to the functional simulation
    def read(self, address: int) -> Any:
        if address in self.data:
            return self.data[address]
        if self.backing is not None:
            return self.backing.read(address)
        return 0

    def write(self, address: int, value: Any) -> None:
        self.data[address] = value
        if self.backing is not None:
            self.backing.write(address, value)

    def covers(self, address: int) -> bool:
        if self.backing is None:
            return True
        cov = getattr(self.backing, "covers", None)
        return cov(address) if cov is not None else True


class SetAssociativeCache(CacheInterface):
    """Set-associative cache with an in-tree LRU/FIFO tag simulator.

    §6: on a miss, the request slot's latency counter is set to
    ``miss_latency``; after it elapses the tag state is updated and the slot
    is ready.  Hits take ``hit_latency``.
    """

    def __init__(self, name: str, sets: int = 64, ways: int = 4, **kw):
        super().__init__(name, **kw)
        self.sets = sets
        self.ways = ways
        # tag state: per set, ordered list of line tags (front = LRU victim)
        self._tags: List[List[int]] = [[] for _ in range(sets)]

    def timing_reset(self) -> None:
        self._tags = [[] for _ in range(self.sets)]

    def _locate(self, address: int) -> Tuple[int, int]:
        line = address // self.cache_line_size
        return line % self.sets, line // self.sets  # (set index, tag)

    def probe(self, address: int) -> bool:
        """True iff address currently hits (no state change)."""
        s, tag = self._locate(address)
        return tag in self._tags[s]

    def access_latency(self, kind: str, address: int, words: int = 1) -> int:
        s, tag = self._locate(address)
        ways = self._tags[s]
        hit = tag in ways
        if hit:
            if self.replacement_policy.upper() == "LRU":
                ways.remove(tag)
                ways.append(tag)  # most-recently-used at the back
            return self.hit_latency.resolve(address=address) + self.burst_cycles(words)
        # miss — allocate (reads always; writes only with write_allocate)
        if kind == "read" or self.write_allocate:
            if len(ways) >= self.ways:
                ways.pop(0)  # evict LRU/FIFO front
            ways.append(tag)
        return self.miss_latency.resolve(address=address) + self.burst_cycles(words)
