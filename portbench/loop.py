"""The measured window: one client in a closed loop, each request (or
step) issued when the one before it has returned, until ``--seconds``
have passed; the window closes when the last one issued returns."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, List


@dataclass
class Item:
    """One request or step: host-clock times of its issue and of its result
    on the host, the positions it carried, and the host time from its call
    into the program until the call returned (before the wait)."""
    issued: float
    done: float
    units: int
    enqueue_s: float = 0.0


@dataclass
class Window:
    start: float = 0.0           # perf_counter at the window's start
    start_unix: float = 0.0      # the same instant on the Unix clock
    end: float = 0.0
    items: List[Item] = field(default_factory=list)
    traced: int = 0              # items inside the traced span

    @property
    def seconds(self) -> float:
        return self.end - self.start

    @property
    def units(self) -> int:
        return sum(it.units for it in self.items)


def closed_loop(one: Callable[[int], Item], seconds: float,
                tracer=None) -> Window:
    """Call ``one(0)``, ``one(1)``, ... until ``seconds`` have passed since
    the first call; with ``tracer``, trace from the first call through the
    ``tracer.limit``-th (all of them where that is None)."""
    w = Window()
    if tracer is not None:
        tracer.start()
    w.start, w.start_unix = time.perf_counter(), time.time()
    i = 0
    while time.perf_counter() - w.start < seconds:
        w.items.append(one(i))
        i += 1
        if tracer is not None and tracer.running and i == tracer.limit:
            tracer.stop()
            w.traced = i
    w.end = w.items[-1].done if w.items else time.perf_counter()
    if tracer is not None and tracer.running:
        tracer.stop()
        w.traced = i
    return w


