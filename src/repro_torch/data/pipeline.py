"""Token data pipeline.

Production posture (DESIGN.md §6):

* **deterministic** — batch ``i`` is a pure function of (seed, step), so a
  restarted job consumes exactly the tokens it would have seen;
* **resumable** — the iterator state is one integer (``step``), stored in
  every checkpoint manifest;
* **per-host sharded** — each host materializes only its slice of the
  global batch (``host_id``/``n_hosts``); the dry-run never allocates
  global arrays;
* **double-buffered** — a background thread prefetches the next batch while
  the step runs (CPU-side overlap).

Two sources: ``synthetic_source`` (zipf-ish token stream, used by tests and
the quickstart) and ``memmap_source`` (flat uint16/uint32 token file, the
deploy path — no tokenization at train time).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np

__all__ = ["DataConfig", "TokenPipeline", "synthetic_source", "memmap_source"]


@dataclass(frozen=True)
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    host_id: int = 0
    n_hosts: int = 1
    prefetch: int = 2

    @property
    def host_batch(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


def synthetic_source(cfg: DataConfig) -> Callable[[int], Dict[str, np.ndarray]]:
    """Deterministic synthetic LM batches: tokens[i+1] predicts tokens[i]."""

    def batch_at(step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, step, cfg.host_id]))
        # zipf-flavored marginal over the vocab (heavier head, long tail)
        z = rng.zipf(1.3, size=(cfg.host_batch, cfg.seq_len + 1))
        toks = (z % cfg.vocab_size).astype(np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return batch_at


def memmap_source(cfg: DataConfig, path: str | Path,
                  dtype=np.uint16) -> Callable[[int], Dict[str, np.ndarray]]:
    """Flat token-file source; step/host determine the window (epoch wraps)."""
    data = np.memmap(path, dtype=dtype, mode="r")
    tokens_per_batch = cfg.host_batch * (cfg.seq_len + 1)
    n_windows = max(1, (len(data) - 1) // tokens_per_batch)

    def batch_at(step: int) -> Dict[str, np.ndarray]:
        w = (step * cfg.n_hosts + cfg.host_id) % n_windows
        flat = np.asarray(data[w * tokens_per_batch:(w + 1) * tokens_per_batch])
        toks = flat.reshape(cfg.host_batch, cfg.seq_len + 1).astype(np.int32)
        toks %= cfg.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    return batch_at


class TokenPipeline:
    """Resumable prefetching iterator over a deterministic batch function."""

    def __init__(self, cfg: DataConfig,
                 source: Optional[Callable[[int], Dict[str, np.ndarray]]] = None,
                 start_step: int = 0):
        self.cfg = cfg
        self.source = source or synthetic_source(cfg)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=max(1, cfg.prefetch))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self) -> None:
        s = self.step
        while not self._stop.is_set():
            try:
                self._q.put((s, self.source(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        s, batch = self._q.get()
        self.step = s + 1  # checkpointable state: next step to consume
        return batch

    def state(self) -> Dict[str, int]:
        return {"step": self.step}

    def close(self) -> None:
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)
