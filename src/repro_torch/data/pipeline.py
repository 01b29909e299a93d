"""Deterministic, restartable token data pipeline (NumPy plus one thread).

Each process reads only its shard of the global batch
(``host_batch_slice``), a background thread prefetches the next batches, and
the stream is a pure function of (seed, step, row): a restart resumes
bit-exactly from a step counter, and the reference runtime, given the same
config, sees the same tokens. Batches are NumPy arrays; the trainer moves
them to the card.
"""
from __future__ import annotations

import queue
import threading
from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "synthetic_lm"   # synthetic_lm | zipf_lm


def host_batch_slice(cfg: DataConfig, process_index: int, process_count: int):
    per = cfg.global_batch // process_count
    return slice(process_index * per, (process_index + 1) * per)


def _batch_at(cfg: DataConfig, step: int, rows: slice) -> dict[str, np.ndarray]:
    """Pure function of (seed, step): every process can regenerate any batch."""
    n = rows.stop - rows.start
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, rows.start]))
    if cfg.kind == "zipf_lm":
        toks = rng.zipf(1.3, size=(n, cfg.seq_len + 1)).astype(np.int64)
        toks = (toks - 1) % cfg.vocab_size
    else:
        toks = rng.integers(0, cfg.vocab_size, (n, cfg.seq_len + 1))
    toks = toks.astype(np.int32)
    return {
        "tokens": toks[:, :-1],
        "labels": toks[:, 1:],
        "positions": np.broadcast_to(
            np.arange(cfg.seq_len, dtype=np.int32), (n, cfg.seq_len)).copy(),
    }


class DataLoader:
    """Prefetching iterator over deterministic batches, ``(step, batch)``.

    ``start_step`` makes a restart trivial: the loader is stateless apart
    from the step counter it was constructed with. One process by default;
    ``close()`` stops the thread.
    """

    def __init__(self, cfg: DataConfig, start_step: int = 0, prefetch: int = 2,
                 process_index: int = 0, process_count: int = 1):
        self.cfg = cfg
        self.rows = host_batch_slice(cfg, process_index, process_count)
        self.step = start_step
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._fill, daemon=True)
        self._thread.start()

    def _fill(self):
        step = self.step
        while not self._stop.is_set():
            batch = _batch_at(self.cfg, step, self.rows)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self):
        return self

    def __next__(self):
        step, batch = self._q.get()
        self.step = step + 1
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
