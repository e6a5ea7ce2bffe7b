"""Deterministic synthetic token pipeline (shard-aware, prefetching).

A copy of ``repro.data.pipeline`` (numpy and threads only), so the two
packages draw the same batches for the same (seed, step, shard).

Production shape without external data: batches are generated from a
counter-keyed PRNG so that (a) every (step, shard) pair is reproducible
across restarts — checkpoint/resume yields bit-identical batches — and
(b) each data-parallel shard draws a disjoint stream. A background
prefetch thread keeps ``prefetch`` batches ready (host-side pipelining).
"""
from __future__ import annotations

import dataclasses
import queue as queue_mod
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    n_shards: int = 1
    shard_id: int = 0
    seed: int = 0
    # markov-ish structure so the loss actually decreases during training
    structure: float = 0.8  # P(next token = f(prev token))


class SyntheticLM:
    """Token batches with learnable structure: t_{i+1} = (a·t_i + b) mod V
    with prob ``structure``, else uniform — a next-token task a model can fit."""

    def __init__(self, cfg: DataConfig) -> None:
        assert cfg.global_batch % cfg.n_shards == 0
        self.cfg = cfg
        self.batch_per_shard = cfg.global_batch // cfg.n_shards
        self._a = 31337 % cfg.vocab or 1
        self._b = 917

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + step) * cfg.n_shards + cfg.shard_id)
        B, S, V = self.batch_per_shard, cfg.seq_len, cfg.vocab
        toks = np.empty((B, S + 1), np.int64)
        toks[:, 0] = rng.integers(0, V, B)
        structured = rng.random((B, S)) < cfg.structure
        noise = rng.integers(0, V, (B, S))
        for i in range(S):
            nxt = (self._a * toks[:, i] + self._b) % V
            toks[:, i + 1] = np.where(structured[:, i], nxt, noise[:, i])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def iterator(self, start_step: int = 0, prefetch: int = 2
                 ) -> Iterator[Dict[str, np.ndarray]]:
        if prefetch <= 0:
            step = start_step
            while True:
                yield self.batch(step)
                step += 1
        q: queue_mod.Queue = queue_mod.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            step = start_step
            while not stop.is_set():
                q.put(self.batch(step))
                step += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()
