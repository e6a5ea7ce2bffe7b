"""Frozen copies of what the program derives from the seed on the host: the
synthetic token batches of each worker's shard and the asynchronous
workers' schedule. The reference works the inputs out again from the seed
with these, so it takes nothing the program made.

``token_batch`` is the program's ``SyntheticLM.batch`` (``data/pipeline.py``
of the port) as it stood when the benchmark was written: tokens follow
t_{i+1} = (a·t_i + b) mod V with probability 0.8, else uniform, from a
counter-keyed NumPy generator per (seed, step, shard). ``Schedule`` is the
OLAF-async trainer's: worker w computes at speed 1 + 0.5·u_w, the worker
with the earliest next finish delivers next, its cluster is w mod
max(W // 2, 2).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

STRUCTURE = 0.8


def token_batch(vocab: int, seq: int, global_batch: int, n_shards: int,
                shard: int, seed: int, step: int) -> Dict[str, np.ndarray]:
    rng = np.random.default_rng((seed * 1_000_003 + step) * n_shards + shard)
    B = global_batch // n_shards
    a, b = 31337 % vocab or 1, 917
    toks = np.empty((B, seq + 1), np.int64)
    toks[:, 0] = rng.integers(0, vocab, B)
    structured = rng.random((B, seq)) < STRUCTURE
    noise = rng.integers(0, vocab, (B, seq))
    for i in range(seq):
        nxt = (a * toks[:, i] + b) % vocab
        toks[:, i + 1] = np.where(structured[:, i], nxt, noise[:, i])
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


class Schedule:
    """Which worker delivers next, at what virtual time, from which step of
    its shard."""

    def __init__(self, n_workers: int, seed: int):
        rng = np.random.default_rng(seed)
        self.speed = 1.0 + 0.5 * rng.random(n_workers)
        self.next = np.zeros(n_workers)
        self.step = np.zeros(n_workers, int)
        self.n_clusters = max(n_workers // 2, 2)

    def burst(self, size: int) -> List[Tuple[int, int, int, float]]:
        """``size`` deliveries: (worker, cluster, shard step, time)."""
        out = []
        for _ in range(size):
            w = int(np.argmin(self.next))
            out.append((w, w % self.n_clusters, int(self.step[w]),
                        float(self.next[w])))
            self.step[w] += 1
            self.next[w] += self.speed[w]
        return out
