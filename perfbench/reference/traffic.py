"""The PS engine's traffic: congested bursts of worker updates, made from
the seed alone, the same for the program and the reference.

Burst ``i`` holds ``burst_size`` deliveries in the OLAF-async trainer's
schedule (:class:`perfbench.reference.data.Schedule`: worker speeds
1 + 0.5·u, the earliest next finish delivers, cluster = worker mod
max(W // 2, 2)); its payload rows are standard normals drawn on the
device by a generator seeded from (seed, i); after the first burst, a
seeded 1 in ``faulty_share`` of the rows is scaled by ``faulty_scale``, as
from a faulty worker, so the ingress screen fires; and each row carries a
uniform draw for the send gate.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from perfbench.reference.data import Schedule


@dataclasses.dataclass
class BurstMeta:
    now: np.float32
    clusters: np.ndarray  # (U,) int32
    workers: np.ndarray  # (U,) int32
    times: np.ndarray  # (U,) float32
    uniforms: np.ndarray  # (U,) float32
    faulty: np.ndarray  # (U,) bool


class Traffic:
    def __init__(self, cell: dict, seed: int, dim: int, device):
        job = cell["job"]
        self.U, self.dim, self.device = job["burst_size"], dim, device
        self.seed, self.i = seed, 0
        self.share, self.scale = cell["faulty_share"], cell["faulty_scale"]
        self.sched = Schedule(job["workers"], seed)
        self.rng = np.random.default_rng([seed, 7])

    def next(self, rows: torch.Tensor) -> BurstMeta:
        """The next burst: its payload rows written into ``rows`` (U, D)
        float32 on the device, its metadata returned."""
        deliveries = self.sched.burst(self.U)
        gen = torch.Generator(device=self.device).manual_seed(
            (self.seed * 1_000_003 + self.i) % 2**63)
        rows.normal_(0.0, 1.0, generator=gen)
        faulty = self.rng.random(self.U) < 1.0 / self.share
        if self.i == 0:
            faulty[:] = False
        for u in np.flatnonzero(faulty):
            rows[u].mul_(self.scale)
        uniforms = self.rng.random(self.U).astype(np.float32)
        self.i += 1
        times = np.array([t for *_, t in deliveries], np.float32)
        return BurstMeta(
            now=np.float32(max(t for *_, t in deliveries)),
            clusters=np.array([c for _, c, _, _ in deliveries], np.int32),
            workers=np.array([w for w, *_ in deliveries], np.int32),
            times=times, uniforms=uniforms, faulty=faulty)
