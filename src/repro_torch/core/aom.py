"""Age-of-Model (AoM) — the paper's staleness metric (§2.2, §6).

AoM(t) at the PS is the age of the freshest model information the PS holds:
it jumps, on delivery of update k at time D(k), to ``D(k) - gen(k)`` (how old
that update already is) and grows with slope one in between (the sawtooth of
Fig. 5). Peak AoM is the value just before a delivery.

This module turns delivery logs ``[(D_k, gen_k)]`` into the paper's metrics:
time-average AoM (integral of the sawtooth / horizon), peak-AoM sequences
(closed form of §6), and Jain's fairness index over per-cluster averages
(Tabs. 2/3). Its device half (:class:`TorchAoMState`) keeps the running
integral inside the PS step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Sequence, Tuple

import numpy as np
import torch


def aom_trajectory(deliveries: Sequence[Tuple[float, float]],
                   horizon: float, t0: float = 0.0) -> Tuple[np.ndarray, np.ndarray]:
    """Piecewise-linear AoM sawtooth.

    Args:
      deliveries: sorted ``(delivery_time, generation_time)`` pairs.
      horizon: end of observation window.
      t0: virtual generation time of the initial model (AoM(0) = -t0).

    Returns ``(ts, aom)`` vertex arrays (two vertices per delivery: the peak
    just before and the post-jump value).
    """
    ts: List[float] = [0.0]
    age: List[float] = [-t0]
    last_gen = t0
    for d, g in deliveries:
        if d > horizon:
            break
        ts.append(d)
        age.append(d - last_gen)  # peak just before the jump
        # Deliveries carrying older info than what the PS already has do not
        # rejuvenate the model (the PS keeps the freshest generation time).
        last_gen = max(last_gen, g)
        ts.append(d)
        age.append(d - last_gen)  # post-jump age
    ts.append(horizon)
    age.append(horizon - last_gen)
    return np.asarray(ts), np.asarray(age)


def average_aom(deliveries: Sequence[Tuple[float, float]], horizon: float,
                t0: float = 0.0) -> float:
    """Time-average of the sawtooth (trapezoid integration of the vertices)."""
    ts, age = aom_trajectory(deliveries, horizon, t0)
    if horizon <= 0:
        return 0.0
    area = float(np.trapezoid(age, ts))
    return area / horizon


def peak_aom(arrivals: Sequence[float], departures: Sequence[float]) -> np.ndarray:
    """Closed-form peak AoM of §6:

    ``Δ_p(k) = (D(k) − A(l))·1{D(k) < A(k+1)}`` with
    ``l = max{i < k : D(i) < A(i+1)}`` (the latest *valid* departure before k;
    an update is valid iff it left before the next same-flow arrival, i.e.
    it was not aggregated/replaced in the queue).
    """
    A = np.asarray(arrivals, float)
    D = np.asarray(departures, float)
    n = len(A)
    peaks = np.zeros(n)
    last_valid = None
    for k in range(n):
        valid = (k + 1 >= n) or (D[k] < A[k + 1])
        if valid:
            ref = A[last_valid] if last_valid is not None else 0.0
            peaks[k] = D[k] - ref
            last_valid = k
    return peaks


def jain_fairness(values: Iterable[float]) -> float:
    """Jain's index ``f = (Σx)² / (n·Σx²)`` in [1/n, 1] (Tabs. 2/3)."""
    x = np.asarray(list(values), float)
    if x.size == 0 or np.all(x == 0):
        return 1.0
    return float(x.sum() ** 2 / (x.size * np.square(x).sum()))


def per_cluster_average_aom(deliveries_by_cluster: Dict[int, Sequence[Tuple[float, float]]],
                            horizon: float) -> Dict[int, float]:
    return {c: average_aom(sorted(d), horizon) for c, d in deliveries_by_cluster.items()}


# ===========================================================================
# Device half: the running sawtooth integral updated inside the PS step, the
# counterpart of ``repro``'s ``JaxAoMState`` and ``jax_aom_*`` functions.
# 0-dim float32 tensors on the PS's device; nothing reads back to the host.
# ===========================================================================
@dataclasses.dataclass
class TorchAoMState:
    """The trapezoid integral so far, the last delivery time and the
    freshest generation time the PS holds (0-dim float32 tensors)."""

    last_t: torch.Tensor
    last_gen: torch.Tensor
    integral: torch.Tensor


def aom_init(t0: float = 0.0, *, device) -> TorchAoMState:
    """AoM(0) = -t0, as :func:`aom_trajectory`."""
    def f(v):
        return torch.full((), v, dtype=torch.float32, device=device)

    return TorchAoMState(last_t=f(0.0), last_gen=f(t0), integral=f(0.0))


def aom_update(state: TorchAoMState, t, gen, valid) -> TorchAoMState:
    """Fold one delivery ``(t, gen)`` (0-dim float32 tensors; ``valid`` a
    0-dim bool, False = a no-op row) into the integral. ``last_t`` stays
    monotone: a delivery whose time regresses below it is folded at
    ``last_t`` with a zero-width trapezoid, never a negative area."""
    t = torch.maximum(t, state.last_t)
    dt = t - state.last_t
    area = dt * ((state.last_t - state.last_gen) + (t - state.last_gen)) / 2.0
    return TorchAoMState(
        last_t=torch.where(valid, t, state.last_t),
        last_gen=torch.where(valid, torch.maximum(state.last_gen, gen),
                             state.last_gen),
        integral=torch.where(valid, state.integral + area, state.integral))


def aom_update_block(state: TorchAoMState, ts, gens, valids) -> TorchAoMState:
    """Fold a drained block (K rows in FIFO order: ``olaf_step``'s drain
    output) one row after another."""
    ts = ts.to(torch.float32)
    gens = gens.to(torch.float32)
    for i in range(ts.shape[0]):
        state = aom_update(state, ts[i], gens[i], valids[i])
    return state


def aom_average(state: TorchAoMState, horizon) -> torch.Tensor:
    """Time-average AoM over [0, horizon]: the integral plus the open tail
    after the last delivery (a 0-dim float32 tensor)."""
    horizon = torch.full((), horizon, dtype=torch.float32,
                         device=state.last_t.device)
    dt = horizon - state.last_t
    tail = dt * ((state.last_t - state.last_gen)
                 + (horizon - state.last_gen)) / 2.0
    return (state.integral + tail) / torch.clamp(horizon, min=1e-9)


def staleness_mask(now, gen_times, bound: float) -> torch.Tensor:
    """True for drained rows whose age ``now - gen_time`` is within the
    hard ``bound``: AND it into the drain's ``valid`` before the apply."""
    return (now - gen_times.to(torch.float32)) <= torch.full(
        (), bound, dtype=torch.float32, device=gen_times.device)
