"""Worker-side transmission control guided by in-network feedback (§5).

ACKs on the reverse path piggyback the queue state ``{N, Q_max, Q_n}``
(number of active clusters, queue capacity, current occupancy). In the
congestion regime (``N > Q_max``) a worker holding a fresh update transmits
with probability

    P_s = min(Q_max / N + f(Δ̂), 1),     f(Δ̂) = v · max(Δ̂ − Δ̄_T, 0)

where ``Δ̂`` is the time since the last ACK the worker received. Workers with
fresh feedback use the stabilising base rate ``Q_max/N``; workers whose
feedback has gone stale perturb upward with slope ``v`` (urgency: v = 1/Δ̄_T,
fairness: v = Δ̄_T). Without congestion (``N ≤ Q_max``) workers send at will.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class QueueFeedback:
    """Reverse-path signal carried in the ACK (paper packet format §7)."""

    n_active_clusters: int  # 16-bit field in the paper
    q_max: int
    q_occupancy: int  # 24-bit field (or a binary congestion bit)
    timestamp: float = 0.0


@dataclasses.dataclass
class TxControlConfig:
    delta_threshold: float = 0.4  # Δ̄_T, paper uses 400 msec
    slope_mode: str = "fairness"  # "fairness": v=Δ̄_T, "urgency": v=1/Δ̄_T
    slope: Optional[float] = None  # explicit v overrides slope_mode
    # ---- loss recovery (None disables retransmission entirely) ----------
    ack_timeout: Optional[float] = None  # seconds before a send is presumed lost
    max_retries: int = 3  # retransmission budget per update
    backoff: float = 2.0  # exponential deadline growth per retry

    @property
    def v(self) -> float:
        if self.slope is not None:
            return self.slope
        if self.slope_mode == "urgency":
            return 1.0 / self.delta_threshold
        return self.delta_threshold


class TransmissionController:
    """Per-worker state machine implementing §5, plus ACK-timeout loss
    recovery: each send arms a deadline; if no covering ACK arrives the
    update is retransmitted with exponential backoff, at most
    ``max_retries`` times."""

    def __init__(self, cfg: TxControlConfig, rng: np.random.Generator) -> None:
        self.cfg = cfg
        self.rng = rng
        self.last_ack_time: Optional[float] = None
        self.feedback: Optional[QueueFeedback] = None
        # retransmission state (mirrored 1:1 by the vectorized JaxTxState)
        self.outstanding = False
        self.sent_gen = -float("inf")  # gen_time of the outstanding update
        self.deadline = float("inf")  # next ACK-timeout poll
        self.retries = 0

    def on_send(self, now: float, gen_time: float) -> None:
        """A fresh update left the worker: it becomes the (single)
        outstanding one — a newer send supersedes an older outstanding
        update, which the newer one's experience subsumes."""
        if self.cfg.ack_timeout is None:
            return
        self.outstanding = True
        self.sent_gen = gen_time
        self.retries = 0
        self.deadline = now + self.cfg.ack_timeout

    def poll_retransmit(self, now: float) -> bool:
        """True iff the outstanding update's deadline has expired and the
        retry budget allows another copy; arms the next (backed-off)
        deadline as a side effect."""
        if (self.cfg.ack_timeout is None or not self.outstanding
                or now < self.deadline):
            return False
        if self.retries >= self.cfg.max_retries:
            return False  # budget exhausted: give up (next fresh send rearms)
        self.retries += 1
        self.deadline = now + self.cfg.ack_timeout * (
            self.cfg.backoff ** self.retries)
        return True

    def on_ack(self, now: float, feedback: QueueFeedback,
               delivered_gen: Optional[float] = None) -> None:
        self.last_ack_time = now
        self.feedback = feedback
        # an ACK covering model state at least as fresh as the outstanding
        # update clears it (stale-but-delivered beats dropped); an ACK with
        # no gen info (legacy callers) clears unconditionally
        if delivered_gen is None or delivered_gen >= self.sent_gen:
            self.outstanding = False
            self.deadline = float("inf")

    def send_probability(self, now: float) -> float:
        if self.feedback is None:
            return 1.0  # no feedback yet: initial transmissions are free
        n, qmax = self.feedback.n_active_clusters, self.feedback.q_max
        if n <= qmax:
            return 1.0  # no-congestion regime: transmit at will
        delta_hat = now - (self.last_ack_time if self.last_ack_time is not None else now)
        overdue = delta_hat - self.cfg.delta_threshold
        f = self.cfg.v * overdue if overdue > 0 else 0.0
        return float(min(qmax / n + f, 1.0))

    def should_send(self, now: float) -> bool:
        p = self.send_probability(now)
        return bool(self.rng.random() < p)
