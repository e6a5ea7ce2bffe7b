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

:class:`TransmissionController` is one worker's controller (the host
simulator's); :class:`TorchTxState` and the ``txctl_*`` functions are the
same rules over all workers at once, on the PS's device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch


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


# ===========================================================================
# Device half: the §5 controller vectorized over the (W,) worker axis, the
# counterpart of ``repro``'s ``JaxTxState`` and ``jax_txctl_*`` functions.
# Every function is a plain function of tensors on the state's device and
# returns a new state; nothing reads a value back to the host.
# ===========================================================================
@dataclasses.dataclass
class TorchTxState:
    """Per-worker §5 feedback state as (W,) tensors, field for field
    ``repro``'s ``JaxTxState``.

    ``last_ack``/``n_active``/``q_max`` hold the most recent ACK's
    timestamp and piggybacked queue feedback; ``has_fb`` is False until the
    first ACK. ``outstanding``/``sent_gen``/``deadline``/``retries`` are the
    ACK-timeout retransmission state, and ``active`` the node-churn
    membership mask; ``None`` means the same as in ``repro`` (no
    retransmission state; everyone active).
    """

    last_ack: torch.Tensor  # float32[W]
    has_fb: torch.Tensor  # bool[W]
    n_active: torch.Tensor  # float32[W]
    q_max: torch.Tensor  # float32[W]
    outstanding: Optional[torch.Tensor] = None  # bool[W]
    sent_gen: Optional[torch.Tensor] = None  # float32[W]
    deadline: Optional[torch.Tensor] = None  # float32[W]
    retries: Optional[torch.Tensor] = None  # int32[W]
    active: Optional[torch.Tensor] = None  # bool[W]


def _f32(x, like: torch.Tensor) -> torch.Tensor:
    """``x`` (a number or a tensor) as a float32 tensor on ``like``'s
    device; a number is filled in on the device (no host-to-device copy,
    so no wait for the card)."""
    if isinstance(x, torch.Tensor):
        return x.to(device=like.device, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=like.device)


def txctl_init(n_workers: int, *, device, track_active: bool = False
               ) -> TorchTxState:
    """Fresh state for ``n_workers``; ``track_active=True`` materializes
    the membership mask (all True) so node churn can toggle it."""
    def full(value, dt):
        return torch.full((n_workers,), value, dtype=dt, device=device)

    return TorchTxState(
        last_ack=full(0.0, torch.float32), has_fb=full(False, torch.bool),
        n_active=full(0.0, torch.float32), q_max=full(1.0, torch.float32),
        outstanding=full(False, torch.bool),
        sent_gen=full(-math.inf, torch.float32),
        deadline=full(math.inf, torch.float32),
        retries=full(0, torch.int32),
        active=full(True, torch.bool) if track_active else None)


def txctl_set_active(state: TorchTxState, active, *,
                     reset_joined: bool = True) -> TorchTxState:
    """New membership mask: crashed workers go inactive, restarted ones
    rejoin. With ``reset_joined``, a worker going inactive -> active comes
    back fresh: no feedback, no outstanding update, zero retries."""
    active = torch.as_tensor(active, dtype=torch.bool,
                             device=state.last_ack.device)
    prev = state.active if state.active is not None \
        else torch.ones_like(active)
    joined = active & ~prev
    last_ack, has_fb = state.last_ack, state.has_fb
    out, sent_gen = state.outstanding, state.sent_gen
    ddl, retries = state.deadline, state.retries
    if reset_joined:
        last_ack = torch.where(joined, 0.0, last_ack)
        has_fb = has_fb & ~joined
        if out is not None:
            out = out & ~joined
            sent_gen = torch.where(joined, -math.inf, sent_gen)
            ddl = torch.where(joined, math.inf, ddl)
            retries = torch.where(joined, 0, retries)
    return dataclasses.replace(state, last_ack=last_ack, has_fb=has_fb,
                       outstanding=out, sent_gen=sent_gen, deadline=ddl,
                       retries=retries, active=active)


def send_probability(state: TorchTxState, now, delta_threshold: float,
                     v: float) -> torch.Tensor:
    """``P_s = min(Q_max/N + v·max(Δ̂ − Δ̄_T, 0), 1)`` per worker in the
    congestion regime (``N > Q_max``); 1 otherwise and before the first
    ACK; 0 for a crashed worker. float32, as ``jax_send_probability``."""
    delta_hat = _f32(now, state.last_ack) - state.last_ack
    overdue = torch.clamp(delta_hat - delta_threshold, min=0.0)
    p = torch.clamp(state.q_max / torch.clamp(state.n_active, min=1.0)
                    + v * overdue, max=1.0)
    p = torch.where(state.n_active <= state.q_max, 1.0, p)
    p = torch.where(state.has_fb, p, 1.0)
    if state.active is not None:
        p = torch.where(state.active, p, 0.0)
    return p


def txctl_gate(state: TorchTxState, now, delta_threshold: float, v: float,
               worker_ids=None, *, generator: Optional[torch.Generator] = None,
               uniforms: Optional[torch.Tensor] = None):
    """The send gate: ``(send, P_s)`` with ``send = uniform < P_s``.

    ``worker_ids`` optionally selects a (U,) burst of workers (repeats
    allowed). The uniforms are drawn from ``generator`` on the state's
    device, or passed in (``uniforms``, one per gated row): ``repro`` draws
    from ``jax.random``, whose stream torch cannot replay (ROADMAP hazard
    H3), so parity tests inject them."""
    p = send_probability(state, now, delta_threshold, v)
    if worker_ids is not None:
        p = p[worker_ids.long()]
    if uniforms is None:
        if generator is None:
            raise ValueError("txctl_gate needs a generator or the uniforms")
        uniforms = torch.rand(p.shape, generator=generator, device=p.device)
    return uniforms < p, p


def txctl_ack(state: TorchTxState, acked, now, n_active, q_max,
              delivered_gen=None) -> TorchTxState:
    """Multicast ACK: workers in ``acked`` (bool (W,)) take the queue
    feedback ``{N, Q_max}`` and restart their Δ̂ clock. ``delivered_gen``
    clears the outstanding update of acked workers whose ``sent_gen`` it
    covers (``None``: clears every acked worker's). Crashed workers miss
    the multicast."""
    nowf = _f32(now, state.last_ack)
    if state.active is not None:
        acked = acked & state.active
    out, ddl = state.outstanding, state.deadline
    if out is not None:
        cleared = acked if delivered_gen is None else (
            acked & (_f32(delivered_gen, nowf) >= state.sent_gen))
        out = out & ~cleared
        ddl = torch.where(cleared, math.inf, ddl)
    return dataclasses.replace(
        state, last_ack=torch.where(acked, nowf, state.last_ack),
        has_fb=state.has_fb | acked,
        n_active=torch.where(acked, _f32(n_active, nowf), state.n_active),
        q_max=torch.where(acked, _f32(q_max, nowf), state.q_max),
        outstanding=out, deadline=ddl)


def txctl_send(state: TorchTxState, sent, now, gen_time,
               ack_timeout: float) -> TorchTxState:
    """Fresh sends for workers in ``sent`` (bool (W,)): each becomes its
    worker's one outstanding update with a fresh deadline and retry
    budget. Sends claimed for crashed workers are ignored."""
    if state.outstanding is None:
        raise ValueError("txctl_send: the state has no retransmission "
                         "buffers")
    if state.active is not None:
        sent = sent & state.active
    nowf = _f32(now, state.last_ack)
    return dataclasses.replace(
        state, outstanding=state.outstanding | sent,
        sent_gen=torch.where(sent, _f32(gen_time, nowf), state.sent_gen),
        deadline=torch.where(sent, nowf + _f32(ack_timeout, nowf),
                             state.deadline),
        retries=torch.where(sent, 0, state.retries))


def txctl_retransmit(state: TorchTxState, now, ack_timeout: float,
                     backoff: float, max_retries: int):
    """ACK-timeout poll over every worker: ``(due, new_state)``. Due
    workers' retries advance and their deadlines back off exponentially;
    a crashed worker is never due."""
    if state.outstanding is None:
        raise ValueError("txctl_retransmit: the state has no retransmission "
                         "buffers")
    nowf = _f32(now, state.last_ack)
    due = (state.outstanding & (nowf >= state.deadline)
           & (state.retries < max_retries))
    if state.active is not None:
        due = due & state.active
    retries = torch.where(due, state.retries + 1, state.retries)
    deadline = torch.where(
        due, nowf + _f32(ack_timeout, nowf)
        * _f32(backoff, nowf) ** retries.to(torch.float32), state.deadline)
    return due, dataclasses.replace(state, deadline=deadline, retries=retries)
