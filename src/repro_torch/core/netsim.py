"""Deterministic discrete-event network simulator (the paper's ns-3 analogue).

Models the paper's evaluation topologies:

  * microbenchmark (§8.1): many workers -> one accelerator queue (FIFO or
    Olaf) -> constrained output link -> PS;
  * multi-hop (§8.3, Fig. 9): cluster groups behind SW1/SW2 feeding the
    bottleneck SW3 -> PS, with per-switch queues and link capacities;

plus the reverse ACK path that piggybacks queue feedback for the worker-side
transmission control (§5) and multicasts the PS response to the cluster (§7).

Everything is virtual-time and seeded — runs are exactly reproducible.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
from collections import defaultdict
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core.aggregation import Update
from repro_torch.core.aom import average_aom, jain_fairness, per_cluster_average_aom
from repro_torch.core.olaf_queue import PyFifoQueue, PyOlafQueue
from repro_torch.core.txctl import QueueFeedback, TransmissionController, TxControlConfig


# --------------------------------------------------------------------------
# Topology description
# --------------------------------------------------------------------------
@dataclasses.dataclass
class Link:
    """Directed link with serialization capacity and propagation delay."""

    capacity_bps: float
    prop_delay: float = 1e-6


@dataclasses.dataclass
class SwitchCfg:
    name: str
    queue: str = "olaf"  # "olaf" | "fifo"
    queue_slots: int = 8
    reward_threshold: Optional[float] = None
    uplink: Link = dataclasses.field(default_factory=lambda: Link(40e9))
    next_hop: Optional[str] = None  # switch name, or None => PS
    # ordered multi-path candidate set (primary first); None => single path
    next_hops: Optional[Tuple[str, ...]] = None


@dataclasses.dataclass
class WorkerCfg:
    worker_id: int
    cluster_id: int
    ingress_switch: str
    gen_interval: float = 0.1  # mean seconds between fresh updates
    gen_jitter: float = 0.0  # uniform +/- jitter fraction
    trace: Optional[Sequence[float]] = None  # explicit generation times
    n_updates: Optional[int] = None  # stop after this many generations
    size_bits: int = 2048


# --------------------------------------------------------------------------
# Fault model (link loss, scheduled outages, switch stalls)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class LinkFault:
    """Fault behaviour of one switch's uplink(s).

    ``dst`` scopes the fault to the link toward one candidate next hop
    (or the PS when the switch is an egress); ``dst=None`` covers every
    link leaving ``switch``. ``drop_prob`` drops each departing update
    i.i.d.; ``down`` lists half-open ``[t0, t1)`` outage windows during
    which the link carries nothing (departures reroute to a live
    alternate candidate, or are dropped if none exists)."""

    switch: str
    dst: Optional[str] = None
    drop_prob: float = 0.0
    down: Sequence[Tuple[float, float]] = ()


@dataclasses.dataclass
class CorruptionFault:
    """Payload corruption on the worker → ingress first hop.

    Fires at *send time* (fresh sends and retransmitted copies draw
    independently — the worker-side cache keeps the clean bytes, so a
    retransmission can recover a screened original). ``worker`` scopes to
    one worker id, ``switch`` to every worker whose ingress is that
    switch; both ``None`` covers every send. ``prob`` corrupts each
    departing copy i.i.d. from the dedicated fault RNG stream, so a
    zero-probability CorruptionFault is byte-identical to no fault.

    ``mode`` selects the damage:

      * ``"bitflip"`` — XOR a high exponent bit of one payload element
        (silent memory/wire bit damage);
      * ``"nan"`` / ``"inf"`` — overwrite one element with NaN / ±Inf
        (a poisoned gradient);
      * ``"scale"`` — multiply the whole payload by ``factor`` (the
        exploding-update straggler).
    """

    worker: Optional[int] = None
    switch: Optional[str] = None
    prob: float = 0.0
    mode: str = "bitflip"
    factor: float = 1e4


CORRUPTION_MODES = ("bitflip", "nan", "inf", "scale")


def apply_corruption(row: np.ndarray, marker: Tuple[str, int, float]) -> np.ndarray:
    """Apply a ``(mode, seed, factor)`` corruption marker to a payload row.

    Pure function of ``(row, marker)`` — the marker rides the control-plane
    trace, so every consumer (netsim with real payloads, both hybrid
    consumers, tests) reproduces the identical damaged bytes without
    shipping payloads host-side."""
    mode, seed, factor = marker
    out = np.asarray(row, np.float32).copy()
    if out.size == 0:
        return out
    i = int(seed) % out.size
    if mode == "nan":
        out.flat[i] = np.nan
    elif mode == "inf":
        out.flat[i] = np.inf if (int(seed) >> 8) % 2 == 0 else -np.inf
    elif mode == "scale":
        out *= np.float32(factor)
    elif mode == "bitflip":
        out.view(np.uint32).flat[i] ^= np.uint32(1 << 30)
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    return out


def corruption_detectable(marker: Tuple[str, int, float],
                          screen_factor: float) -> bool:
    """Whether the ingress screen catches this marker. Bit damage and
    non-finite injection model checksum / isfinite checks (always
    caught); a ``scale`` fault only trips the norm gate when the factor
    reaches the configured ratio."""
    mode, _seed, factor = marker
    if mode in ("bitflip", "nan", "inf"):
        return True
    return abs(factor) >= screen_factor


@dataclasses.dataclass
class SwitchStall:
    """The switch starts no new transmissions in ``[from_t, until_t)``;
    arrivals still enqueue (and combine, for OLAF queues) meanwhile."""

    switch: str
    from_t: float
    until_t: float


@dataclasses.dataclass
class WorkerFault:
    """Node-level fault for one worker.

    ``crash_t`` kills the worker at that instant: generation stops, its
    outstanding retransmission state dies with the process, and it stops
    hearing ACK multicasts. ``restart_delay`` (requires ``crash_t``)
    brings it back ``delay`` seconds later as a *fresh* member — elastic
    membership: the transmission controller rejoins with no feedback and
    no outstanding update, but keeps its RNG object so the random stream
    stays deterministic. ``slowdown`` > 1 makes the worker a straggler
    (its generation interval is multiplied) for the whole run."""

    worker: int
    crash_t: Optional[float] = None
    restart_delay: Optional[float] = None
    slowdown: float = 1.0


@dataclasses.dataclass
class PSFault:
    """Parameter-server restart at ``restart_t``: for ``recovery`` seconds
    the PS accepts nothing (arrivals in the window are dropped and must be
    recovered by worker retransmission), after which
    ``SimCfg.on_ps_restart`` fires so the trainer can restore from its
    latest checkpoint."""

    restart_t: float
    recovery: float = 0.0

    def down(self, t: float) -> bool:
        return self.restart_t <= t < self.restart_t + self.recovery


@dataclasses.dataclass
class FaultSpec:
    """Declarative failure scenario attached to ``SimCfg.faults``.

    All randomness draws from a dedicated stream (``seed``), so enabling
    a zero-probability FaultSpec leaves a run byte-identical to the
    fault-free baseline. Node faults (``workers`` / ``ps``) are scheduled
    deterministically and consume no randomness at all, so a WorkerFault
    with no crash and unit slowdown is likewise a no-op; a
    zero-probability ``corruption`` entry draws nothing either."""

    links: List[LinkFault] = dataclasses.field(default_factory=list)
    stalls: List[SwitchStall] = dataclasses.field(default_factory=list)
    workers: List[WorkerFault] = dataclasses.field(default_factory=list)
    ps: List[PSFault] = dataclasses.field(default_factory=list)
    corruption: List[CorruptionFault] = dataclasses.field(
        default_factory=list)
    seed: int = 0

    def _match(self, src: str, dst: Optional[str]):
        for lf in self.links:
            if lf.switch == src and (lf.dst is None or lf.dst == dst):
                yield lf

    def drop_prob(self, src: str, dst: Optional[str]) -> float:
        p_keep = 1.0
        for lf in self._match(src, dst):
            p_keep *= 1.0 - lf.drop_prob
        return 1.0 - p_keep

    def link_down(self, src: str, dst: Optional[str], t: float) -> bool:
        return any(t0 <= t < t1 for lf in self._match(src, dst)
                   for (t0, t1) in lf.down)

    def stall_end(self, switch: str, t: float) -> Optional[float]:
        """End of the stall window covering time ``t``, or None."""
        end = None
        for st in self.stalls:
            if st.switch == switch and st.from_t <= t < st.until_t:
                end = st.until_t if end is None else max(end, st.until_t)
        return end

    def worker_slowdown(self, worker_id: int) -> float:
        f = 1.0
        for wf in self.workers:
            if wf.worker == worker_id:
                f *= wf.slowdown
        return f

    def ps_down(self, t: float) -> bool:
        return any(pf.down(t) for pf in self.ps)

    def corruption_candidates(self, worker_id: int, ingress: str):
        """CorruptionFaults matching one worker's send, in declaration
        order (the draw order — deterministic given the spec)."""
        for cf in self.corruption:
            if (cf.worker is None or cf.worker == worker_id) and \
                    (cf.switch is None or cf.switch == ingress):
                yield cf


@dataclasses.dataclass
class SimCfg:
    switches: List[SwitchCfg]
    workers: List[WorkerCfg]
    horizon: float = 10.0
    ack_delay: float = 200e-6  # constant reverse-path delay R
    tx_control: Optional[TxControlConfig] = None  # None => send at will
    seed: int = 0
    faults: Optional[FaultSpec] = None  # None => loss-free fabric
    route_policy: str = "static"  # multi-path hop selection (see topology)
    active_window: float = 1.0  # sliding window for "active clusters" count
    # PS staleness admission control: a hard bound on (arrival - gen_time).
    # Over-stale packets arriving at the PS are rejected outright on FIFO
    # egress queues; on OLAF egress queues they are deferred back into the
    # egress switch (up to ``max_stale_defers`` times) to recombine with
    # fresher same-cluster traffic before a final rejection.
    staleness_bound: Optional[float] = None
    max_stale_defers: int = 1
    # Payload-integrity screening at the ingress pipeline: when enabled, a
    # send whose corruption marker is detectable (checksum-class bit
    # damage / non-finite injection always; norm-class "scale" faults when
    # |factor| >= screen_factor) is screened out before it reaches the
    # combine queue. No ACK ever covers a screened send, so the worker's
    # armed ACK-timeout retransmission recovers it (a NACK by silence) —
    # the same recovery contract as a PSFault window drop.
    ingress_screen: bool = False
    screen_factor: float = 16.0
    # on_ps_restart(now): fires when a PSFault recovery window closes, so
    # the trainer can restore PS state from its latest checkpoint.
    on_ps_restart: Optional[Callable[[float], None]] = None
    # hooks: async-trainer integration.
    # payload_fn(now, worker_id) -> (payload array | None, reward float):
    #   called when a worker generates a fresh update (real PPO gradient).
    # on_deliver(now, update) -> ACK payload (e.g. new global weights).
    # on_ack(now, worker_id, payload): worker receives the PS response.
    payload_fn: Optional[Callable[[float, int], Tuple[Optional[np.ndarray], float]]] = None
    on_deliver: Optional[Callable[[float, Update], object]] = None
    on_ack: Optional[Callable[[float, int, object], None]] = None
    # on_queue_event(now, switch_name, kind, update) with kind in
    # {"enqueue", "lock", "window", "dequeue", "forward", "deliver",
    # "linkdrop", "psdrop", "staledrop", "stalerequeue", "crash",
    # "restart", "straggle"}: fires on every queue transition in event
    # order. This is the control-plane trace consumed by the hybrid device
    # data plane (``repro_torch.core.hybrid``), which replays the switch
    # decisions host-side while all payload bytes move on the accelerator.
    # "window" marks a transmission-window boundary — it fires when a
    # transmission completes, immediately before the departing "dequeue"
    # (the payload must be materialized before it leaves the switch), so a
    # windowed consumer can flush its batched combines there without trace
    # lookahead. Every "dequeue" of a real update is immediately followed
    # by exactly one routing event recording the control-plane decision:
    # "forward" to the chosen next hop (its switch_name is the
    # *destination*), "deliver" to the PS, "linkdrop" when a fault dropped
    # it, "psdrop" when the PS was inside a PSFault recovery window at
    # arrival, "staledrop" when the staleness admission control rejected
    # it, or "stalerequeue" when admission control deferred it back into
    # the same egress switch — so multi-path choices and failures replay
    # identically in the per-event and windowed consumers. The node-fault
    # kinds "crash" / "restart" / "straggle" fire at the worker's ingress
    # switch with a metadata-only update naming the worker; they carry no
    # queue effect and exist so node churn replays through the trace.
    # The payload-integrity kinds fire at the worker's ingress switch
    # *before* any enqueue: "corrupt" records that a CorruptionFault
    # stamped this send (the marker rides ``update.corrupt``, so replay
    # consumers apply the identical byte damage via ``apply_corruption``);
    # "screen" records that ingress screening rejected the send — the
    # update never enqueues, and the consumer must still consume its
    # payload row (fresh sends) so row budgets stay aligned.
    on_queue_event: Optional[Callable[[float, str, str, Optional[Update]], None]] = None


# --------------------------------------------------------------------------
# Simulator
# --------------------------------------------------------------------------
class _Switch:
    def __init__(self, cfg: SwitchCfg) -> None:
        self.cfg = cfg
        if cfg.queue == "olaf":
            self.queue: Union[PyOlafQueue, PyFifoQueue] = PyOlafQueue(
                cfg.queue_slots, cfg.reward_threshold)
        elif cfg.queue == "fifo":
            self.queue = PyFifoQueue(cfg.queue_slots)
        else:
            raise ValueError(cfg.queue)
        self.busy = False
        self.stalled = False  # inside a FaultSpec stall window
        self.last_seen: Dict[int, float] = {}  # cluster -> last arrival time
        self._max_window = 0.0  # widest active_clusters() probe seen

    def active_clusters(self, now: float, window: float) -> int:
        # Sim time is monotone, so entries that fell out of the sliding
        # window can be pruned outright — they only return on a new arrival.
        # Keeps last_seen (and this count) O(active), not O(ever seen).
        # Pruning uses the largest window this switch has been probed with,
        # so a narrower probe can never delete entries a wider one counts.
        self._max_window = max(self._max_window, window)
        stale = [c for c, t in self.last_seen.items()
                 if now - t > self._max_window]
        for c in stale:
            del self.last_seen[c]
        return sum(1 for t in self.last_seen.values() if now - t <= window)

    def feedback(self, now: float, window: float) -> QueueFeedback:
        return QueueFeedback(
            n_active_clusters=self.active_clusters(now, window),
            q_max=self.cfg.queue_slots,
            q_occupancy=len(self.queue),
            timestamp=now,
        )


@dataclasses.dataclass
class SimResult:
    horizon: float
    deliveries: Dict[int, List[Tuple[float, float]]]  # cluster -> (D, gen)
    delivered_updates: List[Update]
    generated: int
    sent: int
    deferred: int
    received_at_ps: int
    raw_updates_delivered: int  # sum of agg_count over deliveries
    queue_stats: Dict[str, Dict[str, int]]
    agg_counts: List[int]  # per delivered packet, for the Fig. 6 CDF
    # ---- failure accounting (all zero on a fault-free fabric) ------------
    link_dropped: int = 0  # packets lost to faults (post-combine)
    raw_link_dropped: int = 0  # raw worker updates inside those packets
    retransmits: int = 0  # worker-side ACK-timeout re-sends
    reroutes: int = 0  # departures steered off the primary next hop
    unrecovered_drops: int = 0  # dropped packets never covered by a later
    #   same-cluster delivery with gen_time >= theirs (retransmit/reroute
    #   recovered everything else)
    drops_by_switch: Dict[str, int] = dataclasses.field(default_factory=dict)
    reroutes_by_switch: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    # ---- node-fault accounting (worker/PS churn, staleness admission) ----
    unique_delivered: int = 0  # distinct fresh sends whose information
    #   reached the PS (uid-deduplicated: retransmitted copies and
    #   combine-subsumed updates count once)
    ps_dropped: int = 0  # packets lost to a PSFault recovery window
    stale_rejected: int = 0  # packets rejected by the staleness bound
    stale_deferred: int = 0  # defer-and-recombine events (OLAF egress)
    worker_crashes: int = 0
    worker_restarts: int = 0
    ps_restarts: int = 0
    # ---- payload-integrity accounting ------------------------------------
    corrupted: int = 0  # sends stamped by a CorruptionFault
    screened: int = 0  # corrupted sends rejected by ingress screening
    tainted_delivered: int = 0  # deliveries still carrying a corruption
    #   marker (with screening on, only undetectable sub-threshold scale
    #   faults should ever land here)

    # ---- derived metrics -------------------------------------------------
    @property
    def loss_pct(self) -> float:
        """Total shortfall between raw updates sent and raw updates that
        reached the PS — combine-absorption, genuine link loss, and
        residual in-queue occupancy all count. See ``link_loss_pct`` /
        ``absorbed_pct`` for the decomposition once faults exist."""
        if self.sent == 0:
            return 0.0
        return 100.0 * (self.sent - self.raw_updates_delivered) / self.sent

    @property
    def link_loss_pct(self) -> float:
        """Share of sent raw updates genuinely lost in flight (link drops
        and outages), as opposed to absorbed by opportunistic combining."""
        if self.sent == 0:
            return 0.0
        return 100.0 * self.raw_link_dropped / self.sent

    @property
    def absorbed_pct(self) -> float:
        """loss_pct minus the genuinely-dropped share: the part explained
        by combine-absorption and end-of-horizon queue residue."""
        return self.loss_pct - self.link_loss_pct

    @property
    def delivery_rate(self) -> float:
        """Fraction of unique sent updates whose information reached the
        PS. Each fresh send carries a unique id; a retransmitted copy
        reuses the original's id and combining unions them, so this can
        never exceed 1.0 (the raw per-copy ratio lives in
        ``raw_delivery_rate``)."""
        if self.sent == 0:
            return 1.0
        return self.unique_delivered / self.sent

    @property
    def raw_delivery_rate(self) -> float:
        """Raw subsumed-update copies delivered / fresh sends. Exceeds 1.0
        when retransmitted duplicates of the same update all deliver —
        kept for loss-decomposition continuity; use ``delivery_rate`` for
        the normalized metric."""
        if self.sent == 0:
            return 1.0
        return self.raw_updates_delivered / self.sent

    @property
    def busy_end(self) -> float:
        """Last delivery time — the AoM observation window end (the idle
        tail after traffic stops would otherwise dominate the average)."""
        ends = [dl[-1][0] for dl in self.deliveries.values() if dl]
        return max(ends) if ends else self.horizon

    def avg_aom(self, clusters: Optional[Sequence[int]] = None) -> float:
        per = self.per_cluster_aom()
        keys = list(per) if clusters is None else [c for c in clusters if c in per]
        if not keys:
            return float("nan")
        return float(np.mean([per[c] for c in keys]))

    def per_cluster_aom(self) -> Dict[int, float]:
        return per_cluster_average_aom(self.deliveries, self.busy_end)

    def aom_fairness(self) -> float:
        return jain_fairness(self.per_cluster_aom().values())

    def aggregation_cdf(self) -> Tuple[np.ndarray, np.ndarray]:
        if not self.agg_counts:
            return np.array([0]), np.array([1.0])
        xs = np.sort(np.asarray(self.agg_counts))
        ys = np.arange(1, xs.size + 1) / xs.size
        return xs, ys


# --------------------------------------------------------------------------
# Shared per-event semantics (the oracle role). The event-driven simulator
# below and the vectorized device-resident model (``core/vecsim.py``) both
# consume these pure helpers, so the two implementations cannot drift on
# the rules they encode.
# --------------------------------------------------------------------------
def next_gen_time(w: WorkerCfg, k: int, now: float, rng,
                  faults: Optional[FaultSpec]) -> Optional[float]:
    """The k-th generation time of worker ``w`` (None = chain exhausted):
    trace lookup, or jittered/slowed interval pacing from ``now`` (the
    predecessor's pop time; the first interval paces from t=0). ``rng`` is
    the simulator's shared jitter stream — one ``random()`` draw iff
    ``gen_jitter > 0``."""
    if w.n_updates is not None and k >= w.n_updates:
        return None
    if w.trace is not None:
        return w.trace[k] if k < len(w.trace) else None
    base = w.gen_interval
    if faults is not None:
        slow = faults.worker_slowdown(w.worker_id)
        if slow != 1.0:  # guard: keep unit-slowdown byte-identical
            base *= slow
    if w.gen_jitter > 0:
        base *= 1.0 + w.gen_jitter * (2 * rng.random() - 1)
    return (now if k else 0.0) + base


def generation_schedule(cfg: SimCfg) -> Tuple[Dict[int, List[float]],
                                              List[Tuple[int, int]]]:
    """Replay *only* the generation chains of ``cfg``'s event heap.

    Returns ``(times, order)``: per-worker lists of executed generation
    times (every generation with ``t <= horizon``), and the global
    execution order as ``(worker_id, k)`` pairs — the heap pop order the
    event simulator processes them in, which is also the payload-row
    consumption order of the hybrid consumers.

    Exactness: the simulator's jitter stream (``default_rng(cfg.seed)``)
    is consumed *only* by :func:`next_gen_time`, in heap pop order of
    generation events. Removing all foreign events from the heap preserves
    the relative order of the generation events (their ``eseq``
    tie-breakers form a monotone subsequence of the original counter), so
    this replay draws the identical jitter sequence and reproduces the
    exact times — the precomputed send schedule of the vectorized model.
    Only valid without worker churn (a crash/restart reorders chain pops);
    the vectorized model's feature envelope enforces that.
    """
    rng = np.random.default_rng(cfg.seed)
    heap: List[Tuple[float, int, WorkerCfg]] = []
    eseq = itertools.count()
    counts: Dict[int, int] = defaultdict(int)
    times: Dict[int, List[float]] = {w.worker_id: [] for w in cfg.workers}
    order: List[Tuple[int, int]] = []

    def schedule(w: WorkerCfg, now: float) -> None:
        t = next_gen_time(w, counts[w.worker_id], now, rng, cfg.faults)
        if t is None:
            return
        # mirror _schedule_generation: never regress virtual time
        heapq.heappush(heap, (max(t, now), next(eseq), w))

    for w in cfg.workers:
        schedule(w, 0.0)
    while heap:
        t, _, w = heapq.heappop(heap)
        if t > cfg.horizon:
            break  # pops are time-ordered: nothing executable remains
        order.append((w.worker_id, counts[w.worker_id]))
        times[w.worker_id].append(t)
        counts[w.worker_id] += 1
        schedule(w, t)
    return times, order


def link_stream_index(spec, src: str, dst: Optional[str]) -> int:
    """Stable per-link index for the i.i.d. loss RNG streams: one row per
    directed (src -> candidate) pair plus one per (src -> PS) egress.
    Shared by :meth:`NetworkSimulator._link_rng` and the vectorized
    model's precomputed per-link uniform tables, so both draw the same
    loss sequence for the same link."""
    S = spec.num_switches
    return spec.index[src] * (S + 1) + (spec.index[dst]
                                        if dst is not None else S)


class NetworkSimulator:
    """Event-driven simulator; see module docstring."""

    def __init__(self, cfg: SimCfg) -> None:
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.switches = {s.name: _Switch(s) for s in cfg.switches}
        self.now = 0.0
        # compile the topology once: candidate sets + route policy for
        # multi-path forwarding, and construction-time wiring validation
        from repro_torch.core.topology import spec_from_switch_cfgs  # lazy: cycle
        self.spec = spec_from_switch_cfgs(
            cfg.switches, route_policy=cfg.route_policy)
        if cfg.workers:
            self.spec.validate_ingress(
                [w.ingress_switch for w in cfg.workers])
        self._events: List[Tuple[float, int, Callable[[], None]]] = []
        self._eseq = itertools.count()
        self._payload_seq = itertools.count()
        # per-worker transmission controllers
        self.controllers: Dict[int, TransmissionController] = {}
        for w in cfg.workers:
            tc_cfg = cfg.tx_control if cfg.tx_control is not None else None
            if tc_cfg is not None:
                self.controllers[w.worker_id] = TransmissionController(
                    tc_cfg, np.random.default_rng(cfg.seed * 7919 + w.worker_id))
        self.workers_by_cluster: Dict[int, List[WorkerCfg]] = defaultdict(list)
        for w in cfg.workers:
            self.workers_by_cluster[w.cluster_id].append(w)
        # fault machinery: dedicated RNG stream so a zero-probability
        # FaultSpec cannot perturb the fault-free event sequence
        self.faults = cfg.faults
        fseed = (cfg.faults.seed if cfg.faults is not None else 0)
        self._fault_seed_base = fseed * 104729 + cfg.seed * 7919 + 11
        self.fault_rng = np.random.default_rng(self._fault_seed_base)
        # per-link i.i.d. loss streams (created lazily, only for links with
        # a positive drop probability): keyed by link_stream_index so the
        # vectorized model can precompute the identical uniform tables
        self._link_rngs: Dict[Tuple[str, Optional[str]], np.random.Generator] = {}
        # worker-side retransmission cache: last sent
        # (gen, reward, payload, uid)
        self._last_sent: Dict[
            int, Tuple[float, float, Optional[np.ndarray], int]] = {}
        # node-fault machinery: crashed workers, per-worker generation-chain
        # epochs (a crash/restart bumps the epoch so pre-crash chain events
        # become no-ops), and PS availability windows
        self._worker_cfg: Dict[int, WorkerCfg] = {
            w.worker_id: w for w in cfg.workers}
        self._crashed: set = set()
        self._worker_epoch: Dict[int, int] = defaultdict(int)
        # unique-send accounting for the normalized delivery rate
        self._uid_seq = itertools.count()
        self._delivered_uids: set = set()
        # metrics
        self.deliveries: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
        self.delivered_updates: List[Update] = []
        self.generated = 0
        self.sent = 0
        self.deferred = 0
        self.agg_counts: List[int] = []
        self._gen_count: Dict[int, int] = defaultdict(int)
        # failure accounting
        self.link_dropped = 0
        self.raw_link_dropped = 0
        self.retransmits = 0
        self.reroutes = 0
        self.drops_by_switch: Dict[str, int] = defaultdict(int)
        self.reroutes_by_switch: Dict[str, int] = defaultdict(int)
        self._dropped_info: List[Tuple[int, float]] = []  # (cluster, gen)
        self._max_delivered_gen: Dict[int, float] = {}
        # node-fault accounting
        self.ps_dropped = 0
        self.stale_rejected = 0
        self.stale_deferred = 0
        self.worker_crashes = 0
        self.worker_restarts = 0
        self.ps_restarts = 0
        # payload-integrity accounting
        self.corrupted = 0
        self.screened = 0
        self.tainted_delivered = 0

    # -- event plumbing ----------------------------------------------------
    def _at(self, t: float, fn: Callable[[], None]) -> None:
        heapq.heappush(self._events, (t, next(self._eseq), fn))

    def run(self) -> SimResult:
        self._schedule_node_faults()
        for w in self.cfg.workers:
            self._schedule_generation(w, first=True)
        while self._events:
            t, _, fn = heapq.heappop(self._events)
            if t > self.cfg.horizon:
                break
            self.now = t
            fn()
        raw = sum(u.subsumed for u in self.delivered_updates)
        # a dropped packet is *recovered* iff a later same-cluster delivery
        # carried model state at least as fresh (a retransmitted copy keeps
        # the original gen_time, and OLAF combining keeps the max)
        unrecovered = sum(
            1 for (c, g) in self._dropped_info
            if g > self._max_delivered_gen.get(c, -math.inf))
        return SimResult(
            horizon=self.cfg.horizon,
            deliveries=dict(self.deliveries),
            delivered_updates=self.delivered_updates,
            generated=self.generated,
            sent=self.sent,
            deferred=self.deferred,
            received_at_ps=len(self.delivered_updates),
            raw_updates_delivered=raw,
            queue_stats={n: s.queue.stats.as_dict() for n, s in self.switches.items()},
            agg_counts=self.agg_counts,
            link_dropped=self.link_dropped,
            raw_link_dropped=self.raw_link_dropped,
            retransmits=self.retransmits,
            reroutes=self.reroutes,
            unrecovered_drops=unrecovered,
            drops_by_switch=dict(self.drops_by_switch),
            reroutes_by_switch=dict(self.reroutes_by_switch),
            unique_delivered=len(self._delivered_uids),
            ps_dropped=self.ps_dropped,
            stale_rejected=self.stale_rejected,
            stale_deferred=self.stale_deferred,
            worker_crashes=self.worker_crashes,
            worker_restarts=self.worker_restarts,
            ps_restarts=self.ps_restarts,
            corrupted=self.corrupted,
            screened=self.screened,
            tainted_delivered=self.tainted_delivered,
        )

    # -- node faults (worker crash/restart/straggle, PS restart) -----------
    def _schedule_node_faults(self) -> None:
        if self.faults is None:
            return
        for wf in self.faults.workers:
            w = self._worker_cfg.get(wf.worker)
            if w is None:
                continue
            if wf.slowdown != 1.0:
                # one trace event at t=0 so straggler membership replays
                self._queue_event(w.ingress_switch, "straggle",
                                  self._node_event_update(w, wf.slowdown))
            if wf.crash_t is not None:
                self._at(wf.crash_t, lambda f=wf: self._on_worker_crash(f))
                if wf.restart_delay is not None:
                    self._at(wf.crash_t + wf.restart_delay,
                             lambda f=wf: self._on_worker_restart(f))
        for pf in self.faults.ps:
            self._at(pf.restart_t + pf.recovery,
                     lambda: self._on_ps_restarted())

    def _node_event_update(self, w: WorkerCfg, reward: float = 0.0) -> Update:
        """Metadata-only marker naming the worker, for node-fault trace
        events (never enqueued anywhere)."""
        return Update(cluster_id=w.cluster_id, worker_id=w.worker_id,
                      gen_time=self.now, reward=reward)

    def _ps_down(self, t: float) -> bool:
        return self.faults is not None and self.faults.ps_down(t)

    def _on_worker_crash(self, wf: WorkerFault) -> None:
        if wf.worker in self._crashed:
            return
        self._crashed.add(wf.worker)
        self._worker_epoch[wf.worker] += 1  # kill the generation chain
        self.worker_crashes += 1
        w = self._worker_cfg[wf.worker]
        self._queue_event(w.ingress_switch, "crash",
                          self._node_event_update(w))

    def _on_worker_restart(self, wf: WorkerFault) -> None:
        if wf.worker not in self._crashed:
            return
        self._crashed.discard(wf.worker)
        self._worker_epoch[wf.worker] += 1
        self.worker_restarts += 1
        w = self._worker_cfg[wf.worker]
        ctl = self.controllers.get(wf.worker)
        if ctl is not None:
            # elastic membership: rejoin as a fresh member — feedback and
            # outstanding-update state died with the process, but the RNG
            # object survives so the send-decision stream stays seeded
            ctl.last_ack_time = None
            ctl.feedback = None
            ctl.outstanding = False
            ctl.sent_gen = -math.inf
            ctl.deadline = math.inf
            ctl.retries = 0
        self._last_sent.pop(wf.worker, None)
        self._queue_event(w.ingress_switch, "restart",
                          self._node_event_update(w))
        self._schedule_generation(w)

    def _on_ps_restarted(self) -> None:
        self.ps_restarts += 1
        if self.cfg.on_ps_restart is not None:
            self.cfg.on_ps_restart(self.now)

    # -- worker side ---------------------------------------------------------
    def _next_gen_time(self, w: WorkerCfg) -> Optional[float]:
        return next_gen_time(w, self._gen_count[w.worker_id], self.now,
                             self.rng, self.faults)

    def _schedule_generation(self, w: WorkerCfg, first: bool = False) -> None:
        t = self._next_gen_time(w)
        if t is None:
            return
        # a restart may schedule from a trace time already in the past;
        # never let the event heap regress virtual time
        t = max(t, self.now)
        epoch = self._worker_epoch[w.worker_id]
        self._at(t, lambda: self._on_generate(w, epoch))

    def _on_generate(self, w: WorkerCfg, epoch: Optional[int] = None) -> None:
        if epoch is not None and epoch != self._worker_epoch[w.worker_id]:
            return  # chain superseded by a crash/restart; the new epoch
            #   (if any) has its own chain
        if w.worker_id in self._crashed:
            return  # worker is down; restart reschedules the chain
        self.generated += 1
        self._gen_count[w.worker_id] += 1
        ctl = self.controllers.get(w.worker_id)
        send = True
        if ctl is not None:
            send = ctl.should_send(self.now)
        if send:
            self.sent += 1
            payload, reward = (None, 0.0)
            if self.cfg.payload_fn is not None:
                payload, reward = self.cfg.payload_fn(self.now, w.worker_id)
            uid = next(self._uid_seq)
            upd = Update(cluster_id=w.cluster_id, worker_id=w.worker_id,
                         gen_time=self.now, reward=reward, payload=payload,
                         size_bits=w.size_bits, uids=frozenset((uid,)))
            if ctl is not None and ctl.cfg.ack_timeout is not None:
                # arm loss recovery: remember what we sent and poll the
                # controller when its ACK deadline expires
                self._last_sent[w.worker_id] = (self.now, reward, payload, uid)
                ctl.on_send(self.now, self.now)
                self._at(ctl.deadline, lambda: self._maybe_retransmit(w))
            self._send_update(w, upd)
        else:
            self.deferred += 1  # worker keeps training; next update subsumes
        self._schedule_generation(w)

    def _maybe_retransmit(self, w: WorkerCfg) -> None:
        """ACK-deadline poll: re-send the worker's outstanding update if
        the controller says its timeout (with exponential backoff) expired
        and the retry budget allows another copy."""
        if w.worker_id in self._crashed:
            return  # the retransmission state died with the process
        ctl = self.controllers.get(w.worker_id)
        if ctl is None or not ctl.poll_retransmit(self.now):
            return  # acked, superseded, stale poll, or budget exhausted
        gen, reward, payload, uid = self._last_sent[w.worker_id]
        self.retransmits += 1
        # the copy reuses the original's uid: delivering either (or both)
        # counts the fresh send as delivered exactly once
        upd = Update(cluster_id=w.cluster_id, worker_id=w.worker_id,
                     gen_time=gen, reward=reward,
                     payload=None if payload is None else payload.copy(),
                     size_bits=w.size_bits, retx=ctl.retries,
                     uids=frozenset((uid,)))
        self._send_update(w, upd)
        self._at(ctl.deadline, lambda: self._maybe_retransmit(w))

    def _queue_event(self, name: str, kind: str, upd: Optional[Update]) -> None:
        if self.cfg.on_queue_event is not None:
            self.cfg.on_queue_event(self.now, name, kind, upd)

    # -- payload integrity (send-time corruption + ingress screening) -------
    def _draw_corruption(self, w: WorkerCfg) -> Optional[Tuple[str, int, float]]:
        """Draw a corruption marker for one departing send, or None. One
        RNG draw per matching positive-probability fault (first firing
        wins), so zero-probability specs consume no randomness."""
        if self.faults is None or not self.faults.corruption:
            return None
        for cf in self.faults.corruption_candidates(
                w.worker_id, w.ingress_switch):
            if cf.prob > 0.0 and self.fault_rng.random() < cf.prob:
                seed = int(self.fault_rng.integers(0, 2 ** 31 - 1))
                return (cf.mode, seed, cf.factor)
        return None

    def _send_update(self, w: WorkerCfg, upd: Update) -> None:
        """Last hop before the ingress switch: apply send-time corruption,
        then ingress screening. ``_last_sent`` cached the clean payload
        *before* this point, so a screened (or lost) copy is recoverable
        by retransmission with fresh corruption draws."""
        marker = self._draw_corruption(w)
        if marker is not None:
            upd.corrupt = marker
            if upd.payload is not None:
                upd.payload = apply_corruption(upd.payload, marker)
            self.corrupted += 1
            self._queue_event(w.ingress_switch, "corrupt",
                              dataclasses.replace(upd, payload=None))
            if self.cfg.ingress_screen and corruption_detectable(
                    marker, self.cfg.screen_factor):
                # screened before the combine queue: no ACK will ever
                # cover this send, so the worker's armed ACK-timeout
                # retransmission recovers it — a NACK by silence, the
                # same contract as a PSFault recovery-window drop
                self.screened += 1
                self._dropped_info.append((upd.cluster_id, upd.gen_time))
                self._queue_event(w.ingress_switch, "screen",
                                  dataclasses.replace(upd, payload=None))
                return
        self._arrive_at_switch(w.ingress_switch, upd)

    # -- switch / queue path -------------------------------------------------
    def _arrive_at_switch(self, name: str, upd: Update) -> None:
        sw = self.switches[name]
        sw.last_seen[upd.cluster_id] = self.now
        # snapshot before enqueue: the queue may merge-mutate the update
        if self.cfg.on_queue_event is not None:
            snap = dataclasses.replace(upd, payload=None)
        sw.queue.enqueue(upd)
        if self.cfg.on_queue_event is not None:
            self._queue_event(name, "enqueue", snap)
        if not sw.busy:
            self._start_transmission(sw)

    def _start_transmission(self, sw: _Switch) -> None:
        head = sw.queue.peek()
        if head is None:
            sw.busy = False
            return
        if self.faults is not None and not sw.stalled:
            end = self.faults.stall_end(sw.cfg.name, self.now)
            if end is not None:
                # stall: nothing departs until the window closes, but
                # arrivals keep combining (the head stays unlocked)
                sw.stalled = True
                self._at(end, lambda: self._end_stall(sw))
                return
        if sw.stalled:
            return  # resume event will restart us
        sw.busy = True
        if isinstance(sw.queue, PyOlafQueue):
            sw.queue.lock_head()  # §12.1: in-flight update cannot be combined
            self._queue_event(sw.cfg.name, "lock", head)
        tx_time = head.size_bits / sw.cfg.uplink.capacity_bps
        self._at(self.now + tx_time, lambda: self._finish_transmission(sw))

    def _end_stall(self, sw: _Switch) -> None:
        sw.stalled = False
        if not sw.busy and len(sw.queue):
            self._start_transmission(sw)

    def _finish_transmission(self, sw: _Switch) -> None:
        # the transmission window closes here: everything enqueued since
        # the previous departure must be combined before the head leaves
        self._queue_event(sw.cfg.name, "window", None)
        upd = sw.queue.dequeue()
        self._queue_event(sw.cfg.name, "dequeue", upd)
        sw.busy = False
        if upd is not None:
            self._route_departure(sw, upd)
        if len(sw.queue):
            self._start_transmission(sw)

    def _route_departure(self, sw: _Switch, upd: Update) -> None:
        """Control-plane routing decision for one departed update: pick a
        live candidate next hop (multi-path), apply the fault model, and
        record the decision in the trace ("forward" / "deliver" /
        "linkdrop") so replays cannot diverge."""
        name = sw.cfg.name
        src = self.spec.index[name]
        cands = self.spec.candidates[src]
        arrive = self.now + sw.cfg.uplink.prop_delay
        if not cands:  # PS egress
            if self._link_faulted(name, None):
                self._record_drop(name, upd)
                return
            if self._ps_down(arrive):
                # the PS is inside a PSFault recovery window when this
                # packet would land: it is lost, but (unlike a staleness
                # rejection) recoverable — no ACK arrives, so the worker's
                # retransmission timer covers it
                self.ps_dropped += 1
                self._dropped_info.append((upd.cluster_id, upd.gen_time))
                self._queue_event(name, "psdrop", upd)
                return
            bound = self.cfg.staleness_bound
            if bound is not None and (arrive - upd.gen_time) > bound:
                sw_q = sw.queue
                if (isinstance(sw_q, PyOlafQueue)
                        and upd.defers < self.cfg.max_stale_defers):
                    # OLAF egress: defer-and-recombine — re-enqueue at the
                    # same switch so Algorithm 1 can merge it with fresher
                    # same-cluster traffic before the retry
                    upd.defers += 1
                    self.stale_deferred += 1
                    self._queue_event(name, "stalerequeue", upd)
                    self._at(arrive,
                             lambda u=upd, n=name: self._arrive_at_switch(n, u))
                    return
                # FIFO egress (or defer budget spent): hard rejection
                self.stale_rejected += 1
                self._queue_event(name, "staledrop", upd)
                return
            self._queue_event(name, "deliver", upd)
            self._at(arrive, lambda u=upd: self._deliver_to_ps(u))
            return
        up = [c for c in cands
              if self.faults is None
              or not self.faults.link_down(name, self.spec.names[c],
                                           self.now)]
        if not up:  # every candidate link is down
            self._record_drop(name, upd)
            return
        dst = self.spec.select_hop(
            src, upd.cluster_id, upd.worker_id, up,
            depth_fn=lambda v: len(self.switches[self.spec.names[v]].queue))
        dst_name = self.spec.names[dst]
        if self._link_faulted(name, dst_name):
            self._record_drop(name, upd)
            return
        if dst != int(self.spec.next_hop[src]):
            self.reroutes += 1
            self.reroutes_by_switch[name] += 1
        # the "forward" event names the *destination* — the source is the
        # switch whose "dequeue" immediately precedes it in the trace
        self._queue_event(dst_name, "forward", upd)
        self._at(arrive,
                 lambda u=upd, n=dst_name: self._arrive_at_switch(n, u))

    def _link_rng(self, src: str, dst: Optional[str]) -> np.random.Generator:
        key = (src, dst)
        rng = self._link_rngs.get(key)
        if rng is None:
            rng = np.random.default_rng(
                [self._fault_seed_base, link_stream_index(self.spec, src, dst)])
            self._link_rngs[key] = rng
        return rng

    def _link_faulted(self, src: str, dst: Optional[str]) -> bool:
        """True if the (src → dst) departure is lost: the link is inside
        an outage window, or the i.i.d. drop probability fires. Each lossy
        link draws from its own seeded stream (see ``link_stream_index``)
        — consulted only when a positive drop probability is configured,
        so fault-free runs stay byte-identical — which is what lets the
        vectorized model precompute per-link uniform tables that replay
        the identical loss sequence with zero host round-trips."""
        if self.faults is None:
            return False
        if self.faults.link_down(src, dst, self.now):
            return True
        p = self.faults.drop_prob(src, dst)
        return p > 0.0 and self._link_rng(src, dst).random() < p

    def _record_drop(self, name: str, upd: Update) -> None:
        self.link_dropped += 1
        self.raw_link_dropped += upd.subsumed
        self.drops_by_switch[name] += 1
        self._dropped_info.append((upd.cluster_id, upd.gen_time))
        self._queue_event(name, "linkdrop", upd)

    # -- PS + reverse path -----------------------------------------------------
    def _deliver_to_ps(self, upd: Update) -> None:
        self.deliveries[upd.cluster_id].append((self.now, upd.gen_time))
        self.delivered_updates.append(upd)
        self.agg_counts.append(upd.agg_count)
        if upd.corrupt is not None:
            self.tainted_delivered += 1
        if upd.uids is not None:
            self._delivered_uids |= upd.uids
        prev = self._max_delivered_gen.get(upd.cluster_id, -math.inf)
        self._max_delivered_gen[upd.cluster_id] = max(prev, upd.gen_time)
        payload = None
        if self.cfg.on_deliver is not None:
            payload = self.cfg.on_deliver(self.now, upd)
        # ACK multicast to the cluster after constant reverse delay R; it
        # carries the *current* bottleneck queue state (max pressure on
        # path) plus the delivered gen_time, which clears the cluster's
        # outstanding-retransmission state for updates it subsumes.
        fb = self._path_feedback()
        t_ack = self.now + self.cfg.ack_delay
        for w in self.workers_by_cluster[upd.cluster_id]:
            self._at(t_ack, lambda wid=w.worker_id, f=fb, p=payload,
                     g=upd.gen_time: self._on_ack(wid, f, p, g))

    def _path_feedback(self) -> QueueFeedback:
        best: Optional[QueueFeedback] = None
        pressure = -1.0
        for sw in self.switches.values():
            fb = sw.feedback(self.now, self.cfg.active_window)
            pr = fb.n_active_clusters / max(fb.q_max, 1)
            if pr > pressure:
                pressure, best = pr, fb
        assert best is not None
        return best

    def _on_ack(self, worker_id: int, fb: QueueFeedback, payload: object,
                delivered_gen: Optional[float] = None) -> None:
        if worker_id in self._crashed:
            return  # a down worker misses the ACK multicast
        ctl = self.controllers.get(worker_id)
        if ctl is not None:
            ctl.on_ack(self.now, fb, delivered_gen=delivered_gen)
        if self.cfg.on_ack is not None:
            self.cfg.on_ack(self.now, worker_id, payload)


# --------------------------------------------------------------------------
# Canned topologies from the paper
# --------------------------------------------------------------------------
def microbench_cfg(queue: str, out_gbps: float, *, n_clusters: int = 9,
                   workers_per_cluster: int = 3, n_updates: Optional[int] = 500,
                   in_gbps_total: float = 60.0, size_bits: int = 2048,
                   queue_slots: int = 8, seed: int = 0,
                   horizon: float = 30.0) -> SimCfg:
    """§8.1 microbenchmark: 27 workers / 9 clusters at 60 Gbps aggregate into
    one accelerator queue with a constrained output link."""
    n_workers = n_clusters * workers_per_cluster
    # per-worker generation interval so aggregate offered load = in_gbps_total
    per_worker_bps = in_gbps_total * 1e9 / n_workers
    interval = size_bits / per_worker_bps
    workers = [
        WorkerCfg(worker_id=i, cluster_id=i % n_clusters, ingress_switch="ACC",
                  gen_interval=interval, gen_jitter=0.15, n_updates=n_updates,
                  size_bits=size_bits)
        for i in range(n_workers)
    ]
    sw = SwitchCfg(name="ACC", queue=queue, queue_slots=queue_slots,
                   uplink=Link(out_gbps * 1e9), next_hop=None)
    return SimCfg(switches=[sw], workers=workers, horizon=horizon, seed=seed)


def multihop_cfg(queue: str, *, interval_s1: float = 0.1, interval_s2: float = 0.1,
                 x1_gbps: float = 10.0, x2_gbps: float = 10.0,
                 sw3_gbps: float = 10.0, tx_control: Optional[TxControlConfig] = None,
                 n_clusters_per_group: int = 5, workers_per_cluster: int = 10,
                 size_bits: int = 8192, horizon: float = 30.0,
                 sw12_slots: int = 5, sw3_slots: int = 8, seed: int = 0,
                 reward_threshold: Optional[float] = None) -> SimCfg:
    """§8.3 multi-hop topology (Fig. 9): C1-C5 -> SW1 -> SW3 -> PS and
    C6-C10 -> SW2 -> SW3 -> PS, 10 workers per cluster, 1 kB updates.

    The SW1/SW2/SW3 switch wiring is one :func:`repro_torch.core.topology.
    multihop_spec` preset compiled to ``SwitchCfg``/``Link``s — see
    ``repro_torch.core.topology`` for the whole declarative topology family
    (chains, wide fan-in, fat-tree, multi-rack, multi-PS egress)."""
    from repro_torch.core.topology import multihop_spec  # lazy: avoids cycle
    workers: List[WorkerCfg] = []
    wid = 0
    for g, (sw, interval) in enumerate([("SW1", interval_s1), ("SW2", interval_s2)]):
        for c in range(n_clusters_per_group):
            cluster = g * n_clusters_per_group + c
            for _ in range(workers_per_cluster):
                workers.append(WorkerCfg(
                    worker_id=wid, cluster_id=cluster, ingress_switch=sw,
                    gen_interval=interval, gen_jitter=0.3, size_bits=size_bits))
                wid += 1
    switches = multihop_spec(
        x1_gbps=x1_gbps, x2_gbps=x2_gbps, sw3_gbps=sw3_gbps,
        sw12_slots=sw12_slots, sw3_slots=sw3_slots,
        reward_threshold=reward_threshold).switch_cfgs(queue=queue)
    return SimCfg(switches=switches, workers=workers, horizon=horizon,
                  tx_control=tx_control, seed=seed)
