"""Hybrid multi-switch data plane: netsim control plane, payloads on the card.

The port of ``repro.core.hybrid``. Each OLAF switch is split across the
host/device boundary for any switch DAG described by a
:class:`~repro_torch.core.topology.TopologySpec` (the §8.3 SW1/SW2→SW3
fan-in is one preset; fat-tree, multi-rack and multi-PS egress are others):

  * control plane — the discrete-event
    :class:`~repro_torch.core.netsim.NetworkSimulator` runs metadata-only
    and emits its queue transitions through ``on_queue_event`` (the trace).
    The trace is replayed against per-switch
    :class:`~repro_torch.core.olaf_queue.PyOlafQueue` mirrors, which
    re-derive every aggregate / replace / append / drop decision.
  * data plane — every payload byte lives in one ``(S, Q, D)`` slot buffer
    on ``device`` (Q = the widest switch; narrower switches ride padded).
    Pending combines accumulate per switch; at each departure ONE
    :func:`repro_torch.kernels.ops.olaf_forward` dispatch lands the flush
    set's pending window (the hand-written ``olaf_combine`` kernel on a
    card) and gathers and clears the departing row, which is routed to its
    next hop on the device: transit hops never copy payload bytes to the
    host. The kernel's ``gate`` carries each packet's ``agg_count``, so
    multi-hop combining stays an exact weighted mean of the raw gradients.

A boundary at switch ``s`` lands only ``s`` and its upstream frontier
(``TopologySpec.flush_set``) with ``flush_cadence=True``; ``False`` lands
every switch. Every dequeue in the trace is followed by one routing event
(``forward`` to the chosen next hop, ``deliver`` to the PS, ``linkdrop`` /
``psdrop`` / ``staledrop`` when the packet is lost, ``stalerequeue`` for a
forward-to-self); the departure's dispatch is deferred to it, so the chosen
hop rides the same call as the drained row. Traces without routing events
fall back to the spec's static next hop.

:meth:`HybridMultiSwitchDataPlane.feed` replays one event per call (the
reference); :meth:`~HybridMultiSwitchDataPlane.feed_window` consumes the
trace per transmission window: one batched Algorithm 1 classify per switch
run, one staged ``(S, U, D)`` block put per flush, and no host-side forward
matching (per-link FIFO and constant propagation delays make each
switch's arrival order a heap keyed by arrival time). Both land the same
blocks in the same launches, and the kernel sums without atomics, so the
two give the same bits.

The counters of :class:`HybridResult` (``h2d_transfers``, ``launches``,
``forward_launches``, ``switch_launches``, ``combined_updates``) count
puts and dispatches exactly as ``repro`` counts them on the same trace.
``sim_impl="vectorized"`` replaces the replay with the vectorized model
(:mod:`repro_torch.core.vecsim`); there ``launches`` counts its steps,
one per grid boundary, where ``repro`` counts its one fused scan as 1.
Delivered rows are tensors on ``device`` (copies, never views of the slot
buffer); ``final_counts`` is an int32 numpy array.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import Update
from repro_torch.core import vecsim
from repro_torch.core.netsim import (NetworkSimulator, SimCfg,
                                     apply_corruption, generation_schedule,
                                     multihop_cfg)
from repro_torch.core.olaf_queue import (EV_AGG, EV_DROP, EV_RESET,
                                         EVENT_OF_CLASS, PyOlafQueue,
                                         burst_contribution_mask)
from repro_torch.core.topology import (TopologySpec, resolve_sim_cfg,
                                       spec_from_switch_cfgs)
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import olaf_combine_sharded, switch_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.olaf_combine import stage_window

# Algorithm 1 class label -> device window event, through the shared table
_EVENT_STR = {EV_DROP: "drop", EV_AGG: "agg", EV_RESET: "reset"}


class _SwitchMirror:
    """Metadata mirror of one switch: replayed PyOlafQueue + device-slot
    assignment. ``slot_of_cluster`` holds a FIFO of slots per cluster —
    normally one, momentarily two when a locked head coexists with a fresh
    same-cluster append (§12.1)."""

    def __init__(self, name: str, capacity: int,
                 reward_threshold: Optional[float]) -> None:
        self.name = name
        self.queue = PyOlafQueue(capacity, reward_threshold)
        self.free_slots: List[int] = list(range(capacity))[::-1]
        self.slot_of_cluster: Dict[int, Deque[int]] = {}
        # pending window entries (slot, event, weight), event "agg" or
        # "reset"; rows ride in the parallel list (host numpy rows from the
        # window path, device tensors for forwarded packets and the
        # per-event path)
        self.pending: List[Tuple[int, str, int]] = []
        self.pending_rows: List[object] = []

    def classify_window(self, upds: List[Update]
                        ) -> List[Tuple[Optional[int], str]]:
        """Replay Algorithm 1 for a window run in one
        :meth:`PyOlafQueue.classify_batch`, mapping each classification to
        its ``(device_slot, event)``."""
        out: List[Tuple[Optional[int], str]] = []
        for cls, upd in zip(self.queue.classify_batch(upds), upds):
            event = _EVENT_STR[EVENT_OF_CLASS[cls]]
            if cls == "drop":
                out.append((None, event))
            elif cls == "append":  # fresh append -> allocate a slot
                slot = self.free_slots.pop()
                self.slot_of_cluster.setdefault(upd.cluster_id,
                                                deque()).append(slot)
                out.append((slot, event))
            else:  # combine into the unlocked waiting update = newest slot
                out.append((self.slot_of_cluster[upd.cluster_id][-1], event))
        return out

    def classify(self, upd: Update) -> Tuple[Optional[int], str]:
        """Single-event classify (the per-event reference path)."""
        return self.classify_window([upd])[0]

    def pop_slot(self, cluster_id: int) -> int:
        slots = self.slot_of_cluster[cluster_id]
        slot = slots.popleft()
        if not slots:
            del self.slot_of_cluster[cluster_id]
        self.free_slots.append(slot)
        return slot


@dataclasses.dataclass
class HybridResult:
    delivered: List[Tuple[float, Update, torch.Tensor]]  # (time, meta, row)
    launches: int  # combine kernel launches (window landings)
    combined_updates: int  # window entries that went through the kernel
    queue_stats: Dict[str, Dict[str, int]]
    final_counts: np.ndarray  # (S, Q) int32 residual device slot counts
    # per switch: device slot -> agg_count according to the metadata mirror
    # (must agree with final_counts, the kernel's count output)
    residual_slot_counts: Dict[str, Dict[int, int]] = dataclasses.field(
        default_factory=dict)
    h2d_transfers: int = 0  # host->device puts issued by the replay
    forward_launches: int = 0  # departure dispatches (gather + clear)
    # per switch: combine launches that landed its pending window
    switch_launches: Dict[str, int] = dataclasses.field(default_factory=dict)
    forwarded: int = 0  # packets routed switch->switch (transit hops)
    # ---- failure accounting (mirrors SimResult's) -------------------------
    link_dropped: int = 0
    rerouted: int = 0
    drops_by_switch: Dict[str, int] = dataclasses.field(default_factory=dict)
    # ---- node-fault accounting -------------------------------------------
    ps_dropped: int = 0
    stale_rejected: int = 0
    stale_deferred: int = 0
    worker_crashes: int = 0
    worker_restarts: int = 0
    worker_straggles: int = 0
    # ---- payload-integrity accounting ------------------------------------
    corrupted: int = 0
    screened: int = 0
    tainted_delivered: int = 0


def _single_device(device):
    """One ``torch.device`` from ``device``. A list of several devices is
    the switch mesh of ``sharded=True`` and nothing else takes one."""
    if isinstance(device, (list, tuple)):
        if len(device) != 1:
            raise ValueError(
                f"a list of {len(device)} devices splits the switch axis: "
                f"it needs sharded=True and a replay backend (the vectorized "
                f"model takes sim_mesh)")
        device = device[0]
    return resolve_device(device)


class HybridMultiSwitchDataPlane:
    """Replays a netsim queue-event trace with payloads on ``device``
    (default ``"cuda"``: raises without a card unless the caller passes
    ``device="cpu"``).

    ``sharded=True`` follows ``repro``'s switch-mesh path: ``device`` may
    then be a list of devices (it may repeat one), over which
    :func:`~repro_torch.distributed.sharding.switch_mesh` splits the
    switches; the slot buffer lives on the mesh's first device. Every flush
    is one :func:`~repro_torch.distributed.sharding.olaf_combine_sharded`
    over the mesh, each shard's reset mask applied in its own call (one
    ``olaf_combine`` launch per shard on a card), and a departure is a
    separate gather-and-clear (:meth:`_drain_only`)."""

    ROUTE_KINDS = frozenset({"forward", "deliver", "linkdrop",
                             "psdrop", "staledrop", "stalerequeue"})
    # node-churn markers: no queue effect, replayed for the counters
    NODE_KINDS = frozenset({"crash", "restart", "straggle"})
    # payload-integrity markers: "corrupt" is counter-only; "screen" means
    # the send never reaches a queue but its payload row is still consumed,
    # keeping the row budget aligned with the simulator's payload_fn calls
    INTEGRITY_KINDS = frozenset({"corrupt", "screen"})

    def __init__(self, switch_cfgs=None, ingress_switches=(), dim: int = 0,
                 payload_rows: Sequence[np.ndarray] = (), *,
                 topology: Optional[TopologySpec] = None,
                 sharded: bool = False, flush_cadence: bool = True,
                 device="cuda") -> None:
        if topology is None and switch_cfgs is None:
            raise ValueError("pass switch_cfgs or topology")
        self.spec = topology if topology is not None \
            else spec_from_switch_cfgs(switch_cfgs)
        self._mesh = None
        if sharded:
            devices = device if isinstance(device, (list, tuple)) \
                else [device]
            self._mesh = switch_mesh(self.spec.num_switches, devices=devices)
            device = self._mesh.devices.flat[0]
        self.device = dev = _single_device(device)
        self.names = list(self.spec.names)
        self.index = self.spec.index
        self.ingress = set(ingress_switches)
        self.flush_cadence = flush_cadence
        self.mirrors = [_SwitchMirror(sp.name, sp.queue_slots,
                                      sp.reward_threshold)
                        for sp in self.spec.switches]
        S = self.spec.num_switches
        Q = int(self.spec.queue_slots.max())
        self.slots_dev = torch.zeros((S, Q, dim), dtype=torch.float32,
                                     device=dev)
        self.counts_dev = torch.zeros((S, Q), dtype=torch.int32, device=dev)
        self.dim = dim
        self.sharded = sharded
        self._rows = payload_rows  # (N, dim) ingress payloads in gen order
        self._next_row = 0
        # retransmitted sends (Update.retx > 0) reuse their original row
        self._last_row: Dict[int, np.ndarray] = {}
        self._zero_row = torch.zeros((dim,), dtype=torch.float32, device=dev)
        # a dequeue's dispatch waits for its routing event:
        # (now, src_name, meta, slot, batched)
        self._pending_depart: Optional[
            Tuple[float, str, Update, int, bool]] = None
        # per-event path: per (src, dst) link, drained (order, meta, row)
        # awaiting arrival downstream, matched by _match_forward
        self._forward: Dict[Tuple[str, str],
                            Deque[Tuple[int, Update, torch.Tensor]]] = {}
        # window path: per destination switch, in-flight transit rows keyed
        # by (arrival_time, departure order)
        self._transit: List[List[Tuple[float, int, Update, torch.Tensor]]] = [
            [] for _ in range(S)]
        self._fwd_order = itertools.count()
        self.delivered: List[Tuple[float, Update, torch.Tensor]] = []
        self.launches = 0
        self.forward_launches = 0
        self.switch_launches: Dict[str, int] = {n: 0 for n in self.names}
        self.forwarded = 0
        self.combined_updates = 0
        self.h2d_transfers = 0
        self.link_dropped = 0
        self.rerouted = 0
        self.drops_by_switch: Dict[str, int] = {}
        self.ps_dropped = 0
        self.stale_rejected = 0
        self.stale_deferred = 0
        self.worker_crashes = 0
        self.worker_restarts = 0
        self.worker_straggles = 0
        self.corrupted = 0
        self.screened = 0
        self.tainted_delivered = 0

    def _flush_names(self, sw_name: str) -> Tuple[str, ...]:
        """The switches that land their pending window at a boundary of
        ``sw_name``: it and its upstream frontier, or every switch."""
        if self.flush_cadence:
            return self.spec.flush_set(sw_name)
        return tuple(self.names)

    # -- incoming packet resolution ---------------------------------------
    def _resolve_incoming(self, sw_name: str, meta: Update, *,
                          batched: bool) -> Tuple[Update, object]:
        """A fresh worker update (``meta.seq == -1``: consumes the next
        ingress row, or its original row for a retransmission) or a packet
        forwarded from upstream (``seq >= 0``: its departure sequence)."""
        if meta.seq >= 0:
            if batched:
                return self._pop_transit(sw_name, meta)
            return self._match_forward(sw_name, meta)
        if sw_name not in self.ingress:
            raise RuntimeError(f"fresh update at non-ingress switch {sw_name}")
        if meta.retx > 0:
            row_host = self._last_row[meta.worker_id]
        else:
            row_host = np.asarray(self._rows[self._next_row], np.float32)
            self._next_row += 1
            self._last_row[meta.worker_id] = row_host
        if meta.corrupt is not None:
            # the simulator's byte damage; _last_row keeps the clean bytes
            row_host = apply_corruption(row_host, meta.corrupt)
        upd = Update(cluster_id=meta.cluster_id, worker_id=meta.worker_id,
                     gen_time=meta.gen_time, reward=meta.reward,
                     size_bits=meta.size_bits, retx=meta.retx,
                     corrupt=meta.corrupt)
        if batched:  # stays on the host until the window's block put
            return upd, row_host
        self.h2d_transfers += 1  # per-event path: one put per row
        return upd, torch.tensor(row_host, device=self.device)

    def _pop_transit(self, sw_name: str, meta: Update
                     ) -> Tuple[Update, torch.Tensor]:
        """The next forwarded enqueue at a switch is the head of its
        arrival-ordered transit heap (window path)."""
        q = self._transit[self.index[sw_name]]
        if not q:
            raise RuntimeError(f"no in-flight transit packet for {meta} at "
                               f"{sw_name}")
        _arrival, _order, upd, row = heapq.heappop(q)
        if (upd.cluster_id, upd.worker_id, upd.seq) != \
                (meta.cluster_id, meta.worker_id, meta.seq):
            raise RuntimeError(f"transit head {upd} does not match {meta} "
                               f"at {sw_name}")
        return upd, row

    def _match_forward(self, sw_name: str, meta: Update
                       ) -> Tuple[Update, torch.Tensor]:
        """Match a forwarded enqueue against the per-link drain queues'
        heads (per-event path): on ``(cluster_id, worker_id)``, then on
        ``gen_time``/``seq``, then on departure order."""
        cands = []
        for key, q in self._forward.items():
            if not q or key[1] != sw_name:
                continue
            order, u, _row = q[0]
            if (u.cluster_id == meta.cluster_id
                    and u.worker_id == meta.worker_id):
                cands.append((order, u, key))
        if not cands:
            raise RuntimeError(f"no forward match for {meta} at {sw_name}")
        if len(cands) > 1:
            exact = [c for c in cands
                     if c[1].gen_time == meta.gen_time
                     and c[1].seq == meta.seq]
            cands = exact or cands
        key = min(cands, key=lambda c: c[0])[2]  # earliest departure first
        _order, upd, row = self._forward[key].popleft()
        return upd, row

    def _node_event(self, kind: str) -> None:
        if kind == "crash":
            self.worker_crashes += 1
        elif kind == "restart":
            self.worker_restarts += 1
        else:
            self.worker_straggles += 1

    def _integrity_event(self, sw_name: str, kind: str,
                         meta: Update) -> None:
        if kind == "corrupt":
            self.corrupted += 1
            return
        # screened: consume and discard the row on the host (no put)
        self._resolve_incoming(sw_name, meta, batched=True)
        self.screened += 1

    # -- per-event reference replay ----------------------------------------
    def feed(self, now: float, sw_name: str, kind: str,
             meta: Optional[Update]) -> None:
        """One event per call: the reference :meth:`feed_window` is held
        to."""
        if kind in self.NODE_KINDS:
            self._node_event(kind)
            return
        if kind in self.INTEGRITY_KINDS:
            self._integrity_event(sw_name, kind, meta)
            return
        if kind in self.ROUTE_KINDS:
            self._route(kind, sw_name)
            return
        if self._pending_depart is not None:
            self._route_pending_legacy()  # trace without routing events
        if kind == "window":  # folded into the dequeue that follows
            return
        mirror = self.mirrors[self.index[sw_name]]
        if kind == "lock":
            mirror.queue.lock_head()
            return
        if kind == "enqueue":
            upd, row = self._resolve_incoming(sw_name, meta, batched=False)
            weight = upd.agg_count
            slot, event = mirror.classify(upd)
            if event != "drop":
                mirror.pending.append((slot, event, weight))
                mirror.pending_rows.append(row)
            return
        if kind != "dequeue":
            raise ValueError(f"unknown trace event {kind!r}")
        self._depart(now, sw_name, meta, batched=False)

    # -- batched window replay ---------------------------------------------
    def feed_window(self, events) -> None:
        """Window-accumulating trace consumer (the fast path): enqueue
        metadata buffers per switch; a ``lock`` resolves its own switch's
        run; a ``dequeue`` resolves the flush set's runs with one
        :meth:`_SwitchMirror.classify_window` each, then lands them with
        the departing-row gather in one dispatch."""
        pend: Dict[str, List[Tuple[Update, object]]] = {}

        def resolve(name: str) -> None:
            run = pend.pop(name, None)
            if run:
                self._classify_run(name, run)

        for now, sw_name, kind, meta in events:
            if kind in self.NODE_KINDS:
                self._node_event(kind)
                continue
            if kind in self.INTEGRITY_KINDS:
                self._integrity_event(sw_name, kind, meta)
                continue
            if kind in self.ROUTE_KINDS:
                self._route(kind, sw_name)
                continue
            if self._pending_depart is not None:
                self._route_pending_legacy()
            if kind == "enqueue":
                # rows and transit pops resolve in event order; only the
                # classify waits for the batch
                pend.setdefault(sw_name, []).append(
                    self._resolve_incoming(sw_name, meta, batched=True))
            elif kind == "lock":
                resolve(sw_name)
                self.mirrors[self.index[sw_name]].queue.lock_head()
            elif kind == "window":
                pass
            elif kind == "dequeue":
                for name in self._flush_names(sw_name):
                    resolve(name)
                self._depart(now, sw_name, meta, batched=True)
            else:
                raise ValueError(f"unknown trace event {kind!r}")
        for name in list(pend):  # trailing partial window, landed by result()
            resolve(name)

    def _classify_run(self, sw_name: str,
                      run: List[Tuple[Update, object]]) -> None:
        """One batched Algorithm 1 resolve for a window run."""
        mirror = self.mirrors[self.index[sw_name]]
        upds = [u for u, _ in run]
        # weights before the resolve: a later update of the run may
        # aggregate into an earlier one, mutating its agg_count in place
        weights = [u.agg_count for u in upds]
        for (slot, event), weight, (_, row) in zip(
                mirror.classify_window(upds), weights, run):
            if event != "drop":
                mirror.pending.append((slot, event, weight))
                mirror.pending_rows.append(row)

    def _depart(self, now: float, sw_name: str, meta: Update, *,
                batched: bool) -> None:
        """A transmission completes at ``sw_name``: pop the mirror's head
        and its slot; the dispatch waits for the routing event."""
        mirror = self.mirrors[self.index[sw_name]]
        upd = mirror.queue.dequeue()
        if upd is None or upd.cluster_id != meta.cluster_id:
            raise RuntimeError(f"dequeue of {meta} at {sw_name} does not "
                               f"match the mirror's head {upd}")
        slot = mirror.pop_slot(upd.cluster_id)
        if self._pending_depart is not None:
            raise RuntimeError("two departures without a routing event")
        self._pending_depart = (now, sw_name, upd, slot, batched)

    def _route(self, kind: str, event_name: str) -> None:
        """Consume the deferred departure with its routing decision:
        ``forward`` (event_name = destination), ``deliver`` (PS), a loss
        (``linkdrop`` / ``psdrop`` / ``staledrop``: the slot is cleared and
        the row discarded on the device), or ``stalerequeue`` (forward to
        the same switch)."""
        if self._pending_depart is None:
            raise RuntimeError(f"routing event {kind}@{event_name} without a "
                               f"pending departure")
        now, src_name, upd, slot, batched = self._pending_depart
        self._pending_depart = None
        s = self.index[src_name]
        if kind == "forward" or kind == "stalerequeue":
            hop = self.index[event_name]
        else:
            hop = -1 if kind == "deliver" else -2
        row = self.flush(self._flush_names(src_name), drain=(s, slot),
                         hop=hop)
        if kind == "linkdrop":
            self.link_dropped += 1
            self.drops_by_switch[src_name] = \
                self.drops_by_switch.get(src_name, 0) + 1
            return
        if kind == "psdrop":
            self.ps_dropped += 1
            return
        if kind == "staledrop":
            self.stale_rejected += 1
            return
        if kind == "deliver":
            if upd.corrupt is not None:
                self.tainted_delivered += 1
            self.delivered.append((now, upd, row))
            return
        if kind == "stalerequeue":
            self.stale_deferred += 1
        else:
            self.forwarded += 1
            if hop != int(self.spec.next_hop[s]):
                self.rerouted += 1
        if batched:
            heapq.heappush(self._transit[hop],
                           (now + float(self.spec.prop_delay[s]),
                            next(self._fwd_order), upd, row))
        else:
            self._forward.setdefault((src_name, event_name), deque()).append(
                (next(self._fwd_order), upd, row))

    def _route_pending_legacy(self) -> None:
        """Route a deferred departure of a trace without routing events:
        the spec's static next hop, failure-free."""
        _now, src_name, _upd, _slot, _batched = self._pending_depart
        nh = int(self.spec.next_hop[self.index[src_name]])
        self._route("deliver" if nh < 0 else "forward",
                    src_name if nh < 0 else self.names[nh])

    # -- the data plane ------------------------------------------------------
    def flush(self, names: Optional[Sequence[str]] = None,
              drain: Optional[Tuple[int, int]] = None,
              hop: Optional[int] = None) -> Optional[torch.Tensor]:
        """One dispatch landing the selected switches' pending windows into
        the (S, Q, D) slot buffer — host rows staged as one block put —
        optionally with the departing-row gather and clear
        (``drain=(switch, slot)``), whose row (a copy on the device) is
        returned. ``hop`` is the drained row's routing decision (switch
        index, -1 = PS, -2 = dropped)."""
        sel = self.mirrors if names is None else \
            [self.mirrors[self.index[n]] for n in names]
        if not any(m.pending for m in sel):
            if drain is None:
                return None
            return self._drain_only(*drain)
        dev = self.device
        S, Q, _ = self.slots_dev.shape
        U = max(len(m.pending) for m in sel)
        # window bucket: the next power of two, at least 4 (repro's jit
        # variants; kept so the counters and shapes match it)
        U = max(4, 1 << (U - 1).bit_length())
        clusters = np.zeros((S, U), np.int32)
        gate = np.zeros((S, U), np.int32)
        reset_mask = np.zeros((S, Q), bool)
        row_grid: List[List[object]] = [[] for _ in range(S)]
        any_host = False
        for m in sel:
            if not m.pending:
                continue
            s = self.index[m.name]
            # only the last reset per slot and the aggs after it contribute
            contrib, last_reset = burst_contribution_mask(
                [p[0] for p in m.pending], [p[1] for p in m.pending])
            for u, ((slot, _event, weight), c) in enumerate(
                    zip(m.pending, contrib)):
                clusters[s, u] = slot
                gate[s, u] = weight if c else 0
            for slot in last_reset:
                reset_mask[s, slot] = True  # the slot restarts from the window
            any_host = any_host or any(
                isinstance(r, np.ndarray) for r in m.pending_rows)
            row_grid[s] = m.pending_rows
            self.combined_updates += len(m.pending)
            self.switch_launches[m.name] += 1
            m.pending, m.pending_rows = [], []
        sel_idx = sorted(s for s, rows in enumerate(row_grid) if rows)
        sub = {s: i for i, s in enumerate(sel_idx)}
        if any_host:
            # window path: host rows in one compact block and one put;
            # rows already on the device (forwarded packets) splice in
            block = np.zeros((len(sel_idx), U, self.dim), np.float32)
            dev_fixups = []
            for s in sel_idx:
                for u, row in enumerate(row_grid[s]):
                    if isinstance(row, np.ndarray):
                        block[sub[s], u] = row
                    else:
                        dev_fixups.append((s, u, row))
            staged = torch.from_numpy(block).to(dev)
            self.h2d_transfers += 1
            updates = self._scatter(staged, sel_idx, U)
            if dev_fixups:
                ss, uu, dev_rows = zip(*dev_fixups)
                updates[list(ss), list(uu)] = torch.stack(dev_rows)
        else:
            # per-event path: rows were put on the device one by one
            flat: List[torch.Tensor] = []
            for s in sel_idx:
                rows = row_grid[s]
                flat.extend(rows)
                flat.extend([self._zero_row] * (U - len(rows)))
            staged = torch.stack(flat).reshape(len(sel_idx), U, self.dim)
            updates = self._scatter(staged, sel_idx, U)
        self.h2d_transfers += 3  # clusters + gate + reset-mask window puts
        self.launches += 1
        drained: Optional[torch.Tensor] = None
        if drain is not None and not self.sharded:
            s, slot = drain
            self.h2d_transfers += 1  # drain (switch, slot, hop) index put
            self.forward_launches += 1
            self.slots_dev, self.counts_dev, rows, _hops = ops.olaf_forward(
                self.slots_dev, self.counts_dev, updates, clusters, gate,
                reset_mask, np.asarray([s], np.int64),
                np.asarray([slot], np.int64),
                drain_hop=np.asarray([-1 if hop is None else hop], np.int32))
            drained = rows[0]
        elif self.sharded:
            # repro's switch-mesh flush: one combine per shard, each with
            # its slice of the reset mask; the departure follows
            w = stage_window(dev, clusters=clusters, gate=gate,
                             reset=reset_mask)
            self.slots_dev, self.counts_dev = olaf_combine_sharded(
                self.slots_dev, self.counts_dev, updates, w["clusters"],
                w["gate"], reset=w["reset"], mesh=self._mesh)
            if drain is not None:
                drained = self._drain_only(*drain)
        else:
            self.slots_dev, self.counts_dev = ops.olaf_combine_window(
                self.slots_dev, self.counts_dev, updates, clusters, gate,
                reset_mask)
        return drained

    def _scatter(self, staged: torch.Tensor, sel_idx: List[int],
                 U: int) -> torch.Tensor:
        """The (S, U, D) update block with ``staged`` at the flush set's
        switches and zeros elsewhere."""
        S = self.slots_dev.shape[0]
        if len(sel_idx) == S:
            return staged
        updates = torch.zeros((S, U, self.dim), dtype=torch.float32,
                              device=self.device)
        updates[sel_idx] = staged
        return updates

    def _drain_only(self, s: int, slot: int) -> torch.Tensor:
        """Departing-row gather and clear with no window to land. The row
        is copied out BEFORE the clear: a basic-indexed row would be a view
        of the buffer and read the zeros."""
        self.forward_launches += 1
        row = self.slots_dev[s, slot].clone()
        self.slots_dev[s, slot] = 0.0
        self.counts_dev[s, slot] = 0
        return row

    def result(self) -> HybridResult:
        if self._pending_depart is not None:
            self._route_pending_legacy()  # trace cut before its routing event
        self.flush()
        residual: Dict[str, Dict[int, int]] = {}
        for m in self.mirrors:
            seen: Dict[int, int] = {}
            slot_counts: Dict[int, int] = {}
            for u in m.queue._q:  # seq order == per-cluster allocation order
                idx = seen.get(u.cluster_id, 0)
                seen[u.cluster_id] = idx + 1
                slot_counts[m.slot_of_cluster[u.cluster_id][idx]] = u.agg_count
            residual[m.name] = slot_counts
        return HybridResult(
            delivered=self.delivered, launches=self.launches,
            combined_updates=self.combined_updates,
            queue_stats={m.name: m.queue.stats.as_dict()
                         for m in self.mirrors},
            final_counts=self.counts_dev.cpu().numpy().astype(np.int32),
            residual_slot_counts=residual,
            h2d_transfers=self.h2d_transfers,
            forward_launches=self.forward_launches,
            switch_launches=dict(self.switch_launches),
            forwarded=self.forwarded,
            link_dropped=self.link_dropped,
            rerouted=self.rerouted,
            drops_by_switch=dict(self.drops_by_switch),
            ps_dropped=self.ps_dropped,
            stale_rejected=self.stale_rejected,
            stale_deferred=self.stale_deferred,
            worker_crashes=self.worker_crashes,
            worker_restarts=self.worker_restarts,
            worker_straggles=self.worker_straggles,
            corrupted=self.corrupted,
            screened=self.screened,
            tainted_delivered=self.tainted_delivered)


def run_hybrid_multihop(dim: int = 256, *, seed: int = 0,
                        payload_rows: Optional[Sequence[np.ndarray]] = None,
                        payload_source=None,
                        sim_cfg: Optional[SimCfg] = None,
                        topology=None,  # TopologySpec | SimCfg preset
                        sharded: bool = False,
                        batched: bool = True,
                        flush_cadence: bool = True,
                        sim_impl: Optional[str] = None,
                        sim_dt=None,
                        sim_mesh=None,
                        device="cuda",
                        **cfg_kw) -> Tuple[HybridResult, SimCfg]:
    """Hybrid run over any topology: the metadata trace from the event
    simulator, payload combining and forwarding on ``device`` in one
    dispatch per transmission boundary. The counterpart of
    ``repro.core.hybrid.run_hybrid_multihop``.

    The topology comes from (first match wins) ``sim_cfg``, ``topology``
    (a :class:`~repro_torch.core.topology.TopologySpec`, or a prebuilt
    ``SimCfg`` preset), else the §8.3 ``multihop_cfg(**cfg_kw)``.
    ``sim_impl`` is ``"event"`` (per-event replay, ``batched=False``),
    ``"window"`` (windowed replay, ``batched=True``), ``None`` (keep
    ``batched``) or ``"vectorized"``: the whole scenario runs through
    :func:`repro_torch.core.vecsim.run_vecsim` on ``device`` (payload
    combining, forwarding, AoM and transmission gating on the device; the
    event heap runs once, metadata only, to lay down the step grid).
    ``sim_dt`` (vectorized only) replaces that exact grid with a uniform
    one: a float is the step (``allow_coarse``), ``"auto"`` picks it with
    :func:`~repro_torch.core.vecsim.auto_dt`; with ``sim_dt`` and no
    ``payload_source`` the event heap never runs. ``sim_mesh`` (vectorized
    only) runs the sharded model over that mesh
    (:func:`~repro_torch.core.vecsim.run_vecsim`'s ``mesh``, with
    ``device`` for an int or tuple); ``sim_dt``/``sim_mesh`` raise
    ``ValueError`` with any other backend. ``sharded=True`` splits the
    replay's switches over ``device``, which may then be a list of devices
    (:class:`HybridMultiSwitchDataPlane`).

    ``payload_rows`` (N, dim) are consumed in worker-generation order;
    ``payload_source(now, worker_id) -> (row, reward)`` makes each
    generated update's payload and reward on the fly (the hook real PPO
    gradients enter through, :func:`repro_torch.rl.async_trainer.
    run_hybrid_ppo`). With neither, rows are drawn from ``seed``, one per
    fresh update that entered the fabric (counted from the trace).
    ``device`` defaults to ``"cuda"`` and raises without a card unless the
    caller passes ``"cpu"``.
    """
    if sim_impl not in (None, "event", "window", "vectorized"):
        raise ValueError(f"unknown sim_impl {sim_impl!r}; expected "
                         f"'event', 'window' or 'vectorized'")
    if sim_impl != "vectorized" and (sim_dt is not None
                                     or sim_mesh is not None):
        raise ValueError("sim_dt/sim_mesh require sim_impl='vectorized'")
    if sim_impl == "event":
        batched = False
    elif sim_impl == "window":
        batched = True
    mesh_list = sharded and sim_impl != "vectorized" \
        and isinstance(device, (list, tuple))
    dev = device if mesh_list else _single_device(device)
    if sim_cfg is not None:
        cfg = sim_cfg
    elif topology is not None:
        cfg = resolve_sim_cfg(topology, seed=seed, **cfg_kw)
    else:
        cfg = multihop_cfg("olaf", seed=seed, **cfg_kw)
    if (sim_impl == "vectorized" and sim_dt is not None
            and payload_source is None):
        # the uniform grid needs no oracle trace, so the event heap never
        # runs: rows are sized by the generation schedule (an upper bound
        # on fresh sends)
        if payload_rows is None:
            gen_times, _ = generation_schedule(cfg)
            n_gen = sum(len(t) for t in gen_times.values())
            rng = np.random.default_rng(seed + 1)
            payload_rows = rng.normal(
                size=(max(n_gen, 1), dim)).astype(np.float32)
        return _run_hybrid_vectorized(cfg, None, dim, payload_rows, [], dev,
                                      sim_dt=sim_dt, sim_mesh=sim_mesh), cfg
    events: List[Tuple[float, str, str, Optional[Update]]] = []
    trace_cfg = dataclasses.replace(
        cfg, on_queue_event=lambda now, sw, kind, upd: events.append(
            (now, sw, kind, upd)))
    rew_acc: List[Tuple[float, int, float]] = []
    if payload_source is not None:
        if payload_rows is not None:
            raise ValueError("pass payload_rows or payload_source, not both")
        rows_acc: List[np.ndarray] = []

        def _collect(now, worker_id):
            row, reward = payload_source(now, worker_id)
            rows_acc.append(row)
            rew_acc.append((now, worker_id, reward))
            return None, reward  # metadata-only sim; rows stay on the host

        trace_cfg = dataclasses.replace(trace_cfg, payload_fn=_collect)
        NetworkSimulator(trace_cfg).run()
        payload_rows = rows_acc
    else:
        NetworkSimulator(trace_cfg).run()
        if payload_rows is None:
            # one row per fresh ingress enqueue (seq == -1) and per screened
            # fresh send, whose row was generated and consumed too
            n_fresh = sum(1 for _, _, kind, m in events
                          if (kind == "enqueue" and m.seq < 0
                              and m.retx == 0)
                          or (kind == "screen" and m.retx == 0))
            rng = np.random.default_rng(seed + 1)
            payload_rows = rng.normal(
                size=(n_fresh, dim)).astype(np.float32)
    if sim_impl == "vectorized":
        return _run_hybrid_vectorized(cfg, events, dim, payload_rows,
                                      rew_acc, dev, sim_dt=sim_dt,
                                      sim_mesh=sim_mesh), cfg
    plane = HybridMultiSwitchDataPlane(
        cfg.switches, {w.ingress_switch for w in cfg.workers}, dim,
        payload_rows, sharded=sharded, flush_cadence=flush_cadence,
        device=dev)
    if batched:
        plane.feed_window(events)
    else:
        for now, sw, kind, meta in events:
            plane.feed(now, sw, kind, meta)
    return plane.result(), cfg


def _run_hybrid_vectorized(cfg: SimCfg, events, dim: int, payload_rows,
                           rewards, dev: torch.device, sim_dt=None,
                           sim_mesh=None) -> HybridResult:
    """Consume the scenario through :func:`repro_torch.core.vecsim.
    run_vecsim` on ``dev`` instead of replaying the trace window by window:
    ``repro``'s ``_run_hybrid_vectorized``. Rows are consumed in global
    send order, the trace's fresh-enqueue order; ``rewards`` are the
    ``(now, worker_id, reward)`` triples ``payload_source`` returned, laid
    onto each worker's generation schedule.

    ``launches`` counts the boundaries stepped (``n_steps``; ``repro``'s
    one fused ``lax.scan`` dispatch is 1), ``h2d_transfers`` the staged
    host-to-device copies. Delivered rows are tensors on ``dev`` (with
    ``sim_mesh``, on the mesh's first device)."""
    gen_rewards = None
    if rewards:
        gen_times, _ = generation_schedule(cfg)
        widx = {w.worker_id: i for i, w in enumerate(cfg.workers)}
        g_max = max((len(t) for t in gen_times.values()), default=1)
        gen_rewards = np.zeros((len(cfg.workers), g_max), np.float32)
        ptr = {wid: 0 for wid in gen_times}
        for now, wid, rw in rewards:
            ts_w = gen_times[wid]
            k = ptr[wid]
            while k < len(ts_w) and ts_w[k] < now - 1e-9:
                k += 1
            if k >= len(ts_w) or abs(ts_w[k] - now) > 1e-6:
                raise RuntimeError(
                    f"reward at t={now} does not align with worker {wid}'s "
                    f"generation schedule")
            gen_rewards[widx[wid], k] = rw
            ptr[wid] = k + 1
    rows = None
    if payload_rows is not None and len(payload_rows):
        rows = np.asarray(payload_rows, np.float32).reshape(-1, dim)
    if sim_dt is None:
        grid_kw = dict(grid=vecsim.grid_from_trace(cfg, events))
    else:
        dt = (vecsim.auto_dt(cfg, dim=dim, device=dev) if sim_dt == "auto"
              else float(sim_dt))
        grid_kw = dict(dt=dt, allow_coarse=True)
    vres = vecsim.run_vecsim(cfg, dim=dim, payload_rows=rows,
                             gen_rewards=gen_rewards, mesh=sim_mesh,
                             device=dev, **grid_kw)
    sim = vres.sim
    delivered = list(zip((float(t) for t in vres.delivery_times),
                         sim.delivered_updates,
                         vres.delivered_payloads.unbind(0)))
    residual_slot_counts = {
        sw.name: {slot: int(c)
                  for slot, c in enumerate(vres.final_counts[i]) if int(c)}
        for i, sw in enumerate(cfg.switches)}
    return HybridResult(
        delivered=delivered,
        launches=vres.n_steps,
        combined_updates=sum(qs["enqueued"]
                             for qs in sim.queue_stats.values()),
        queue_stats=sim.queue_stats,
        final_counts=vres.final_counts,
        residual_slot_counts=residual_slot_counts,
        h2d_transfers=vres.h2d_transfers,
        forward_launches=0,
        switch_launches={},
        forwarded=vres.forwarded,
        link_dropped=sim.link_dropped,
        rerouted=sim.reroutes,
        drops_by_switch=sim.drops_by_switch,
        ps_dropped=sim.ps_dropped,
        stale_rejected=sim.stale_rejected,
        stale_deferred=sim.stale_deferred,
        worker_crashes=sim.worker_crashes,
        worker_restarts=sim.worker_restarts,
        corrupted=sim.corrupted,
        screened=sim.screened,
        tainted_delivered=sim.tainted_delivered)
