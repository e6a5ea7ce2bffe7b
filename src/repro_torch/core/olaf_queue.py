"""OlafQueue — the paper's alternative queue design (§4, Algorithm 1).

Two interchangeable implementations:

  * :class:`PyOlafQueue` / :class:`PyFifoQueue` — event-driven reference
    used by the discrete-event network simulator (``core/netsim.py``);
    a numpy copy of ``repro.core.olaf_queue``'s host half.
  * :class:`TorchQueueState` with :func:`enqueue_burst` /
    :func:`dequeue_burst` / :func:`olaf_step` — the fixed-shape
    struct-of-arrays queue that stages deliveries at the parameter server.
    These functions are the plain PyTorch version of the fused CUDA
    ``olaf_step`` kernel (``repro_torch.kernels.olaf_step``): the CPU path
    and the yardstick the kernel is held to on the card.
  * :func:`enqueue_one` / :func:`enqueue_batch` / :func:`dequeue_one` —
    the single-slot oracles (``repro``'s ``jax_enqueue``,
    ``jax_enqueue_batch``, ``jax_dequeue``); the vectorized simulator
    (``core/vecsim.py``) starts service through :func:`dequeue_one`.
  * :func:`screen_mask` — the PS step's ingress screen on the device.

Semantics (paper §4 + §12.1):
  - at most one update per cluster in the queue (plus momentarily a second
    one when the first is *locked*, i.e. head-of-line and in transmission);
  - incoming update whose cluster is present: reward-gated aggregate /
    replace / drop, written back at the waiting update's position;
  - same-worker replacement only while ``replace_flag`` is set (un-aggregated);
  - append at tail if the cluster is absent and the queue is not full;
  - drop only if full and no same-cluster update is waiting.
Dequeue is strictly sequential (FIFO over slot sequence numbers); an
aggregated/replaced update inherits the old update's departure position.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import (Action, Update, aggregate,
                                          column_slices, gate, replace)


class QueueStats:
    """Counters shared by both queue flavours (Tab. 1 columns)."""

    def __init__(self) -> None:
        self.enqueued = 0
        self.dropped = 0
        self.aggregations = 0
        self.replacements = 0
        self.reward_drops = 0
        self.departed = 0

    def as_dict(self) -> Dict[str, int]:
        return dict(
            enqueued=self.enqueued, dropped=self.dropped,
            aggregations=self.aggregations, replacements=self.replacements,
            reward_drops=self.reward_drops, departed=self.departed,
        )


class PyFifoQueue:
    """Classical tail-drop FIFO — the paper's baseline."""

    def __init__(self, capacity: int) -> None:
        self.capacity = capacity
        self._q: Deque[Update] = deque()
        self.stats = QueueStats()

    def __len__(self) -> int:
        return len(self._q)

    def enqueue(self, upd: Update) -> bool:
        if len(self._q) >= self.capacity:
            self.stats.dropped += 1
            return False
        self._q.append(upd)
        self.stats.enqueued += 1
        return True

    def peek(self) -> Optional[Update]:
        return self._q[0] if self._q else None

    def dequeue(self) -> Optional[Update]:
        if not self._q:
            return None
        self.stats.departed += 1
        return self._q.popleft()


class PyOlafQueue:
    """Reference OlafQueue (Algorithm 1 + §12.1 head-lock corner case).

    Every operation is O(1): the deque holds departure order, and
    ``_by_cluster`` maps each cluster to its *unlocked* waiting update (the
    Olaf invariant guarantees at most one), replacing the per-enqueue linear
    scan. Combines mutate the waiting ``Update`` in place so its identity —
    and hence its deque position — is preserved.
    """

    def __init__(self, capacity: int, reward_threshold: Optional[float] = None) -> None:
        self.capacity = capacity
        self.reward_threshold = reward_threshold
        self._q: Deque[Update] = deque()  # kept sorted by seq (departure order)
        self._by_cluster: Dict[int, Update] = {}  # cluster -> unlocked waiting
        self._seq = 0
        self._locked_seq: Optional[int] = None  # head update in transmission
        self.stats = QueueStats()

    # -- introspection ----------------------------------------------------
    def __len__(self) -> int:
        return len(self._q)

    def clusters(self) -> List[int]:
        return [u.cluster_id for u in self._q]

    def occupancy(self) -> int:
        return len(self._q)

    # -- §12.1: the head update may be locked while serializing ----------
    def lock_head(self) -> None:
        if self._q:
            head = self._q[0]
            self._locked_seq = head.seq
            # a locked head can no longer be combined with
            if self._by_cluster.get(head.cluster_id) is head:
                del self._by_cluster[head.cluster_id]

    @staticmethod
    def _overwrite(waiting: Update, new: Update) -> None:
        """Write ``new``'s fields into ``waiting`` so the object (and its
        deque position / cluster-map entry) survives the combine."""
        waiting.__dict__.update(new.__dict__)

    # -- Algorithm 1 ------------------------------------------------------
    def enqueue(self, upd: Update) -> bool:
        """Returns True iff the update's information is retained in the queue."""
        waiting = self._by_cluster.get(upd.cluster_id)
        if waiting is not None:
            if waiting.replaceable and waiting.worker_id == upd.worker_id:
                # Alg.1 lines 9-10: same-worker, un-aggregated -> replace.
                new = replace(waiting, upd)
                new.replaceable = True  # still a single un-aggregated update
                self._overwrite(waiting, new)
                self.stats.replacements += 1
                return True
            act = gate(upd.reward, waiting.reward, self.reward_threshold)
            if act is Action.DROP:
                self.stats.reward_drops += 1
                self.stats.dropped += 1
                return False
            if act is Action.REPLACE:
                new = replace(waiting, upd)
                new.replaceable = False  # reward-replace counts as a combine event
                self._overwrite(waiting, new)
                self.stats.replacements += 1
                return True
            self._overwrite(waiting, aggregate(waiting, upd))  # Alg.1 lines 12/16
            self.stats.aggregations += 1
            return True
        if len(self._q) >= self.capacity:
            self.stats.dropped += 1  # Alg.1 line 22
            return False
        upd.seq = self._seq  # Alg.1 lines 18-20: append at tail
        self._seq += 1
        self._q.append(upd)
        self._by_cluster[upd.cluster_id] = upd
        self.stats.enqueued += 1
        return True

    def classify_batch(self, updates: List[Update]) -> List[str]:
        """Replay Algorithm 1 for a whole window of updates in one call.

        Returns the per-update stats-delta classification — ``"append"`` /
        ``"agg"`` / ``"replace"`` / ``"drop"`` — resolved from the counter
        deltas of each :meth:`enqueue`, so a window consumer (the hybrid
        control-plane replay) pays one Python call per transmission window
        instead of one per queue event.
        """
        out: List[str] = []
        st = self.stats
        for upd in updates:
            before = (st.aggregations, st.replacements, st.enqueued,
                      st.dropped)
            self.enqueue(upd)
            if st.dropped != before[3]:
                out.append("drop")
            elif st.enqueued != before[2]:
                out.append("append")
            elif st.replacements != before[1]:
                out.append("replace")
            else:
                out.append("agg")
        return out

    def enqueue_batch(self, updates: List[Update]) -> List[bool]:
        """Batched :meth:`enqueue`; True per update whose information is
        retained (anything but a drop)."""
        return [ev != "drop" for ev in self.classify_batch(updates)]

    def peek(self) -> Optional[Update]:
        return self._q[0] if self._q else None

    def dequeue(self) -> Optional[Update]:
        if not self._q:
            return None
        self.stats.departed += 1
        head = self._q.popleft()
        if self._locked_seq is not None and head.seq == self._locked_seq:
            self._locked_seq = None
        if self._by_cluster.get(head.cluster_id) is head:
            del self._by_cluster[head.cluster_id]
        return head


def burst_contribution_mask(slots: List[int], events: List[str]
                            ) -> Tuple[List[bool], Dict[int, int]]:
    """Host-side telescoped-mean contribution rule shared with
    :func:`_burst_resolve`.

    For a window of ``(slot, event)`` assignments with ``event`` in
    ``{"agg", "reset"}``, only the *last* reset per slot and the aggregates
    after it contribute to the slot's combined payload — everything written
    before that reset was overwritten. Returns ``(contributes, last_reset)``
    where ``last_reset`` maps each reset slot to the window index of its
    final reset (the slot restarts from that update).
    """
    last_reset: Dict[int, int] = {}
    for u, (slot, event) in enumerate(zip(slots, events)):
        if event == "reset":
            last_reset[slot] = u
    contributes = []
    for u, (slot, event) in enumerate(zip(slots, events)):
        lr = last_reset.get(slot, -1)
        contributes.append((u > lr) if event == "agg" else (u == lr))
    return contributes, last_reset


# ===========================================================================
# Fixed-shape struct-of-arrays queue (the PS staging buffer on the device).
# ===========================================================================
#: ``seq`` of an empty slot: sorts after every live slot.
EMPTY_SEQ = 2**31 - 1

# Per-update burst events (scalar resolve output).
EV_DROP = 0  # full-queue or reward-gated drop, or a withheld row
EV_AGG = 1  # running-mean aggregate into the target slot
EV_RESET = 2  # slot payload restarts from this update (append / replace)

#: Algorithm 1 classification label -> queue event, one place. The hybrid
#: window replay maps ``PyOlafQueue.classify_batch`` labels onto device
#: events through this table; :func:`classify_slot_events` inverts it.
EVENT_OF_CLASS = {"append": EV_RESET, "replace": EV_RESET,
                  "agg": EV_AGG, "drop": EV_DROP}


def classify_slot_events(slots, events, pre_occupied) -> List[str]:
    """Host-side inverse of the Algorithm 1 event stream: the
    ``classify_batch`` labels (``append`` / ``replace`` / ``agg`` /
    ``drop``) of a per-update ``(slot, event)`` assignment.

    ``pre_occupied`` is the (Q,) bool occupancy before the burst; the walk
    replays occupancy forward, so a RESET into a vacant slot is an append
    and a RESET into an occupied slot a replace.
    """
    occ = [bool(v) for v in np.asarray(pre_occupied)]
    labels: List[str] = []
    for slot, event in zip(np.asarray(slots), np.asarray(events)):
        slot, event = int(slot), int(event)
        if event == EV_DROP:
            labels.append("drop")
        elif event == EV_AGG:
            labels.append("agg")
        else:  # EV_RESET
            labels.append("replace" if occ[slot] else "append")
            occ[slot] = True
    return labels


@dataclasses.dataclass
class TorchQueueState:
    """Fixed-capacity OlafQueue state, field for field ``repro``'s
    ``JaxQueueState``: ``(Q,)`` metadata, ``(Q, D)`` payload and 0-dim
    counters, or the same with a leading S (switch) axis on every field.

    Empty slots have ``cluster == -1``, ``seq == EMPTY_SEQ`` and reward
    ``-inf``; departure order is the slot with the smallest ``seq``. Every
    integer field is int32 and ``replaceable`` is bool.
    """

    cluster: torch.Tensor  # int32[Q]
    worker: torch.Tensor  # int32[Q]
    seq: torch.Tensor  # int32[Q], EMPTY_SEQ for empty
    gen_time: torch.Tensor  # float32[Q]
    reward: torch.Tensor  # float32[Q]
    agg_count: torch.Tensor  # int32[Q]
    replaceable: torch.Tensor  # bool[Q]
    payload: torch.Tensor  # float32[Q, D]
    next_seq: torch.Tensor  # int32[] monotone counter
    n_dropped: torch.Tensor  # int32[] (Tab. 1 counters)
    n_agg: torch.Tensor
    n_repl: torch.Tensor
    n_screened: torch.Tensor  # burst rows rejected by the ingress screen

    @property
    def device(self) -> torch.device:
        return self.payload.device

    def fields(self) -> Dict[str, torch.Tensor]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def clone(self) -> "TorchQueueState":
        return TorchQueueState(**{n: v.clone() for n, v in self.fields().items()})

    def select(self, s: int) -> "TorchQueueState":
        """Queue ``s`` of a state with a leading S axis (a view)."""
        return TorchQueueState(**{n: v[s] for n, v in self.fields().items()})

    @staticmethod
    def stack(states: List["TorchQueueState"]) -> "TorchQueueState":
        return TorchQueueState(**{
            n: torch.stack([getattr(st, n) for st in states])
            for n in states[0].fields()})


def queue_init(capacity: int, dim: int, *, device) -> TorchQueueState:
    def full(shape, value, dt):
        return torch.full(shape, value, dtype=dt, device=device)

    i32 = torch.int32
    return TorchQueueState(
        cluster=full((capacity,), -1, i32),
        worker=full((capacity,), -1, i32),
        seq=full((capacity,), EMPTY_SEQ, i32),
        gen_time=full((capacity,), 0.0, torch.float32),
        reward=full((capacity,), -math.inf, torch.float32),
        agg_count=full((capacity,), 0, i32),
        replaceable=full((capacity,), False, torch.bool),
        payload=full((capacity, dim), 0.0, torch.float32),
        next_seq=full((), 0, i32),
        n_dropped=full((), 0, i32),
        n_agg=full((), 0, i32),
        n_repl=full((), 0, i32),
        n_screened=full((), 0, i32),
    )


def queue_state_from_numpy(arrays, *, device) -> TorchQueueState:
    """Build a state from an object with the 13 ``JaxQueueState`` fields as
    attributes (numpy or anything ``np.asarray`` takes), keeping their
    dtypes; integer fields are pinned to int32."""
    out = {}
    for f in dataclasses.fields(TorchQueueState):
        a = np.asarray(getattr(arrays, f.name))
        if a.dtype.kind in "iu":
            a = a.astype(np.int32)
        out[f.name] = torch.from_numpy(np.array(a)).to(device)
    return TorchQueueState(**out)


def queue_state_to_numpy(state: TorchQueueState) -> Dict[str, np.ndarray]:
    """Field name -> numpy array, the inverse of :func:`queue_state_from_numpy`
    (``JaxQueueState(**queue_state_to_numpy(st))`` carries a state back)."""
    return {n: v.detach().cpu().numpy() for n, v in state.fields().items()}


def _burst_resolve(state: TorchQueueState, clusters, workers, gen_times,
                   rewards, reward_threshold, send=None, capacity=None,
                   screen=None, in_counts=None, in_replaceable=None):
    """Scalar half of the burst: Algorithm 1 decisions for U updates.

    The sequential walk of ``repro``'s ``_burst_resolve`` over the burst,
    carrying only the ``(Q,)`` metadata columns. ``send`` (False = deferred
    by transmission control) and ``screen`` (True = rejected by the ingress
    screen, counted in ``n_screened``) withhold a row from the queue;
    ``capacity`` is a slot COUNT — the queue is full when
    ``sum(occupied) >= capacity``, and an append takes the first empty slot
    at any index. ``in_counts`` weights an incoming row that is already the
    mean of k updates; ``in_replaceable`` is its replace flag.

    One queue (``(Q,)`` metadata, ``(U,)`` burst), or S queues walked side
    by side: a leading S axis on the state and the burst, with
    ``reward_threshold`` and ``capacity`` a number or ``(S,)`` (the vmap of
    ``repro``'s ``ops.olaf_burst_multi``).

    Returns ``(carry, slots, events)`` with ``carry`` the post-burst
    ``(cluster, worker, seq, gen_time, reward, agg_count, replaceable,
    next_seq, n_dropped, n_agg, n_repl, n_screened)``. Every op stays on
    the state's device; nothing syncs with the host.
    """
    dev = state.cluster.device
    U = clusters.shape[-1]
    Q = state.cluster.shape[-1]
    lead = tuple(state.cluster.shape[:-1])
    i32 = torch.int32
    ones = torch.ones(clusters.shape, dtype=torch.bool, device=dev)
    send = ones if send is None else send.to(torch.bool)
    screen = ~ones if screen is None else screen.to(torch.bool)
    in_counts = (torch.ones(clusters.shape, dtype=i32, device=dev)
                 if in_counts is None else in_counts.to(i32))
    in_replaceable = ones if in_replaceable is None else in_replaceable.to(torch.bool)
    cap_count = torch.as_tensor(Q if capacity is None else capacity,
                                dtype=i32, device=dev)
    qidx = torch.arange(Q, device=dev)
    # the metadata rides in two packs, so reading the hit slot and writing
    # the target slot is one op per pack: ints (cluster, worker, seq,
    # agg_count, replaceable) and floats (gen_time, reward)
    P = torch.stack([state.cluster, state.worker, state.seq, state.agg_count,
                     state.replaceable.to(i32)], dim=-1)
    F = torch.stack([state.gen_time, state.reward], dim=-1)
    nseq = state.next_seq
    cols = [x.unbind(-1) for x in (
        clusters.to(i32), workers.to(i32), gen_times.to(torch.float32),
        rewards.to(torch.float32), send & ~screen, in_counts, in_replaceable)]
    hits, slots, events = [], [], []
    for u in range(U):
        # act: sent AND admitted by the ingress screen
        c, w, t, r, act, icnt, irp = (col[u] for col in cols)
        cl = P[..., 0]
        occupied = cl >= 0
        same = occupied & (cl == c.unsqueeze(-1))
        hit = same.any(dim=-1)
        # argmax returns the first maximal index, as jnp.argmax does
        slot_hit = torch.argmax(same.to(torch.uint8), dim=-1)
        idx = slot_hit.view(*lead, 1, 1)
        ph = P.gather(-2, idx.expand(*lead, 1, 5)).squeeze(-2)
        fh = F.gather(-2, idx.expand(*lead, 1, 2)).squeeze(-2)
        h_gt, h_rw = fh[..., 0], fh[..., 1]

        act_hit = act & hit
        swr = act_hit & (ph[..., 4] != 0) & (ph[..., 1] == w)
        rdiff = r - h_rw
        other = act_hit & ~swr
        do_rr = other & (rdiff > reward_threshold)
        do_rd = other & (rdiff < -reward_threshold)
        do_agg = other & ~(do_rr | do_rd)
        full = occupied.sum(dim=-1) >= cap_count
        do_append = act & ~(hit | full)

        slot = torch.where(hit, slot_hit,
                           torch.argmax((~occupied).to(torch.uint8), dim=-1))
        write = swr | do_rr | do_agg | do_append
        onehot = ((qidx == slot.unsqueeze(-1))
                  & write.unsqueeze(-1)).unsqueeze(-1)
        # replaceable after the write: a same-worker replace keeps one
        # un-aggregated update; an append takes the row's own flag;
        # aggregation and reward-replace are combine events and clear it
        new_p = torch.stack([
            c, w, torch.where(hit, ph[..., 2], nseq),
            torch.where(do_agg, ph[..., 3] + icnt, icnt),
            (swr | (do_append & irp)).to(i32)], dim=-1)
        new_f = torch.stack([
            torch.where(do_agg, torch.maximum(t, h_gt), t),
            torch.where(do_agg, torch.maximum(r, h_rw), r)], dim=-1)
        P = torch.where(onehot, new_p.unsqueeze(-2), P)
        F = torch.where(onehot, new_f.unsqueeze(-2), F)
        nseq = nseq + do_append.to(i32)
        hits.append(hit)
        slots.append(slot)
        events.append(torch.where(do_agg, EV_AGG,
                                  torch.where(write, EV_RESET, EV_DROP)))
    slots = torch.stack(slots, dim=-1).to(i32)
    events = torch.stack(events, dim=-1).to(i32)
    hit_all = torch.stack(hits, dim=-1)
    # the counters from the event stream: an admitted row that wrote
    # nothing was dropped (queue full, or reward-gated); a reset into a
    # hit slot is a replacement, into a free one an append
    act_all = send & ~screen
    nd = state.n_dropped + (act_all & (events == EV_DROP)).sum(
        dim=-1, dtype=i32)
    na = state.n_agg + (events == EV_AGG).sum(dim=-1, dtype=i32)
    nr = state.n_repl + ((events == EV_RESET) & hit_all).sum(dim=-1,
                                                             dtype=i32)
    ns = state.n_screened + (send & screen).sum(dim=-1, dtype=i32)
    cl, wk, sq, cnt, rp = (x.contiguous() for x in P.unbind(-1))
    gt, rw = (x.contiguous() for x in F.unbind(-1))
    carry = (cl, wk, sq, gt, rw, cnt, rp != 0, nseq, nd, na, nr, ns)
    return carry, slots, events


def enqueue_burst_ex(state: TorchQueueState, clusters, workers, gen_times,
                     rewards, payloads, reward_threshold: float = math.inf,
                     send=None, capacity=None, screen=None, in_counts=None,
                     in_replaceable=None):
    """:func:`enqueue_burst` plus the per-update ``(slots, events)``
    assignment of :func:`_burst_resolve`. Returns
    ``(new_state, slots, events)``. One queue, or S queues with a leading
    S axis on the state and the burst (as :func:`_burst_resolve`).

    The payload half telescopes the chain of per-update running means:

        new[q] = (base[q] · base_n[q] + Σ_{u contributing to q} upd[u]) / n[q]

    where only the last reset (append / replace) per slot and the
    aggregates after it contribute, and ``base_n`` is the old ``agg_count``
    of a slot that saw no reset in the burst, else 0.
    """
    U = clusters.shape[-1]
    dev = state.cluster.device
    if U == 0:  # empty burst (drain-only cycle): nothing to resolve
        empty = torch.zeros(clusters.shape, dtype=torch.int32, device=dev)
        return state, empty, empty
    if in_counts is None:
        in_counts = torch.ones(clusters.shape, dtype=torch.int32, device=dev)
    carry, slots, events = _burst_resolve(
        state, clusters, workers, gen_times, rewards, reward_threshold, send,
        capacity, screen, in_counts, in_replaceable)
    (cl, wk, sq, gt, rw, cnt, rp, nseq, nd, na, nr, ns) = carry

    Q = state.cluster.shape[-1]
    u_idx = torch.arange(U, dtype=torch.int32, device=dev)
    onehot = slots.unsqueeze(-1) == torch.arange(
        Q, dtype=torch.int32, device=dev)  # (..., U, Q)
    is_reset = events == EV_RESET
    is_agg = events == EV_AGG
    # last reset per slot: everything written before it was overwritten
    last_reset = torch.where(is_reset.unsqueeze(-1) & onehot,
                             u_idx.unsqueeze(-1), -1).amax(dim=-2)  # (..., Q)
    lr_u = last_reset.gather(-1, slots.long())
    contributes = (is_agg & (u_idx > lr_u)) | (is_reset & (u_idx == lr_u))
    seg = ((onehot & contributes.unsqueeze(-1)).to(torch.float32)
           * in_counts.to(torch.float32).unsqueeze(-1))  # (..., U, Q)
    # one-hot segment sum (..., Q, D)
    sums = seg.transpose(-1, -2) @ payloads.to(torch.float32)
    n_contrib = seg.sum(dim=-2)
    base_n = torch.where(last_reset < 0, state.agg_count, 0).to(torch.float32)
    touched = (last_reset >= 0) | (n_contrib > 0)
    denom = torch.clamp(base_n + n_contrib, min=1.0)
    combined = ((state.payload.to(torch.float32) * base_n.unsqueeze(-1)
                 + sums) / denom.unsqueeze(-1))
    new_payload = torch.where(touched.unsqueeze(-1),
                              combined.to(state.payload.dtype), state.payload)
    new_state = TorchQueueState(
        cluster=cl, worker=wk, seq=sq, gen_time=gt, reward=rw, agg_count=cnt,
        replaceable=rp, payload=new_payload, next_seq=nseq,
        n_dropped=nd, n_agg=na, n_repl=nr, n_screened=ns)
    return new_state, slots, events


def enqueue_burst(state: TorchQueueState, clusters, workers, gen_times,
                  rewards, payloads, reward_threshold: float = math.inf,
                  send=None, capacity=None, screen=None) -> TorchQueueState:
    """Algorithm 1 for a whole U-update incast burst (see
    :func:`enqueue_burst_ex`)."""
    state, _, _ = enqueue_burst_ex(state, clusters, workers, gen_times,
                                   rewards, payloads, reward_threshold, send,
                                   capacity, screen)
    return state


def dequeue_burst(state: TorchQueueState, k: int
                  ) -> Tuple[TorchQueueState, Dict[str, torch.Tensor]]:
    """Drain-k: pop the ``k`` oldest valid slots in one fixed-shape pass.

    The k smallest ``seq`` in ascending order, ties on the empty sentinel
    broken by the lowest slot index — ``lax.top_k(-seq)``'s order, which a
    stable sort reproduces and ``torch.topk`` does not promise. Every
    ``out`` entry has a leading ``k`` axis (row 0 = oldest) and carries the
    slot's metadata from before the clear; ``out['valid']`` is a prefix
    mask and an invalid row's payload is 0. A popped slot keeps its
    ``gen_time``.
    """
    Q = state.cluster.shape[0]
    k = min(int(k), Q)
    slots = torch.sort(state.seq, stable=True).indices[:k]
    valid = state.cluster[slots] >= 0
    payload = torch.where(valid[:, None], state.payload[slots],
                          torch.zeros((), dtype=state.payload.dtype,
                                      device=state.device))
    out = dict(
        valid=valid,
        n_valid=valid.sum(dtype=torch.int32),
        cluster=state.cluster[slots],
        worker=state.worker[slots],
        gen_time=state.gen_time[slots],
        reward=state.reward[slots],
        agg_count=state.agg_count[slots],
        payload=payload,
    )
    onehot = slots[:, None] == torch.arange(Q, device=state.device)[None, :]
    popped = (onehot & valid[:, None]).any(dim=0)  # (Q,)

    def clear(vec, value):
        return torch.where(popped, torch.as_tensor(value, dtype=vec.dtype,
                                                   device=vec.device), vec)

    new_state = dataclasses.replace(
        state,
        cluster=clear(state.cluster, -1),
        worker=clear(state.worker, -1),
        seq=clear(state.seq, EMPTY_SEQ),
        reward=clear(state.reward, -math.inf),
        agg_count=clear(state.agg_count, 0),
        replaceable=clear(state.replaceable, False),
        payload=torch.where(popped[:, None], 0.0, state.payload),
    )
    return new_state, out


def enqueue_one(state: TorchQueueState, cluster, worker, gen_time, reward,
                payload, reward_threshold: float = math.inf,
                capacity=None) -> TorchQueueState:
    """Algorithm 1 for one incoming update into one queue, ``repro``'s
    ``jax_enqueue`` (the single-slot oracle of the burst routes).

    Unlike :func:`_burst_resolve` it tests fullness by slot REGION:
    ``capacity`` (default Q) caps the logical slot count, the queue is full
    when every slot below it is occupied, and an append takes the first
    empty slot below it (ROADMAP hazard H1). An aggregate writes the running
    mean ``(old·n + new)/(n + 1)`` at once. Scalars are numbers or 0-dim
    tensors; ``payload`` is (D,). Leaves its input state untouched.
    """
    dev = state.cluster.device
    Q = state.cluster.shape[0]

    def scalar(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    cluster, worker = scalar(cluster, torch.int32), scalar(worker, torch.int32)
    gen_time = scalar(gen_time, torch.float32)
    reward = scalar(reward, torch.float32)
    payload = torch.as_tensor(payload, device=dev).to(state.payload.dtype)
    qidx = torch.arange(Q, device=dev)
    valid_slot = qidx < (Q if capacity is None else scalar(capacity,
                                                           torch.int32))
    occupied = state.cluster >= 0
    same = occupied & (state.cluster == cluster)
    hit = same.any()
    slot_hit = torch.argmax(same.to(torch.uint8))  # first, as jnp.argmax
    w_reward, w_cnt = state.reward[slot_hit], state.agg_count[slot_hit]
    swr = hit & state.replaceable[slot_hit] & (state.worker[slot_hit] == worker)
    rdiff = reward - w_reward
    do_rr = hit & ~swr & (rdiff > reward_threshold)
    do_rd = hit & ~swr & (rdiff < -reward_threshold)
    do_agg = hit & ~swr & ~do_rr & ~do_rd
    full = (occupied | ~valid_slot).all()
    do_append = ~hit & ~full
    do_dropf = ~hit & full
    agg_payload = ((state.payload[slot_hit] * w_cnt.to(payload.dtype)
                    + payload) / (w_cnt + 1).to(payload.dtype))
    slot = torch.where(hit, slot_hit,
                       torch.argmax((~occupied & valid_slot).to(torch.uint8)))
    write = swr | do_rr | do_agg | do_append
    onehot = (qidx == slot) & write

    def put(old, new):
        return torch.where(onehot, new, old)

    return TorchQueueState(
        cluster=put(state.cluster, cluster),
        worker=put(state.worker, worker),
        seq=put(state.seq, torch.where(hit, state.seq[slot_hit],
                                       state.next_seq)),
        gen_time=put(state.gen_time, torch.where(
            do_agg, torch.maximum(gen_time, state.gen_time[slot_hit]),
            gen_time)),
        reward=put(state.reward, torch.where(
            do_agg, torch.maximum(reward, w_reward), reward)),
        agg_count=put(state.agg_count, torch.where(
            do_agg, w_cnt + 1, torch.ones_like(w_cnt))),
        replaceable=put(state.replaceable, swr | do_append),
        payload=torch.where(onehot[:, None],
                            torch.where(do_agg, agg_payload, payload)[None, :],
                            state.payload),
        next_seq=state.next_seq + do_append.to(torch.int32),
        n_dropped=state.n_dropped + (do_dropf | do_rd).to(torch.int32),
        n_agg=state.n_agg + do_agg.to(torch.int32),
        n_repl=state.n_repl + (swr | do_rr).to(torch.int32),
        n_screened=state.n_screened)


def enqueue_batch(state: TorchQueueState, clusters, workers, gen_times,
                  rewards, payloads, reward_threshold: float = math.inf,
                  capacity=None) -> TorchQueueState:
    """Sequential batch enqueue, ``repro``'s ``jax_enqueue_batch``: one
    :func:`enqueue_one` per update, in order. The slow-path oracle the
    burst routes are held to, not a hot path."""
    for u in range(clusters.shape[0]):
        state = enqueue_one(state, clusters[u], workers[u], gen_times[u],
                            rewards[u], payloads[u], reward_threshold,
                            capacity)
    return state


def dequeue_one(state: TorchQueueState
                ) -> Tuple[TorchQueueState, Dict[str, torch.Tensor]]:
    """Pop the slot with the smallest ``seq``, ``repro``'s ``jax_dequeue``:
    one queue, or S queues at once (a leading S axis, as ``repro``'s vecsim
    vmaps it). The lowest slot wins a tie (ROADMAP hazard H2), so an empty
    queue names slot 0 with ``valid`` False and changes nothing. ``out``
    holds ``valid``, ``cluster``, ``worker``, ``gen_time``, ``reward``,
    ``agg_count`` and ``payload`` of that slot as they were before the
    clear, an invalid row included (H6); the popped slot keeps its
    ``gen_time``."""
    Q, D = state.payload.shape[-2:]
    slot = torch.argmin(state.seq, dim=-1)  # first minimal index on a tie
    idx = slot.unsqueeze(-1)

    def at(vec):
        return vec.gather(-1, idx).squeeze(-1)

    valid = at(state.cluster) >= 0
    row = state.payload.gather(
        -2, idx.unsqueeze(-1).expand(*idx.shape, D)).squeeze(-2)
    out = dict(valid=valid, cluster=at(state.cluster),
               worker=at(state.worker), gen_time=at(state.gen_time),
               reward=at(state.reward), agg_count=at(state.agg_count),
               payload=row)
    onehot = ((torch.arange(Q, device=state.device) == idx)
              & valid.unsqueeze(-1))

    def clear(vec, value):  # a number, so nothing is copied to the card
        return torch.where(onehot, value, vec)

    new_state = dataclasses.replace(
        state,
        cluster=clear(state.cluster, -1),
        worker=clear(state.worker, -1),
        seq=clear(state.seq, EMPTY_SEQ),
        reward=clear(state.reward, -math.inf),
        agg_count=clear(state.agg_count, 0),
        replaceable=clear(state.replaceable, False),
        payload=torch.where(onehot.unsqueeze(-1), 0.0, state.payload))
    return new_state, out


def expire_inactive_drains(out: Dict[str, torch.Tensor], active_workers
                           ) -> Dict[str, torch.Tensor]:
    """Node-churn gating: drained rows of crashed workers are expired — the
    slot is freed (the drain already popped it) but the row is masked
    invalid. ``active_workers`` is a bool (W,) membership mask; works for
    the single-queue (k,) and multi-queue (S, k) layouts."""
    aw = torch.as_tensor(active_workers, dtype=torch.bool,
                         device=out["valid"].device)
    w = out["worker"].clamp(0, aw.shape[0] - 1).long()  # invalid rows: -1
    valid = out["valid"] & aw[w]
    return dict(out, valid=valid, n_valid=valid.sum(dim=-1, dtype=torch.int32))


def olaf_step(state: TorchQueueState, clusters, workers, gen_times, rewards,
              payloads, k: int, reward_threshold: float = math.inf,
              send=None, capacity=None, active_workers=None, screen=None
              ) -> Tuple[TorchQueueState, Dict[str, torch.Tensor]]:
    """One full data-plane cycle: burst enqueue then drain-k.

    Exactly :func:`enqueue_burst` followed by :func:`dequeue_burst` (and
    :func:`expire_inactive_drains` when ``active_workers`` is given), the
    composition of ``repro``'s ``jax_olaf_step``. This is the plain version
    the CUDA kernel is held to; it takes a single queue (no S axis) and
    leaves its input state untouched.
    """
    state = enqueue_burst(state, clusters, workers, gen_times, rewards,
                          payloads, reward_threshold, send, capacity, screen)
    state, out = dequeue_burst(state, k)
    if active_workers is not None:
        out = expire_inactive_drains(out, active_workers)
    return state, out


def screen_mask(payloads: torch.Tensor, med: torch.Tensor, *,
                factor: float = 16.0, mask: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ingress screen for one burst of payload rows (U, D), the counterpart
    of ``repro``'s ``jax_screen_mask``: ``(screen (U,) bool, new med)``.

    A row is screened (True) when a coordinate is non-finite, or when its
    L2 norm (over its finite coordinates) exceeds ``factor ×`` the running
    scale estimate ``med`` (a 0-dim float32; 0 until the first admitted
    row). Each admitted row moves ``med`` by at most ±10%. The rows are
    judged in order, row u against the estimate after rows < u; a row with
    ``mask`` False (deferred by transmission control) is never screened and
    never moves ``med``. The norms are summed over column slices
    (:data:`~repro_torch.core.aggregation.COLUMN_CHUNK`); nothing is read
    back to the host.
    """
    U, D = payloads.shape
    sumsq = torch.zeros(U, dtype=torch.float32, device=payloads.device)
    finite = torch.ones(U, dtype=torch.bool, device=payloads.device)
    for sl in column_slices(D):
        x = payloads[:, sl].to(torch.float32)
        fin = torch.isfinite(x)
        sumsq += torch.where(fin, x, 0.0).square().sum(dim=-1)
        finite &= fin.all(dim=-1)
    norms = torch.sqrt(sumsq)
    if mask is None:
        mask = torch.ones(U, dtype=torch.bool, device=payloads.device)
    m = med.to(torch.float32)
    screened = []
    for u in range(U):
        n, act = norms[u], mask[u]
        big = (m > 0.0) & (n > factor * m)
        scr = act & (~finite[u] | big)
        m_new = torch.where(m == 0.0, n,
                            m + torch.clamp(n - m, min=-0.1 * m, max=0.1 * m))
        m = torch.where(act & ~scr, m_new, m)
        screened.append(scr)
    screen = (torch.stack(screened) if screened
              else torch.zeros(0, dtype=torch.bool, device=payloads.device))
    return screen, m
