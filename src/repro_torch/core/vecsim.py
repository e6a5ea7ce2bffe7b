"""Vectorized network simulator on one device: the port of ``repro.core.vecsim``.

The event-driven :mod:`repro_torch.core.netsim` heap is the semantic oracle;
it advances one Python callback per event. This module re-expresses the
same network model as a time-stepped program over tensors on one device:
per-switch combine queues (Algorithm 1 through
:func:`repro_torch.kernels.ops.olaf_burst_multi`), link serialization and
propagation, §5 transmission control (:mod:`repro_torch.core.txctl`) and
per-cluster AoM accounting (:mod:`repro_torch.core.aom`) advance one grid
boundary per :meth:`_Runner.step`. ``repro`` runs the boundaries as one
jitted ``lax.scan``; here :func:`run_vecsim` calls the step once per
boundary, eagerly. The step makes no host round-trip: every branch on the
scenario is a Python value of :class:`_Static`, every data-dependent choice
is a tensor op, and its inner sequential walks (the burst resolve, the
per-switch ``_aux_walk``, the ACK fold) are Python loops of fixed length.
The staged arrays (compiled from
:meth:`repro_torch.core.topology.TopologySpec.scan_arrays` plus the replayed
randomness) are the only host-to-device copies, and the results come back
in one packed copy at the end; the delivered payloads stay on the device.

Time grid and exactness are ``repro``'s (see ``repro/core/vecsim.py``'s
docstring): step k processes every pending event with ``time <= ts[k]``
(and ``<= horizon``); :func:`midpoint_grid` over an oracle trace is exact,
:func:`uniform_grid` is exact for ``dt`` at most the minimum link service
time and approximate (``allow_coarse``) above it. Same-instant ties follow
the heap's push order through the ``(time, sched, sched2, key2)`` lexsort;
under dyadic rates, delays and intervals every event time is exact in
float32 and float64, and the run equals the heap's bit for bit. Times are
float32 here, against the heap's float64 (ROADMAP hazard H4).

Where the port departs from ``repro`` in mechanism, not in results:

  * the arrival bursts and ``_aux_walk`` walk the first ``width`` columns
    of the sorted arrivals, not all ``Rt + Wm``: active arrivals sort first
    (an inactive one has time +inf), so the columns past them are no-ops.
    The run counts the most active arrivals any switch had in one step; if
    that exceeds ``width`` the result is discarded and the run repeated
    with a width that holds it (:func:`run_vecsim`), so the answer never
    depends on the width;
  * ``repro``'s scatters with ``mode="drop"`` become writes that cannot
    leave their buffer (hazard H21): a ring insertion gathers each slot's
    source row instead of scattering rows to slots, and the delivery and
    drop logs carry one scratch row past their end that every discarded
    write lands in;
  * the ``hash`` route's uint32 arithmetic runs in int64, reduced mod 2^32
    after every product and sum (hazard H22); every sort is stable and
    every argmin/argmax takes the first index on a tie (hazard H2).

Randomness is replayed, not re-rolled, exactly as in ``repro``: generation
times from :func:`~repro_torch.core.netsim.generation_schedule`, gate draws
from each controller's ``default_rng(seed * 7919 + worker_id)``, loss draws
from the :func:`~repro_torch.core.netsim.link_stream_index` streams.

Single device only: the sharded runner is ROADMAP queue 1 item 5.
"""
from __future__ import annotations

import dataclasses
import math
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregation import Update
from repro_torch.core.aom import TorchAoMState, aom_average, aom_init, aom_update
from repro_torch.core.netsim import (NetworkSimulator, SimCfg, SimResult,
                                     generation_schedule, link_stream_index)
from repro_torch.core.olaf_queue import (EMPTY_SEQ, EV_AGG, EV_DROP,
                                         EV_RESET, TorchQueueState,
                                         dequeue_one)
from repro_torch.core.topology import spec_from_switch_cfgs
from repro_torch.core.txctl import (send_probability, txctl_ack, txctl_init,
                                    txctl_send)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

_BIG_I32 = np.int32(1 << 30)
_M32 = 0xFFFFFFFF


class VecsimUnsupported(NotImplementedError):
    """The scenario uses a feature outside the vectorized model's envelope."""


def check_vecsim_supported(cfg: SimCfg) -> None:
    """Raise :class:`VecsimUnsupported` unless ``cfg`` fits the envelope."""
    problems: List[str] = []
    if cfg.staleness_bound is not None:
        problems.append("staleness_bound (PS admission control)")
    if cfg.ingress_screen:
        problems.append("ingress_screen (payload-integrity screening)")
    f = cfg.faults
    if f is not None:
        for kind in ("stalls", "workers", "ps", "corruption"):
            if getattr(f, kind):
                problems.append(f"faults.{kind}")
    if cfg.tx_control is not None and cfg.tx_control.ack_timeout is not None:
        problems.append("tx_control.ack_timeout (retransmission)")
    for hook in ("payload_fn", "on_deliver", "on_ack", "on_queue_event",
                 "on_ps_restart"):
        if getattr(cfg, hook) is not None:
            problems.append(f"{hook} (host callback)")
    if problems:
        raise VecsimUnsupported(
            "vectorized simulator does not support: " + ", ".join(problems)
            + "; use the event-driven NetworkSimulator for this scenario")


# ---------------------------------------------------------------------------
# Time grids
# ---------------------------------------------------------------------------
def midpoint_grid(times: Sequence[float], horizon: float,
                  *, bucket: int = 128) -> np.ndarray:
    """Boundary grid from known event times: one boundary at the midpoint
    between each pair of consecutive unique times (each event sits strictly
    inside its own cell, with half-gap float32 margin), one final boundary
    past the last event. Times beyond the horizon are pruned — the heap
    never executes them. ``bucket`` pads the step count (repeating the
    final boundary, a provable no-op) so different trials of the
    equivalence suite share one step shape."""
    t = np.unique(np.asarray(list(times), np.float64))
    t = t[(t >= 0.0) & (t <= horizon)]
    if t.size == 0:
        bounds = np.asarray([horizon + 1.0], np.float64)
    else:
        mids = (t[:-1] + t[1:]) / 2.0
        bounds = np.concatenate([mids, [t[-1] + 1.0]])
    bounds = bounds.astype(np.float32)
    if bucket > 1 and bounds.size % bucket:
        pad = bucket - bounds.size % bucket
        bounds = np.concatenate([bounds, np.full(pad, bounds[-1], np.float32)])
    return bounds


def uniform_grid(cfg: SimCfg, dt: float, *, allow_coarse: bool = False,
                 bucket: int = 128) -> np.ndarray:
    """Fixed-step grid covering ``[0, horizon]`` plus a chain-flush tail.

    Exactness requires ``dt`` at most the minimum link service time (a
    back-to-back completion chain resolves one packet per step); asserted
    here unless ``allow_coarse=True`` — the caller then accepts the
    documented coarse-grid tolerance (see module docstring)."""
    min_size = min((w.size_bits for w in cfg.workers), default=1)
    max_rate = max((s.uplink.capacity_bps for s in cfg.switches), default=1.0)
    min_service = min_size / max_rate
    if not allow_coarse and dt > min_service:
        # name the link that sets the bound: the fastest uplink serializes
        # the smallest packet in min_service seconds
        src = next((s for s in cfg.switches
                    if s.uplink.capacity_bps == max_rate), None)
        link = ""
        if src is not None:
            link = (f" — set by link ({src.name} -> {src.next_hop or 'PS'}):"
                    f" {min_size} bits at {max_rate:g} bps serialize in "
                    f"{min_service:g}s")
        raise ValueError(
            f"uniform_grid dt={dt:g} exceeds the minimum link service time "
            f"{min_service:g}s{link}: back-to-back completion chains would "
            f"resolve one grid step late. Pass allow_coarse=True to accept "
            f"the documented coarse-grid tolerance.")
    n = max(1, int(math.ceil(cfg.horizon / dt)))
    ts = dt * np.arange(1, n + 1, dtype=np.float64)
    # flush tail: each extra step drains at most one completion per switch,
    # so queued-up chains (bounded by the slot count) finish resolving
    qmax = max((s.queue_slots for s in cfg.switches), default=1)
    tail = cfg.horizon + dt * np.arange(1, qmax + 4, dtype=np.float64)
    bounds = np.concatenate([ts, tail]).astype(np.float32)
    if bucket > 1 and bounds.size % bucket:
        pad = bucket - bounds.size % bucket
        bounds = np.concatenate([bounds, np.full(pad, bounds[-1], np.float32)])
    return bounds


def grid_from_trace(cfg: SimCfg, events: Sequence[Tuple], *,
                    bucket: int = 128) -> np.ndarray:
    """Midpoint grid from an oracle queue-event trace (the list collected
    through ``SimCfg.on_queue_event``): every trace time, plus the
    PS-arrival (``t + prop``) and ACK (``+ ack_delay``) expansions of each
    ``deliver`` record, plus every executed generation time (deferred
    generations consume a gate draw but emit no queue event)."""
    prop = {s.name: s.uplink.prop_delay for s in cfg.switches}
    times: List[float] = []
    gen_times, _ = generation_schedule(cfg)
    for ts_w in gen_times.values():
        times.extend(ts_w)
    for ev in events:
        now, name, kind = ev[0], ev[1], ev[2]
        times.append(now)
        if kind == "deliver":
            times.append(now + prop[name])
            times.append(now + prop[name] + cfg.ack_delay)
    return midpoint_grid(times, cfg.horizon, bucket=bucket)


def oracle_event_times(cfg: SimCfg, *, bucket: int = 128
                       ) -> Tuple[np.ndarray, SimResult]:
    """Run the event-driven oracle once, returning ``(grid, SimResult)``:
    the exact midpoint grid for this scenario plus the oracle's own result
    (the equivalence suite's reference, so one heap run serves both)."""
    events: List[Tuple[float, str, str, Optional[Update]]] = []
    trace_cfg = dataclasses.replace(
        cfg, on_queue_event=lambda now, sw, kind, upd: events.append(
            (now, sw, kind, upd)))
    res = NetworkSimulator(trace_cfg).run()
    return grid_from_trace(cfg, events, bucket=bucket), res


# ---------------------------------------------------------------------------
# Scenario compilation (host): cfg -> static dims + staged arrays
# ---------------------------------------------------------------------------
class _Static(NamedTuple):
    S: int       # switches (padded)
    W: int       # workers (padded)
    C: int       # clusters (padded, dense ids)
    CC: int      # candidate columns
    Q: int       # queue slot buffer width
    Wm: int      # max workers per switch (padded)
    Rt: int      # transit ring slots
    Rp: int      # PS-wire ring slots
    Ra: int      # ACK ring slots
    G: int       # generation table width
    NL: int      # per-link loss-uniform table width
    K: int       # outage-window columns
    Gc: int      # delivery buffer rows
    Gd: int      # drop-record buffer rows
    D: int       # payload dim
    route: str   # "static" | "hash" | "adaptive"
    has_tx: bool


@dataclasses.dataclass
class _Compiled:
    static: _Static
    arrays: Dict[str, np.ndarray]
    switch_names: List[str]   # real switches only
    cluster_ids: List[int]    # dense index -> real cluster id
    n_real_switches: int
    generated: int            # len(schedule order)
    total_sends_bound: int
    wire: np.ndarray          # (S,) per-switch in-flight bound, 0 on egress


def _pow2(n: int, lo: int = 2) -> int:
    return max(lo, 1 << (int(n - 1).bit_length())) if n > 0 else lo


def compile_scenario(cfg: SimCfg, *, dim: int = 1,
                     payload_rows: Optional[np.ndarray] = None,
                     gen_rewards: Optional[np.ndarray] = None,
                     pad_pow2: bool = True) -> _Compiled:
    """Compile ``cfg`` into the step's static dims and staged arrays
    (numpy; ``repro``'s arrays, array for array).

    ``gen_rewards`` is an optional (n_workers, G) table of rewards aligned
    to each worker's *executed* generations (the oracle side wires the
    equivalent ``payload_fn``); omitted -> all rewards 0.0, matching a
    heap run without ``payload_fn``. ``pad_pow2`` buckets every axis to a
    power of two with provably inert padding (dummy egress switches with
    no traffic, workers that never generate, clusters never delivered) so
    randomized trials share one shape."""
    check_vecsim_supported(cfg)
    spec = spec_from_switch_cfgs(cfg.switches, route_policy=cfg.route_policy)
    if cfg.workers:
        spec.validate_ingress([w.ingress_switch for w in cfg.workers])
    sa = spec.scan_arrays()
    bucket = _pow2 if pad_pow2 else (lambda n, lo=2: max(n, 1))

    S0, W0 = spec.num_switches, len(cfg.workers)
    cluster_ids = sorted({w.cluster_id for w in cfg.workers})
    c_index = {c: i for i, c in enumerate(cluster_ids)}
    C0 = len(cluster_ids)
    CC0 = sa["cand_matrix"].shape[1]
    Q0 = int(sa["queue_slots"].max()) if S0 else 1

    gen_times, order = generation_schedule(cfg)
    counts = {wid: len(ts) for wid, ts in gen_times.items()}
    G0 = max(list(counts.values()) + [1])
    total_gens = len(order)

    by_ingress: Dict[str, List[int]] = defaultdict(list)
    for i, w in enumerate(cfg.workers):
        by_ingress[w.ingress_switch].append(i)
    Wm0 = max([len(v) for v in by_ingress.values()] + [1])

    # ring bounds: at most one completion per switch per step, so ring
    # occupancy is bounded by packets concurrently on the wire
    min_size = min((w.size_bits for w in cfg.workers), default=1)
    wire = spec.wire_packets(min_size)
    Rt0 = max(int(wire[~sa["is_egress"]].sum()), 2)
    Rp0 = max(int(wire[sa["is_egress"]].sum()), 2)
    ack_pkts = sum(
        int(math.ceil(cfg.ack_delay * cfg.switches[s].uplink.capacity_bps
                      / max(min_size, 1))) + 2
        for s in range(S0) if sa["is_egress"][s])
    Ra0 = max(min(ack_pkts, total_gens + 2), 2)

    st = _Static(
        S=bucket(S0), W=bucket(W0), C=bucket(C0), CC=bucket(CC0, 1),
        Q=bucket(Q0), Wm=bucket(Wm0), Rt=bucket(Rt0), Rp=bucket(Rp0),
        Ra=bucket(Ra0), G=bucket(G0), NL=bucket(total_gens + 2, 4),
        K=bucket(1, 1), Gc=bucket(max(total_gens, 1)),
        Gd=bucket(max(total_gens * max(S0, 1), 1)), D=max(int(dim), 1),
        route=cfg.route_policy, has_tx=cfg.tx_control is not None)

    # ---- per-switch arrays (padding rows are inert egress switches) ------
    S, CC, K = st.S, st.CC, st.K
    cand = np.full((S, CC), -1, np.int32)
    cand[:S0, :CC0] = sa["cand_matrix"]
    ccount = np.zeros(S, np.int32)
    ccount[:S0] = sa["cand_count"]
    next_hop = np.full(S, -1, np.int32)
    next_hop[:S0] = sa["next_hop"]
    is_eg = np.ones(S, bool)
    is_eg[:S0] = sa["is_egress"]
    is_fifo = np.zeros(S, bool)
    is_fifo[:S0] = sa["is_fifo"]
    slots = np.ones(S, np.int32)
    slots[:S0] = sa["queue_slots"]
    rthr = np.full(S, np.inf, np.float32)
    rthr[:S0] = sa["reward_threshold"]
    # rate/prop read straight from the cfg (the spec's gbps round-trip is
    # not bit-exact, which the bitwise AoM test relies on)
    rate = np.ones(S, np.float32)
    prop = np.zeros(S, np.float32)
    for i, sc in enumerate(cfg.switches):
        rate[i] = sc.uplink.capacity_bps
        prop[i] = sc.uplink.prop_delay

    # ---- fault tables: composite drop prob + outage windows + uniforms --
    # column j < CC: link (switch -> candidate j); column CC: egress -> PS
    f = cfg.faults
    K_need = 1
    windows: Dict[Tuple[int, int], List[Tuple[float, float]]] = {}
    p_tab = np.zeros((S, CC + 1), np.float32)
    lossy: List[Tuple[int, int, str, Optional[str]]] = []
    if f is not None and f.links:
        for si in range(S0):
            src = spec.names[si]
            cols: List[Tuple[int, Optional[str]]] = [
                (j, spec.names[cand[si, j]]) for j in range(int(ccount[si]))]
            cols.append((CC, None))
            for j, dst in cols:
                p = f.drop_prob(src, dst)
                if p > 0.0:
                    p_tab[si, j] = p
                    lossy.append((si, j, src, dst))
                win = [(t0, t1) for lf in f._match(src, dst)
                       for (t0, t1) in lf.down]
                if win:
                    windows[(si, j)] = win
                    K_need = max(K_need, len(win))
    K = _pow2(K_need, 1) if pad_pow2 else K_need
    st = st._replace(K=K)
    down_t0 = np.full((S, CC + 1, K), np.inf, np.float32)
    down_t1 = np.full((S, CC + 1, K), np.inf, np.float32)
    for (si, j), win in windows.items():
        for k, (t0, t1) in enumerate(win):
            down_t0[si, j, k] = t0
            down_t1[si, j, k] = t1
    loss_u = np.zeros((S, CC + 1, st.NL), np.float32)
    if lossy:
        base = f.seed * 104729 + cfg.seed * 7919 + 11
        for si, j, src, dst in lossy:
            rng = np.random.default_rng(
                [base, link_stream_index(spec, src, dst)])
            loss_u[si, j] = rng.random(st.NL)

    # ---- per-worker arrays ----------------------------------------------
    W, G = st.W, st.G
    gen_t = np.full((W, G), np.inf, np.float32)
    gen_sched = np.full((W, G), np.inf, np.float32)
    gen_sched2 = np.full((W, G), np.inf, np.float32)
    gen_rank = np.zeros((W, G), np.int32)
    gen_u = np.ones((W, G), np.float32)  # 1.0 => never sends (padding)
    gen_rw = np.zeros((W, G), np.float32)
    gcount = np.zeros(W, np.int32)
    w_cluster = np.full(W, -1, np.int32)
    w_id = np.full(W, -1, np.int32)
    w_size = np.ones(W, np.float32)
    sw_workers = np.full((S, st.Wm), -1, np.int32)
    rank_of = {pair: r for r, pair in enumerate(order)}
    for i, w in enumerate(cfg.workers):
        ts_w = gen_times[w.worker_id]
        n = len(ts_w)
        gcount[i] = n
        gen_t[i, :n] = ts_w
        # the heap event for generation k was PUSHED when generation k-1
        # fired (the first at init, before anything else): that push time
        # decides who wins exact event-time ties against completions and
        # transit arrivals (heap order is (time, eseq))
        gen_sched[i, :n] = [-1.0] + list(ts_w[:-1]) if n else []
        # depth-2 key: the PARENT event's own push time (generation k-1
        # was pushed at generation k-2's firing) — breaks recursive ties
        # between events pushed at the same instant
        gen_sched2[i, :n] = [-1.0, -1.0][:n] + list(ts_w[:-2])
        gen_rank[i, :n] = [rank_of[(w.worker_id, k)] for k in range(n)]
        if st.has_tx:
            gen_u[i, :G] = np.random.default_rng(
                cfg.seed * 7919 + w.worker_id).random(G)
        if gen_rewards is not None:
            m = min(n, gen_rewards.shape[1])
            gen_rw[i, :m] = gen_rewards[i, :m]
        w_cluster[i] = c_index[w.cluster_id]
        w_id[i] = w.worker_id
        w_size[i] = w.size_bits
    for name, idxs in by_ingress.items():
        si = spec.index[name]
        sw_workers[si, :len(idxs)] = idxs

    # ---- payload rows, consumed in global send order --------------------
    n_rows = max(total_gens, 1)
    rows = np.zeros((n_rows + 1, st.D), np.float32)
    if payload_rows is not None:
        pr = np.asarray(payload_rows, np.float32).reshape(-1, st.D)
        rows[:min(len(pr), n_rows)] = pr[:n_rows]

    tc = cfg.tx_control
    arrays = dict(
        cand=cand, ccount=ccount, next_hop=next_hop, is_eg=is_eg,
        is_fifo=is_fifo, slots=slots, slots_f=slots.astype(np.float32),
        rate=rate, prop=prop, rthr=rthr, p_tab=p_tab, down_t0=down_t0,
        down_t1=down_t1, loss_u=loss_u, gen_t=gen_t, gen_sched=gen_sched,
        gen_sched2=gen_sched2, gen_rank=gen_rank,
        gen_u=gen_u, gen_rw=gen_rw, gcount=gcount, w_cluster=w_cluster,
        w_id=w_id, w_size=w_size, sw_workers=sw_workers, rows=rows,
        cl_real=np.asarray(cluster_ids + [0] * (st.C - C0), np.int32),
        horizon=np.float32(cfg.horizon),
        ack_delay=np.float32(cfg.ack_delay),
        active_window=np.float32(cfg.active_window),
        delta_thr=np.float32(tc.delta_threshold if tc else 0.0),
        v_slope=np.float32(tc.v if tc else 0.0),
    )
    wire_pad = np.zeros(st.S, np.int64)
    wire_pad[:S0] = np.where(sa["is_egress"], 0, wire)
    return _Compiled(static=st, arrays=arrays,
                     switch_names=list(spec.names),
                     cluster_ids=cluster_ids, n_real_switches=S0,
                     generated=total_gens, total_sends_bound=total_gens,
                     wire=wire_pad)


# ---------------------------------------------------------------------------
# Device half: rings, the carry and the step
# ---------------------------------------------------------------------------
def _ring_insert(ring, ovf, mask, rows):
    """Insert ``rows[s]`` (masked) into the first free slot (time == +inf)
    of each ring array, one source row after another: the sequential
    reference :func:`_ring_insert_vec` is held to."""
    for s in range(mask.shape[0]):
        free = torch.isinf(ring["time"])
        idx = torch.argmax(free.to(torch.uint8)).view(1)
        any_free = free.any()
        ok = mask[s] & any_free
        ring = {k: v.index_copy(0, idx, torch.where(
            ok, rows[k][s], v.index_select(0, idx)[0]).unsqueeze(0))
            for k, v in ring.items()}
        ovf = ovf | (mask[s] & ~any_free)
    return ring, ovf


def _ring_insert_vec(ring, ovf, mask, rows):
    """Vectorized first-free ring insertion, identical to the sequential
    :func:`_ring_insert` within one call: no slot is freed between the
    insertions of one batch, so the k-th masked source row (in source
    order) lands in the k-th lowest free slot. Returns ``(ring, ovf,
    slot)`` with ``slot`` each masked row's landing index (``R`` for a row
    that did not fit, which sets ``ovf``).

    ``repro`` scatters the rows with ``mode="drop"`` so a row at ``R`` is
    discarded; torch has no such scatter (hazard H21). Here each ring slot
    gathers its source row instead: no index leaves the ring."""
    R = ring["time"].shape[0]
    N = mask.shape[0]
    free = torch.isinf(ring["time"])
    # stable: free slots first, in ascending index (a bool is cast first)
    forder = torch.argsort((~free).to(torch.uint8), stable=True)
    rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
    n_free = free.sum(dtype=torch.int32)
    ok = mask & (rank < n_free)
    slot = torch.where(ok, forder[rank.clamp(0, R - 1).long()], R)
    # the j-th free slot takes the j-th masked row, for j below both counts
    m = min(R, N)
    src = torch.argsort((~mask).to(torch.uint8), stable=True)[:m]
    j = torch.arange(m, device=mask.device)
    take = (j < n_free) & (j < mask.sum(dtype=torch.int32))
    inv = torch.full((R,), -1, dtype=torch.int64, device=mask.device)
    inv = inv.index_copy(0, forder[:m], torch.where(take, src, -1))
    has = inv >= 0
    gidx = inv.clamp(min=0)
    out = {}
    for k, v in ring.items():
        h = has.view((R,) + (1,) * (v.dim() - 1))
        out[k] = torch.where(h, rows[k][gidx].to(v.dtype), v)
    return out, ovf | (mask & ~ok).any(), slot


def _mul_u32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)`` and a
    constant ``c < 2**32``, with no int64 overflow: ``c`` is split into
    16-bit halves (hazard H22)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def route_hash(cl_real: torch.Tensor, worker: torch.Tensor,
               switch: torch.Tensor) -> torch.Tensor:
    """The ``hash`` route's key, ``repro``'s uint32 arithmetic
    ``cl·2654435761 + wk·40503 + s·9176`` (wrapping at 2**32) computed in
    int64: each operand is taken mod 2**32 (so worker -1 is 0xFFFFFFFF, as
    numpy's uint32 cast has it) and every product and sum is reduced mod
    2**32. Returns int64 in ``[0, 2**32)``."""
    def u32(x):
        return x.to(torch.int64) & _M32

    return (_mul_u32(u32(cl_real), 2654435761)
            + _mul_u32(u32(worker), 40503)
            + _mul_u32(u32(switch), 9176)) & _M32


def _stage(arrays: Dict[str, np.ndarray], dev: torch.device
           ) -> Dict[str, torch.Tensor]:
    """One host-to-device copy per compiled array (0-dim for a scalar)."""
    return {k: torch.from_numpy(np.array(v)).to(dev)
            for k, v in arrays.items()}


class _Runner:
    """The per-boundary step of one compiled scenario on one device.

    ``arrs`` are the staged arrays; ``width`` is how many sorted arrival
    columns the bursts walk (the module docstring). :meth:`step` advances
    the carry by one grid boundary and makes no host round-trip; every
    shape and branch is fixed by ``static``."""

    def __init__(self, static: _Static, arrs: Dict[str, torch.Tensor],
                 width: int, horizon: float):
        self.st = st = static
        self.arrs = arrs
        self.horizon = float(horizon)
        self.dev = dev = arrs["cand"].device
        self.A = st.Rt + st.Wm
        self.U = min(int(width), self.A)
        self.key2_off = int(st.W * st.G)

        def ar(n):
            return torch.arange(n, device=dev)

        self.aS, self.aW, self.aA = ar(st.S), ar(st.W), ar(self.A)
        self.aQ, self.aC, self.aCC = ar(st.Q), ar(st.C), ar(st.CC)
        self.key2_tr = (self.key2_off + ar(st.Rt).to(torch.int32)).expand(
            st.S, st.Rt)
        self.ones_sw = torch.ones((st.S, st.Wm), dtype=torch.int32,
                                  device=dev)
        self.true_sw = torch.ones((st.S, st.Wm), dtype=torch.bool,
                                  device=dev)

    # -- the carry ---------------------------------------------------------
    def init_carry(self) -> dict:
        """The initial state: ``repro``'s ``_init_carry``, a dict of tensors
        on the run's device. The delivery (``dlv``) and drop (``drp``) logs
        carry one scratch row past their end (hazard H21); the drop log
        keeps only what the result reads (``repro``'s also logs the drop
        time and subsumed count)."""
        st, dev = self.st, self.dev
        S, W, C, Q, D, CC = st.S, st.W, st.C, st.Q, st.D, st.CC
        Rt, Rp, Ra, Gc, Gd = st.Rt, st.Rp, st.Ra, st.Gc, st.Gd
        i32, f32 = torch.int32, torch.float32

        def full(shape, value, dtype):
            return torch.full(shape, value, dtype=dtype, device=dev)

        q = TorchQueueState(
            cluster=full((S, Q), -1, i32), worker=full((S, Q), -1, i32),
            seq=full((S, Q), EMPTY_SEQ, i32), gen_time=full((S, Q), 0.0, f32),
            reward=full((S, Q), -math.inf, f32),
            agg_count=full((S, Q), 0, i32),
            replaceable=full((S, Q), False, torch.bool),
            payload=full((S, Q, D), 0.0, f32), next_seq=full((S,), 0, i32),
            n_dropped=full((S,), 0, i32), n_agg=full((S,), 0, i32),
            n_repl=full((S,), 0, i32), n_screened=full((S,), 0, i32))
        aom0 = aom_init(0.0, device=dev)
        tr = dict(time=full((Rt,), math.inf, f32), sched=full((Rt,), 0.0, f32),
                  sched2=full((Rt,), 0.0, f32), dst=full((Rt,), -1, i32),
                  rcl=full((Rt,), 0, i32), wk=full((Rt,), 0, i32),
                  gen=full((Rt,), 0.0, f32), rw=full((Rt,), 0.0, f32),
                  agg=full((Rt,), 0, i32), subs=full((Rt,), 0, i32),
                  size=full((Rt,), 1.0, f32), rp=full((Rt,), True, torch.bool),
                  pay=full((Rt, D), 0.0, f32))
        carry = dict(
            q=q,
            rclq=full((S, Q), -1, i32), subsq=full((S, Q), 0, i32),
            sizeq=full((S, Q), 1.0, f32),
            srv=dict(valid=full((S,), False, torch.bool),
                     rcl=full((S,), -1, i32), wk=full((S,), -1, i32),
                     gen=full((S,), 0.0, f32), rw=full((S,), 0.0, f32),
                     agg=full((S,), 0, i32), subs=full((S,), 0, i32),
                     size=full((S,), 1.0, f32),
                     fin=full((S,), math.inf, f32),
                     rp=full((S,), True, torch.bool),
                     pay=full((S, D), 0.0, f32)),
            free_t=full((S,), 0.0, f32),
            nonempty=full((S,), math.inf, f32),
            last_seen=full((S, C), -math.inf, f32),
            tr=tr,
            ps=dict(time=full((Rp,), math.inf, f32), rcl=full((Rp,), 0, i32),
                    wk=full((Rp,), 0, i32), gen=full((Rp,), 0.0, f32),
                    rw=full((Rp,), 0.0, f32), agg=full((Rp,), 0, i32),
                    subs=full((Rp,), 0, i32), pay=full((Rp, D), 0.0, f32)),
            ack=dict(time=full((Ra,), math.inf, f32), cl=full((Ra,), -1, i32),
                     nact=full((Ra,), 0.0, f32), qmax=full((Ra,), 1.0, f32),
                     gen=full((Ra,), 0.0, f32)),
            aom=TorchAoMState(**{f.name: getattr(aom0, f.name).expand(C)
                                 .clone()
                                 for f in dataclasses.fields(TorchAoMState)}),
            dlv=dict(n=full((), 0, i32), time=full((Gc + 1,), 0.0, f32),
                     rcl=full((Gc + 1,), 0, i32), wk=full((Gc + 1,), 0, i32),
                     gen=full((Gc + 1,), 0.0, f32),
                     rw=full((Gc + 1,), 0.0, f32),
                     agg=full((Gc + 1,), 0, i32),
                     subs=full((Gc + 1,), 0, i32),
                     pay=full((Gc + 1, D), 0.0, f32)),
            drp=dict(n=full((), 0, i32), rcl=full((Gd + 1,), 0, i32),
                     gen=full((Gd + 1,), 0.0, f32)),
            sent=full((), 0, i32), deferred=full((), 0, i32),
            link_dropped=full((), 0, i32), raw_link_dropped=full((), 0, i32),
            reroutes=full((), 0, i32), forwarded=full((), 0, i32),
            reroutes_s=full((S,), 0, i32), drops_s=full((S,), 0, i32),
            departed=full((S,), 0, i32), rdrops=full((S,), 0, i32),
            fctr=full((S,), 0, i32), lctr=full((S, CC + 1), 0, i32),
            gptr=full((W,), 0, i32), srow=full((), 0, i32),
            max_active=full((), 0, i32),
            ovf=dict(tr=full((), False, torch.bool),
                     ps=full((), False, torch.bool),
                     ack=full((), False, torch.bool)))
        if st.has_tx:
            carry["tx"] = txctl_init(W, device=dev)
        return carry

    # -- sequential walks --------------------------------------------------
    def _aux_walk(self, cl0, occ0, subs0, rcl0, size0, nocc0, slots, evs, act,
                  cps, cr, t_r, insub, insz):
        """Per-switch replay of a burst's ``(slot, event)`` stream, all
        switches side by side (``repro``'s vmapped ``aux_walk`` scan): the
        per-slot real-cluster / subsumed / size sidecar, reward drops (a
        drop with a same-cluster hit) and the first append into an empty
        queue. A fixed-length loop over the burst's columns."""
        clq, occ, subs, rcl, sizev, nocc = cl0, occ0, subs0, rcl0, size0, nocc0
        first_app = torch.full(nocc0.shape, math.inf, dtype=torch.float32,
                               device=self.dev)
        rdrop = torch.zeros_like(nocc0)
        cols = [x.unbind(1) for x in (slots.long(), evs, act, cps, cr, t_r,
                                      insub, insz)]
        for u in range(slots.shape[1]):
            slot, ev, a, c_ps, c_r, t_u, isub, isz = (col[u] for col in cols)
            slot1, c_ps = slot.unsqueeze(1), c_ps.unsqueeze(1)
            occ_slot = occ.gather(1, slot1).squeeze(1)
            hit = (occ & (clq == c_ps)).any(dim=1)
            rdrop = rdrop + (a & (ev == EV_DROP) & hit).to(torch.int32)
            is_agg = a & (ev == EV_AGG)
            is_rst = a & (ev == EV_RESET)
            appendv = is_rst & ~occ_slot
            first_app = torch.where(appendv & (nocc == 0),
                                    torch.minimum(first_app, t_u), first_app)
            oh = self.aQ.unsqueeze(0) == slot1
            wrt = oh & (is_agg | is_rst).unsqueeze(1)
            addm = oh & (is_agg | (is_rst & occ_slot)).unsqueeze(1)
            isub = isub.unsqueeze(1)
            subs = torch.where(addm, subs + isub, subs)
            subs = torch.where(oh & appendv.unsqueeze(1), isub, subs)
            rcl = torch.where(wrt, c_r.unsqueeze(1), rcl)
            sizev = torch.where(wrt, isz.unsqueeze(1), sizev)
            rst = oh & is_rst.unsqueeze(1)
            clq = torch.where(rst, c_ps, clq)
            nocc = nocc + appendv.to(torch.int32)
            occ = occ | rst
        return subs, rcl, sizev, first_app, rdrop

    def _try_start(self, q, subsq, rclq, sizeq, srv, free_t, nonempty):
        """Pop the min-seq packet into the service register wherever the
        server is free and the queue nonempty (netsim's restart-at-finish
        and head lock), through :func:`dequeue_one` over every switch."""
        occ = (q.cluster >= 0).sum(dim=1, dtype=torch.int32)
        start_m = ~srv["valid"] & (occ > 0)
        start_t = torch.maximum(free_t, nonempty)
        slot_min = torch.argmin(q.seq, dim=1, keepdim=True)

        def at(x):
            return x.gather(1, slot_min).squeeze(1)

        rp_g, size_g = at(q.replaceable), at(sizeq)
        q_pop, outd = dequeue_one(q)
        sm = start_m.unsqueeze(1)
        qf = dataclasses.replace(q, **{
            f: torch.where(sm, getattr(q_pop, f), getattr(q, f))
            for f in ("cluster", "worker", "seq", "reward", "agg_count",
                      "replaceable")},
            payload=torch.where(sm.unsqueeze(2), q_pop.payload, q.payload))

        def sel(new, old):
            return torch.where(start_m, new, old)

        srv = dict(
            valid=srv["valid"] | start_m, rcl=sel(at(rclq), srv["rcl"]),
            wk=sel(outd["worker"], srv["wk"]),
            gen=sel(outd["gen_time"], srv["gen"]),
            rw=sel(outd["reward"], srv["rw"]),
            agg=sel(outd["agg_count"], srv["agg"]),
            subs=sel(at(subsq), srv["subs"]), size=sel(size_g, srv["size"]),
            fin=sel(start_t + size_g / self.arrs["rate"], srv["fin"]),
            rp=sel(rp_g, srv["rp"]),
            pay=torch.where(sm, outd["payload"], srv["pay"]))
        oh = (self.aQ.unsqueeze(0) == slot_min) & sm
        return (qf, torch.where(oh, 0, subsq), torch.where(oh, -1, rclq),
                torch.where(oh, 1.0, sizeq), srv)

    # -- one grid boundary -------------------------------------------------
    def step(self, carry: dict, t: torch.Tensor) -> dict:
        """Advance ``carry`` to the boundary ``t`` (a 0-dim float32 tensor
        on the device): ``repro``'s scan body, phase for phase."""
        st, arrs = self.st, self.arrs
        S, W, C, CC, G = st.S, st.W, st.C, st.CC, st.G
        NL, Gc, Gd, Wm, U = st.NL, st.Gc, st.Gd, st.Wm, self.U
        aS = self.aS
        i32, f32 = torch.int32, torch.float32
        inf = math.inf
        horizon = arrs["horizon"]
        q, srv = carry["q"], carry["srv"]

        def row(x, idx):  # x[s, idx[s]] for every s
            return x.gather(1, idx.unsqueeze(1)).squeeze(1)

        # ======== phase 1: service completions ===========================
        fin = srv["fin"]
        done = srv["valid"] & (fin <= t) & (fin <= horizon)
        depth = ((q.cluster >= 0).sum(dim=1, dtype=i32)
                 + srv["valid"].to(i32))
        cand_valid = self.aCC.unsqueeze(0) < arrs["ccount"].unsqueeze(1)
        finb = fin[:, None, None]
        down_c = ((arrs["down_t0"][:, :CC, :] <= finb)
                  & (finb < arrs["down_t1"][:, :CC, :])).any(dim=2)
        alive = cand_valid & ~down_c
        eg_down = ((arrs["down_t0"][:, CC, :] <= fin[:, None])
                   & (fin[:, None] < arrs["down_t1"][:, CC, :])).any(dim=1)
        m = alive.sum(dim=1, dtype=i32)
        if st.route == "hash":
            h = route_hash(arrs["cl_real"][srv["rcl"].clamp(0, C - 1).long()],
                           srv["wk"], aS)
            kth = h % m.clamp(min=1).to(torch.int64)
            csum = torch.cumsum(alive.to(i32), dim=1, dtype=i32) - 1
            selcol = torch.argmax(((csum == kth.unsqueeze(1)) & alive)
                                  .to(torch.uint8), dim=1)
        elif st.route == "adaptive":
            dsts = arrs["cand"].clamp(0, S - 1).long()
            dd = torch.where(alive, depth[dsts].to(f32), inf)
            selcol = torch.argmin(dd, dim=1)
        else:  # static: first alive candidate
            selcol = torch.argmax(alive.to(torch.uint8), dim=1)
        sel = row(arrs["cand"], selcol)
        is_eg = arrs["is_eg"]
        drawcol = torch.where(is_eg, CC, selcol)
        p = row(arrs["p_tab"], drawcol)
        ctr = row(carry["lctr"], drawcol)
        u = arrs["loss_u"][aS, drawcol, ctr.clamp(0, NL - 1).long()]
        need_draw = done & (p > 0.0) & torch.where(is_eg, ~eg_down, m > 0)
        lost_draw = need_draw & (u < p)
        lctr = carry["lctr"].scatter_add(1, drawcol.unsqueeze(1),
                                         need_draw.to(i32).unsqueeze(1))
        eg_del = is_eg & done & ~eg_down & ~lost_draw
        ne_fwd = ~is_eg & done & (m > 0) & ~lost_draw
        dropped_now = done & ~eg_del & ~ne_fwd
        reroute_now = ne_fwd & (sel != arrs["next_hop"])
        raw_drop_add = torch.where(dropped_now, srv["subs"], 0).sum(dtype=i32)

        orderd = torch.argsort(torch.where(dropped_now, fin, inf), stable=True)
        posd = torch.argsort(orderd, stable=True)
        drp = carry["drp"]
        widx = drp["n"] + posd
        widx = torch.where(dropped_now & (widx < Gd), widx, Gd)  # H21
        for k in ("rcl", "gen"):  # what the unrecovered-drop count reads
            drp[k].index_copy_(0, widx, srv[k])
        drp["n"] = drp["n"] + dropped_now.sum(dtype=i32)

        ovf = carry["ovf"]
        arr_t = fin + arrs["prop"]
        ps, ovf_ps, _ = _ring_insert_vec(
            carry["ps"], ovf["ps"], eg_del,
            dict(time=arr_t, rcl=srv["rcl"], wk=srv["wk"], gen=srv["gen"],
                 rw=srv["rw"], agg=srv["agg"], subs=srv["subs"],
                 pay=srv["pay"]))
        # heap push time of this completion (its service start): decides
        # same-instant ties against arrivals, and is the forwarded
        # arrival's depth-2 tie key
        csched = fin - srv["size"] / arrs["rate"]
        tr, ovf_tr, _ = _ring_insert_vec(
            carry["tr"], ovf["tr"], ne_fwd,
            dict(time=arr_t, sched=fin, sched2=csched, dst=sel,
                 rcl=srv["rcl"], wk=srv["wk"], gen=srv["gen"], rw=srv["rw"],
                 agg=srv["agg"], subs=srv["subs"], size=srv["size"],
                 rp=srv["rp"], pay=srv["pay"]))
        free_t = torch.where(done, fin, carry["free_t"])
        srv = dict(srv, valid=srv["valid"] & ~done,
                   fin=torch.where(done, inf, fin))

        # ======== phase 2: PS deliveries + ACKs ==========================
        due = (ps["time"] <= t) & (ps["time"] <= horizon)
        orderp = torch.argsort(torch.where(due, ps["time"], inf), stable=True)
        posp = torch.argsort(orderp, stable=True)
        dlv = carry["dlv"]
        didx = dlv["n"] + posp
        didx = torch.where(due & (didx < Gc), didx, Gc)  # H21
        for k in ("time", "rcl", "wk", "gen", "rw", "agg", "subs", "pay"):
            dlv[k].index_copy_(0, didx, ps[k])
        dlv["n"] = dlv["n"] + due.sum(dtype=i32)
        ts_b, gen_b = ps["time"][orderp], ps["gen"][orderp]
        due_b, rcl_b = due[orderp], ps["rcl"][orderp]
        aom = carry["aom"]
        for i in range(ts_b.shape[0]):  # the drained block, in time order
            aom = aom_update(aom, ts_b[i], gen_b[i],
                             due_b[i] & (rcl_b[i] == self.aC))
        ack, ovf_ack = carry["ack"], ovf["ack"]
        if st.has_tx:
            # bottleneck-path feedback at each delivery instant, read
            # against the pre-arrival last_seen
            age = ps["time"][:, None, None] - carry["last_seen"][None, :, :]
            nact = (age <= arrs["active_window"]).sum(dim=2, dtype=i32).to(f32)
            pr = nact / arrs["slots_f"].clamp(min=1.0).unsqueeze(0)
            s_star = torch.argmax(pr, dim=1)
            fb_n = row(nact, s_star)
            fb_q = arrs["slots_f"][s_star]
            ack, ovf_ack, _ = _ring_insert_vec(
                ack, ovf_ack, due_b,
                dict(time=(ps["time"] + arrs["ack_delay"])[orderp], cl=rcl_b,
                     nact=fb_n[orderp], qmax=fb_q[orderp], gen=gen_b))
        ps = dict(ps, time=torch.where(due, inf, ps["time"]))
        tx = carry.get("tx")
        if st.has_tx:
            due_a = (ack["time"] <= t) & (ack["time"] <= horizon)
            ordera = torch.argsort(torch.where(due_a, ack["time"], inf),
                                   stable=True)
            a_cl, a_due = ack["cl"][ordera], due_a[ordera]
            a_t, a_n = ack["time"][ordera], ack["nact"][ordera]
            a_q, a_g = ack["qmax"][ordera], ack["gen"][ordera]
            for i in range(a_cl.shape[0]):  # repro's ack_body scan
                acked = (arrs["w_cluster"] == a_cl[i]) & a_due[i]
                tx = txctl_ack(tx, acked, torch.where(a_due[i], a_t[i], 0.0),
                               a_n[i], a_q[i], delivered_gen=a_g[i])
            ack = dict(ack, time=torch.where(due_a, inf, ack["time"]))

        # ======== phase 3: arrivals (transit + gated generations) ========
        gptr0 = carry["gptr"]
        gidx = gptr0.clamp(0, G - 1).long()
        g_t = row(arrs["gen_t"], gidx)
        g_due = (gptr0 < arrs["gcount"]) & (g_t <= t) & (g_t <= horizon)
        if st.has_tx:
            p_send = send_probability(tx, g_t, arrs["delta_thr"],
                                      arrs["v_slope"])
            g_send = g_due & (row(arrs["gen_u"], gidx) < p_send)
        else:
            g_send = g_due
        sent = carry["sent"] + g_send.sum(dtype=i32)
        deferred = carry["deferred"] + (g_due & ~g_send).sum(dtype=i32)
        grank = row(arrs["gen_rank"], gidx)
        ordw = torch.argsort(torch.where(g_send, grank, int(_BIG_I32)),
                             stable=True)
        posw = torch.argsort(ordw, stable=True)
        n_rows_tab = arrs["rows"].shape[0] - 1
        row_idx = torch.where(
            g_send, torch.clamp(carry["srow"] + posw, max=n_rows_tab),
            n_rows_tab)
        srow = carry["srow"] + g_send.sum(dtype=i32)
        g_rw = row(arrs["gen_rw"], gidx)
        gptr = gptr0 + g_due.to(i32)
        if st.has_tx:
            tx = txctl_send(tx, g_send, g_t, g_t, ack_timeout=inf)

        tr_due = (tr["time"] <= t) & (tr["time"] <= horizon)
        act_tr = tr_due.unsqueeze(0) & (tr["dst"].unsqueeze(0)
                                        == aS.unsqueeze(1))
        sww = arrs["sw_workers"]
        wv = sww.clamp(0, W - 1).long()

        def bcast(x):
            return x.unsqueeze(0).expand(S, x.shape[0])

        def cols(worker_part, ring_part):
            return torch.cat([worker_part, bcast(ring_part)], dim=1)

        act_c = torch.cat([(sww >= 0) & g_send[wv], act_tr], dim=1)
        time_c = cols(g_t[wv], tr["time"])
        sch_c = cols(row(arrs["gen_sched"], gidx)[wv], tr["sched"])
        sch2_c = cols(row(arrs["gen_sched2"], gidx)[wv], tr["sched2"])
        key2 = torch.cat([grank[wv], self.key2_tr], dim=1)
        # lexsort (time, sched, sched2, key2) through stable argsorts: the
        # heap drains same-instant events in push order (H2)
        o1 = torch.argsort(key2, dim=1, stable=True)
        s2 = torch.where(act_c, sch2_c, inf).gather(1, o1)
        o1 = o1.gather(1, torch.argsort(s2, dim=1, stable=True))
        s1 = torch.where(act_c, sch_c, inf).gather(1, o1)
        o2 = o1.gather(1, torch.argsort(s1, dim=1, stable=True))
        t1 = torch.where(act_c, time_c, inf).gather(1, o2)
        ordA = o2.gather(1, torch.argsort(t1, dim=1, stable=True))
        # active arrivals sort first: the bursts walk the first U columns
        n_act = act_c.sum(dim=1, dtype=i32)
        max_active = torch.maximum(carry["max_active"], n_act.max())
        ordU = ordA[:, :U]

        def gat(worker_part, ring_part):
            return cols(worker_part, ring_part).gather(1, ordU)

        act_s = act_c.gather(1, ordU)
        time_s = time_c.gather(1, ordU)
        sch_s = sch_c.gather(1, ordU)
        cl_s = gat(arrs["w_cluster"][wv], tr["rcl"])
        wk_s = gat(arrs["w_id"][wv], tr["wk"])
        gen_s = gat(g_t[wv], tr["gen"])
        rw_s = gat(g_rw[wv], tr["rw"])
        agg_s = gat(self.ones_sw, tr["agg"])
        subs_s = gat(self.ones_sw, tr["subs"])
        size_s = gat(arrs["w_size"][wv], tr["size"])
        irp_s = gat(self.true_sw, tr["rp"])
        # payload rows of the walked columns only: a worker column reads
        # its row of the staged table, a transit column its ring row
        is_w = ordU < Wm
        w_row = row_idx[wv.gather(1, ordU.clamp(max=Wm - 1))]
        pay_s = torch.where(is_w.unsqueeze(2), arrs["rows"][w_row],
                            tr["pay"][(ordU - Wm).clamp(min=0)])
        # FIFO: a unique pseudo-cluster per arrival reduces Algorithm 1 to
        # a tail-drop append
        eff_cl = torch.where(
            arrs["is_fifo"].unsqueeze(1),
            C + carry["fctr"].unsqueeze(1) + self.aA[:U].to(i32).unsqueeze(0),
            cl_s)
        fctr = carry["fctr"] + self.A

        # -- batch A: arrivals the heap processes BEFORE a completion at
        # this instant (earlier time, or equal time with earlier push)
        finc, cschc = fin.unsqueeze(1), csched.unsqueeze(1)
        early_s = act_s & done.unsqueeze(1) & (
            (time_s < finc) | ((time_s == finc) & (sch_s < cschc)))
        cl_preA = q.cluster
        occ_preA = cl_preA >= 0
        pre_cntA = occ_preA.sum(dim=1, dtype=i32)
        capA = arrs["slots"] - (srv["valid"] | done).to(i32)
        q, slots_eA, events_eA = ops.olaf_burst_multi(
            q, eff_cl, wk_s, gen_s, rw_s, pay_s, arrs["rthr"], early_s,
            capA, agg_s, irp_s)
        subsqA, rclqA, sizeqA, first_appA, rdropA = self._aux_walk(
            cl_preA, occ_preA, carry["subsq"], carry["rclq"], carry["sizeq"],
            pre_cntA, slots_eA, events_eA, early_s, eff_cl, cl_s, time_s,
            subs_s, size_s)
        nonemptyA = torch.where((pre_cntA == 0) & torch.isfinite(first_appA),
                                first_appA, carry["nonempty"])

        # -- restart-at-finish: the next head is dequeued and locked at the
        # completion instant, before a later-pushed same-instant arrival
        q, subsq0, rclq0, sizeq0, srv = self._try_start(
            q, subsqA, rclqA, sizeqA, srv, free_t, nonemptyA)

        # an arrival at an idle switch starts serializing (head-locked) at
        # its arrival instant: load the first remaining active row straight
        # into the service register
        act_late = act_s & ~early_s
        has_act = act_late.any(dim=1)
        fidx = torch.argmax(act_late.to(torch.uint8), dim=1)
        startA = ~srv["valid"] & has_act

        def sel(new, old):
            return torch.where(startA, new, old)

        size_f = row(size_s, fidx)
        srv = dict(
            valid=srv["valid"] | startA, rcl=sel(row(cl_s, fidx), srv["rcl"]),
            wk=sel(row(wk_s, fidx), srv["wk"]),
            gen=sel(row(gen_s, fidx), srv["gen"]),
            rw=sel(row(rw_s, fidx), srv["rw"]),
            agg=sel(row(agg_s, fidx), srv["agg"]),
            subs=sel(row(subs_s, fidx), srv["subs"]),
            size=sel(size_f, srv["size"]),
            fin=sel(torch.maximum(free_t, row(time_s, fidx))
                    + size_f / arrs["rate"], srv["fin"]),
            rp=sel(row(irp_s, fidx), srv["rp"]),
            pay=torch.where(startA.unsqueeze(1), pay_s[aS, fidx], srv["pay"]))
        # the loaded row was appended-then-locked: it takes a seq number
        q = dataclasses.replace(q, next_seq=q.next_seq + startA.to(i32))
        act_B = act_late & ~((self.aA[:U].unsqueeze(0) == fidx.unsqueeze(1))
                             & startA.unsqueeze(1))

        cl_pre = q.cluster
        occ_pre = cl_pre >= 0
        pre_cnt = occ_pre.sum(dim=1, dtype=i32)
        cap = arrs["slots"] - srv["valid"].to(i32)
        q, slots_a, events_a = ops.olaf_burst_multi(
            q, eff_cl, wk_s, gen_s, rw_s, pay_s, arrs["rthr"], act_B, cap,
            agg_s, irp_s)
        subsq, rclq, sizeq, first_app, rdrop = self._aux_walk(
            cl_pre, occ_pre, subsq0, rclq0, sizeq0, pre_cnt, slots_a,
            events_a, act_B, eff_cl, cl_s, time_s, subs_s, size_s)
        rdrops = carry["rdrops"] + rdropA + rdrop
        nonempty = torch.where((pre_cnt == 0) & torch.isfinite(first_app),
                               first_app, nonemptyA)
        ls_upd = torch.where(
            act_s.unsqueeze(2) & (cl_s.unsqueeze(2) == self.aC.view(1, 1, C)),
            time_s.unsqueeze(2), -inf).amax(dim=1)
        last_seen = torch.maximum(carry["last_seen"], ls_upd)
        tr = dict(tr, time=torch.where(tr_due, inf, tr["time"]))

        # ======== phase 4: service starts ================================
        qf, subsq, rclq, sizeq, srv = self._try_start(
            q, subsq, rclq, sizeq, srv, free_t, nonempty)

        new = dict(
            carry, q=qf, rclq=rclq, subsq=subsq, sizeq=sizeq, srv=srv,
            free_t=free_t, nonempty=nonempty, last_seen=last_seen, tr=tr,
            ps=ps, ack=ack, aom=aom, dlv=dlv, drp=drp, sent=sent,
            deferred=deferred,
            link_dropped=carry["link_dropped"] + dropped_now.sum(dtype=i32),
            raw_link_dropped=carry["raw_link_dropped"] + raw_drop_add,
            reroutes=carry["reroutes"] + reroute_now.sum(dtype=i32),
            forwarded=carry["forwarded"] + ne_fwd.sum(dtype=i32),
            reroutes_s=carry["reroutes_s"] + reroute_now.to(i32),
            drops_s=carry["drops_s"] + dropped_now.to(i32),
            departed=carry["departed"] + done.to(i32),
            rdrops=rdrops, fctr=fctr, lctr=lctr, gptr=gptr, srow=srow,
            max_active=max_active,
            ovf=dict(tr=ovf_tr, ps=ovf_ps, ack=ovf_ack))
        if st.has_tx:
            new["tx"] = tx
        return new

    def run(self, carry: dict, ts: torch.Tensor) -> dict:
        """One :meth:`step` per boundary of ``ts`` (float32 on the device),
        then the per-cluster time-average AoM (``aom_avg``). No host
        round-trip."""
        with torch.no_grad():
            for k in range(ts.shape[0]):
                carry = self.step(carry, ts[k])
            carry["aom_avg"] = aom_average(carry["aom"], self.horizon)
        return carry


# ---------------------------------------------------------------------------
# Host entry point and result assembly
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class VecSimResult:
    """Vectorized-run output, ``repro``'s fields: the event-heap-compatible
    :class:`~repro_torch.core.netsim.SimResult` plus what the heap cannot
    give cheaply. ``delivered_payloads`` is a tensor on the run's device;
    every other array is numpy."""
    sim: SimResult
    aom: Dict[int, float]            # real cluster id -> time-averaged AoM
    n_steps: int                     # grid boundaries stepped
    h2d_transfers: int               # host->device copies staged (total)
    forwarded: int                   # inter-switch forwards
    delivery_times: np.ndarray       # (n_del,) exact delivery instants
    delivered_payloads: torch.Tensor  # (n_del, D), delivery order
    final_counts: np.ndarray         # (S_real, Q) residual per-slot agg
    residual: Dict[str, int]         # per-switch queue + in-service packets
    width: int = 0                   # burst columns walked by the kept run
    passes: int = 1                  # runs made (> 1: the width grew)


def default_width(static: _Static) -> int:
    """The first burst width :func:`run_vecsim` tries: 4 columns (an
    exact grid puts at most a few arrivals at one switch into a cell), at
    most every column."""
    return min(static.Rt + static.Wm, 4)


_FETCH = ("dlv.n", "dlv.time", "dlv.rcl", "dlv.wk", "dlv.gen", "dlv.rw",
          "dlv.agg", "dlv.subs", "drp.n", "drp.rcl", "drp.gen", "ovf.tr",
          "ovf.ps", "ovf.ack", "q.next_seq", "q.n_dropped", "q.n_agg",
          "q.n_repl", "q.cluster", "q.agg_count", "srv.valid", "rdrops",
          "departed", "drops_s", "reroutes_s", "sent", "deferred",
          "link_dropped", "raw_link_dropped", "reroutes", "forwarded",
          "aom_avg", "max_active")


def _lookup(carry: dict, key: str) -> torch.Tensor:
    obj = carry
    for part in key.split("."):
        obj = obj[part] if isinstance(obj, dict) else getattr(obj, part)
    return obj


def _fetch(carry: dict) -> Dict[str, np.ndarray]:
    """The carry's result fields (:data:`_FETCH`) in ONE device-to-host
    copy: their bytes packed into one buffer on the device."""
    ts = [_lookup(carry, k).contiguous().reshape(-1) for k in _FETCH]
    buf = torch.cat([t.view(torch.uint8) for t in ts]).cpu().numpy()
    out, off = {}, 0
    for key, t in zip(_FETCH, ts):
        nb = t.numel() * t.element_size()
        shape = tuple(_lookup(carry, key).shape)
        dtype = np.dtype(str(t.dtype).replace("torch.", ""))
        out[key] = buf[off:off + nb].copy().view(dtype).reshape(shape)
        off += nb
    return out


def run_vecsim(cfg: SimCfg, *, dt: Optional[float] = None,
               grid: Optional[np.ndarray] = None, dim: int = 1,
               payload_rows: Optional[np.ndarray] = None,
               gen_rewards: Optional[np.ndarray] = None,
               pad_pow2: bool = True, allow_coarse: bool = False,
               grid_bucket: int = 128, mesh=None,
               rt_loc: Optional[int] = None, device="cuda",
               width: Optional[int] = None) -> VecSimResult:
    """Run ``cfg`` through the vectorized model on ``device`` (default
    ``"cuda"``: raises without a card unless the caller passes ``"cpu"``).

    Grid selection: an explicit ``grid`` wins; else ``dt`` selects
    :func:`uniform_grid`; else an exact event-aligned grid is derived from
    one oracle heap run (:func:`oracle_event_times`). The compiled arrays
    are staged once (one copy each, plus the grid: ``h2d_transfers``);
    the boundaries are stepped without a host round-trip; the results come
    back in one packed copy, the payloads stay on the device.

    ``width`` (default :func:`default_width`) is how many sorted arrival
    columns the bursts walk. If some switch had more active arrivals in one
    step, the run is repeated with a width that holds them, so the result
    never depends on it. ``mesh`` and ``rt_loc`` belong to the sharded
    runner, which is not ported (ROADMAP queue 1 item 5), and raise.
    """
    if mesh is not None or rt_loc is not None:
        raise NotImplementedError(
            "the sharded vectorized simulator (mesh / rt_loc) is not ported "
            "yet: it is ROADMAP queue 1 item 5; run on one device")
    dev = resolve_device(device)
    comp = compile_scenario(cfg, dim=dim, payload_rows=payload_rows,
                            gen_rewards=gen_rewards, pad_pow2=pad_pow2)
    if grid is None:
        if dt is not None:
            grid = uniform_grid(cfg, dt, allow_coarse=allow_coarse,
                                bucket=grid_bucket)
        else:
            grid, _ = oracle_event_times(cfg, bucket=grid_bucket)
    ts = torch.from_numpy(np.asarray(grid, np.float32)).to(dev)
    arrs = _stage(comp.arrays, dev)
    width = default_width(comp.static) if width is None else int(width)
    passes = 0
    while True:
        runner = _Runner(comp.static, arrs, width,
                         float(comp.arrays["horizon"]))
        carry = runner.run(runner.init_carry(), ts)
        host = _fetch(carry)
        passes += 1
        need = int(host["max_active"])
        if need <= runner.U:
            break
        width = _pow2(need)
    res = _assemble(cfg, comp, host, carry, len(ts), len(arrs) + 1)
    res.width, res.passes = runner.U, passes
    return res


def auto_dt(cfg: SimCfg, *, tol: float = 0.05, prefix_frac: float = 0.25,
            max_iters: int = 6, dim: int = 1, device="cuda") -> float:
    """Pick the largest :func:`uniform_grid` ``dt`` whose coarse-grid AoM
    stays within ``tol`` (relative, worst cluster) of the exact
    event-aligned grid, bisected in log space against one oracle run on a
    short prefix (``prefix_frac`` of the horizon). ``repro``'s
    ``auto_dt``, with every run on ``device``."""
    check_vecsim_supported(cfg)
    min_size = min((w.size_bits for w in cfg.workers), default=1)
    max_rate = max((s.uplink.capacity_bps for s in cfg.switches), default=1.0)
    lo = min_size / max_rate  # the documented exact-regime bound
    pre = dataclasses.replace(cfg, horizon=float(cfg.horizon) * prefix_frac)
    hi = max(float(pre.horizon) / 8.0, lo)
    if hi <= lo:
        return lo
    ref = run_vecsim(pre, dim=dim, device=device)  # exact prefix reference

    def rel_err(dt: float) -> float:
        res = run_vecsim(pre, dt=dt, dim=dim, allow_coarse=True,
                         device=device)
        worst = 0.0
        for c, want in ref.aom.items():
            got = res.aom.get(c, float("inf"))
            worst = max(worst, abs(got - want) / max(abs(want), 1e-6))
        return worst

    if rel_err(hi) <= tol:
        return hi
    good, bad = lo, hi
    for _ in range(max_iters):
        mid = math.sqrt(good * bad)
        if rel_err(mid) <= tol:
            good = mid
        else:
            bad = mid
    return good


def _assemble(cfg: SimCfg, comp: _Compiled, host: Dict[str, np.ndarray],
              carry: dict, n_steps: int, h2d: int) -> VecSimResult:
    """``repro``'s ``_assemble`` over the fetched fields; the delivered
    payloads are gathered into delivery order on the device."""
    st = comp.static
    S0 = comp.n_real_switches
    names = comp.switch_names
    cl_real = comp.arrays["cl_real"]
    n_del = int(host["dlv.n"])
    n_drop = int(host["drp.n"])
    if (bool(host["ovf.tr"]) or bool(host["ovf.ps"]) or bool(host["ovf.ack"])
            or n_del > st.Gc or n_drop > st.Gd):
        raise RuntimeError(
            "vecsim internal buffer overflow (tr=%s ps=%s ack=%s dlv=%d/%d "
            "drp=%d/%d) — ring bound estimate too small for this scenario"
            % (bool(host["ovf.tr"]), bool(host["ovf.ps"]),
               bool(host["ovf.ack"]), n_del, st.Gc, n_drop, st.Gd))

    d_time, d_rcl, d_gen = host["dlv.time"], host["dlv.rcl"], host["dlv.gen"]
    d_wk, d_rw, d_agg = host["dlv.wk"], host["dlv.rw"], host["dlv.agg"]
    d_subs = host["dlv.subs"]
    order = np.argsort(d_time[:n_del], kind="stable")
    deliveries: Dict[int, List[Tuple[float, float]]] = defaultdict(list)
    delivered_updates: List[Update] = []
    agg_counts: List[int] = []
    for i in order:
        rc = int(cl_real[int(d_rcl[i])])
        t = float(d_time[i])
        g = float(d_gen[i])
        deliveries[rc].append((t, g))
        delivered_updates.append(Update(
            cluster_id=rc, worker_id=int(d_wk[i]), gen_time=g,
            reward=float(d_rw[i]), payload=None, agg_count=int(d_agg[i]),
            subsumed=int(d_subs[i])))
        agg_counts.append(int(d_agg[i]))

    max_gen: Dict[int, float] = {}
    for u in delivered_updates:
        max_gen[u.cluster_id] = max(max_gen.get(u.cluster_id, -np.inf),
                                    u.gen_time)
    unrecovered = sum(
        1 for i in range(n_drop)
        if float(host["drp.gen"][i]) > max_gen.get(
            int(cl_real[int(host["drp.rcl"][i])]), -np.inf))

    queue_stats = {
        name: dict(enqueued=int(host["q.next_seq"][s]),
                   dropped=int(host["q.n_dropped"][s]),
                   aggregations=int(host["q.n_agg"][s]),
                   replacements=int(host["q.n_repl"][s]),
                   reward_drops=int(host["rdrops"][s]),
                   departed=int(host["departed"][s]))
        for s, name in enumerate(names)}
    drops_by_switch = {names[s]: int(host["drops_s"][s])
                       for s in range(S0) if int(host["drops_s"][s])}
    reroutes_by_switch = {names[s]: int(host["reroutes_s"][s])
                          for s in range(S0) if int(host["reroutes_s"][s])}
    raw = int(np.sum(d_subs[:n_del]))
    sim = SimResult(
        horizon=cfg.horizon,
        deliveries=dict(deliveries),
        delivered_updates=delivered_updates,
        generated=comp.generated,
        sent=int(host["sent"]),
        deferred=int(host["deferred"]),
        received_at_ps=n_del,
        # netsim's "raw" counter sums subsumed (fresh sends represented)
        raw_updates_delivered=raw,
        queue_stats=queue_stats,
        agg_counts=agg_counts,
        link_dropped=int(host["link_dropped"]),
        raw_link_dropped=int(host["raw_link_dropped"]),
        reroutes=int(host["reroutes"]),
        unrecovered_drops=int(unrecovered),
        drops_by_switch=drops_by_switch,
        reroutes_by_switch=reroutes_by_switch,
        unique_delivered=raw)

    occ = host["q.cluster"][:S0] >= 0
    final_counts = np.where(occ, host["q.agg_count"][:S0], 0)
    residual = {names[s]: int(occ[s].sum()) + int(host["srv.valid"][s])
                for s in range(S0)}
    aom = {comp.cluster_ids[c]: float(host["aom_avg"][c])
           for c in range(len(comp.cluster_ids))}
    dlv = carry["dlv"]
    dev_order = torch.argsort(dlv["time"][:n_del], stable=True)
    return VecSimResult(
        sim=sim, aom=aom, n_steps=n_steps, h2d_transfers=h2d,
        forwarded=int(host["forwarded"]),
        delivery_times=d_time[:n_del][order],
        delivered_payloads=dlv["pay"][:n_del][dev_order],
        final_counts=final_counts, residual=residual)
