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

Over a mesh of devices, :class:`_ShardedRunner` splits the switches over
its "switch" axis and the workers over its "worker" axis (``repro``'s
``_make_runner_sharded``); :func:`run_vecsim`'s ``mesh`` selects it. Its
result is the one-device result, bit for bit.
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
from repro_torch.distributed.sharding import (Mesh, all_gather, device_list,
                                              psum, visible_devices)
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


def _row(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[s, idx[s]]`` for every row ``s``."""
    return x.gather(1, idx.unsqueeze(1)).squeeze(1)


def _init_state(st: _Static, dev, groups: Sequence[str], *, n_rows: int,
                ring: int, n_workers: int, n_clusters: int) -> dict:
    """The initial state: ``repro``'s ``_init_carry``, a dict of tensors on
    ``dev``, in three groups: ``"switch"`` (per-switch state, ``n_rows``
    switches and a transit ring of ``ring`` slots), ``"worker"`` (per
    worker, ``n_workers`` of them, and ``n_clusters`` AoM rows) and
    ``"replicated"`` (the PS and ACK rings, the logs, the counters). The
    delivery (``dlv``) and drop (``drp``) logs carry one scratch row past
    their end (hazard H21); the drop log keeps only what the result reads
    (``repro``'s also logs the drop time and subsumed count)."""
    S, W, Rt = n_rows, n_workers, ring
    C, Q, D, CC = st.C, st.Q, st.D, st.CC
    Rp, Ra, Gc, Gd = st.Rp, st.Ra, st.Gc, st.Gd
    i32, f32, b8 = torch.int32, torch.float32, torch.bool

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    carry = {}
    if "switch" in groups:
        q = TorchQueueState(
            cluster=full((S, Q), -1, i32), worker=full((S, Q), -1, i32),
            seq=full((S, Q), EMPTY_SEQ, i32), gen_time=full((S, Q), 0.0, f32),
            reward=full((S, Q), -math.inf, f32),
            agg_count=full((S, Q), 0, i32),
            replaceable=full((S, Q), False, b8),
            payload=full((S, Q, D), 0.0, f32), next_seq=full((S,), 0, i32),
            n_dropped=full((S,), 0, i32), n_agg=full((S,), 0, i32),
            n_repl=full((S,), 0, i32), n_screened=full((S,), 0, i32))
        carry.update(
            q=q,
            rclq=full((S, Q), -1, i32), subsq=full((S, Q), 0, i32),
            sizeq=full((S, Q), 1.0, f32),
            srv=dict(valid=full((S,), False, b8),
                     rcl=full((S,), -1, i32), wk=full((S,), -1, i32),
                     gen=full((S,), 0.0, f32), rw=full((S,), 0.0, f32),
                     agg=full((S,), 0, i32), subs=full((S,), 0, i32),
                     size=full((S,), 1.0, f32),
                     fin=full((S,), math.inf, f32),
                     rp=full((S,), True, b8),
                     pay=full((S, D), 0.0, f32)),
            free_t=full((S,), 0.0, f32),
            nonempty=full((S,), math.inf, f32),
            last_seen=full((S, C), -math.inf, f32),
            tr=dict(time=full((Rt,), math.inf, f32),
                    sched=full((Rt,), 0.0, f32),
                    sched2=full((Rt,), 0.0, f32), dst=full((Rt,), -1, i32),
                    rcl=full((Rt,), 0, i32), wk=full((Rt,), 0, i32),
                    gen=full((Rt,), 0.0, f32), rw=full((Rt,), 0.0, f32),
                    agg=full((Rt,), 0, i32), subs=full((Rt,), 0, i32),
                    size=full((Rt,), 1.0, f32), rp=full((Rt,), True, b8),
                    pay=full((Rt, D), 0.0, f32)),
            reroutes_s=full((S,), 0, i32), drops_s=full((S,), 0, i32),
            departed=full((S,), 0, i32), rdrops=full((S,), 0, i32),
            fctr=full((S,), 0, i32), lctr=full((S, CC + 1), 0, i32),
            max_active=full((), 0, i32))
    if "worker" in groups:
        aom0 = aom_init(0.0, device=dev)
        carry.update(
            gptr=full((W,), 0, i32),
            aom=TorchAoMState(**{f.name: getattr(aom0, f.name)
                                 .expand(n_clusters).clone()
                                 for f in dataclasses.fields(TorchAoMState)}))
        if st.has_tx:
            carry["tx"] = txctl_init(W, device=dev)
    if "replicated" in groups:
        carry.update(
            ps=dict(time=full((Rp,), math.inf, f32), rcl=full((Rp,), 0, i32),
                    wk=full((Rp,), 0, i32), gen=full((Rp,), 0.0, f32),
                    rw=full((Rp,), 0.0, f32), agg=full((Rp,), 0, i32),
                    subs=full((Rp,), 0, i32), pay=full((Rp, D), 0.0, f32)),
            ack=dict(time=full((Ra,), math.inf, f32), cl=full((Ra,), -1, i32),
                     nact=full((Ra,), 0.0, f32), qmax=full((Ra,), 1.0, f32),
                     gen=full((Ra,), 0.0, f32)),
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
            srow=full((), 0, i32),
            ovf=dict(tr=full((), False, b8), ps=full((), False, b8),
                     ack=full((), False, b8)))
    return carry


# -- the replicated bookkeeping of a boundary, shared by both runners -------
def _log_drops(drp, dropped, fin, rcl, gen, subs, Gd: int):
    """Append this boundary's link drops to the drop log (in place), in
    time order; returns the subsumed count they carried."""
    i32 = torch.int32
    orderd = torch.argsort(torch.where(dropped, fin, math.inf), stable=True)
    posd = torch.argsort(orderd, stable=True)
    widx = drp["n"] + posd
    widx = torch.where(dropped & (widx < Gd), widx, Gd)  # H21
    for k, v in (("rcl", rcl), ("gen", gen)):  # what the result reads
        drp[k].index_copy_(0, widx, v)
    drp["n"] = drp["n"] + dropped.sum(dtype=i32)
    return torch.where(dropped, subs, 0).sum(dtype=i32)


def _deliver(dlv, ps, t, horizon, Gc: int):
    """Append the PS ring's rows due by ``t`` to the delivery log (in
    place), in time order. Returns ``(due, orderp)``: the due mask and the
    ring's time order."""
    due = (ps["time"] <= t) & (ps["time"] <= horizon)
    orderp = torch.argsort(torch.where(due, ps["time"], math.inf),
                           stable=True)
    posp = torch.argsort(orderp, stable=True)
    didx = dlv["n"] + posp
    didx = torch.where(due & (didx < Gc), didx, Gc)  # H21
    for k in ("time", "rcl", "wk", "gen", "rw", "agg", "subs", "pay"):
        dlv[k].index_copy_(0, didx, ps[k])
    dlv["n"] = dlv["n"] + due.sum(dtype=torch.int32)
    return due, orderp


def _aom_block(aom, ts_b, gen_b, due_b, rcl_b, clusters):
    """Fold the drained block, in time order, into the AoM rows of the
    dense cluster ids ``clusters``."""
    for i in range(ts_b.shape[0]):
        aom = aom_update(aom, ts_b[i], gen_b[i], due_b[i] & (rcl_b[i] == clusters))
    return aom


def _feedback(ps_time, last_seen, window):
    """Active clusters per switch at each PS ring row's instant, read
    against the pre-arrival ``last_seen``: (Rp, switches) float32."""
    age = ps_time[:, None, None] - last_seen[None, :, :]
    return (age <= window).sum(dim=2, dtype=torch.int32).to(torch.float32)


def _ack_rows(ps, orderp, nact, slots_f, ack_delay, gen_b, rcl_b):
    """The ACK ring rows of the drained block: the bottleneck switch's
    (first attaining max pressure) feedback at each delivery."""
    pr = nact / slots_f.clamp(min=1.0).unsqueeze(0)
    s_star = torch.argmax(pr, dim=1)
    fb_n = _row(nact, s_star)
    fb_q = slots_f[s_star]
    return dict(time=(ps["time"] + ack_delay)[orderp], cl=rcl_b,
                nact=fb_n[orderp], qmax=fb_q[orderp], gen=gen_b)


def _ack_order(ack, t, horizon):
    """The ACKs due by ``t`` in time order: ``(due_a, (cl, due, time,
    nact, qmax, gen))``, the rows sorted."""
    due_a = (ack["time"] <= t) & (ack["time"] <= horizon)
    ordera = torch.argsort(torch.where(due_a, ack["time"], math.inf),
                           stable=True)
    return due_a, tuple(x[ordera] for x in (
        ack["cl"], due_a, ack["time"], ack["nact"], ack["qmax"], ack["gen"]))


def _ack_fold(tx, w_cluster, rows):
    """``repro``'s ``ack_body`` scan: each sorted ACK row acknowledges its
    cluster's workers among ``w_cluster``."""
    a_cl, a_due, a_t, a_n, a_q, a_g = rows
    for i in range(a_cl.shape[0]):
        acked = (w_cluster == a_cl[i]) & a_due[i]
        tx = txctl_ack(tx, acked, torch.where(a_due[i], a_t[i], 0.0),
                       a_n[i], a_q[i], delivered_gen=a_g[i])
    return tx


def _generate(arrs, gptr0, t, tx, has_tx: bool) -> dict:
    """The workers' next generations due by ``t``, gated by transmission
    control: each worker's time, send/due flags, global rank, reward and
    heap push keys, its advanced pointer and (with txctl) the state after
    the sends."""
    G = arrs["gen_t"].shape[1]
    gidx = gptr0.clamp(0, G - 1).long()
    g_t = _row(arrs["gen_t"], gidx)
    g_due = (gptr0 < arrs["gcount"]) & (g_t <= t) & (g_t <= arrs["horizon"])
    if has_tx:
        p_send = send_probability(tx, g_t, arrs["delta_thr"], arrs["v_slope"])
        g_send = g_due & (_row(arrs["gen_u"], gidx) < p_send)
    else:
        g_send = g_due
    out = dict(g_t=g_t, g_due=g_due, g_send=g_send,
               grank=_row(arrs["gen_rank"], gidx),
               g_rw=_row(arrs["gen_rw"], gidx),
               sch=_row(arrs["gen_sched"], gidx),
               sch2=_row(arrs["gen_sched2"], gidx),
               gptr=gptr0 + g_due.to(torch.int32))
    if has_tx:
        out["tx"] = txctl_send(tx, g_send, g_t, g_t, ack_timeout=math.inf)
    return out


def _send_rows(g_send, g_due, grank, srow, n_rows_tab: int):
    """Payload rows for this boundary's sends, consumed in global send
    order: ``(sent, deferred, row_idx (W,), new srow)``."""
    i32 = torch.int32
    ordw = torch.argsort(torch.where(g_send, grank, int(_BIG_I32)),
                         stable=True)
    posw = torch.argsort(ordw, stable=True)
    row_idx = torch.where(g_send, torch.clamp(srow + posw, max=n_rows_tab),
                          n_rows_tab)
    n = g_send.sum(dtype=i32)
    return n, (g_due & ~g_send).sum(dtype=i32), row_idx, srow + n


class _Runner:
    """The per-boundary step of one compiled scenario on one device.

    ``arrs`` are the staged arrays; ``width`` is how many sorted arrival
    columns the bursts walk (the module docstring). :meth:`step` advances
    the carry by one grid boundary and makes no host round-trip; every
    shape and branch is fixed by ``static``.

    A runner may hold one block of the switches only (a switch shard of
    :class:`_ShardedRunner`): ``n_rows`` rows whose original switch ids
    are ``row * stride + offset`` (the stripe permutation), with a transit
    ring of ``ring`` slots. :meth:`complete` and :meth:`arrive` are the
    step's two per-switch phases over its rows."""

    def __init__(self, static: _Static, arrs: Dict[str, torch.Tensor],
                 width: int, horizon: float, *, n_rows: Optional[int] = None,
                 ring: Optional[int] = None, stride: int = 1,
                 offset: int = 0):
        self.st = st = static
        self.arrs = arrs
        self.horizon = float(horizon)
        self.dev = dev = arrs["cand"].device
        self.S = S = st.S if n_rows is None else int(n_rows)
        self.Rt = Rt = st.Rt if ring is None else int(ring)
        self.A = Rt + st.Wm
        self.U = min(int(width), self.A)
        # FIFO pseudo-clusters advance by the one-device column count on
        # every runner, so a switch block's queues hold the one-device ids
        self.fifo_stride = st.Rt + st.Wm
        self.key2_off = int(st.W * st.G)

        def ar(n):
            return torch.arange(n, device=dev)

        self.aS, self.aA = ar(S), ar(self.A)
        self.aQ, self.aC, self.aCC = ar(st.Q), ar(st.C), ar(st.CC)
        self.gid = self.aS * stride + offset  # original ids of the rows
        self.key2_tr = (self.key2_off + ar(Rt).to(torch.int32)).expand(S, Rt)
        self.ones_sw = torch.ones((S, st.Wm), dtype=torch.int32, device=dev)
        self.true_sw = torch.ones((S, st.Wm), dtype=torch.bool, device=dev)

    def init_carry(self) -> dict:
        """The initial state of every group (:func:`_init_state`)."""
        st = self.st
        return _init_state(st, self.dev, ("switch", "worker", "replicated"),
                           n_rows=self.S, ring=self.Rt, n_workers=st.W,
                           n_clusters=st.C)

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

    # -- the per-switch phases ---------------------------------------------
    def depth(self, carry) -> torch.Tensor:
        """Queue depth of each row's switch, the packet in service
        included (the ``adaptive`` route reads its candidates')."""
        return ((carry["q"].cluster >= 0).sum(dim=1, dtype=torch.int32)
                + carry["srv"]["valid"].to(torch.int32))

    def complete(self, carry: dict, t: torch.Tensor,
                 depth: Optional[torch.Tensor] = None) -> dict:
        """Phase 1 on the rows: the packets in service that finish by
        ``t``, the next hop each takes (route, outage, loss draw) and what
        becomes of it (``eg_del`` to the PS, ``ne_fwd`` to ``sel``,
        ``dropped``). ``depth`` is every switch's :meth:`depth` in original
        order (the ``adaptive`` route); None reads the rows' own, which are
        every switch on one device."""
        st, arrs = self.st, self.arrs
        C, CC, NL = st.C, st.CC, st.NL
        i32, f32 = torch.int32, torch.float32
        inf = math.inf
        srv = carry["srv"]
        fin = srv["fin"]
        done = srv["valid"] & (fin <= t) & (fin <= arrs["horizon"])
        cand_valid = self.aCC.unsqueeze(0) < arrs["ccount"].unsqueeze(1)
        finb = fin[:, None, None]
        down_c = ((arrs["down_t0"][:, :CC, :] <= finb)
                  & (finb < arrs["down_t1"][:, :CC, :])).any(dim=2)
        alive = cand_valid & ~down_c
        eg_down = ((arrs["down_t0"][:, CC, :] <= fin[:, None])
                   & (fin[:, None] < arrs["down_t1"][:, CC, :])).any(dim=1)
        m = alive.sum(dim=1, dtype=i32)
        if st.route == "hash":
            # a switch's own id is its original one, never its row (H25)
            h = route_hash(arrs["cl_real"][srv["rcl"].clamp(0, C - 1).long()],
                           srv["wk"], self.gid)
            kth = h % m.clamp(min=1).to(torch.int64)
            csum = torch.cumsum(alive.to(i32), dim=1, dtype=i32) - 1
            selcol = torch.argmax(((csum == kth.unsqueeze(1)) & alive)
                                  .to(torch.uint8), dim=1)
        elif st.route == "adaptive":
            depth = self.depth(carry) if depth is None else depth
            dsts = arrs["cand"].clamp(0, st.S - 1).long()
            dd = torch.where(alive, depth[dsts].to(f32), inf)
            selcol = torch.argmin(dd, dim=1)
        else:  # static: first alive candidate
            selcol = torch.argmax(alive.to(torch.uint8), dim=1)
        sel = _row(arrs["cand"], selcol)
        is_eg = arrs["is_eg"]
        drawcol = torch.where(is_eg, CC, selcol)
        p = _row(arrs["p_tab"], drawcol)
        ctr = _row(carry["lctr"], drawcol)
        u = arrs["loss_u"][self.aS, drawcol, ctr.clamp(0, NL - 1).long()]
        need_draw = done & (p > 0.0) & torch.where(is_eg, ~eg_down, m > 0)
        lost_draw = need_draw & (u < p)
        lctr = carry["lctr"].scatter_add(1, drawcol.unsqueeze(1),
                                         need_draw.to(i32).unsqueeze(1))
        eg_del = is_eg & done & ~eg_down & ~lost_draw
        ne_fwd = ~is_eg & done & (m > 0) & ~lost_draw
        dropped = done & ~eg_del & ~ne_fwd
        # the completion's heap push time (its service start): decides
        # same-instant ties against arrivals, and is the forwarded
        # arrival's depth-2 tie key
        return dict(fin=fin, done=done, sel=sel, eg_del=eg_del, ne_fwd=ne_fwd,
                    dropped=dropped, reroute=ne_fwd & (sel != arrs["next_hop"]),
                    lctr=lctr, arr_t=fin + arrs["prop"],
                    csched=fin - srv["size"] / arrs["rate"],
                    free_t=torch.where(done, fin, carry["free_t"]),
                    srv=dict(srv, valid=srv["valid"] & ~done,
                             fin=torch.where(done, inf, fin)))

    def arrive(self, carry: dict, t: torch.Tensor, c: dict, tr: dict,
               gen: dict) -> dict:
        """Phase 3's switch side and phase 4 on the rows: the arrivals due
        by ``t`` (the rows' ingress workers' sends and the transit ring's
        rows bound for them) in heap order, the burst before the
        completions (batch A), restart-at-finish, the burst after (batch
        B), then the service starts. ``c`` is :meth:`complete`'s result,
        ``tr`` the ring after this boundary's insertions and ``gen`` the
        worker side over every worker (:func:`_generate`'s fields, the
        payload ``row_idx`` and the tables ``w_cluster``, ``w_id``,
        ``w_size``). Returns the rows' new state."""
        st, arrs = self.st, self.arrs
        S, W, C, Wm, U = self.S, st.W, st.C, st.Wm, self.U
        aS = self.aS
        i32 = torch.int32
        inf = math.inf
        q, srv = carry["q"], c["srv"]
        fin, done, csched, free_t = c["fin"], c["done"], c["csched"], c["free_t"]
        tr_due = (tr["time"] <= t) & (tr["time"] <= arrs["horizon"])
        act_tr = tr_due.unsqueeze(0) & (tr["dst"].unsqueeze(0)
                                        == self.gid.unsqueeze(1))
        sww = arrs["sw_workers"]
        wv = sww.clamp(0, W - 1).long()

        def bcast(x):
            return x.unsqueeze(0).expand(S, x.shape[0])

        def cols(worker_part, ring_part):
            return torch.cat([worker_part, bcast(ring_part)], dim=1)

        act_c = torch.cat([(sww >= 0) & gen["g_send"][wv], act_tr], dim=1)
        time_c = cols(gen["g_t"][wv], tr["time"])
        sch_c = cols(gen["sch"][wv], tr["sched"])
        sch2_c = cols(gen["sch2"][wv], tr["sched2"])
        # a ring row's depth-3 tie key is its one-device ring slot: its
        # column on one device, its ``key2`` in a shard's ring
        key2 = torch.cat([gen["grank"][wv], bcast(tr["key2"]) if "key2" in tr
                          else self.key2_tr], dim=1)
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
        cl_s = gat(gen["w_cluster"][wv], tr["rcl"])
        wk_s = gat(gen["w_id"][wv], tr["wk"])
        gen_s = gat(gen["g_t"][wv], tr["gen"])
        rw_s = gat(gen["g_rw"][wv], tr["rw"])
        agg_s = gat(self.ones_sw, tr["agg"])
        subs_s = gat(self.ones_sw, tr["subs"])
        size_s = gat(gen["w_size"][wv], tr["size"])
        irp_s = gat(self.true_sw, tr["rp"])
        # payload rows of the walked columns only: a worker column reads
        # its row of the staged table, a transit column its ring row
        is_w = ordU < Wm
        w_row = gen["row_idx"][wv.gather(1, ordU.clamp(max=Wm - 1))]
        pay_s = torch.where(is_w.unsqueeze(2), arrs["rows"][w_row],
                            tr["pay"][(ordU - Wm).clamp(min=0)])
        # FIFO: a unique pseudo-cluster per arrival reduces Algorithm 1 to
        # a tail-drop append
        eff_cl = torch.where(
            arrs["is_fifo"].unsqueeze(1),
            C + carry["fctr"].unsqueeze(1) + self.aA[:U].to(i32).unsqueeze(0),
            cl_s)
        fctr = carry["fctr"] + self.fifo_stride

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

        size_f = _row(size_s, fidx)
        srv = dict(
            valid=srv["valid"] | startA,
            rcl=sel(_row(cl_s, fidx), srv["rcl"]),
            wk=sel(_row(wk_s, fidx), srv["wk"]),
            gen=sel(_row(gen_s, fidx), srv["gen"]),
            rw=sel(_row(rw_s, fidx), srv["rw"]),
            agg=sel(_row(agg_s, fidx), srv["agg"]),
            subs=sel(_row(subs_s, fidx), srv["subs"]),
            size=sel(size_f, srv["size"]),
            fin=sel(torch.maximum(free_t, _row(time_s, fidx))
                    + size_f / arrs["rate"], srv["fin"]),
            rp=sel(_row(irp_s, fidx), srv["rp"]),
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
        nonempty = torch.where((pre_cnt == 0) & torch.isfinite(first_app),
                               first_app, nonemptyA)
        ls_upd = torch.where(
            act_s.unsqueeze(2) & (cl_s.unsqueeze(2) == self.aC.view(1, 1, C)),
            time_s.unsqueeze(2), -inf).amax(dim=1)

        # ======== phase 4: service starts ================================
        qf, subsq, rclq, sizeq, srv = self._try_start(
            q, subsq, rclq, sizeq, srv, free_t, nonempty)
        return dict(
            q=qf, rclq=rclq, subsq=subsq, sizeq=sizeq, srv=srv, free_t=free_t,
            nonempty=nonempty,
            last_seen=torch.maximum(carry["last_seen"], ls_upd),
            tr=dict(tr, time=torch.where(tr_due, inf, tr["time"])),
            reroutes_s=carry["reroutes_s"] + c["reroute"].to(i32),
            drops_s=carry["drops_s"] + c["dropped"].to(i32),
            departed=carry["departed"] + done.to(i32),
            rdrops=carry["rdrops"] + rdropA + rdrop, fctr=fctr,
            lctr=c["lctr"], max_active=max_active)

    # -- one grid boundary -------------------------------------------------
    def step(self, carry: dict, t: torch.Tensor) -> dict:
        """Advance ``carry`` to the boundary ``t`` (a 0-dim float32 tensor
        on the device): ``repro``'s scan body, phase for phase."""
        st, arrs = self.st, self.arrs
        i32 = torch.int32
        inf = math.inf
        horizon = arrs["horizon"]
        srv = carry["srv"]  # the rows leaving keep these fields

        # ======== phase 1: service completions ===========================
        c = self.complete(carry, t)
        drp = carry["drp"]
        raw_drop_add = _log_drops(drp, c["dropped"], c["fin"], srv["rcl"],
                                  srv["gen"], srv["subs"], st.Gd)
        ovf = carry["ovf"]
        ps, ovf_ps, _ = _ring_insert_vec(
            carry["ps"], ovf["ps"], c["eg_del"],
            dict(time=c["arr_t"], rcl=srv["rcl"], wk=srv["wk"],
                 gen=srv["gen"], rw=srv["rw"], agg=srv["agg"],
                 subs=srv["subs"], pay=srv["pay"]))
        tr, ovf_tr, _ = _ring_insert_vec(
            carry["tr"], ovf["tr"], c["ne_fwd"],
            dict(time=c["arr_t"], sched=c["fin"], sched2=c["csched"],
                 dst=c["sel"], rcl=srv["rcl"], wk=srv["wk"], gen=srv["gen"],
                 rw=srv["rw"], agg=srv["agg"], subs=srv["subs"],
                 size=srv["size"], rp=srv["rp"], pay=srv["pay"]))

        # ======== phase 2: PS deliveries + ACKs ==========================
        dlv = carry["dlv"]
        due, orderp = _deliver(dlv, ps, t, horizon, st.Gc)
        ts_b, gen_b = ps["time"][orderp], ps["gen"][orderp]
        due_b, rcl_b = due[orderp], ps["rcl"][orderp]
        aom = _aom_block(carry["aom"], ts_b, gen_b, due_b, rcl_b, self.aC)
        ack, ovf_ack = carry["ack"], ovf["ack"]
        if st.has_tx:
            nact = _feedback(ps["time"], carry["last_seen"],
                             arrs["active_window"])
            ack, ovf_ack, _ = _ring_insert_vec(
                ack, ovf_ack, due_b,
                _ack_rows(ps, orderp, nact, arrs["slots_f"],
                          arrs["ack_delay"], gen_b, rcl_b))
        ps = dict(ps, time=torch.where(due, inf, ps["time"]))
        tx = carry.get("tx")
        if st.has_tx:
            due_a, rows = _ack_order(ack, t, horizon)
            tx = _ack_fold(tx, arrs["w_cluster"], rows)
            ack = dict(ack, time=torch.where(due_a, inf, ack["time"]))

        # ======== phase 3: arrivals (transit + gated generations) ========
        g = _generate(arrs, carry["gptr"], t, tx, st.has_tx)
        sent, deferred, row_idx, srow = _send_rows(
            g["g_send"], g["g_due"], g["grank"], carry["srow"],
            arrs["rows"].shape[0] - 1)
        new_sw = self.arrive(carry, t, c, tr, dict(
            g, row_idx=row_idx, w_cluster=arrs["w_cluster"],
            w_id=arrs["w_id"], w_size=arrs["w_size"]))
        new = dict(
            carry, **new_sw, ps=ps, ack=ack, aom=aom, dlv=dlv, drp=drp,
            sent=carry["sent"] + sent, deferred=carry["deferred"] + deferred,
            link_dropped=carry["link_dropped"] + c["dropped"].sum(dtype=i32),
            raw_link_dropped=carry["raw_link_dropped"] + raw_drop_add,
            reroutes=carry["reroutes"] + c["reroute"].sum(dtype=i32),
            forwarded=carry["forwarded"] + c["ne_fwd"].sum(dtype=i32),
            gptr=g["gptr"], srow=srow,
            ovf=dict(tr=ovf_tr, ps=ovf_ps, ack=ovf_ack))
        if st.has_tx:
            new["tx"] = g["tx"]
        return new

    def run(self, carry: dict, ts: torch.Tensor) -> dict:
        """One :meth:`step` per boundary of ``ts`` (float32 on the device),
        then the per-cluster time-average AoM (``aom_avg``). No host
        round-trip. The loop runs under ``torch.inference_mode`` (no
        autograd bookkeeping per op), so the carry returned holds inference
        tensors: read, copy or step them, but do not update them in place
        outside the mode (H27)."""
        with torch.inference_mode():
            for k in range(ts.shape[0]):
                carry = self.step(carry, ts[k])
            carry["aom_avg"] = aom_average(carry["aom"], self.horizon)
        return carry


# ---------------------------------------------------------------------------
# The sharded step: per-switch state over the "switch" axis of a mesh,
# workers / txctl / AoM over its "worker" axis
# ---------------------------------------------------------------------------
# staged-array axes: leading switch axis (sharded, stripe-permuted), leading
# worker axis (sharded contiguously), everything else replicated
_SWITCH_AXIS_KEYS = ("cand", "ccount", "next_hop", "is_eg", "is_fifo",
                     "slots", "slots_f", "rate", "prop", "rthr", "p_tab",
                     "down_t0", "down_t1", "loss_u", "sw_workers")
_WORKER_AXIS_KEYS = ("gen_t", "gen_sched", "gen_sched2", "gen_rank", "gen_u",
                     "gen_rw", "gcount", "w_cluster", "w_id", "w_size")
# the carry's per-switch and per-worker groups (the rest is replicated)
_SWITCH_STATE = ("q", "rclq", "subsq", "sizeq", "srv", "free_t", "nonempty",
                 "last_seen", "reroutes_s", "drops_s", "departed", "rdrops",
                 "fctr", "lctr")
_WORKER_STATE = ("gptr", "tx", "aom")


def _stripe_perm(S: int, ns: int) -> np.ndarray:
    """Stripe permutation: shard ``d`` holds original switches ``d, d+ns,
    d+2*ns, ...`` so a fat-tree's contiguous edge / agg / core layers
    spread evenly over the shards. ``perm[d*S_loc + i] = i*ns + d`` maps
    shard-major position to original switch id."""
    return (np.arange(S // ns)[None, :] * ns
            + np.arange(ns)[:, None]).reshape(S)


def _unstripe(x: torch.Tensor, ns: int, dim: int) -> torch.Tensor:
    """A shard-major gathered switch axis ``dim`` put back in original
    switch order (the stripe permutation's inverse: a reshape and a
    transpose)."""
    if ns == 1:
        return x
    shape = x.shape
    S = shape[dim]
    return x.reshape(shape[:dim] + (ns, S // ns) + shape[dim + 1:]) \
        .transpose(dim, dim + 1).reshape(shape)


def _tree_map(fn, *trees):
    """``fn`` over the tensor leaves of matching dicts / dataclasses."""
    x = trees[0]
    if x is None:
        return None
    if isinstance(x, dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in x}
    if dataclasses.is_dataclass(x):
        return type(x)(**{f.name: _tree_map(fn, *(getattr(t, f.name)
                                                  for t in trees))
                          for f in dataclasses.fields(x)})
    return fn(*trees)


class _ShardedRunner:
    """The sharded step over an ``(ns, nw)`` ("switch", "worker") mesh of
    devices: ``repro``'s ``_make_runner_sharded`` (its ``shard_map`` body),
    one grid boundary per :meth:`step`, bitwise the one-device runner.

    * Switch ``s`` lives on switch shard ``s % ns`` (the stripe
      permutation, ``_stripe_perm``), as row ``s // ns``: its queues,
      service register, loss counters and ``last_seen``, each shard a
      :class:`_Runner` over its rows that steps :meth:`_Runner.complete`
      and :meth:`_Runner.arrive` on its device. Per boundary only the
      forwarding frontier (at most one completed packet per switch) is
      gathered, in original switch order.
    * Workers split contiguously over ``nw`` worker shards: generation
      pointers, txctl state and AoM rows. Their per-boundary gather is
      four float32 and three int32 rows of width W.
    * A transit row lands in its destination shard's local ring (``ring``
      slots), so each shard sorts ``ring + Wm`` arrival columns, not ``Rt
      + Wm``. A replicated ghost ring of arrival times replays the one
      device ring's first-free slot assignment; each row carries its ghost
      slot as ``key2``, the depth-3 tie key, so every sort matches the one
      device run. A row that does not fit its local ring sets ``trl``
      (the result is then discarded and the run repeated with a wider
      ring, :func:`run_vecsim`); it is never dropped silently.

    ``repro`` computes each switch block on every device of its mesh row,
    each worker block on every device of its column, and the replicated
    bookkeeping (PS and ACK rings, the delivery and drop logs, the
    counters, the ghost ring) on every device. Those replicas compute the
    same function of the same inputs, so here each is computed once per
    boundary: a switch block on its row's first device, a worker block on
    its column's first, the bookkeeping on the mesh's first (``home``),
    and a result is copied to each device that reads it (no copy at all
    where that is the same device: the readers never write it). Each
    ``lax.all_gather``/``lax.psum`` becomes
    :func:`~repro_torch.distributed.sharding.all_gather`/``psum``, which
    always make fresh tensors. The carry is ``dict(sw=[...], wk=[...],
    rep={...})``: one dict per switch shard, per worker shard, and the
    replicated state."""

    def __init__(self, static: _Static, arrs: Dict[str, torch.Tensor],
                 devices: np.ndarray, width: int, horizon: float, ring: int):
        self.st = st = static
        ns, nw = devices.shape
        self.ns, self.nw, self.ring = ns, nw, int(ring)
        self.home = home = devices[0, 0]
        self.horizon = float(horizon)
        self.key2_off = int(st.W * st.G)
        S_loc, W_loc, C_loc = st.S // ns, st.W // nw, st.C // nw
        rep = [k for k in arrs
               if k not in _SWITCH_AXIS_KEYS and k not in _WORKER_AXIS_KEYS]
        self.arrs = {k: arrs[k] for k in rep}
        # the feedback reads every switch's slot count in original order
        self.slots_f = _unstripe(arrs["slots_f"], ns, 0)
        self.shards = []
        for si in range(ns):
            d = devices[si, 0]
            a = {k: arrs[k][si * S_loc:(si + 1) * S_loc].to(d)
                 for k in _SWITCH_AXIS_KEYS}
            # repro gathers the worker tables once; here they are whole
            a.update({k: arrs[k].to(d) for k in rep + ["w_cluster", "w_id",
                                                         "w_size"]})
            self.shards.append(_Runner(st, a, width, horizon, n_rows=S_loc,
                                       ring=ring, stride=ns, offset=si))
        self.U = self.shards[0].U
        self.workers = []  # (device, arrays, dense cluster ids of its AoM rows)
        for wi in range(nw):
            d = devices[0, wi]
            a = {k: arrs[k][wi * W_loc:(wi + 1) * W_loc].to(d)
                 for k in _WORKER_AXIS_KEYS}
            a.update({k: arrs[k].to(d) for k in ("horizon", "delta_thr",
                                                 "v_slope")})
            self.workers.append((d, a, torch.arange(
                wi * C_loc, (wi + 1) * C_loc, device=d)))
        self.devices = sorted({home, *(s.dev for s in self.shards),
                               *(w[0] for w in self.workers)}, key=str)
        self._W_loc, self._C_loc = W_loc, C_loc

    def init_carry(self) -> dict:
        st, i32 = self.st, torch.int32
        sw = []
        for s in self.shards:
            c = _init_state(st, s.dev, ("switch",), n_rows=s.S, ring=s.Rt,
                            n_workers=0, n_clusters=0)
            c["tr"]["key2"] = torch.zeros((s.Rt,), dtype=i32, device=s.dev)
            c["trl"] = torch.zeros((), dtype=torch.bool, device=s.dev)
            sw.append(c)
        wk = [_init_state(st, d, ("worker",), n_rows=0, ring=0,
                          n_workers=self._W_loc, n_clusters=self._C_loc)
              for d, _, _ in self.workers]
        rep = _init_state(st, self.home, ("replicated",), n_rows=0, ring=0,
                          n_workers=0, n_clusters=0)
        rep["ghost"] = torch.full((st.Rt,), math.inf, dtype=torch.float32,
                                  device=self.home)
        return dict(sw=sw, wk=wk, rep=rep)

    def _gather_sw(self, parts, dim: int) -> torch.Tensor:
        """A gather over "switch", on ``home``, in original switch order."""
        return _unstripe(all_gather(parts, dim, device=self.home), self.ns,
                         dim)

    def _gather_wk(self, parts, dim: int) -> torch.Tensor:
        return all_gather(parts, dim, device=self.home)

    def step(self, carry: dict, t: torch.Tensor) -> dict:
        """Advance ``carry`` to the boundary ``t`` (0-dim float32 on
        ``home``): ``repro``'s sharded scan body, phase for phase, each
        shard's part run in turn. No host round-trip."""
        st, arrs = self.st, self.arrs
        ns, home = self.ns, self.home
        i32 = torch.int32
        inf = math.inf
        horizon = arrs["horizon"]
        sw, wk, rep = carry["sw"], carry["wk"], carry["rep"]
        t_at = {d: t.to(d) for d in self.devices}

        # ======== phase 1: service completions, each switch shard ========
        depth = None
        if st.route == "adaptive":
            depth = self._gather_sw([s.depth(x) for s, x in
                                     zip(self.shards, sw)], 0)
        comp = [s.complete(x, t_at[s.dev],
                           None if depth is None else depth.to(s.dev))
                for s, x in zip(self.shards, sw)]
        # -- the forwarding frontier, gathered in original switch order so
        # every replicated decision below is the one device's
        fr_f = self._gather_sw([torch.stack(
            [c["arr_t"], c["fin"], c["csched"], x["srv"]["gen"],
             x["srv"]["rw"], x["srv"]["size"]]) for c, x in zip(comp, sw)], 1)
        fr_i = self._gather_sw([torch.stack(
            [c["sel"], x["srv"]["rcl"], x["srv"]["wk"], x["srv"]["agg"],
             x["srv"]["subs"]]) for c, x in zip(comp, sw)], 1)
        fr_b = self._gather_sw([torch.stack(
            [c["eg_del"], c["ne_fwd"], c["dropped"], c["reroute"],
             x["srv"]["rp"]]) for c, x in zip(comp, sw)], 1)
        pay_g = self._gather_sw([x["srv"]["pay"] for x in sw], 0)
        time_g, fin_g, csched_g, gen_g, rw_g, size_g = fr_f
        sel_g, rcl_g, wk_g, agg_g, subs_g = fr_i
        egdel_g, nefwd_g, drop_g, rrt_g, rp_g = fr_b

        drp = rep["drp"]
        raw_drop_add = _log_drops(drp, drop_g, fin_g, rcl_g, gen_g, subs_g,
                                  st.Gd)
        ovf = rep["ovf"]
        ps, ovf_ps, _ = _ring_insert_vec(
            rep["ps"], ovf["ps"], egdel_g,
            dict(time=time_g, rcl=rcl_g, wk=wk_g, gen=gen_g, rw=rw_g,
                 agg=agg_g, subs=subs_g, pay=pay_g))
        # ghost transit ring: the one-device ring's times and slots; the
        # slot a row takes is its key2 in whichever ring it lands
        ghost, ovf_tr, slot_g = _ring_insert_vec(
            dict(time=rep["ghost"]), ovf["tr"], nefwd_g, dict(time=time_g))
        mine_g = torch.where(nefwd_g, sel_g % ns, -1)  # destination shard
        key2_g = self.key2_off + slot_g.to(i32)
        rings = []
        for si, (s, x) in enumerate(zip(self.shards, sw)):
            d = s.dev
            f, i_, k2 = fr_f.to(d), fr_i.to(d), key2_g.to(d)
            rows = dict(time=f[0], sched=f[1], sched2=f[2], dst=i_[0],
                        rcl=i_[1], wk=i_[2], gen=f[3], rw=f[4], agg=i_[3],
                        subs=i_[4], size=f[5], rp=fr_b[4].to(d), key2=k2,
                        pay=pay_g.to(d))
            rings.append(_ring_insert_vec(x["tr"], x["trl"],
                                          mine_g.to(d) == si, rows)[:2])

        # ======== phase 2: PS deliveries (replicated), AoM per worker shard
        dlv = rep["dlv"]
        due, orderp = _deliver(dlv, ps, t, horizon, st.Gc)
        ts_b, gen_b = ps["time"][orderp], ps["gen"][orderp]
        due_b, rcl_b = due[orderp], ps["rcl"][orderp]
        aoms = [_aom_block(x["aom"], ts_b.to(d), gen_b.to(d), due_b.to(d),
                           rcl_b.to(d), cl)
                for (d, _, cl), x in zip(self.workers, wk)]
        ack, ovf_ack = rep["ack"], ovf["ack"]
        if st.has_tx:
            nact = self._gather_sw([_feedback(
                ps["time"].to(s.dev), x["last_seen"],
                s.arrs["active_window"]) for s, x in zip(self.shards, sw)], 1)
            ack, ovf_ack, _ = _ring_insert_vec(
                ack, ovf_ack, due_b,
                _ack_rows(ps, orderp, nact, self.slots_f, arrs["ack_delay"],
                          gen_b, rcl_b))
        ps = dict(ps, time=torch.where(due, inf, ps["time"]))
        txs = [x.get("tx") for x in wk]
        if st.has_tx:
            due_a, arows = _ack_order(ack, t, horizon)
            txs = [_ack_fold(tx, a["w_cluster"], [r.to(d) for r in arows])
                   for (d, a, _), tx in zip(self.workers, txs)]
            ack = dict(ack, time=torch.where(due_a, inf, ack["time"]))

        # ======== phase 3: arrivals ======================================
        # worker side: each worker shard gates its generations, then one
        # gather of the frontier rows (never the (W, G) tables)
        gens = [_generate(a, x["gptr"], t_at[d], tx, st.has_tx)
                for (d, a, _), x, tx in zip(self.workers, wk, txs)]
        wk_f32 = self._gather_wk([torch.stack(
            [g["g_t"], g["g_rw"], g["sch"], g["sch2"]]) for g in gens], 1)
        wk_i32 = self._gather_wk([torch.stack(
            [g["g_send"].to(i32), g["g_due"].to(i32), g["grank"]])
            for g in gens], 1)
        g_send_f, g_due_f = wk_i32[0].bool(), wk_i32[1].bool()
        sent, deferred, row_idx, srow = _send_rows(
            g_send_f, g_due_f, wk_i32[2], rep["srow"],
            arrs["rows"].shape[0] - 1)
        # switch side: each shard's local ring and ingress rows
        new_sw = []
        for s, x, c, (tr, trl) in zip(self.shards, sw, comp, rings):
            d = s.dev
            f, i_ = wk_f32.to(d), wk_i32.to(d)
            gen = dict(g_t=f[0], g_rw=f[1], sch=f[2], sch2=f[3],
                       g_send=g_send_f.to(d), grank=i_[2],
                       row_idx=row_idx.to(d), w_cluster=s.arrs["w_cluster"],
                       w_id=s.arrs["w_id"], w_size=s.arrs["w_size"])
            new_sw.append(dict(s.arrive(x, t_at[d], c, tr, gen), trl=trl))
        # the ghost ring frees the rows the local rings free: the one-device
        # clear condition on the mirrored times
        gh = ghost["time"]
        gh = torch.where((gh <= t) & (gh <= horizon), inf, gh)
        new_wk = []
        for x, g, aom in zip(wk, gens, aoms):
            new_wk.append(dict(x, gptr=g["gptr"], aom=aom))
            if st.has_tx:
                new_wk[-1]["tx"] = g["tx"]
        new_rep = dict(
            rep, ps=ps, ack=ack, dlv=dlv, drp=drp, ghost=gh,
            sent=rep["sent"] + sent, deferred=rep["deferred"] + deferred,
            link_dropped=rep["link_dropped"] + drop_g.sum(dtype=i32),
            raw_link_dropped=rep["raw_link_dropped"] + raw_drop_add,
            reroutes=rep["reroutes"] + rrt_g.sum(dtype=i32),
            forwarded=rep["forwarded"] + nefwd_g.sum(dtype=i32), srow=srow,
            ovf=dict(tr=ovf_tr, ps=ovf_ps, ack=ovf_ack))
        return dict(sw=new_sw, wk=new_wk, rep=new_rep)

    def run(self, carry: dict, ts: torch.Tensor) -> dict:
        """One :meth:`step` per boundary of ``ts`` (float32 on ``home``).
        No host round-trip; under ``torch.inference_mode``, as
        :meth:`_Runner.run` (H27)."""
        with torch.inference_mode():
            for k in range(ts.shape[0]):
                carry = self.step(carry, ts[k])
        return carry

    def gather(self, carry: dict) -> dict:
        """The carry in the one-device runner's layout on ``home``: the
        switch blocks gathered in original switch order, the worker blocks
        gathered, ``max_active`` the largest over the shards, ``ovf.trl``
        whether any local ring overflowed (an exact int32 ``psum``), and
        ``aom_avg``. The transit ring is not gathered (the local rings lay
        its rows out otherwise; ``rep["ghost"]`` holds its times). Fresh
        tensors throughout: later steps of ``carry`` cannot reach them."""
        sw, wk, rep = carry["sw"], carry["wk"], carry["rep"]
        with torch.no_grad():
            out = dict(rep)
            for key in _SWITCH_STATE:
                out[key] = _tree_map(lambda *p: self._gather_sw(p, 0),
                                     *(x[key] for x in sw))
            for key in _WORKER_STATE:
                if key in wk[0]:
                    out[key] = _tree_map(lambda *p: self._gather_wk(p, 0),
                                         *(x[key] for x in wk))
            out["max_active"] = torch.stack(
                [x["max_active"].to(self.home) for x in sw]).max()
            out["ovf"] = dict(rep["ovf"], trl=psum(
                [x["trl"] for x in sw], device=self.home) > 0)
            out["aom_avg"] = aom_average(out["aom"], self.horizon)
        return out


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
    passes: int = 1                  # runs made (> 1: the width or ring grew)
    ring: int = 0                    # a shard's transit-ring slots (sharded)


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


def _fetch(carry: dict, keys: Sequence[str] = _FETCH
           ) -> Dict[str, np.ndarray]:
    """The carry's result fields (``keys``) in ONE device-to-host copy:
    their bytes packed into one buffer on the device."""
    ts = [_lookup(carry, k).contiguous().reshape(-1) for k in keys]
    buf = torch.cat([t.view(torch.uint8) for t in ts]).cpu().numpy()
    out, off = {}, 0
    for key, t in zip(keys, ts):
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
    never depends on it.

    ``mesh`` selects the sharded runner (:class:`_ShardedRunner`): an int
    (switch shards), an ``(switch_shards, worker_shards)`` tuple, or a
    :class:`~repro_torch.distributed.sharding.Mesh` with a "switch" (and
    optionally "worker") axis, e.g. ``distributed.sharding.vecsim_mesh()``.
    A mesh object brings its devices; an int or tuple takes the first of
    ``device`` when it is a list (which may repeat a device), else of the
    visible devices of its type (every card for ``"cuda"``, the one CPU
    for ``"cpu"``), and raises ``ValueError`` when they are too few, as
    ``repro`` does. The results gather on the mesh's first device. The
    sharded run is bitwise the one-device run. ``rt_loc`` overrides a
    shard's transit-ring width (ignored without a mesh, as in ``repro``);
    when a local ring overflows, the run is repeated with it doubled (at
    most ``Rt``), in the same loop as the width's, so neither changes the
    result."""
    devs = None if mesh is None else _mesh_devices(mesh, device)
    dev = resolve_device(device) if devs is None else devs[0, 0]
    comp = compile_scenario(cfg, dim=dim, payload_rows=payload_rows,
                            gen_rewards=gen_rewards, pad_pow2=pad_pow2)
    if grid is None:
        if dt is not None:
            grid = uniform_grid(cfg, dt, allow_coarse=allow_coarse,
                                bucket=grid_bucket)
        else:
            grid, _ = oracle_event_times(cfg, bucket=grid_bucket)
    st = comp.static
    width = default_width(st) if width is None else int(width)
    horizon = float(comp.arrays["horizon"])
    keys = _FETCH
    if devs is not None:
        ns, nw = devs.shape
        if st.S % ns or st.W % nw or st.C % nw:
            raise ValueError(
                f"padded dims (S={st.S}, W={st.W}, C={st.C}) are not "
                f"divisible by the mesh ({ns} switch x {nw} worker shards)")
        perm = _stripe_perm(st.S, ns)
        arrays = dict(comp.arrays)
        for k in _SWITCH_AXIS_KEYS:
            arrays[k] = comp.arrays[k][perm]
        ring = _default_ring(comp, ns) if rt_loc is None else int(rt_loc)
        keys = _FETCH + ("ovf.trl",)
    else:
        arrays, ring = comp.arrays, 0
    ts = torch.from_numpy(np.asarray(grid, np.float32)).to(dev)
    arrs = _stage(arrays, dev)
    passes = 0
    while True:
        if devs is None:
            runner = _Runner(st, arrs, width, horizon)
            carry = runner.run(runner.init_carry(), ts)
        else:
            runner = _ShardedRunner(st, arrs, devs, width, horizon, ring)
            carry = runner.gather(runner.run(runner.init_carry(), ts))
        host = _fetch(carry, keys)
        passes += 1
        need = int(host["max_active"])
        grow_ring = devs is not None and bool(host["ovf.trl"]) \
            and ring < st.Rt
        if need <= runner.U and not grow_ring:
            break
        if need > runner.U:
            width = _pow2(need)
        if grow_ring:
            ring = min(st.Rt, ring * 2)
    res = _assemble(cfg, comp, host, carry, len(ts), len(arrs) + 1)
    res.width, res.passes, res.ring = runner.U, passes, ring
    return res


def _mesh_shape(mesh) -> Tuple[int, int]:
    """Normalize a mesh request to ``(switch_shards, worker_shards)``: an
    int (switch shards only), a 2-tuple, or a mesh whose axis sizes are
    read by name ("switch" required, "worker" optional;
    ``distributed.sharding.switch_mesh`` qualifies)."""
    if isinstance(mesh, int):
        return mesh, 1
    if isinstance(mesh, tuple):
        ns, nw = mesh
        return int(ns), int(nw)
    sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    if "switch" not in sizes:
        raise ValueError(f"mesh {mesh} has no 'switch' axis")
    return int(sizes["switch"]), int(sizes.get("worker", 1))


def _mesh_devices(mesh, device) -> np.ndarray:
    """The ``(switch_shards, worker_shards)`` array of devices a mesh
    request runs on (see :func:`run_vecsim`)."""
    ns, nw = _mesh_shape(mesh)
    if isinstance(mesh, Mesh):
        if mesh.axis_names not in (("switch",), ("switch", "worker")):
            raise ValueError(f"mesh {mesh}: the axes must be ('switch',) or "
                             f"('switch', 'worker')")
        devs = mesh.device_list()
    elif isinstance(device, (list, tuple)):
        devs = device_list(device)
    else:
        dev = resolve_device(device)
        devs = visible_devices() if dev.type == "cuda" else [dev]
    if ns < 1 or nw < 1 or ns * nw > len(devs):
        raise ValueError(
            f"mesh ({ns} switch x {nw} worker shards) needs {ns * nw} "
            f"devices, only {len(devs)} available")
    arr = np.empty(ns * nw, dtype=object)
    arr[:] = devs[:ns * nw]
    return arr.reshape(ns, nw)


def _default_ring(comp: _Compiled, ns: int) -> int:
    """The destination-aware local-ring bound: a source's in-flight rows
    can land in shard ``d``'s ring only if one of its candidates lives
    there (original switch ``v`` is on shard ``v % ns``). Skew beyond the
    bound overflows a local ring, which the run reports and
    :func:`run_vecsim` repeats doubled, at most ``Rt`` (a subset of the
    destinations never holds more rows than the whole ring)."""
    st = comp.static
    cand, cnt = comp.arrays["cand"], comp.arrays["ccount"]
    inflow = np.zeros(ns, np.int64)
    for u in range(st.S):
        if comp.wire[u] > 0:
            for d in {int(c) % ns for c in cand[u, :int(cnt[u])] if c >= 0}:
                inflow[d] += int(comp.wire[u])
    return min(st.Rt, _pow2(max(int(inflow.max()), 2)))


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
            or bool(host.get("ovf.trl", False))
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
