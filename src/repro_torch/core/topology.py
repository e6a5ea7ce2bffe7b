"""Declarative switch-topology specification for the OLAF data plane.

The paper's evaluation (§8.3) hard-codes one SW1/SW2→SW3 fan-in; this
module turns the topology into *data*. A :class:`TopologySpec` describes an
arbitrary switch DAG — each switch forwards to an ordered *candidate set*
of next hops (one candidate = the historic fan-in-tree case; several =
a multi-path fabric, e.g. a fat-tree with multiple spines) — and compiles
it ONCE into static arrays the rest of the stack consumes:

  * ``next_hop``      — ``(S,)`` int32 primary next-hop vector (−1 = PS
                        egress); ``candidates`` holds the full per-switch
                        candidate tuple and ``select_hop`` applies the
                        spec's ``route_policy`` ("static" | "hash" |
                        "adaptive") over the live subset. The simulator
                        records every routing decision in the queue-event
                        trace, so the hybrid replay paths cannot diverge;
  * ``adjacency``     — ``(S, S)`` bool, ``adjacency[u, v]`` iff ``u``
                        feeds ``v`` (one-hot rows of ``next_hop``);
  * ``reachability``  — ``(S, S)`` bool transitive closure:
                        ``reachability[u, v]`` iff ``v`` lies on ``u``'s
                        downstream path to its PS;
  * ``queue_slots`` / ``rate_bps`` / ``prop_delay`` — per-switch slot,
                        serialization-rate and propagation-delay vectors;
  * ``topo_order``    — upstream-first topological drain order;
  * ``upstreams``     — per switch, its upstream frontier (the switches
                        whose next hop it is). ``flush_set(name)`` =
                        the switch plus that frontier, the per-switch
                        flush cadence of the hybrid window cursor.

:func:`build_sim_cfg` spreads worker clusters over the spec's source
switches and emits the :class:`~repro_torch.core.netsim.SimCfg` wiring
(``SwitchCfg``/``Link``) so every preset is a one-liner:
``chain_cfg(6)``, ``fanin_cfg(4)``, ``fattree_cfg(2)``, ``multirack_cfg()``,
``multips_cfg()`` — and ``repro_torch.core.netsim.multihop_cfg`` builds its
SW1/SW2/SW3 wiring from :func:`multihop_spec` too.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.netsim import Link, SimCfg, SwitchCfg, WorkerCfg


@dataclasses.dataclass(frozen=True)
class SwitchSpec:
    """One switch of the DAG: a queue plus a serialized uplink.

    ``next_hop`` names the single (primary) next hop; ``next_hops`` widens
    it to an ordered *candidate set* for multi-path fabrics — the first
    candidate (or ``next_hop``, which must then be a member) is the primary
    and the rest are alternates a route policy may pick, e.g. to steer
    around a failed link. Leaving both unset makes the switch a PS egress.
    """

    name: str
    next_hop: Optional[str] = None  # switch name, or None => PS egress
    queue_slots: int = 8
    rate_gbps: float = 10.0  # uplink serialization capacity
    prop_delay: float = 1e-6  # uplink propagation delay
    queue: str = "olaf"  # "olaf" | "fifo"
    reward_threshold: Optional[float] = None
    next_hops: Optional[Tuple[str, ...]] = None  # multi-path candidates


_UNSET = object()

ROUTE_POLICIES = ("static", "hash", "adaptive")


class TopologySpec:
    """A compiled switch DAG (see module docstring for the array surface)."""

    def __init__(self, switches: Sequence[SwitchSpec], *,
                 route_policy: str = "static") -> None:
        if route_policy not in ROUTE_POLICIES:
            raise ValueError(f"route_policy must be one of {ROUTE_POLICIES},"
                             f" got {route_policy!r}")
        self.route_policy = route_policy
        self.switches: Tuple[SwitchSpec, ...] = tuple(switches)
        self.names: List[str] = [s.name for s in self.switches]
        if len(set(self.names)) != len(self.names):
            raise ValueError(f"duplicate switch names: {self.names}")
        self.index: Dict[str, int] = {n: i for i, n in enumerate(self.names)}
        S = len(self.switches)
        self.num_switches = S
        # candidate next-hop sets: primary first, alternates after. A bare
        # next_hop is a one-candidate set; an egress switch has none.
        cand: List[Tuple[int, ...]] = []
        for i, s in enumerate(self.switches):
            hops: Tuple[str, ...]
            if s.next_hops is not None:
                hops = tuple(s.next_hops)
                if not hops:
                    raise ValueError(f"{s.name}: next_hops must be non-empty"
                                     f" when given (omit it for a PS egress)")
                if len(set(hops)) != len(hops):
                    raise ValueError(f"{s.name}: duplicate candidates in "
                                     f"next_hops {hops}")
                if s.next_hop is not None:
                    if s.next_hop not in hops:
                        raise ValueError(
                            f"{s.name}: next_hop {s.next_hop!r} is not a "
                            f"member of next_hops {hops}")
                    # the declared primary leads the candidate order
                    hops = (s.next_hop,) + tuple(
                        h for h in hops if h != s.next_hop)
            elif s.next_hop is not None:
                hops = (s.next_hop,)
            else:
                hops = ()
            for h in hops:
                if h not in self.index:
                    raise ValueError(f"{s.name}: unknown next hop {h!r}")
                if h == s.name:
                    raise ValueError(f"{s.name}: next-hop cycle (self-loop)")
            cand.append(tuple(self.index[h] for h in hops))
        self.candidates: Tuple[Tuple[int, ...], ...] = tuple(cand)
        self.next_hop = np.asarray(
            [c[0] if c else -1 for c in cand], np.int32)
        self.queue_slots = np.asarray(
            [s.queue_slots for s in self.switches], np.int32)
        self.rate_bps = np.asarray(
            [s.rate_gbps * 1e9 for s in self.switches], np.float64)
        self.prop_delay = np.asarray(
            [s.prop_delay for s in self.switches], np.float64)
        # adjacency: one row per switch, hot at every candidate next hop
        self.adjacency = np.zeros((S, S), bool)
        for u in range(S):
            for v in cand[u]:
                self.adjacency[u, v] = True
        # acyclicity over the *candidate* graph: iterative colored DFS so a
        # cycle through any alternate path is rejected with a clear message
        color = [0] * S  # 0 = unvisited, 1 = on stack, 2 = done
        for root in range(S):
            if color[root]:
                continue
            stack: List[Tuple[int, int]] = [(root, 0)]
            color[root] = 1
            while stack:
                u, ci = stack[-1]
                if ci < len(cand[u]):
                    stack[-1] = (u, ci + 1)
                    v = cand[u][ci]
                    if color[v] == 1:
                        path = [self.names[x] for x, _ in stack]
                        path = path[path.index(self.names[v]):]
                        raise ValueError(
                            f"next-hop cycle reachable from "
                            f"{self.names[root]!r}: "
                            f"{' -> '.join(path + [self.names[v]])}")
                    if color[v] == 0:
                        color[v] = 1
                        stack.append((v, 0))
                else:
                    color[u] = 2
                    stack.pop()
        # strict downstream reachability (transitive closure of adjacency)
        reach = self.adjacency.copy()
        for _ in range(S):
            reach = reach | (reach @ self.adjacency)
        self.reachability = reach
        # upstream frontier + upstream-first topological drain order
        self.upstreams: Tuple[Tuple[int, ...], ...] = tuple(
            tuple(int(u) for u in np.nonzero(self.adjacency[:, v])[0])
            for v in range(S))
        indeg = self.adjacency.sum(axis=0).astype(int)
        order, ready = [], [u for u in range(S) if indeg[u] == 0]
        while ready:
            u = ready.pop(0)
            order.append(u)
            for v in cand[u]:
                indeg[v] -= 1
                if indeg[v] == 0:
                    ready.append(v)
        assert len(order) == S  # acyclic => Kahn consumes every switch
        self.topo_order = np.asarray(order, np.int32)
        self.egress: Tuple[int, ...] = tuple(
            int(i) for i in np.nonzero(self.next_hop < 0)[0])
        self.source_names: Tuple[str, ...] = tuple(
            self.names[u] for u in range(S) if not self.upstreams[u])

    # -- routing ------------------------------------------------------------
    def select_hop(self, src: int, cluster_id: int, worker_id: int,
                   up: Sequence[int],
                   depth_fn=None) -> int:
        """Pick the next hop for a departure at switch index ``src`` among
        the *up* candidate subset (already filtered for failed links, in
        candidate order).

          * ``static``   — primary if alive, else the first alive alternate;
          * ``hash``     — flow-stable ECMP hash of (cluster, worker);
          * ``adaptive`` — least destination queue occupancy (``depth_fn``
            maps a switch index to its current depth), ties in candidate
            order.
        """
        if not up:
            raise ValueError(f"{self.names[src]}: no live next hop")
        if len(up) == 1 or self.route_policy == "static":
            return int(up[0])
        if self.route_policy == "hash":
            h = (int(cluster_id) * 2654435761 + int(worker_id) * 40503
                 + src * 9176) & 0xFFFFFFFF
            return int(up[h % len(up)])
        # adaptive: least-loaded destination queue
        depths = [depth_fn(v) if depth_fn is not None else 0 for v in up]
        return int(up[int(np.argmin(depths))])

    def validate_ingress(self, ingress: Sequence[str]) -> None:
        """Check the worker wiring against this spec: every ingress must
        name a real switch, and every switch must be reachable from some
        worker ingress (an orphan switch would silently never carry
        traffic)."""
        unknown = sorted({n for n in ingress if n not in self.index})
        if unknown:
            raise ValueError(f"worker ingress switches {unknown} are not in "
                             f"the topology {self.names}")
        seen = {self.index[n] for n in ingress}
        frontier = list(seen)
        while frontier:
            u = frontier.pop()
            for v in self.candidates[u]:
                if v not in seen:
                    seen.add(v)
                    frontier.append(v)
        orphans = [self.names[u] for u in range(self.num_switches)
                   if u not in seen]
        if orphans:
            raise ValueError(
                f"switches {orphans} are unreachable from any worker "
                f"ingress {sorted(set(ingress))}; every switch must lie on "
                f"some worker's path to a PS")

    # -- derived views ------------------------------------------------------
    def scan_arrays(self) -> Dict[str, np.ndarray]:
        """Compile the spec into the dense per-link tensors the vectorized
        simulator's ``lax.scan`` consumes (``core/vecsim.py``):

          * ``cand_matrix``  — ``(S, Cmax)`` int32 candidate next hops,
            primary first, right-padded with −1 (a pure-egress switch has an
            all-−1 row, mirroring ``next_hop == -1``);
          * ``cand_count``   — ``(S,)`` int32 live candidate count per row;
          * ``next_hop`` / ``queue_slots`` / ``rate_bps`` / ``prop_delay``
            — the existing per-switch vectors, re-exported so one call
            stages every static array; ``queue_slots`` is what the scan
            pads the shared ``(S, Qmax)`` queue buffer against;
          * ``is_egress``    — ``(S,)`` bool, True where ``next_hop == -1``
            (the PS egress rows of a multi-PS fabric);
          * ``is_fifo``      — ``(S,)`` bool per-switch queue discipline;
          * ``reward_threshold`` — ``(S,)`` float64, ``+inf`` where the
            switch declares no reward gate (Algorithm 1 then never
            reward-replaces/drops, matching ``reward_threshold=None``).

        ``Cmax`` is at least 1 so single-path and single-switch specs still
        produce a well-formed (non-empty) candidate axis.
        """
        S = self.num_switches
        cmax = max([len(c) for c in self.candidates] + [1])
        cand_matrix = np.full((S, cmax), -1, np.int32)
        for u, c in enumerate(self.candidates):
            cand_matrix[u, :len(c)] = c
        return dict(
            cand_matrix=cand_matrix,
            cand_count=np.asarray([len(c) for c in self.candidates],
                                  np.int32),
            next_hop=self.next_hop.copy(),
            queue_slots=self.queue_slots.copy(),
            rate_bps=self.rate_bps.copy(),
            prop_delay=self.prop_delay.copy(),
            is_egress=self.next_hop < 0,
            is_fifo=np.asarray([s.queue == "fifo" for s in self.switches],
                               bool),
            reward_threshold=np.asarray(
                [np.inf if s.reward_threshold is None else s.reward_threshold
                 for s in self.switches], np.float64),
        )

    def wire_packets(self, size_bits: int) -> np.ndarray:
        """Per-switch bound on packets concurrently on the uplink wire:
        serialization spaces departures at least one service time apart,
        so at most ``prop_delay * rate / size`` packets (plus slack for
        the boundary cases) are in flight per uplink. The vectorized
        simulator sizes its transit/PS rings from the sum of these — and
        its sharded runner sizes each shard's local ring from the subset
        of sources that can reach the shard."""
        size = max(int(size_bits), 1)
        return (self.prop_delay * self.rate_bps / size).astype(np.int64) + 3

    def flush_set(self, name: str) -> Tuple[str, ...]:
        """The per-switch flush cadence: the departing switch plus its
        upstream frontier, in topological (upstream-first) order."""
        v = self.index[name]
        members = set(self.upstreams[v]) | {v}
        return tuple(self.names[u] for u in self.topo_order if u in members)

    def switch_cfgs(self, queue: Optional[str] = None,
                    reward_threshold=_UNSET) -> List[SwitchCfg]:
        """Emit the netsim ``SwitchCfg``/``Link`` wiring for this spec.
        ``queue``/``reward_threshold`` override every switch when given."""
        return [
            SwitchCfg(
                name=s.name,
                queue=queue if queue is not None else s.queue,
                queue_slots=s.queue_slots,
                reward_threshold=(s.reward_threshold
                                  if reward_threshold is _UNSET
                                  else reward_threshold),
                uplink=Link(s.rate_gbps * 1e9, s.prop_delay),
                next_hop=(self.names[c[0]] if c else None),
                # None (not a 1-tuple) for single-path switches keeps the
                # emitted cfg dataclass-equal to hand-written wiring
                next_hops=(tuple(self.names[v] for v in c)
                           if len(c) > 1 else None),
            )
            for s, c in zip(self.switches, self.candidates)
        ]

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        hops = ", ".join(
            f"{s.name}->{s.next_hop or 'PS'}" for s in self.switches)
        return f"TopologySpec({hops})"


def spec_from_switch_cfgs(switch_cfgs: Sequence[SwitchCfg], *,
                          route_policy: str = "static") -> TopologySpec:
    """Compile a spec from existing netsim ``SwitchCfg`` wiring (the
    backward-compatible entry the hybrid plane uses when no spec is
    passed)."""
    return TopologySpec([
        SwitchSpec(name=c.name, next_hop=c.next_hop,
                   queue_slots=c.queue_slots,
                   rate_gbps=c.uplink.capacity_bps / 1e9,
                   prop_delay=c.uplink.prop_delay, queue=c.queue,
                   reward_threshold=c.reward_threshold,
                   next_hops=(tuple(c.next_hops)
                              if c.next_hops is not None else None))
        for c in switch_cfgs
    ], route_policy=route_policy)


# --------------------------------------------------------------------------
# Named presets. Rates default to the congested test/bench scale (the OLAF
# operating point — queueing actually happens inside sub-second horizons);
# pass paper-scale ``rate_gbps`` for uncongested line-rate runs.
# --------------------------------------------------------------------------
def multihop_spec(*, x1_gbps: float = 10.0, x2_gbps: float = 10.0,
                  sw3_gbps: float = 10.0, sw12_slots: int = 5,
                  sw3_slots: int = 8,
                  reward_threshold: Optional[float] = None,
                  queue: str = "olaf") -> TopologySpec:
    """The paper's §8.3 SW1/SW2→SW3 fan-in (Fig. 9)."""
    return TopologySpec([
        SwitchSpec("SW1", next_hop="SW3", queue_slots=sw12_slots,
                   rate_gbps=x1_gbps, queue=queue,
                   reward_threshold=reward_threshold),
        SwitchSpec("SW2", next_hop="SW3", queue_slots=sw12_slots,
                   rate_gbps=x2_gbps, queue=queue,
                   reward_threshold=reward_threshold),
        SwitchSpec("SW3", next_hop=None, queue_slots=sw3_slots,
                   rate_gbps=sw3_gbps, queue=queue,
                   reward_threshold=reward_threshold),
    ])


def chain_spec(n: int = 3, *, rate_gbps: float = 0.6e-3,
               queue_slots: int = 5, **kw) -> TopologySpec:
    """A linear chain SW1 → SW2 → … → SWn → PS (workers enter at SW1)."""
    assert n >= 1
    return TopologySpec([
        SwitchSpec(f"SW{i + 1}",
                   next_hop=None if i == n - 1 else f"SW{i + 2}",
                   queue_slots=queue_slots, rate_gbps=rate_gbps, **kw)
        for i in range(n)
    ])


def fanin_spec(fan: int = 4, *, leaf_gbps: float = 0.4e-3,
               core_gbps: float = 0.8e-3, leaf_slots: int = 4,
               core_slots: int = 8, **kw) -> TopologySpec:
    """Wide fan-in: LEAF1..LEAFfan → CORE → PS."""
    leaves = [SwitchSpec(f"LEAF{i + 1}", next_hop="CORE",
                         queue_slots=leaf_slots, rate_gbps=leaf_gbps, **kw)
              for i in range(fan)]
    return TopologySpec(
        leaves + [SwitchSpec("CORE", next_hop=None, queue_slots=core_slots,
                             rate_gbps=core_gbps, **kw)])


def fattree_spec(k: int = 2, *, edge_gbps: float = 0.4e-3,
                 agg_gbps: float = 0.6e-3, core_gbps: float = 1.0e-3,
                 edge_slots: int = 4, agg_slots: int = 6,
                 core_slots: int = 8, spines: int = 1,
                 route_policy: str = "static", **kw) -> TopologySpec:
    """Leaf–spine / fat-tree-style upstream tree: k pods of k edge
    switches, each pod's edges feeding its aggregation switch, every
    aggregation feeding the core layer (k² + k + spines switches).

    ``spines=1`` keeps the historic single-CORE tree. ``spines>1`` gives
    every aggregation switch all CORE1..COREn spines as candidate next
    hops — the multi-path fabric the failure suite reroutes across —
    with ``route_policy`` choosing among them."""
    switches: List[SwitchSpec] = []
    for p in range(k):
        for e in range(k):
            switches.append(SwitchSpec(
                f"EDGE{p + 1}{e + 1}", next_hop=f"AGG{p + 1}",
                queue_slots=edge_slots, rate_gbps=edge_gbps, **kw))
    cores = (["CORE"] if spines == 1
             else [f"CORE{i + 1}" for i in range(spines)])
    for p in range(k):
        switches.append(SwitchSpec(
            f"AGG{p + 1}", next_hop=cores[0],
            next_hops=tuple(cores) if spines > 1 else None,
            queue_slots=agg_slots, rate_gbps=agg_gbps, **kw))
    for c in cores:
        switches.append(SwitchSpec(c, next_hop=None, queue_slots=core_slots,
                                   rate_gbps=core_gbps, **kw))
    return TopologySpec(switches, route_policy=route_policy)


def multirack_spec(racks: int = 4, *, tor_gbps: float = 0.4e-3,
                   agg_gbps: float = 0.6e-3, core_gbps: float = 1.0e-3,
                   tor_slots: int = 4, agg_slots: int = 6,
                   core_slots: int = 8, **kw) -> TopologySpec:
    """Multi-rack: one ToR per rack, pairs of ToRs behind an aggregation
    switch, all aggregations behind one core egress."""
    switches = [SwitchSpec(f"TOR{r + 1}", next_hop=f"RAGG{r // 2 + 1}",
                           queue_slots=tor_slots, rate_gbps=tor_gbps, **kw)
                for r in range(racks)]
    for a in range((racks + 1) // 2):
        switches.append(SwitchSpec(
            f"RAGG{a + 1}", next_hop="CORE", queue_slots=agg_slots,
            rate_gbps=agg_gbps, **kw))
    switches.append(SwitchSpec("CORE", next_hop=None, queue_slots=core_slots,
                               rate_gbps=core_gbps, **kw))
    return TopologySpec(switches)


def multips_spec(groups: int = 2, *, leaves_per_group: int = 2,
                 leaf_gbps: float = 0.4e-3, egress_gbps: float = 0.7e-3,
                 leaf_slots: int = 4, egress_slots: int = 6,
                 **kw) -> TopologySpec:
    """Multi-PS egress: independent sub-trees, each draining to its own
    parameter server (several switches with ``next_hop=None``)."""
    switches: List[SwitchSpec] = []
    for g in range(groups):
        for i in range(leaves_per_group):
            switches.append(SwitchSpec(
                f"G{g + 1}L{i + 1}", next_hop=f"G{g + 1}E",
                queue_slots=leaf_slots, rate_gbps=leaf_gbps, **kw))
    for g in range(groups):
        switches.append(SwitchSpec(
            f"G{g + 1}E", next_hop=None, queue_slots=egress_slots,
            rate_gbps=egress_gbps, **kw))
    return TopologySpec(switches)


# --------------------------------------------------------------------------
# SimCfg wiring from a spec
# --------------------------------------------------------------------------
def build_sim_cfg(spec: TopologySpec, *, queue: Optional[str] = None,
                  clusters_per_ingress: int = 2,
                  workers_per_cluster: int = 2,
                  gen_interval: float = 0.02, gen_jitter: float = 0.3,
                  size_bits: int = 8192, horizon: float = 0.3,
                  n_updates: Optional[int] = None, tx_control=None,
                  seed: int = 0, faults=None,
                  reward_threshold=_UNSET) -> SimCfg:
    """Netsim wiring for a topology spec: ``SwitchCfg``/``Link`` per switch
    plus ``clusters_per_ingress`` worker clusters spread over the spec's
    source switches (the leaves of the DAG)."""
    workers: List[WorkerCfg] = []
    wid = cluster = 0
    for ing in spec.source_names:
        for _ in range(clusters_per_ingress):
            for _ in range(workers_per_cluster):
                workers.append(WorkerCfg(
                    worker_id=wid, cluster_id=cluster, ingress_switch=ing,
                    gen_interval=gen_interval, gen_jitter=gen_jitter,
                    n_updates=n_updates, size_bits=size_bits))
                wid += 1
            cluster += 1
    return SimCfg(switches=spec.switch_cfgs(queue, reward_threshold),
                  workers=workers, horizon=horizon, tx_control=tx_control,
                  seed=seed, faults=faults, route_policy=spec.route_policy)


def resolve_sim_cfg(topology, *, seed: int = 0, **cfg_kw) -> SimCfg:
    """One ``topology=`` argument for the hybrid entry points: either a
    :class:`TopologySpec` (worker clusters spread over its sources via
    :func:`build_sim_cfg` with ``cfg_kw``) or an already-built ``SimCfg``
    from a ``*_cfg`` preset one-liner (in which case stray ``cfg_kw``
    would be silently dead — rejected instead)."""
    if isinstance(topology, SimCfg):
        if cfg_kw:
            raise TypeError(f"topology is a prebuilt SimCfg; the extra "
                            f"kwargs {sorted(cfg_kw)} would be ignored — "
                            f"pass them to its *_cfg preset instead")
        return topology
    return build_sim_cfg(topology, seed=seed, **cfg_kw)


def chain_cfg(n: int = 3, *, queue: str = "olaf", seed: int = 0,
              spec_kw: Optional[dict] = None, **cfg_kw) -> SimCfg:
    return build_sim_cfg(chain_spec(n, **(spec_kw or {})), queue=queue,
                         seed=seed, **cfg_kw)


def fanin_cfg(fan: int = 4, *, queue: str = "olaf", seed: int = 0,
              spec_kw: Optional[dict] = None, **cfg_kw) -> SimCfg:
    return build_sim_cfg(fanin_spec(fan, **(spec_kw or {})), queue=queue,
                         seed=seed, **cfg_kw)


def fattree_cfg(k: int = 2, *, queue: str = "olaf", seed: int = 0,
                spec_kw: Optional[dict] = None, **cfg_kw) -> SimCfg:
    return build_sim_cfg(fattree_spec(k, **(spec_kw or {})), queue=queue,
                         seed=seed, **cfg_kw)


def multirack_cfg(racks: int = 4, *, queue: str = "olaf", seed: int = 0,
                  spec_kw: Optional[dict] = None, **cfg_kw) -> SimCfg:
    return build_sim_cfg(multirack_spec(racks, **(spec_kw or {})),
                         queue=queue, seed=seed, **cfg_kw)


def multips_cfg(groups: int = 2, *, queue: str = "olaf", seed: int = 0,
                spec_kw: Optional[dict] = None, **cfg_kw) -> SimCfg:
    return build_sim_cfg(multips_spec(groups, **(spec_kw or {})),
                         queue=queue, seed=seed, **cfg_kw)
