"""The port's hybrid multi-switch data plane against ``repro``'s.

The same configuration, built twice (once from each package's netsim and
topology, which give the same trace), goes through
``repro.core.hybrid.run_hybrid_multihop`` (Pallas in interpret mode) and
``repro_torch.core.hybrid.run_hybrid_multihop`` on the CPU (the combine's
plain version). Trace metadata, times and every counter of
``HybridResult`` (``h2d_transfers`` and the fault and integrity counters
included) must match exactly; delivered rows within ``rtol=1e-5,
atol=1e-6`` (the combine sums in another order). Inside the port, the
event and window backends must give the same bits.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.aggregation as j_agg  # noqa: E402
import repro.core.hybrid as j_hyb  # noqa: E402
import repro.core.netsim as j_net  # noqa: E402
import repro.core.topology as j_topo  # noqa: E402
import repro.core.txctl as j_tx  # noqa: E402
import repro_torch.core.aggregation as t_agg  # noqa: E402
import repro_torch.core.hybrid as t_hyb  # noqa: E402
import repro_torch.core.netsim as t_net  # noqa: E402
import repro_torch.core.topology as t_topo  # noqa: E402
import repro_torch.core.txctl as t_tx  # noqa: E402

DIM = 24
RTOL, ATOL = 1e-5, 1e-6


def _ns(agg, hyb, net, topo, tx):
    return types.SimpleNamespace(**{**vars(agg), **vars(net), **vars(topo),
                                    **vars(tx), **vars(hyb)})


REPRO = _ns(j_agg, j_hyb, j_net, j_topo, j_tx)
PORT = _ns(t_agg, t_hyb, t_net, t_topo, t_tx)

COUNTERS = ("launches", "combined_updates", "forward_launches",
            "switch_launches", "forwarded", "link_dropped", "rerouted",
            "drops_by_switch", "h2d_transfers", "ps_dropped",
            "stale_rejected", "stale_deferred", "worker_crashes",
            "worker_restarts", "worker_straggles", "corrupted", "screened",
            "tainted_delivered", "queue_stats", "residual_slot_counts")


def _meta(u):
    return (u.cluster_id, u.worker_id, u.gen_time, u.reward, u.agg_count,
            u.seq, u.retx, u.corrupt)


def assert_matches_repro(want, got):
    """``want`` from repro, ``got`` from the port."""
    assert len(want.delivered) == len(got.delivered)
    for (t0, u0, p0), (t1, u1, p1) in zip(want.delivered, got.delivered):
        assert t0 == t1
        assert _meta(u0) == _meta(u1)
        assert isinstance(p1, torch.Tensor) and p1.shape == (DIM,)
        np.testing.assert_allclose(np.asarray(p0), p1.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert got.final_counts.dtype == np.int32
    np.testing.assert_array_equal(np.asarray(want.final_counts),
                                  got.final_counts)
    for f in COUNTERS:
        assert getattr(want, f) == getattr(got, f), f


def assert_bitwise(a, b):
    """Two port results equal bit for bit (``h2d_transfers`` aside, which
    the backends count differently by design)."""
    assert len(a.delivered) == len(b.delivered)
    for (t0, u0, p0), (t1, u1, p1) in zip(a.delivered, b.delivered):
        assert t0 == t1 and _meta(u0) == _meta(u1)
        assert torch.equal(p0, p1)
    np.testing.assert_array_equal(a.final_counts, b.final_counts)
    for f in COUNTERS:
        if f != "h2d_transfers":
            assert getattr(a, f) == getattr(b, f), f


def run_both(cfg_fn, **kw):
    """``cfg_fn(ns)`` builds the config from one package's namespace."""
    want, _ = j_hyb.run_hybrid_multihop(DIM, sim_cfg=cfg_fn(REPRO), **kw)
    got, _ = t_hyb.run_hybrid_multihop(DIM, sim_cfg=cfg_fn(PORT),
                                       device="cpu", **kw)
    assert_matches_repro(want, got)
    return got


# ---- configurations: each a function of the package namespace -------------
MULTIHOP_KW = dict(n_clusters_per_group=2, workers_per_cluster=2,
                   horizon=0.25, interval_s1=0.02, interval_s2=0.025,
                   x1_gbps=0.5e-3, x2_gbps=0.5e-3, sw3_gbps=0.8e-3,
                   size_bits=8192, sw12_slots=4, sw3_slots=4)


def multihop(seed):
    return lambda ns: ns.multihop_cfg("olaf", seed=seed, **MULTIHOP_KW)


def faulty_fattree(ns):
    spec = ns.fattree_spec(2, spines=2, route_policy="hash")
    faults = ns.FaultSpec(links=[
        ns.LinkFault(switch="AGG1", drop_prob=0.3),
        ns.LinkFault(switch="AGG1", dst="CORE2", down=((0.05, 0.12),)),
    ], seed=4)
    return ns.build_sim_cfg(
        spec, clusters_per_ingress=1, workers_per_cluster=2,
        gen_interval=0.015, horizon=0.2, faults=faults, seed=7,
        tx_control=ns.TxControlConfig(ack_timeout=0.004, max_retries=2))


def churn_fattree(ns):
    spec = ns.fattree_spec(2, spines=2, route_policy="adaptive")
    faults = ns.FaultSpec(
        workers=[ns.WorkerFault(worker=0, crash_t=0.08, restart_delay=0.08),
                 ns.WorkerFault(worker=3, crash_t=0.12),
                 ns.WorkerFault(worker=1, slowdown=2.0)],
        ps=[ns.PSFault(restart_t=0.15, recovery=0.03)])
    cfg = ns.build_sim_cfg(
        spec, gen_interval=0.015, horizon=0.25, seed=13, faults=faults,
        tx_control=ns.TxControlConfig(ack_timeout=0.03, max_retries=2))
    return dataclasses.replace(cfg, staleness_bound=0.08)


def screened_corruption(ns):
    spec = ns.fattree_spec(2, spines=2, route_policy="hash")
    faults = ns.FaultSpec(
        links=[ns.LinkFault(switch="AGG1", drop_prob=0.2)],
        corruption=[ns.CorruptionFault(worker=0, prob=0.4, mode="nan"),
                    ns.CorruptionFault(switch="EDGE12", prob=0.3,
                                       mode="scale", factor=1e3),
                    ns.CorruptionFault(prob=0.1, mode="bitflip")], seed=14)
    cfg = ns.build_sim_cfg(
        spec, clusters_per_ingress=1, workers_per_cluster=2,
        gen_interval=0.02, horizon=0.4, n_updates=10, faults=faults, seed=7,
        tx_control=ns.TxControlConfig(ack_timeout=0.02, max_retries=6))
    return dataclasses.replace(cfg, ingress_screen=True)


def mixed_ingress(ns):
    """SW1 -> SW3 -> PS with workers on both: SW3 sees fresh and forwarded
    enqueues."""
    workers, wid = [], 0
    for sw, cluster in (("SW1", 0), ("SW1", 1), ("SW3", 2), ("SW3", 3)):
        for _ in range(2):
            workers.append(ns.WorkerCfg(
                worker_id=wid, cluster_id=cluster, ingress_switch=sw,
                gen_interval=0.02, gen_jitter=0.3, size_bits=8192))
            wid += 1
    switches = [
        ns.SwitchCfg("SW1", queue_slots=4, uplink=ns.Link(0.5e6),
                     next_hop="SW3"),
        ns.SwitchCfg("SW3", queue_slots=4, uplink=ns.Link(0.8e6),
                     next_hop=None)]
    return ns.SimCfg(switches=switches, workers=workers, horizon=0.3, seed=5)


# ---- the scenarios ----------------------------------------------------------
@pytest.mark.parametrize("seed", [3, 11])
def test_multihop_both_backends(seed):
    """§8.3 SW1/SW2→SW3 fan-in: each backend equals repro's, and the two
    backends equal each other bit for bit."""
    event = run_both(multihop(seed), sim_impl="event", seed=seed)
    window = run_both(multihop(seed), sim_impl="window", seed=seed)
    assert_bitwise(event, window)
    assert len(window.delivered) > 0
    assert window.h2d_transfers < event.h2d_transfers
    assert any(u.agg_count > 1 for _, u, _ in window.delivered)


def test_multihop_payload_rows_and_source():
    """Explicit rows, and a payload source whose rewards drive the gating,
    through the window backend."""
    rows = np.random.default_rng(77).normal(size=(4000, DIM)).astype(
        np.float32)
    run_both(multihop(3), payload_rows=rows)

    def source(seed):
        r = np.random.default_rng(seed)
        return lambda now, wid: (r.normal(size=DIM).astype(np.float32),
                                 float(r.normal()))

    kw = dict(MULTIHOP_KW, reward_threshold=0.3)
    want, _ = j_hyb.run_hybrid_multihop(DIM, seed=2, payload_source=source(9),
                                        **kw)
    got, _ = t_hyb.run_hybrid_multihop(DIM, seed=2, payload_source=source(9),
                                       device="cpu", **kw)
    assert_matches_repro(want, got)


def test_faulty_fattree_links():
    got = run_both(faulty_fattree)
    assert got.link_dropped > 0 and got.rerouted >= 0 and got.delivered


def test_node_churn_fattree():
    got = run_both(churn_fattree)
    event = run_both(churn_fattree, sim_impl="event")
    assert_bitwise(event, got)
    assert got.worker_crashes == 2 and got.worker_restarts == 1
    assert got.worker_straggles == 1
    assert got.ps_dropped + got.stale_rejected + got.stale_deferred > 0


def test_screened_corruption_keeps_rows_finite():
    got = run_both(screened_corruption)
    assert got.corrupted > 0 and got.screened > 0
    assert all(bool(torch.isfinite(p).all()) for _, _, p in got.delivered)


def test_legacy_every_switch_flush():
    got = run_both(faulty_fattree, flush_cadence=False)
    cadence, _ = t_hyb.run_hybrid_multihop(DIM, sim_cfg=faulty_fattree(PORT),
                                           device="cpu")
    assert sum(got.switch_launches.values()) >= \
        sum(cadence.switch_launches.values())


def test_sharded_one_device():
    """``sharded=True``: the multi-queue combine on the reset-masked counts
    and a separate drain, with repro's counters; over a list of three
    devices (one switch each) the same bits, and a list without
    ``sharded`` raises."""
    got = run_both(multihop(3), sharded=True)
    plain, _ = t_hyb.run_hybrid_multihop(DIM, sim_cfg=multihop(3)(PORT),
                                         device="cpu")
    assert got.forward_launches == plain.forward_launches
    for (_, _, p0), (_, _, p1) in zip(got.delivered, plain.delivered):
        torch.testing.assert_close(p0, p1, rtol=RTOL, atol=ATOL)
    split, _ = t_hyb.run_hybrid_multihop(DIM, sim_cfg=multihop(3)(PORT),
                                         sharded=True, device=["cpu"] * 3)
    assert_bitwise(got, split)
    with pytest.raises(ValueError, match="needs sharded=True"):
        t_hyb.run_hybrid_multihop(DIM, sim_cfg=multihop(3)(PORT),
                                  device=["cpu", "cpu"])


@pytest.mark.parametrize("impl", ["event", "window"])
def test_mixed_ingress_transit_switch(impl):
    got = run_both(mixed_ingress, sim_impl=impl)
    assert got.forwarded > 0 and got.delivered


# ---- crafted traces through the plane itself ---------------------------------
def _two_upstream(ns):
    switches = [
        ns.SwitchCfg("SWA", queue_slots=4, next_hop="SWC",
                     uplink=ns.Link(40e9, prop_delay=0.010)),
        ns.SwitchCfg("SWB", queue_slots=4, next_hop="SWC",
                     uplink=ns.Link(40e9, prop_delay=0.007)),
        ns.SwitchCfg("SWC", queue_slots=4, next_hop=None)]

    def mk(gen_time, seq=-1):
        return ns.Update(cluster_id=0, worker_id=7, gen_time=gen_time,
                         reward=0.0, size_bits=64, seq=seq)

    events = [
        (0.010, "SWA", "enqueue", mk(0.010)), (0.010, "SWA", "lock", mk(0.010)),
        (0.011, "SWA", "window", None), (0.011, "SWA", "dequeue", mk(0.010)),
        (0.011, "SWC", "forward", mk(0.010)),
        (0.012, "SWB", "enqueue", mk(0.012)), (0.012, "SWB", "lock", mk(0.012)),
        (0.013, "SWB", "window", None), (0.013, "SWB", "dequeue", mk(0.012)),
        (0.013, "SWC", "forward", mk(0.012)),
        (0.020, "SWC", "enqueue", mk(0.012, 0)),
        (0.020, "SWC", "lock", mk(0.012, 0)),
        (0.0205, "SWC", "window", None), (0.0205, "SWC", "dequeue", mk(0.012)),
        (0.0205, "SWC", "deliver", mk(0.012)),
        (0.021, "SWC", "enqueue", mk(0.010, 0)),
        (0.021, "SWC", "lock", mk(0.010, 0)),
        (0.022, "SWC", "window", None), (0.022, "SWC", "dequeue", mk(0.010)),
        (0.022, "SWC", "deliver", mk(0.010))]
    return switches, events


def _replay(ns, switches, events, rows, batched, **kw):
    plane = ns.HybridMultiSwitchDataPlane(switches, {"SWA", "SWB", "SW"},
                                          DIM, rows, **kw)
    if batched:
        plane.feed_window(events)
    else:
        for ev in events:
            plane.feed(*ev)
    return plane.result()


@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("routed", [True, False])
def test_two_upstream_overtaking(batched, routed):
    """A later departure (SWB) overtakes an earlier one (SWA) on the way to
    SWC; both same-flow heads must be matched to the right rows, with and
    without routing events in the trace."""
    rows = np.eye(2, DIM, dtype=np.float32)
    results = []
    for ns, kw in ((REPRO, {}), (PORT, dict(device="cpu"))):
        switches, events = _two_upstream(ns)
        if not routed:
            events = [ev for ev in events if ev[2] not in ("forward",
                                                            "deliver")]
        results.append(_replay(ns, switches, events, rows, batched, **kw))
    want, got = results
    assert_matches_repro(want, got)
    assert [u.gen_time for _, u, _ in got.delivered] == [0.012, 0.010]
    np.testing.assert_array_equal(got.delivered[0][2].numpy(), rows[1])
    np.testing.assert_array_equal(got.delivered[1][2].numpy(), rows[0])


@pytest.mark.parametrize("sharded", [False, True])
def test_drain_only_departure_delivers_its_row_h10(sharded):
    """H10: a departure with no window to land copies its row out before
    clearing the slot (a basic-indexed torch row is a view and would read
    the zeros). Two updates land in one flush; the second departs later,
    drain-only."""
    rows = np.arange(2 * DIM, dtype=np.float32).reshape(2, DIM) + 1.0
    results = []
    for ns, kw in ((REPRO, {}), (PORT, dict(device="cpu"))):
        def mk(cluster, worker, t, seq=-1):
            return ns.Update(cluster_id=cluster, worker_id=worker,
                             gen_time=t, reward=0.0, size_bits=64, seq=seq)

        events = [
            (0.010, "SW", "enqueue", mk(0, 1, 0.010)),
            (0.011, "SW", "enqueue", mk(1, 2, 0.011)),
            (0.012, "SW", "lock", None), (0.013, "SW", "window", None),
            (0.013, "SW", "dequeue", mk(0, 1, 0.010)),
            (0.013, "SW", "deliver", mk(0, 1, 0.010)),
            (0.014, "SW", "lock", None), (0.015, "SW", "window", None),
            (0.015, "SW", "dequeue", mk(1, 2, 0.011)),
            (0.015, "SW", "deliver", mk(1, 2, 0.011))]
        switches = [ns.SwitchCfg("SW", queue_slots=4, next_hop=None)]
        results.append(_replay(ns, switches, events, rows, True,
                               sharded=sharded, **kw))
    want, got = results
    assert_matches_repro(want, got)
    assert got.launches == 1 and got.forward_launches == 2
    for (_, _, row), expect in zip(got.delivered, rows):
        np.testing.assert_array_equal(row.numpy(), expect)
    assert not got.final_counts.any()


def test_backend_selection_errors():
    # a mesh of two switch shards over the one CPU device, as repro's over
    # one jax device
    with pytest.raises(ValueError, match="needs 2 devices, only 1"):
        t_hyb.run_hybrid_multihop(DIM, sim_impl="vectorized", sim_mesh=2,
                                  sim_dt=0.01, device="cpu")
    with pytest.raises(ValueError, match="sim_dt/sim_mesh require"):
        t_hyb.run_hybrid_multihop(DIM, sim_impl="event", sim_dt=0.01,
                                  device="cpu")
    with pytest.raises(ValueError, match="unknown sim_impl"):
        t_hyb.run_hybrid_multihop(DIM, sim_impl="scan", device="cpu")
