"""The port's vectorized network simulator against ``repro``'s.

``repro_torch.core.vecsim`` steps a scenario one grid boundary at a time
over tensors; ``repro.core.vecsim`` runs the same model as one jitted
``lax.scan``. Each configuration is built once with ``repro``'s classes and
carried over to the port's identical ones, then run through both on the
CPU. Every ``VecSimResult`` field must match exactly (counters, delivery
metadata and times, AoM, final counts, residuals), apart from
``delivered_payloads`` (within ``rtol=1e-5, atol=1e-6``: the burst sums its
rows in another order), ``h2d_transfers`` (the port's own staged copies,
which happen to number the same) and, in the hybrid, ``launches`` (the
port's steps against ``repro``'s one scan). The same runs are held to the
port's own event-heap netsim, as ``tests/test_vecsim.py`` holds ``repro``'s.
The single-slot queue oracles, the S-queue burst and the ring insertion are
held to ``repro``'s one by one, and the hazards the port meets here (H2
ties, H21 writes past a buffer, H22 the uint32 hash) are pinned.
"""
import argparse
import dataclasses
import io
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import olaf_queue as j_q  # noqa: E402
from repro.core import vecsim as j_vec  # noqa: E402
from repro.core.hybrid import run_hybrid_multihop as j_hybrid  # noqa: E402
from repro.core.netsim import (FaultSpec, LinkFault, PSFault,  # noqa: E402
                               WorkerFault, multihop_cfg)
from repro.core.txctl import TxControlConfig  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.launch.train import run_scenario as jax_run_scenario  # noqa: E402
from repro_torch.core import olaf_queue as t_q  # noqa: E402
from repro_torch.core import vecsim as t_vec  # noqa: E402
from repro_torch.core.aom import average_aom  # noqa: E402
from repro_torch.core.hybrid import run_hybrid_multihop as t_hybrid  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from test_vecsim import (_counters, _dyadic_fattree_cfg,  # noqa: E402
                         _random_dyadic_cfg)

RTOL, ATOL = 1e-5, 1e-6
DIM = 3
QUEUE_FIELDS = ("cluster", "worker", "seq", "gen_time", "reward", "agg_count",
                "replaceable", "payload", "next_seq", "n_dropped", "n_agg",
                "n_repl", "n_screened")


def to_port(obj):
    """``obj`` (a ``repro`` netsim configuration) rebuilt from the port's
    classes of the same names: the port's netsim is a copy of ``repro``'s,
    so the two describe the same scenario value for value."""
    class _Remap(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "repro" or module.startswith("repro."):
                module = "repro_torch" + module[len("repro"):]
            return super().find_class(module, name)

    return _Remap(io.BytesIO(pickle.dumps(obj))).load()


def _faulty_fattree(route):
    cfg0 = _dyadic_fattree_cfg(route)
    faults = FaultSpec(links=[LinkFault(switch=s.name, drop_prob=0.05)
                              for s in cfg0.switches], seed=11)
    return _dyadic_fattree_cfg(route, faults=faults)


def _half(cfg):
    """The first half of a fat-tree run's horizon (the file's time)."""
    return dataclasses.replace(cfg, horizon=cfg.horizon / 2)


CONFIGS = {
    "random0": lambda: _random_dyadic_cfg(0),  # adaptive, link faults
    "random1": lambda: _random_dyadic_cfg(1),  # hash, faults, txctl
    "fattree_static": lambda: _half(_dyadic_fattree_cfg()),  # the AoM case
    "fattree_hash": lambda: _half(_dyadic_fattree_cfg("hash")),
    "fattree_adaptive_faults": lambda: _half(_faulty_fattree("adaptive")),
}


@pytest.fixture(scope="module")
def runs():
    """name -> (repro cfg, port cfg, grid, repro result, port result,
    port netsim result), each computed once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = CONFIGS[name]()
            pcfg = to_port(cfg)
            grid, ref = t_vec.oracle_event_times(pcfg)
            rows = np.random.default_rng(7).normal(
                size=(2048, DIM)).astype(np.float32)
            want = j_vec.run_vecsim(cfg, grid=grid, dim=DIM,
                                    payload_rows=rows)
            got = t_vec.run_vecsim(pcfg, grid=grid, dim=DIM,
                                   payload_rows=rows, device="cpu")
            cache[name] = (cfg, pcfg, grid, want, got, ref)
        return cache[name]

    return get


def _update_key(u):
    return dataclasses.astuple(u)


def assert_vecsim_equal(want, got):
    """``want`` from repro, ``got`` from the port: every field exact but
    the payloads (and ``h2d_transfers``, which is the port's own count)."""
    for f in dataclasses.fields(want.sim):
        a, b = getattr(want.sim, f.name), getattr(got.sim, f.name)
        if f.name == "delivered_updates":
            a, b = list(map(_update_key, a)), list(map(_update_key, b))
        assert a == b, f.name
    for f in ("aom", "n_steps", "forwarded", "residual"):
        assert getattr(want, f) == getattr(got, f), f
    np.testing.assert_array_equal(want.delivery_times, got.delivery_times)
    assert got.delivery_times.dtype == np.float32
    np.testing.assert_array_equal(want.final_counts, got.final_counts)
    pay = got.delivered_payloads.numpy()
    assert pay.shape == np.asarray(want.delivered_payloads).shape
    np.testing.assert_allclose(pay, np.asarray(want.delivered_payloads),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_vecsim_matches_repro(runs, name):
    *_, want, got, _ref = runs(name)
    assert len(got.sim.delivered_updates) > 0
    assert_vecsim_equal(want, got)
    assert got.h2d_transfers == len(t_vec.compile_scenario(
        runs(name)[1]).arrays) + 1


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_run_vecsim_matches_port_netsim(runs, name):
    """``tests/test_vecsim.py``'s ``assert_equivalent``, on the port: the
    port's event heap against the port's vectorized run."""
    _cfg, pcfg, _grid, _want, res, ref = runs(name)
    sim = res.sim

    def keys(updates):
        return sorted((u.cluster_id, u.worker_id, float(u.gen_time),
                       u.agg_count, u.subsumed) for u in updates)

    assert keys(ref.delivered_updates) == keys(sim.delivered_updates)
    assert ref.queue_stats == sim.queue_stats
    assert _counters(ref) == _counters(sim)
    assert ref.drops_by_switch == sim.drops_by_switch
    assert ref.reroutes_by_switch == sim.reroutes_by_switch
    for c, pairs in ref.deliveries.items():
        want = average_aom(pairs, pcfg.horizon)
        got = res.aom.get(c, 0.0)
        assert abs(got - want) <= 2e-4 * max(1.0, abs(want)), (c, got, want)


def test_dyadic_bitwise_aom(runs):
    """With dyadic times every (delivery, gen) pair equals the heap's, so
    the host-side AoM integral over them equals the oracle's exactly."""
    _cfg, pcfg, _grid, _want, res, ref = runs("fattree_static")
    for c, pairs in ref.deliveries.items():
        got = sorted(res.sim.deliveries.get(c, []))
        assert got == sorted(pairs), c
        assert average_aom(got, pcfg.horizon) == average_aom(
            sorted(pairs), pcfg.horizon)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_compile_scenario_matches_repro(name):
    cfg = CONFIGS[name]()
    want = j_vec.compile_scenario(cfg, dim=DIM)
    got = t_vec.compile_scenario(to_port(cfg), dim=DIM)
    assert tuple(want.static) == tuple(got.static)
    assert sorted(want.arrays) == sorted(got.arrays)
    for k, a in want.arrays.items():
        b = got.arrays[k]
        assert np.asarray(a).dtype == np.asarray(b).dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    for f in ("switch_names", "cluster_ids", "n_real_switches", "generated",
              "total_sends_bound"):
        assert getattr(want, f) == getattr(got, f), f
    np.testing.assert_array_equal(want.wire, got.wire)


def test_width_does_not_change_the_result(runs):
    """A run whose bursts walk one column repeats itself at a width that
    holds every step's arrivals: the same result as the default width."""
    _cfg, pcfg, grid, _want, got, _ref = runs("random0")
    rows = np.random.default_rng(7).normal(size=(2048, DIM)).astype(
        np.float32)
    narrow = t_vec.run_vecsim(pcfg, grid=grid, dim=DIM, payload_rows=rows,
                              device="cpu", width=1)
    assert narrow.sim.queue_stats == got.sim.queue_stats
    assert narrow.aom == got.aom
    np.testing.assert_array_equal(narrow.delivery_times, got.delivery_times)
    assert torch.equal(narrow.delivered_payloads, got.delivered_payloads)


def test_auto_grid_and_uniform_grid(runs):
    """Without dt or grid the run derives the oracle grid itself; the
    uniform grid is ``repro``'s, and its dt assert names the link."""
    cfg, pcfg, grid, _want, got, _ref = runs("random0")
    auto = t_vec.run_vecsim(pcfg, dim=DIM, payload_rows=np.random.default_rng(
        7).normal(size=(2048, DIM)).astype(np.float32), device="cpu")
    assert auto.sim.queue_stats == got.sim.queue_stats
    np.testing.assert_array_equal(auto.delivery_times, got.delivery_times)
    np.testing.assert_array_equal(t_vec.grid_from_trace(pcfg, []),
                                  j_vec.grid_from_trace(cfg, []))

    mh = multihop_cfg("olaf", seed=0)
    pmh = to_port(mh)
    min_service = min(w.size_bits for w in mh.workers) / max(
        s.uplink.capacity_bps for s in mh.switches)
    with pytest.raises(ValueError, match="allow_coarse") as exc:
        t_vec.uniform_grid(pmh, 4 * min_service)
    fastest = max(mh.switches, key=lambda s: s.uplink.capacity_bps)
    assert f"({fastest.name} ->" in str(exc.value)
    assert f"{min_service:g}s" in str(exc.value)
    for dt, coarse in ((4 * min_service, True), (min_service / 2, False)):
        np.testing.assert_array_equal(
            t_vec.uniform_grid(pmh, dt, allow_coarse=coarse),
            j_vec.uniform_grid(mh, dt, allow_coarse=coarse))


@pytest.mark.parametrize("change", [
    dict(staleness_bound=0.1), dict(ingress_screen=True),
    dict(faults=FaultSpec(workers=[WorkerFault(worker=0, crash_t=0.1)])),
    dict(faults=FaultSpec(ps=[PSFault(restart_t=0.1, recovery=0.1)])),
    dict(tx_control=TxControlConfig(ack_timeout=0.05)),
    dict(on_deliver=lambda *a: None)])
def test_unsupported_features_raise_where_repro_raises(change):
    cfg = dataclasses.replace(_dyadic_fattree_cfg(), **change)
    with pytest.raises(j_vec.VecsimUnsupported) as want:
        j_vec.check_vecsim_supported(cfg)
    port_cfg = cfg if "on_deliver" in change else to_port(cfg)
    with pytest.raises(t_vec.VecsimUnsupported) as got:
        t_vec.run_vecsim(port_cfg, dt=1e-3, allow_coarse=True, device="cpu")
    assert str(got.value) == str(want.value)
    assert issubclass(t_vec.VecsimUnsupported, NotImplementedError)


def test_sharding_and_the_default_device_raise():
    """A mesh larger than the visible devices raises ``ValueError`` (one
    CPU device here, as ``repro`` on one jax device); ``rt_loc`` without a
    mesh is ignored, as in ``repro``; the default device needs a card."""
    cfg = to_port(_dyadic_fattree_cfg())
    kw = dict(dt=2.0 ** -7, allow_coarse=True, device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, only 1"):
        t_vec.run_vecsim(cfg, mesh=2, **kw)
    a = t_vec.run_vecsim(cfg, **kw)
    b = t_vec.run_vecsim(cfg, rt_loc=8, **kw)
    np.testing.assert_array_equal(a.delivery_times, b.delivery_times)
    assert a.sim.queue_stats == b.sim.queue_stats and b.ring == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            t_vec.run_vecsim(cfg, dt=1e-3, allow_coarse=True)


# ---------------------------------------------------------------------------
# the single-slot oracles and the S-queue burst
# ---------------------------------------------------------------------------
def _random_state(rng, Q, D, n_occ, lead=()):
    """A queue state (numpy fields) with ``n_occ`` occupied slots at random
    positions, unique seqs, random metadata and payloads."""
    shape = lead + (Q,)
    cl = np.full(shape, -1, np.int32)
    seq = np.full(shape, t_q.EMPTY_SEQ, np.int32)
    for idx in np.ndindex(*lead):
        pos = rng.choice(Q, size=n_occ, replace=False)
        cl[idx][pos] = rng.permutation(12)[:n_occ]
        seq[idx][pos] = rng.permutation(40)[:n_occ]
    occ = cl >= 0
    return dict(
        cluster=cl,
        worker=np.where(occ, rng.integers(0, 4, shape), -1).astype(np.int32),
        seq=seq, gen_time=rng.random(shape).astype(np.float32),
        reward=np.where(occ, rng.normal(size=shape), -np.inf).astype(
            np.float32),
        agg_count=np.where(occ, rng.integers(1, 4, shape), 0).astype(
            np.int32),
        replaceable=occ & (rng.random(shape) < 0.5),
        payload=rng.normal(size=shape + (D,)).astype(np.float32),
        next_seq=np.full(lead, 40, np.int32),
        n_dropped=np.zeros(lead, np.int32), n_agg=np.zeros(lead, np.int32),
        n_repl=np.zeros(lead, np.int32), n_screened=np.zeros(lead, np.int32))


def _both(fields):
    jst = j_q.JaxQueueState(**{k: jnp.asarray(v) for k, v in fields.items()})
    tst = t_q.TorchQueueState(**{k: torch.from_numpy(np.array(v))
                                 for k, v in fields.items()})
    return jst, tst


def _assert_state_equal(jst, tst, payload_tol=None):
    """Every field exact; the payload within ``payload_tol`` (rtol, atol)
    when one is given."""
    for f in QUEUE_FIELDS:
        a, b = np.asarray(getattr(jst, f)), getattr(tst, f).numpy()
        assert a.dtype == b.dtype, f
        if f == "payload" and payload_tol is not None:
            np.testing.assert_allclose(b, a, rtol=payload_tol[0],
                                       atol=payload_tol[1])
        else:
            np.testing.assert_array_equal(a, b, err_msg=f)


@pytest.mark.parametrize("n_occ", [0, 3, 6])
def test_dequeue_one_matches_jax_dequeue(n_occ):
    """Every output field and the new state, exact, on an empty, a partly
    filled and a full queue (one queue, and three side by side against
    ``vmap(jax_dequeue)``). An empty queue names slot 0 (H2: the first
    index of a tie), with its stale fields (H6)."""
    rng = np.random.default_rng(n_occ)
    for lead in ((), (3,)):
        jst, tst = _both(_random_state(rng, 6, 5, n_occ, lead))
        for _ in range(n_occ + 1):
            deq = jax.vmap(j_q.jax_dequeue) if lead else j_q.jax_dequeue
            jst, jout = deq(jst)
            tst, tout = t_q.dequeue_one(tst)
            assert sorted(jout) == sorted(tout)
            for k in jout:
                a, b = np.asarray(jout[k]), tout[k].numpy()
                assert a.dtype == b.dtype, k
                np.testing.assert_array_equal(a, b, err_msg=k)
            _assert_state_equal(jst, tst)


@pytest.mark.parametrize("capacity,thr", [(None, np.inf), (3, 0.5), (5, 1.0)])
def test_enqueue_one_and_enqueue_batch_match_jax(capacity, thr):
    """Seeded bursts through ``enqueue_one`` (one by one) and
    ``enqueue_batch`` against ``jax_enqueue`` / ``jax_enqueue_batch``, from
    an empty queue to a full one (drops): every field exact against
    ``jax_enqueue``, and against ``jax_enqueue_batch`` but its payload,
    which XLA computes inside a compiled scan and rounds differently in the
    last bit (it differs from ``jax_enqueue``'s by as much as ours)."""
    rng = np.random.default_rng(11 if capacity is None else capacity)
    Q, D, U = 6, 5, 24
    jst, tst = _both(_random_state(rng, Q, D, 0))
    cl = rng.integers(0, 12, U).astype(np.int32)
    wk = rng.integers(0, 3, U).astype(np.int32)
    gt = rng.random(U).astype(np.float32)
    rw = rng.normal(size=U).astype(np.float32)
    pay = rng.normal(size=(U, D)).astype(np.float32)
    kw = dict(reward_threshold=thr, capacity=capacity)
    j1, t1 = jst, tst
    for u in range(U):
        j1 = j_q.jax_enqueue(j1, cl[u], wk[u], gt[u], rw[u], jnp.asarray(
            pay[u]), **kw)
        t1 = t_q.enqueue_one(t1, int(cl[u]), int(wk[u]), float(gt[u]),
                             float(rw[u]), torch.from_numpy(pay[u]), **kw)
        _assert_state_equal(j1, t1)
    assert int(t1.n_dropped) > 0 and bool((t1.cluster >= 0).any())
    jb = j_q.jax_enqueue_batch(jst, *map(jnp.asarray, (cl, wk, gt, rw, pay)),
                               **kw)
    tb = t_q.enqueue_batch(tst, *map(torch.from_numpy, (cl, wk, gt, rw, pay)),
                           **kw)
    _assert_state_equal(j1, tb)
    scan_tol = (1e-6, 1e-7)
    _assert_state_equal(jb, tb, payload_tol=scan_tol)
    np.testing.assert_allclose(np.asarray(jb.payload), np.asarray(j1.payload),
                               rtol=scan_tol[0], atol=scan_tol[1])


def test_olaf_burst_multi_matches_repro():
    """S=3 Q=8 U=16 D=24 with capacity below Q (one switch with an
    occupied slot past its capacity: H1), per-switch thresholds, a send
    mask, ``in_counts`` and ``in_replaceable``: slots, events and metadata
    exact, payloads within rtol=1e-5, atol=1e-6."""
    rng = np.random.default_rng(5)
    S, Q, U, D = 3, 8, 16, 24
    fields = _random_state(rng, Q, D, 4, (S,))
    fields["cluster"][0, 7], fields["seq"][0, 7] = 11, 39  # past capacity
    jst, tst = _both(fields)
    burst = (rng.integers(0, 12, (S, U)).astype(np.int32),
             rng.integers(0, 4, (S, U)).astype(np.int32),
             rng.random((S, U)).astype(np.float32),
             rng.normal(size=(S, U)).astype(np.float32),
             rng.normal(size=(S, U, D)).astype(np.float32))
    thr = np.asarray([np.inf, 0.5, 1.0], np.float32)
    send = rng.random((S, U)) < 0.8
    cap = np.asarray([5, 8, 6], np.int32)
    in_counts = rng.integers(1, 4, (S, U)).astype(np.int32)
    in_rp = rng.random((S, U)) < 0.5
    jres = j_ops.olaf_burst_multi(
        jst, *map(jnp.asarray, burst), jnp.asarray(thr), jnp.asarray(send),
        jnp.asarray(cap), jnp.asarray(in_counts), jnp.asarray(in_rp))
    tres = t_ops.olaf_burst_multi(
        tst, *map(torch.from_numpy, burst), torch.from_numpy(thr),
        torch.from_numpy(send), torch.from_numpy(cap),
        torch.from_numpy(in_counts), torch.from_numpy(in_rp))
    _assert_state_equal(jres[0], tres[0], payload_tol=(RTOL, ATOL))
    for a, b in zip(jres[1:], tres[1:]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    events = tres[2].numpy()
    assert {t_q.EV_DROP, t_q.EV_AGG, t_q.EV_RESET} <= set(events.ravel())
    _assert_state_equal(jst, tst)  # the input state is left untouched


# ---------------------------------------------------------------------------
# rings and the hazards
# ---------------------------------------------------------------------------
def _ring_case(trial, R=16, N=12, p_occ=0.5):
    rng = np.random.default_rng(50 + trial)
    t = np.full(R, np.inf, np.float32)
    occupied = rng.random(R) < p_occ
    t[occupied] = rng.random(occupied.sum()).astype(np.float32)
    ring = {"time": t, "val": rng.integers(0, 99, R).astype(np.int32),
            "pay": rng.normal(size=(R, 3)).astype(np.float32)}
    mask = rng.random(N) < 0.6
    rows = {"time": rng.random(N).astype(np.float32),
            "val": rng.integers(100, 199, N).astype(np.int32),
            "pay": rng.normal(size=(N, 3)).astype(np.float32)}
    return ring, mask, rows


def _torch_dict(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}


@pytest.mark.parametrize("trial", range(4))
def test_ring_insert_vec_matches_sequential_and_repro(trial):
    ring, mask, rows = _ring_case(trial)
    ovf0 = torch.tensor(False)
    ra, oa = t_vec._ring_insert(_torch_dict(ring), ovf0,
                                torch.from_numpy(mask), _torch_dict(rows))
    rb, ob, slot = t_vec._ring_insert_vec(_torch_dict(ring), ovf0,
                                          torch.from_numpy(mask),
                                          _torch_dict(rows))
    rj, oj, slot_j = j_vec._ring_insert_vec(
        {k: jnp.asarray(v) for k, v in ring.items()}, jnp.asarray(False),
        jnp.asarray(mask), {k: jnp.asarray(v) for k, v in rows.items()})
    for k in ring:
        assert torch.equal(ra[k], rb[k]), k
        np.testing.assert_array_equal(rb[k].numpy(), np.asarray(rj[k]))
    assert bool(oa) == bool(ob) == bool(oj)
    np.testing.assert_array_equal(slot.numpy(), np.asarray(slot_j))


def test_ring_rows_past_the_end_change_nothing_h21():
    """More masked rows than free slots: the rows that do not fit land
    nowhere (no exception, no write past the ring, no clamp onto a real
    row), their slot reads R and ``ovf`` is set, as with ``repro``'s
    ``mode="drop"`` scatter."""
    ring, mask, rows = _ring_case(0, R=8, N=12, p_occ=0.75)
    mask[:] = True
    free = np.isinf(ring["time"])
    n_free = int(free.sum())
    assert 0 < n_free < mask.sum()
    rb, ob, slot = t_vec._ring_insert_vec(
        _torch_dict(ring), torch.tensor(False), torch.from_numpy(mask),
        _torch_dict(rows))
    assert bool(ob)
    assert (slot.numpy()[n_free:] == 8).all()
    np.testing.assert_array_equal(np.sort(slot.numpy()[:n_free]),
                                  np.flatnonzero(free))
    for k in ring:
        got = rb[k].numpy()
        np.testing.assert_array_equal(got[~free], ring[k][~free])
        np.testing.assert_array_equal(got[np.flatnonzero(free)],
                                      rows[k][:n_free])


def test_delivery_log_overflow_is_reported_not_raised_h21(monkeypatch):
    """A delivery log too short for the run: the writes past its end land
    in its scratch row, the step raises nothing, and the run reports the
    overflow as ``repro`` does."""
    real = t_vec.compile_scenario

    def short_log(*a, **kw):
        comp = real(*a, **kw)
        comp.static = comp.static._replace(Gc=2, Gd=1)
        return comp

    monkeypatch.setattr(t_vec, "compile_scenario", short_log)
    with pytest.raises(RuntimeError, match="buffer overflow"):
        t_vec.run_vecsim(to_port(_faulty_fattree("static")), dt=2.0 ** -9,
                         allow_coarse=True, device="cpu")


def test_route_hash_matches_numpy_uint32_h22():
    """The ``hash`` route's key against numpy uint32 arithmetic on values
    whose products and sums wrap at 2**32 (worker -1 included)."""
    rng = np.random.default_rng(3)
    n = 4096
    cl = rng.integers(0, 2**31 - 1, n).astype(np.int32)
    wk = rng.integers(-1, 2**31 - 1, n).astype(np.int32)
    wk[:16] = -1
    sw = rng.integers(0, 2**31 - 1, n).astype(np.int64)
    m = rng.integers(1, 9, n).astype(np.int32)
    with np.errstate(over="ignore"):
        want = (cl.astype(np.uint32) * np.uint32(2654435761)
                + wk.astype(np.uint32) * np.uint32(40503)
                + sw.astype(np.uint32) * np.uint32(9176))
    got = t_vec.route_hash(torch.from_numpy(cl), torch.from_numpy(wk),
                           torch.from_numpy(sw))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(
        (got % torch.from_numpy(m).to(torch.int64)).numpy(),
        (want % m.astype(np.uint32)).astype(np.int64))


# ---------------------------------------------------------------------------
# the hybrid's vectorized backend and the scenario command
# ---------------------------------------------------------------------------
def test_hybrid_vectorized_matches_window_and_repro():
    """``run_hybrid_multihop(sim_impl="vectorized")`` on the CPU: the same
    (metadata, payload) stream as the port's window replay, and every
    ``HybridResult`` field of ``repro``'s vectorized hybrid but
    ``launches`` (one per step here, 1 fused scan there)."""
    kw = dict(dim=16, seed=3, horizon=0.1)  # tests/test_vecsim.py's case
    rw, _ = t_hybrid(sim_impl="window", device="cpu", **kw)
    rv, _ = t_hybrid(sim_impl="vectorized", device="cpu", **kw)
    rj, _ = j_hybrid(sim_impl="vectorized", **kw)

    def skey(x):
        t, u, _ = x
        return (u.cluster_id, u.worker_id, u.gen_time, u.agg_count,
                u.subsumed, t)

    assert len(rw.delivered) == len(rv.delivered) == len(rj.delivered) > 0
    for (tw, uw, pw), (tv, uv, pv) in zip(sorted(rw.delivered, key=skey),
                                          sorted(rv.delivered, key=skey)):
        assert abs(tw - tv) <= 2e-5 * max(1.0, tw)
        assert (uw.cluster_id, uw.worker_id, uw.agg_count, uw.subsumed) \
            == (uv.cluster_id, uv.worker_id, uv.agg_count, uv.subsumed)
        assert pv.device.type == "cpu"
        np.testing.assert_allclose(pw.numpy(), pv.numpy(), rtol=RTOL,
                                   atol=ATOL)
    assert rw.queue_stats == rv.queue_stats
    assert rw.residual_slot_counts == rv.residual_slot_counts
    for (tj, uj, pj), (tv, uv, pv) in zip(rj.delivered, rv.delivered):
        assert tj == tv and _update_key(uj) == _update_key(uv)
        np.testing.assert_allclose(pv.numpy(), np.asarray(pj), rtol=RTOL,
                                   atol=ATOL)
    for f in dataclasses.fields(rj):
        if f.name in ("delivered", "launches"):
            continue
        a, b = getattr(rj, f.name), getattr(rv, f.name)
        if isinstance(a, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name
    assert rj.launches == 1 and rv.launches > 1


@pytest.mark.parametrize("sim_dt", [None, "0.002"])
def test_scenario_command_vectorized_matches_repro(capsys, sim_dt):
    """``--mode scenario --sim-impl vectorized`` on the CPU, on the exact
    grid and on a uniform one (``--sim-dt``, no event heap): the summary
    line's counts equal ``repro``'s, and its h2d count; its launch count
    is the number of steps (``repro`` fuses them into one scan)."""
    dt_args = [] if sim_dt is None else ["--sim-dt", sim_dt]
    got = port_train.main(["--mode", "scenario", "--topology", "fattree",
                           "--fattree-k", "2", "--sim-dim", "24",
                           "--sim-impl", "vectorized", "--device", "cpu"]
                          + dt_args)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("scenario fattree [vectorized]: ")
    want = jax_run_scenario(argparse.Namespace(
        topology="fattree", fattree_k=2, fattree_spines=1, seed=0,
        sim_dim=24, sim_impl="vectorized", sim_dt=sim_dt, sim_shards=1,
        sim_worker_shards=1))
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert len(got.delivered) == len(want.delivered) > 0
    assert line.split(";")[0] == want_line.split(";")[0]
    launches, h2d = line.split(";")[1].split(",")
    assert h2d == want_line.split(";")[1].split(",")[1]
    assert launches.strip() == f"{got.launches} combine launches"
    assert want.launches == 1 and got.launches > 1
    assert got.queue_stats == want.queue_stats
    assert got.forwarded == want.forwarded
