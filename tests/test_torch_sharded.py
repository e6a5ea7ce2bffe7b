"""The port's sharded vectorized simulator and ``distributed/sharding.py``
against ``repro``'s, on meshes of CPU devices.

``repro`` runs its sharded scan with ``shard_map`` from one process over
``jax.devices()``; the port runs one process over a mesh of
``torch.device``s, and an explicit device list may name the CPU several
times (the counterpart of ``repro``'s forced host device count). Every
sharded run is held bit for bit to ``repro``'s single-device
``run_vecsim`` on every field ``tests/test_vecsim_sharded.py``'s
``assert_sharded_bitwise`` compares, and to the port's own single-device
run, on ``repro``'s two randomized fault-injected configurations at
meshes (2,1), (4,1), (2,2) and (1,2). The forced local-ring and width
retries, the mesh checks, the k=8 compile path, ``olaf_step_sharded`` /
``olaf_step_multi``, the hybrid's switch mesh, the CLI's ``--sim-shards``
and the hazards H25 (a shard's switch ids), H26 (no aliasing between a
gathered tensor and a shard's carry) and H27 (the step loops' inference
mode) are pinned here.
"""
import argparse
import dataclasses
import io
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import vecsim as j_vec  # noqa: E402
from repro.core.hybrid import run_hybrid_multihop as j_hybrid  # noqa: E402
from repro.core.olaf_queue import jax_queue_init  # noqa: E402
from repro.core.topology import build_sim_cfg, fattree_spec  # noqa: E402
from repro.kernels import ops as j_ops  # noqa: E402
from repro.launch.train import run_scenario as jax_run_scenario  # noqa: E402
from repro_torch.core import olaf_queue  # noqa: E402
from repro_torch.core import topology as t_topo  # noqa: E402
from repro_torch.core import vecsim as t_vec  # noqa: E402
from repro_torch.core.hybrid import run_hybrid_multihop as t_hybrid  # noqa: E402
from repro_torch.core.olaf_queue import TorchQueueState, queue_init  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kernels import ops as t_ops  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from test_vecsim import _counters  # noqa: E402
from test_vecsim_sharded import _random_sharded_cfg  # noqa: E402

DIM = 2  # assert_sharded_bitwise's
RTOL, ATOL = 1e-5, 1e-6
MESHES = [(2, 1), (4, 1), (2, 2), (1, 2)]


def to_port(obj):
    """``obj`` (a ``repro`` netsim configuration) rebuilt from the port's
    classes of the same names."""
    class _Remap(pickle.Unpickler):
        def find_class(self, module, name):
            if module == "repro" or module.startswith("repro."):
                module = "repro_torch" + module[len("repro"):]
            return super().find_class(module, name)

    return _Remap(io.BytesIO(pickle.dumps(obj))).load()


def cpu_mesh(ns, nw):
    """An (ns, nw) ("switch", "worker") mesh of CPU entries."""
    return sharding.Mesh(np.array(["cpu"] * (ns * nw), dtype=object)
                         .reshape(ns, nw), ("switch", "worker"))


def assert_bitwise(a, b):
    """``assert_sharded_bitwise``'s fields, no tolerance anywhere; ``a``
    may be ``repro``'s result or the port's."""
    np.testing.assert_array_equal(a.delivery_times, b.delivery_times)
    np.testing.assert_array_equal(np.asarray(a.delivered_payloads),
                                  b.delivered_payloads.numpy())
    np.testing.assert_array_equal(a.final_counts, b.final_counts)
    assert a.aom == b.aom
    assert a.residual == b.residual
    assert a.sim.queue_stats == b.sim.queue_stats
    assert _counters(a.sim) == _counters(b.sim)
    assert a.sim.drops_by_switch == b.sim.drops_by_switch
    assert a.sim.reroutes_by_switch == b.sim.reroutes_by_switch

    def keys(updates):
        return [(u.cluster_id, u.worker_id, u.gen_time, u.reward,
                 u.agg_count, u.subsumed) for u in updates]

    assert keys(a.sim.delivered_updates) == keys(b.sim.delivered_updates)


@pytest.fixture(scope="module")
def trials():
    """trial -> (port cfg, repro result, port single-device result), each
    computed once."""
    cache = {}

    def get(trial):
        if trial not in cache:
            cfg = _random_sharded_cfg(trial)
            pcfg = to_port(cfg)
            cache[trial] = (pcfg, j_vec.run_vecsim(cfg, dim=DIM),
                            t_vec.run_vecsim(pcfg, dim=DIM, device="cpu"))
        return cache[trial]

    return get


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
@pytest.mark.parametrize("trial", [0, 1])
def test_sharded_equals_repro_single_device(trials, trial, mesh):
    pcfg, want, single = trials(trial)
    got = t_vec.run_vecsim(pcfg, dim=DIM, mesh=cpu_mesh(*mesh))
    assert_bitwise(want, got)
    assert_bitwise(single, got)
    assert got.passes == 1 and got.h2d_transfers == single.h2d_transfers
    assert got.n_steps == single.n_steps


def _hash_cfg():
    """A dyadic fat-tree k=2 with two cores under the ``hash`` route: two
    multipath aggregation switches that land on different switch shards."""
    spec = fattree_spec(2, spines=2, edge_gbps=2 ** 19 / 1e9,
                        agg_gbps=2 ** 20 / 1e9, core_gbps=2 ** 21 / 1e9,
                        prop_delay=2.0 ** -12, route_policy="hash")
    return build_sim_cfg(spec, clusters_per_ingress=1, workers_per_cluster=2,
                         gen_interval=2.0 ** -7, gen_jitter=0.0,
                         size_bits=8192, horizon=0.125, seed=5)


@pytest.fixture(scope="module")
def hash_run():
    cfg = _hash_cfg()
    return to_port(cfg), j_vec.run_vecsim(cfg, dim=DIM)


def test_forced_ring_and_width_retries_keep_the_result(hash_run):
    """``rt_loc=2`` overflows a local ring (``trl``) and ``width=1`` the
    burst width: the one retry loop repeats the run, wider each time, to
    the same bits."""
    pcfg, want = hash_run
    got = t_vec.run_vecsim(pcfg, dim=DIM, mesh=(2, 1), device=["cpu"] * 2,
                           rt_loc=2, width=1)
    assert got.passes > 2 and got.ring > 2 and got.width > 1
    assert_bitwise(want, got)


def test_mesh_rejects_bad_shape(trials):
    pcfg = trials(0)[0]
    with pytest.raises(ValueError, match="not divisible"):
        t_vec.run_vecsim(pcfg, dim=DIM, mesh=(3, 1), device=["cpu"] * 3)
    # a mesh larger than the visible devices, given without a device list
    with pytest.raises(ValueError, match="needs 4 devices, only 1"):
        t_vec.run_vecsim(pcfg, dim=DIM, mesh=(2, 2), device="cpu")
    with pytest.raises(ValueError, match="needs 2 devices, only 1"):
        t_vec.run_vecsim(pcfg, dim=DIM, mesh=2, device=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            sharding.vecsim_mesh(8)


def test_meshes_from_device_lists():
    cpu = ["cpu"] * 8
    assert sharding.vecsim_mesh(80, devices=cpu).shape == \
        {"switch": 8, "worker": 1}
    assert sharding.vecsim_mesh(4, worker_shards=2, devices=cpu).shape == \
        {"switch": 4, "worker": 2}
    assert sharding.vecsim_mesh(4, worker_shards=4, n_clusters=2,
                                devices=cpu).shape == {"switch": 4,
                                                       "worker": 2}
    assert sharding.switch_mesh(21, devices=cpu[:3]).shape == {"switch": 3}
    assert sharding.switch_mesh(3, devices=cpu[:2]).shape == {"switch": 1}
    m = sharding.vecsim_mesh(3, devices=cpu[:4])
    assert t_vec._mesh_shape(m) == (2, 1) and t_vec._mesh_shape(4) == (4, 1)
    assert all(d == torch.device("cpu") for d in m.devices.flat)


def test_fattree_k8_compiles():
    """The port's ``compile_scenario`` stages the 80-switch k=8 fat-tree
    padded to a switch count the 8-shard mesh divides."""
    spec = t_topo.fattree_spec(8, spines=8)
    assert len(spec.switches) == 80
    cfg = t_topo.build_sim_cfg(spec, gen_interval=2.0 ** -6, gen_jitter=0.0,
                               size_bits=8192, horizon=0.125)
    comp = t_vec.compile_scenario(cfg)
    st = comp.static
    assert comp.n_real_switches == 80
    assert st.S >= 80 and st.S % 8 == 0
    assert comp.arrays["cand"].shape[0] == st.S
    is_eg = np.asarray(comp.arrays["is_eg"]).astype(bool)
    assert (comp.wire[is_eg] == 0).all()
    assert (comp.wire[~is_eg][:72] > 0).all()
    assert 2 <= t_vec._default_ring(comp, 8) <= st.Rt


# ---- H25: a shard's switch ids are the original ones -------------------------
def test_hash_route_uses_original_switch_ids_h25(hash_run):
    """The ``hash`` route keys on the switch's own id: after the stripe
    permutation row ``i`` of shard ``d`` is switch ``i*ns + d``, not ``i``.
    Two multipath aggregation switches on different shards reroute by
    their own ids, bit for bit as ``repro``'s single device."""
    pcfg, want = hash_run
    got = t_vec.run_vecsim(pcfg, dim=DIM, mesh=(4, 1), device=["cpu"] * 4)
    assert len(want.sim.reroutes_by_switch) == 2 and want.forwarded > 0
    assert_bitwise(want, got)


# ---- H26: a gathered tensor never aliases a shard's carry ---------------------
def test_gathers_are_fresh_tensors_h26(trials):
    """``all_gather`` of one part is a copy, ``x.to(dev)`` on its own
    device is ``x`` itself, and a gathered carry shares no storage with the
    shards' carries: stepping on after the gather does not change it."""
    x = torch.arange(4)
    assert x.to("cpu") is x
    g = sharding.all_gather([x])
    assert g.data_ptr() != x.data_ptr() and torch.equal(g, x)
    assert sharding.psum([torch.tensor(True), torch.tensor(True)]).item() == 2
    pcfg = trials(0)[0]
    comp = t_vec.compile_scenario(pcfg, dim=DIM)
    grid = t_vec.uniform_grid(pcfg, 2.0 ** -8, allow_coarse=True)
    ts = torch.from_numpy(grid)
    runner = t_vec._ShardedRunner(
        comp.static, t_vec._stage(comp.arrays, torch.device("cpu")),
        np.array([[torch.device("cpu")]], dtype=object), 8,
        float(comp.arrays["horizon"]), comp.static.Rt)
    carry = runner.run(runner.init_carry(), ts[:16])
    out = runner.gather(carry)
    ptrs = set()
    for part in (carry["sw"][0], carry["wk"][0]):
        t_vec._tree_map(lambda t: ptrs.add(t.untyped_storage().data_ptr()),
                        {k: v for k, v in part.items() if k != "trl"})
    snap = {}
    for key in t_vec._SWITCH_STATE + ("gptr", "aom"):
        t_vec._tree_map(
            lambda t, k=key: snap.setdefault(k, []).append(t.clone()),
            out[key])
        t_vec._tree_map(
            lambda t: ptrs.isdisjoint({t.untyped_storage().data_ptr()})
            or pytest.fail(f"{key} aliases a shard's carry"), out[key])
    runner.run(carry, ts[16:32])
    for key, before in snap.items():
        after = []
        t_vec._tree_map(lambda t: after.append(t), out[key])
        assert all(torch.equal(a, b) for a, b in zip(before, after)), key


# ---- H27: the runners step under inference mode; results are normal tensors --
def test_results_are_not_inference_tensors_h27(trials, hash_run):
    """The step loops run under ``torch.inference_mode``: their carries are
    inference tensors, but what ``run_vecsim`` returns is built after the
    loop, so a caller may update it in place."""
    single = trials(0)[2]
    pcfg = hash_run[0]
    split = t_vec.run_vecsim(pcfg, dim=DIM, mesh=(2, 1), device=["cpu"] * 2)
    for res in (single, split):
        pay = res.delivered_payloads
        assert pay.numel() and not pay.is_inference()
        pay.add_(0.0)
    comp = t_vec.compile_scenario(pcfg, dim=DIM)
    runner = t_vec._Runner(comp.static, t_vec._stage(
        comp.arrays, torch.device("cpu")), 4, float(comp.arrays["horizon"]))
    ts = torch.from_numpy(t_vec.uniform_grid(pcfg, 2.0 ** -8,
                                             allow_coarse=True))
    carry = runner.run(runner.init_carry(), ts[:4])
    assert carry["sent"].is_inference()
    runner.run(carry, ts[4:8])  # stepping on stays inside the mode


# ---- olaf_step_sharded / olaf_step_multi -------------------------------------
def _queues(S, Q, D):
    return TorchQueueState.stack([queue_init(Q, D, device="cpu")
                                  for _ in range(S)])


def _to_port_state(st):
    return TorchQueueState(**{f: torch.from_numpy(np.array(getattr(st, f)))
                              for f in TorchQueueState.__dataclass_fields__})


def _assert_cycle(want, got):
    (st_w, out_w), (st_g, out_g) = want, got
    for f in TorchQueueState.__dataclass_fields__:
        a = np.asarray(getattr(st_w, f))
        b = getattr(st_g, f).numpy()
        if f == "payload":
            np.testing.assert_allclose(b, a, rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(b, a, err_msg=f)
    for f, v in out_w.items():
        if f == "payload":
            np.testing.assert_allclose(out_g[f].numpy(), np.asarray(v),
                                       rtol=RTOL, atol=ATOL)
        else:
            np.testing.assert_array_equal(out_g[f].numpy(), np.asarray(v),
                                          err_msg=f)


def _step_burst(rng, S, U, D):
    return (rng.integers(0, 6, (S, U)).astype(np.int32),
            rng.integers(0, 3, (S, U)).astype(np.int32),
            rng.random((S, U)).astype(np.float32),
            rng.normal(size=(S, U)).astype(np.float32),
            rng.normal(size=(S, U, D)).astype(np.float32))


@pytest.mark.parametrize("caps", [None, [3, 5, 8]])
def test_olaf_step_sharded_matches_repro_single_launch(caps):
    """Three shards over a CPU mesh (one ``olaf_step_multi`` call each)
    against ``repro``'s one ``olaf_step_multi`` call, with and without a
    heterogeneous ``(S,)`` capacity vector; the port's one call equals
    both. Two cycles, so the second runs on the first's state."""
    rng = np.random.default_rng(11)
    S, Q, U, D, k = 3, 8, 9, 16, 2
    mesh = sharding.switch_mesh(S, devices=["cpu"] * 3)
    assert mesh.size == 3
    j_st = jax_queue_init(Q, D)
    j_st = type(j_st)(**{f: jnp.stack([getattr(j_st, f)] * S)
                         for f in j_st.__dataclass_fields__})
    p_one, p_sh = _queues(S, Q, D), _queues(S, Q, D)
    jcap = None if caps is None else jnp.asarray(caps, jnp.int32)
    for _ in range(2):
        burst = _step_burst(rng, S, U, D)
        j_st, j_out = j_ops.olaf_step_multi(
            j_st, *map(jnp.asarray, burst), capacity=jcap, k=k)
        tb = tuple(map(torch.from_numpy, burst))
        p_one, one_out = t_ops.olaf_step_multi(
            p_one, *tb, capacity=None if caps is None
            else torch.tensor(caps, dtype=torch.int32), k=k)
        p_sh, sh_out = sharding.olaf_step_sharded(p_sh, *tb, capacities=caps,
                                                  k=k, mesh=mesh)
        _assert_cycle((j_st, j_out), (p_one, one_out))
        _assert_cycle((j_st, j_out), (p_sh, sh_out))


def test_olaf_step_multi_heterogeneous_capacities():
    """One padded (S, Qmax) ``olaf_step_multi`` with a per-switch capacity
    vector equals single-queue cycles at each switch's exact size
    (``tests/test_topology.py``'s check, which skips off a TPU; the
    reference here is the port's own one-queue cycle)."""
    rng = np.random.default_rng(2)
    caps = [3, 5, 8]
    S, Q, U, D, k = len(caps), max(caps), 9, 16, 3
    burst = _step_burst(rng, S, U, D)
    st, out = t_ops.olaf_step_multi(
        _queues(S, Q, D), *map(torch.from_numpy, burst),
        capacity=torch.tensor(caps, dtype=torch.int32), k=k)
    for s, cap in enumerate(caps):
        st1, out1 = olaf_queue.olaf_step(
            queue_init(cap, D, device="cpu"),
            *(torch.from_numpy(b[s]) for b in burst), k)
        np.testing.assert_array_equal(st.cluster[s][:cap].numpy(),
                                      np.asarray(st1.cluster))
        assert (st.cluster[s][cap:] == -1).all()
        np.testing.assert_array_equal(out["valid"][s].numpy(),
                                      np.asarray(out1["valid"]))
        np.testing.assert_allclose(out["payload"][s].numpy(),
                                   np.asarray(out1["payload"]),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("with_reset", [False, True])
def test_olaf_combine_sharded_equals_one_call(with_reset):
    """Each shard's call equals its rows of one call; with a reset mask,
    each shard gets its slice of it."""
    rng = np.random.default_rng(5)
    S, Q, U, D = 6, 4, 8, 33
    args = (torch.from_numpy(rng.normal(size=(S, Q, D)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, (S, Q)).astype(np.int32)),
            torch.from_numpy(rng.normal(size=(S, U, D)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, Q, (S, U)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 3, (S, U)).astype(np.int32)))
    reset = torch.from_numpy(rng.random((S, Q)) < 0.4) if with_reset \
        else None
    want = t_ops.olaf_combine_multi(*args, reset=reset)
    if with_reset:
        masked = torch.where(reset, 0, args[1])
        ref = t_ops.olaf_combine_multi(args[0], masked, *args[2:])
        assert reset.any() and all(torch.equal(a, b)
                                   for a, b in zip(want, ref))
    for n in (1, 2, 3):
        got = sharding.olaf_combine_sharded(
            *args, reset=reset,
            mesh=sharding.switch_mesh(S, devices=["cpu"] * n))
        for a, b in zip(want, got):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="do not split"):
        sharding.olaf_combine_sharded(*args, mesh=cpu_mesh(4, 1))


# ---- the hybrid's switch mesh and the CLI --------------------------------------
def _hybrid_cfg(ns):
    """Three racks: three ToRs, two aggregations, one core (six switches)."""
    return ns.multirack_cfg(3, seed=7, horizon=0.2, gen_interval=0.015)


def test_hybrid_sharded_over_a_device_list_matches_repro():
    """``sharded=True`` over a list of three CPU devices (six switches, two
    a shard: three ``olaf_combine_multi`` calls per flush) against
    ``repro``'s sharded hybrid: every counter and trace field equal, rows
    within 1e-6."""
    import repro.core.topology as j_topo
    import repro_torch.core.topology as p_topo
    calls = []
    real = t_ops.olaf_combine_multi

    def counted(*a, **kw):
        calls.append(a[0].shape[0])
        return real(*a, **kw)

    want, _ = j_hybrid(16, sim_cfg=_hybrid_cfg(j_topo), sharded=True)
    t_ops.olaf_combine_multi = counted
    try:
        got, cfg = t_hybrid(16, sim_cfg=_hybrid_cfg(p_topo), sharded=True,
                            device=["cpu"] * 3)
    finally:
        t_ops.olaf_combine_multi = real
    assert len(cfg.switches) == 6 and got.launches > 0 and got.forwarded
    assert calls == [2] * (3 * got.launches)
    assert len(want.delivered) == len(got.delivered) > 0
    for (t0, u0, p0), (t1, u1, p1) in zip(want.delivered, got.delivered):
        assert t0 == t1 and dataclasses.astuple(u0) == \
            dataclasses.astuple(u1)
        np.testing.assert_allclose(p1.numpy(), np.asarray(p0), rtol=0,
                                   atol=1e-6)
    np.testing.assert_array_equal(got.final_counts,
                                  np.asarray(want.final_counts))
    for f in ("launches", "combined_updates", "forward_launches",
              "switch_launches", "forwarded", "h2d_transfers",
              "queue_stats", "residual_slot_counts", "link_dropped",
              "rerouted", "drops_by_switch"):
        assert getattr(got, f) == getattr(want, f), f


def test_scenario_command_sim_shards_matches_repro(capsys):
    """``--sim-shards 2 --sim-worker-shards 2`` on the CPU: a (1,1) mesh
    over the one CPU device, as ``repro``'s over one jax device, through
    the sharded runner; its counters equal ``repro``'s command, and the
    vectorized hybrid's ``sim_mesh`` over two CPU entries equals it bit for
    bit."""
    dt = 2.0 ** -7
    got = port_train.main(["--mode", "scenario", "--topology", "fattree",
                           "--sim-dim", "8", "--sim-impl", "vectorized",
                           "--sim-dt", str(dt), "--device", "cpu",
                           "--sim-shards", "2", "--sim-worker-shards", "2"])
    want = jax_run_scenario(argparse.Namespace(
        topology="fattree", fattree_k=2, fattree_spines=1, seed=0,
        sim_dim=8, sim_impl="vectorized", sim_dt=dt, sim_shards=2,
        sim_worker_shards=2))
    split, _ = t_hybrid(8, sim_cfg=t_topo.fattree_cfg(2, seed=0),
                        sim_impl="vectorized", sim_dt=dt,
                        sim_mesh=cpu_mesh(2, 1), device="cpu")
    for f in ("forwarded", "h2d_transfers", "queue_stats",
              "combined_updates", "link_dropped", "rerouted",
              "residual_slot_counts"):
        assert getattr(got, f) == getattr(want, f) == getattr(split, f), f
    assert len(got.delivered) == len(want.delivered) > 0
    for (t0, u0, p0), (t1, u1, p1) in zip(got.delivered, split.delivered):
        assert t0 == t1 and torch.equal(p0, p1)
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].split(";")[0] == lines[-1].split(";")[0]
