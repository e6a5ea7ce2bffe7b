"""Checkpointed PS recovery in ``AsyncDRLTrainer``: the port against ``repro``.

Both trainers run ``tests/test_node_faults.py``'s churn configuration (two
worker crashes, a slowed worker, one PS bounce, the staleness bound) on the
lander actor-critic (D = 941) with a snapshot every 3 deliveries, and the
injected payloads of ``tests/test_torch_trainer.py`` in place of the PPO
gradients whose random streams the two frameworks cannot share (H3). So the
simulated network, the snapshots, the restore after the bounce and every
drain after it must agree: every ``SimResult`` field, the PS counts,
``recovered_from``, the reward curve and time-to-n exact, PS weights within
``rtol=1e-6`` (float32 payload means summed in another order). The two
checkpoint directories hold the same steps; integer and bool arrays are
equal, float arrays within ``rtol=1e-6``, the manifests' ``extra`` equal.
A snapshot written by either package restores in the other.
"""
import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.core.netsim import FaultSpec as JaxFaultSpec  # noqa: E402
from repro.core.netsim import PSFault as JaxPSFault  # noqa: E402
from repro.core.netsim import WorkerFault as JaxWorkerFault  # noqa: E402
from repro.core.txctl import TxControlConfig as JaxTxControlConfig  # noqa: E402
from repro.rl import async_trainer as jax_trainer  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.core.netsim import FaultSpec, PSFault, WorkerFault  # noqa: E402
from repro_torch.core.olaf_queue import TorchQueueState  # noqa: E402
from repro_torch.core.txctl import TxControlConfig  # noqa: E402
from repro_torch.rl import async_trainer  # noqa: E402

D = 941  # the paper's lander actor-critic
RTOL = 1e-6
QUEUE_FIELDS = [f.name for f in dataclasses.fields(TorchQueueState)]


def _payload(worker_id: int, count: int):
    rng = np.random.default_rng([worker_id, count])
    return (rng.normal(size=D).astype(np.float32),
            float(np.float32(rng.normal())))


def _injected(trainer_cls):
    class Injected(trainer_cls):
        def _make_payload(self, now, worker_id):
            calls = self.__dict__.setdefault("_calls", {})
            calls[worker_id] = calls.get(worker_id, 0) + 1
            return _payload(worker_id, calls[worker_id])
    return Injected


def _cfg(ckpt_dir, *, jax: bool, ckpt_every: int = 3):
    """``tests/test_node_faults.py::test_trainer_ps_checkpoint_recovery``'s
    configuration on the lander env."""
    fs, pf, wf, tx = ((JaxFaultSpec, JaxPSFault, JaxWorkerFault,
                       JaxTxControlConfig) if jax else
                      (FaultSpec, PSFault, WorkerFault, TxControlConfig))
    module = jax_trainer if jax else async_trainer
    faults = fs(
        workers=[wf(worker=1, crash_t=0.4, restart_delay=0.5),
                 wf(worker=3, crash_t=0.6),
                 wf(worker=2, slowdown=2.0)],
        ps=[pf(restart_t=0.9, recovery=0.05)])
    return module.AsyncTrainConfig(
        env="lander", n_clusters=2, workers_per_cluster=2,
        n_updates_per_worker=8, queue="olaf", horizon=3.0, seed=3,
        out_gbps=1e-3, tx_control=tx(ack_timeout=0.3, max_retries=2),
        faults=faults, staleness_bound=0.5, max_stale_defers=1,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every)


def _pair(ref_dir, port_dir, **kw):
    ref = _injected(jax_trainer.AsyncDRLTrainer)(_cfg(ref_dir, jax=True, **kw))
    port = _injected(async_trainer.AsyncDRLTrainer)(
        _cfg(port_dir, jax=False, **kw), device="cpu")
    port.ps.w = ref.ps.w.copy()  # the two frameworks draw other inits
    return ref, port


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("recovery")
    ref_dir, port_dir = str(root / "repro"), str(root / "port")
    ref, port = _pair(ref_dir, port_dir)
    return dict(ref=ref, port=port, want=ref.run(), got=port.run(),
                ref_dir=ref_dir, port_dir=port_dir)


def test_recovery_run_matches_repro(runs):
    ref, port, want, got = (runs[k] for k in ("ref", "port", "want", "got"))
    assert port._dim == D
    skip = {"delivered_updates"}
    for f in dataclasses.fields(want.sim_result):
        if f.name not in skip:
            assert getattr(want.sim_result, f.name) == \
                getattr(got.sim_result, f.name), f.name
    meta = ("cluster_id", "worker_id", "gen_time", "reward", "agg_count")
    assert ([tuple(getattr(u, m) for m in meta)
             for u in want.sim_result.delivered_updates]
            == [tuple(getattr(u, m) for m in meta)
                for u in got.sim_result.delivered_updates])
    sr = got.sim_result
    assert sr.worker_crashes == 2 and sr.worker_restarts == 1
    assert sr.ps_restarts == 1 and port.ps_restarts == ref.ps_restarts == 1
    assert port.recovered_from and port.recovered_from == ref.recovered_from
    assert (want.ps.applied, want.ps.rejected) == (got.ps.applied,
                                                   got.ps.rejected)
    assert want.ps.applied > 0
    assert want.reward_curve == got.reward_curve
    assert want.time_to_n_updates == got.time_to_n_updates
    np.testing.assert_allclose(got.ps.w, want.ps.w, rtol=RTOL, atol=0)
    for f in ("next_seq", "n_dropped", "n_agg", "n_repl", "n_screened"):
        assert int(getattr(port._ps_queue, f)) == \
            int(np.asarray(getattr(ref._ps_queue, f))), f


def test_recovery_reads_a_snapshot_taken_before_the_bounce(runs):
    """The restore rolled the PS back to a snapshot taken before the PS
    bounced (``restart_t`` 0.9), at a delivery count that ``ckpt_every``
    divides; deliveries kept arriving after it."""
    port = runs["port"]
    step = port.recovered_from[0]
    assert step % 3 == 0 and 0 < step < port._deliver_count
    assert ckpt.read_manifest(runs["port_dir"], step)["extra"]["time"] < 0.9


def _steps(d):
    return sorted(f for f in os.listdir(d) if f.startswith("ckpt_"))


def test_checkpoint_files_match_repro(runs):
    ref_dir, port_dir = runs["ref_dir"], runs["port_dir"]
    assert _steps(ref_dir) == _steps(port_dir) and _steps(ref_dir)
    assert ckpt.latest_step(port_dir) == jax_ckpt.latest_step(ref_dir)
    for name in _steps(ref_dir):
        path = os.path.join(ref_dir, name)
        if name.endswith(".json"):
            with open(path) as f:
                want = json.load(f)
            with open(os.path.join(port_dir, name)) as f:
                got = json.load(f)
            assert got["extra"] == want["extra"], name
            assert got["n_arrays"] == want["n_arrays"] == 16, name
            assert {k: v["n_leaves"] for k, v in got["aux"].items()} == \
                {k: v["n_leaves"] for k, v in want["aux"].items()}, name
            continue
        with np.load(path) as a, np.load(os.path.join(port_dir, name)) as b:
            assert sorted(a.files) == sorted(b.files), name
            for k in a.files:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
                if a[k].dtype.kind == "f":
                    np.testing.assert_allclose(b[k], a[k], rtol=RTOL, atol=0,
                                               err_msg=f"{name} {k}")
                else:
                    np.testing.assert_array_equal(b[k], a[k],
                                                  err_msg=f"{name} {k}")


def _restored(trainer):
    """The state ``_on_ps_restart`` restores, as numpy."""
    q = trainer._ps_queue
    return dict(w=np.asarray(trainer.ps.w),
                g_a=None if trainer.ps.g_a is None else np.asarray(trainer.ps.g_a),
                r_g=trainer.ps.r_g, applied=trainer.ps.applied,
                rejected=trainer.ps.rejected,
                recovered_from=list(trainer.recovered_from),
                **{f: np.asarray(getattr(q, f)) for f in QUEUE_FIELDS})


def _same_restore(got, want):
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        else:
            assert got[k] == v, k


@pytest.mark.parametrize("written_by", ["repro", "port"])
def test_restore_crosses_packages(runs, written_by):
    """The port's ``_on_ps_restart`` reading ``repro``'s directory gives
    ``repro``'s restored state, and ``repro``'s reading the port's gives the
    port's own, bit for bit (both read the same files)."""
    d = runs["ref_dir" if written_by == "repro" else "port_dir"]
    ref, port = _pair(d, d)
    ref._on_ps_restart(1.0)
    port._on_ps_restart(1.0)
    want, got = _restored(ref), _restored(port)
    _same_restore(got, want)
    assert got["recovered_from"] == [ckpt.latest_step(d)]
    assert got["g_a"] is not None and np.isfinite(got["r_g"])
    for f in QUEUE_FIELDS:  # on the trainer's device, as the live queue
        v = getattr(port._ps_queue, f)
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu", f


@pytest.mark.parametrize("written_by", ["repro", "port"])
def test_snapshot_before_any_apply_keeps_minus_inf(tmp_path, written_by):
    """A snapshot taken before the PS applied anything holds ``r_g = -inf``
    and no running average: both survive the manifest's JSON both ways."""
    d = str(tmp_path / "ck")
    ref, port = _pair(d, d)
    (ref if written_by == "repro" else port)._save_ps_checkpoint(0.25)
    assert json.loads(open(os.path.join(d, "ckpt_00000000.json")).read())[
        "extra"] == dict(r_g=-np.inf, has_g_a=False, applied=0, rejected=0,
                         time=0.25)
    ref.ps.r_g = port.ps.r_g = 1.0
    ref._on_ps_restart(0.5)
    port._on_ps_restart(0.5)
    want, got = _restored(ref), _restored(port)
    _same_restore(got, want)
    assert got["r_g"] == -np.inf and got["g_a"] is None
    assert got["recovered_from"] == [0]


def test_restart_without_ckpt_dir_only_drops_the_buffer():
    ref, port = _pair(None, None)
    for t in (ref, port):
        t._ps_buf = [(0, 0, 0.1, 1.0, np.ones(D, np.float32))]
        t.ps.w = t.ps.w + 0.5
        t.ps.r_g = 2.0
    before = _restored(port)
    ref._on_ps_restart(0.5)
    port._on_ps_restart(0.5)
    assert port._ps_buf == [] == ref._ps_buf
    assert port.ps_restarts == ref.ps_restarts == 1
    _same_restore(_restored(port), before)
    assert port.recovered_from == ref.recovered_from == []


def test_restart_before_the_first_snapshot_restores_nothing(tmp_path):
    d = str(tmp_path / "empty")
    os.makedirs(d)
    ref, port = _pair(d, d)
    port._ps_buf = [(0, 0, 0.1, 1.0, np.ones(D, np.float32))]
    port.ps.r_g = 2.0
    before = _restored(port)
    ref._on_ps_restart(0.5)
    port._on_ps_restart(0.5)
    assert port._ps_buf == [] and port.ps_restarts == 1
    _same_restore(_restored(port), before)
    assert port.recovered_from == ref.recovered_from == []
    assert os.listdir(d) == []
