"""The slice as a whole: ``AsyncDRLTrainer`` in the port against ``repro``'s.

Both trainers run one small config with the same injected payloads (a
seeded numpy function of the worker and its call count, in place of the
PPO gradients whose random streams the two frameworks cannot share), so
the simulated network, the PS staging queue's ``olaf_step`` drains and the
reward-gated PS apply must agree: equal ``SimResult`` counters, PS counts,
reward curve and time-to-n, and PS weights within ``rtol=1e-6`` (the
staged payloads' telescoped mean is float32 in both, summed in another
order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core.txctl import TxControlConfig as JaxTxControlConfig  # noqa: E402
from repro.rl import async_trainer as jax_trainer  # noqa: E402
from repro_torch.configs.olaf_ppo import PPOConfig  # noqa: E402
from repro_torch.core.txctl import TxControlConfig  # noqa: E402
from repro_torch.rl import async_trainer  # noqa: E402

D = 941  # the paper's lander actor-critic, one jumbo frame


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


def _cfg(module, tx_cls, **kw):
    return module.AsyncTrainConfig(
        env="lander", n_clusters=2, workers_per_cluster=2,
        n_updates_per_worker=6, queue_slots=4, ps_drain_k=3,
        tx_control=tx_cls(), **kw)


def test_injected_payload_run_matches_repro():
    ref = _injected(jax_trainer.AsyncDRLTrainer)(
        _cfg(jax_trainer, JaxTxControlConfig))
    port = _injected(async_trainer.AsyncDRLTrainer)(
        _cfg(async_trainer, TxControlConfig), device="cpu")
    assert port._dim == ref._ps_queue.payload.shape[1] == D
    port.ps.w = ref.ps.w.copy()  # the two frameworks draw other inits
    want, got = ref.run(), port.run()

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
    assert (want.ps.applied, want.ps.rejected) == (got.ps.applied,
                                                   got.ps.rejected)
    assert want.ps.applied > 0 and want.sim_result.received_at_ps > 0
    assert want.reward_curve == got.reward_curve
    assert want.time_to_n_updates == got.time_to_n_updates
    np.testing.assert_allclose(got.ps.w, want.ps.w, rtol=1e-6, atol=0)
    # the staging queue ends empty and agrees field by field
    assert int((port._ps_queue.cluster >= 0).sum()) == 0
    for f in ("next_seq", "n_dropped", "n_agg", "n_repl"):
        assert int(getattr(port._ps_queue, f)) == int(getattr(ref._ps_queue, f))


def test_real_ppo_gradients_on_cpu():
    # the paper's model at full width; a shorter rollout keeps it quick
    cfg = dataclasses.replace(_cfg(async_trainer, TxControlConfig),
                              n_updates_per_worker=3,
                              ppo=PPOConfig(rollout_len=64))
    res = async_trainer.AsyncDRLTrainer(cfg, device="cpu").run(eval_every=1)
    assert res.ps.applied > 0
    assert np.isfinite(res.ps.w).all()
    flat = torch.cat([p.reshape(-1) for p in
                      (res.final_params["policy"]["w"],
                       res.final_params["value"]["b"])])
    assert bool(torch.isfinite(flat).all())
    assert len(res.eval_rewards) == 1 and np.isfinite(res.eval_rewards[0])
