"""The port's hybrid run fed by real PPO gradients, and its scenario command.

``run_hybrid_ppo`` runs on the CPU here (``device="cpu"``) at the tiny
configuration of ``tests/test_hybrid_multiswitch.py``; its gradients come
from the port's own PPO, so it is held to its invariants and to its own
event backend, not to ``repro``'s numbers. The scenario command is held to
``repro``'s on the same fat-tree trace; the command's refusals are checked
here too.
"""
import argparse

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.launch.train import run_scenario as jax_run_scenario  # noqa: E402
from repro_torch.configs.olaf_ppo import PPOConfig  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.rl.async_trainer import run_hybrid_ppo  # noqa: E402

KW = dict(ppo_cfg=PPOConfig(obs_dim=4, n_actions=2, rollout_len=8, hidden=8),
          n_envs=2, seed=1, n_clusters_per_group=2, workers_per_cluster=1,
          horizon=0.2, interval_s1=0.04, interval_s2=0.05, x1_gbps=0.5e-3,
          x2_gbps=0.5e-3, sw3_gbps=0.8e-3, size_bits=8192, sw12_slots=4,
          sw3_slots=4)


@pytest.fixture(scope="module")
def window_run():
    return run_hybrid_ppo(device="cpu", sim_impl="window", **KW)


def test_every_delivery_reaches_the_ps(window_run):
    hyb, ps, _cfg = window_run
    assert len(hyb.delivered) > 0
    assert ps.applied + ps.rejected == len(hyb.delivered)
    assert ps.applied >= 1 and np.isfinite(ps.w).all()
    payloads = [p for _, _, p in hyb.delivered]
    assert all(p.device.type == "cpu" and bool(torch.isfinite(p).all())
               for p in payloads)
    assert any(float(p.abs().max()) > 0 for p in payloads)
    assert any(u.reward != 0.0 for _, u, _ in hyb.delivered)
    assert 0 < hyb.launches <= hyb.combined_updates


def test_event_backend_gives_the_same_weights(window_run):
    hyb_w, ps_w, _ = window_run
    hyb_e, ps_e, _ = run_hybrid_ppo(device="cpu", sim_impl="event", **KW)
    np.testing.assert_array_equal(ps_w.w, ps_e.w)
    assert (ps_w.applied, ps_w.rejected) == (ps_e.applied, ps_e.rejected)
    for (_, _, p0), (_, _, p1) in zip(hyb_w.delivered, hyb_e.delivered):
        assert torch.equal(p0, p1)


def test_vectorized_backend_gives_the_window_weights(window_run):
    """``sim_impl="vectorized"`` delivers the window replay's packets (the
    same metadata, times within 2e-5 (float32 here), rows within
    rtol=1e-5, atol=1e-6: the burst sums them in another order), so the PS
    applies the same updates to within that tolerance."""
    hyb_w, ps_w, _ = window_run
    hyb_v, ps_v, _ = run_hybrid_ppo(device="cpu", sim_impl="vectorized", **KW)

    def key(d):
        t, u, _ = d
        return (u.cluster_id, u.worker_id, u.gen_time, u.agg_count, t)

    assert len(hyb_v.delivered) == len(hyb_w.delivered) > 0
    for (tw, uw, pw), (tv, uv, pv) in zip(sorted(hyb_w.delivered, key=key),
                                          sorted(hyb_v.delivered, key=key)):
        assert abs(tw - tv) <= 2e-5 * max(1.0, tw)
        # the vectorized model keeps times in float32 (hazard H4)
        assert abs(uw.gen_time - uv.gen_time) <= 1e-6 * max(1.0, uw.gen_time)
        assert (uw.cluster_id, uw.worker_id, uw.agg_count) == (
            uv.cluster_id, uv.worker_id, uv.agg_count)
        assert uv.reward == np.float32(uw.reward)
        np.testing.assert_allclose(pv.numpy(), pw.numpy(), rtol=1e-5,
                                   atol=1e-6)
    assert hyb_v.queue_stats == hyb_w.queue_stats
    assert (ps_v.applied, ps_v.rejected) == (ps_w.applied, ps_w.rejected)
    np.testing.assert_allclose(ps_v.w, ps_w.w, rtol=1e-5, atol=1e-6)


def test_without_a_card_the_default_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_hybrid_ppo(**KW)
    from repro_torch.core.hybrid import run_hybrid_multihop
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_hybrid_multihop(16)


def test_scenario_command_matches_repro(capsys):
    args = ["--mode", "scenario", "--topology", "fattree", "--fattree-k",
            "2", "--sim-dim", "24", "--device", "cpu"]
    got = port_train.main(args)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("scenario fattree [window]: ")
    want = jax_run_scenario(argparse.Namespace(
        topology="fattree", fattree_k=2, fattree_spines=1, seed=0,
        sim_dim=24, sim_impl=None, sim_dt=None, sim_shards=1,
        sim_worker_shards=1))
    assert len(got.delivered) == len(want.delivered) > 0
    for f in ("forwarded", "launches", "h2d_transfers", "queue_stats",
              "combined_updates", "switch_launches"):
        assert getattr(got, f) == getattr(want, f), f
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.split(";")[:2] == want_line.split(";")[:2]


STUB_FRONTEND = "use the family-specific example drivers for stub-frontend archs"


@pytest.mark.parametrize("argv,code,match", [
    (["--arch", "internvl2-76b", "--reduced", "--mode", "sync"],
     STUB_FRONTEND, ""),
    (["--arch", "whisper-small", "--reduced", "--mode", "olaf-async"],
     STUB_FRONTEND, "")])
def test_scenario_command_refuses_unported_modes(argv, code, match, capsys,
                                                 monkeypatch):
    """The LM modes refuse the vlm and encdec families with ``repro``'s own
    ``SystemExit`` message, before any model is built. (The scenario
    command's ``--sim-shards`` runs: ``tests/test_torch_sharded.py``.)"""
    from repro_torch.models import api

    def no_model(*a, **kw):
        raise AssertionError("a model was built")

    monkeypatch.setattr(api, "init_model", no_model)
    with pytest.raises(SystemExit) as exc:
        port_train.main(argv + ["--device", "cpu"])
    assert exc.value.code == code
    assert match in capsys.readouterr().err
