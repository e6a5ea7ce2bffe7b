"""End-to-end driver: asynchronous distributed PPO through the OLAF network.

The paper's full system on one machine: heterogeneous workers compute real
PPO gradients (CartPole), updates traverse the simulated congested network
through an OlafQueue (or FIFO for comparison), the PS applies the
reward-gated averaging rule, and new global weights flow back on the ACK
path. Prints the delivered-update statistics, final policy reward, and the
FIFO-vs-Olaf comparison. PPO and every PS drain (one ``olaf_step`` call)
run on ``--device``.

Run:  PYTHONPATH=src python -m repro_torch.examples.async_drl_train \\
          [--fast] [--updates N] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict

import torch

from repro_torch.configs.olaf_ppo import PPOConfig
from repro_torch.device import resolve_device
from repro_torch.optim.async_rules import PSConfig
from repro_torch.rl import ppo
from repro_torch.rl.async_trainer import AsyncDRLTrainer, AsyncTrainConfig
from repro_torch.rl.env import make_env


def main(argv=None) -> Dict[str, dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fast", action="store_true", help="smaller run")
    ap.add_argument("--updates", type=int, default=None)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    n_upd = args.updates or (20 if args.fast else 60)

    base = AsyncTrainConfig(
        env="cartpole",
        n_clusters=3, workers_per_cluster=2,
        n_updates_per_worker=n_upd,
        out_gbps=1.2e-3, queue_slots=2,  # heavily congested uplink
        base_interval=0.05, heterogeneity=0.6,
        ppo=PPOConfig(obs_dim=4, n_actions=2, rollout_len=128, hidden=32),
        n_envs=4, ps=PSConfig(lr=2e-3, slack=5.0), seed=0)

    env = make_env(base.env)
    out = {}
    for queue in ("fifo", "olaf"):
        cfg = dataclasses.replace(base, queue=queue)
        t0 = time.time()
        res = AsyncDRLTrainer(cfg, device=dev).run()
        final_eval = ppo.evaluate(res.final_params, env,
                                  torch.Generator(device=dev).manual_seed(7),
                                  n_envs=8, horizon=200)
        sr = res.sim_result
        print(f"[{queue:>4}] applied {res.ps.applied:4d} updates "
              f"(rejected {res.ps.rejected}), net loss {sr.loss_pct:5.1f}%, "
              f"avg AoM {sr.avg_aom()*1e3:7.1f} ms, "
              f"eval return {final_eval:6.1f}  ({time.time()-t0:.0f}s wall)")
        out[queue] = dict(applied=res.ps.applied, rejected=res.ps.rejected,
                          loss_pct=sr.loss_pct, avg_aom=sr.avg_aom(),
                          eval_return=final_eval)
    return out


if __name__ == "__main__":
    main()
