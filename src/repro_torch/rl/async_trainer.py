"""End-to-end asynchronous distributed DRL over the OLAF network (§2.1+§8.2).

Virtual-time discrete-event simulation of the full system: real PPO
gradients are computed when a worker's (heterogeneous) compute interval
elapses; the update packet traverses the simulated network (FIFO or
OlafQueue accelerator, optional worker-side transmission control); the PS
applies the paper's reward-gated averaging rule and multicasts the new
global weights + queue feedback back to the cluster.

This is the reproduction vehicle for Figs. 2/3/7/8: the same trainer runs
with ``queue='olaf' | 'fifo'`` and different link capacities. PPO and the
PS staging queue run on ``device``; every PS drain is one
``repro_torch.kernels.ops.olaf_step`` call, the CUDA kernel on a card.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint.ckpt import (latest_step, read_manifest,
                                         restore_checkpoint, save_checkpoint)
from repro_torch.configs.olaf_ppo import PPOConfig
from repro_torch.core.netsim import (Link, NetworkSimulator, SimCfg,
                                     SwitchCfg, WorkerCfg)
from repro_torch.core.olaf_queue import queue_init
from repro_torch.core.txctl import TxControlConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.models.rlnets import (flatten_params, init_actor_critic,
                                       unflatten_params)
from repro_torch.optim.async_rules import ParameterServer, PSConfig
from repro_torch.rl import ppo
from repro_torch.rl.env import make_env


@dataclasses.dataclass
class AsyncTrainConfig:
    env: str = "cartpole"
    n_clusters: int = 2
    workers_per_cluster: int = 2
    n_updates_per_worker: int = 30
    queue: str = "olaf"  # olaf | fifo
    queue_slots: int = 8
    out_gbps: float = 1e-5  # constrained accelerator uplink
    base_interval: float = 0.05  # mean compute time per worker iteration
    heterogeneity: float = 0.5  # worker speed spread (paper: heterogeneous)
    reward_threshold: Optional[float] = None  # queue-side gating
    tx_control: Optional[TxControlConfig] = None
    ps: PSConfig = dataclasses.field(default_factory=PSConfig)
    ppo: PPOConfig = dataclasses.field(default_factory=PPOConfig)
    n_envs: int = 4
    local_lr: float = 5e-3  # worker-side local step while awaiting ACK
    seed: int = 0
    horizon: float = 1e9
    # PS drain pipeline: every delivery is staged, and every k-th delivery
    # drains the staging queue with ONE fused ``olaf_step`` call (burst
    # enqueue + drain-k), applying the agg_count-weighted mean via
    # ``ps.on_updates``. k <= 1 drains on every delivery; ACKs between
    # drains carry the then-current (possibly stale) weights.
    ps_drain_k: int = 1
    # Optional repro_torch.core.topology.TopologySpec: replaces the single
    # "ACC" accelerator switch with the spec's whole switch DAG. Worker
    # clusters are spread round-robin over the spec's source switches;
    # ``queue`` and ``reward_threshold`` above override every switch.
    topology: Optional[object] = None
    # Optional repro_torch.core.netsim.FaultSpec: link drops / outages /
    # switch stalls / node faults, all inside the simulated network.
    faults: Optional[object] = None
    # Hard staleness admission at the PS egress (netsim); None disables it.
    staleness_bound: Optional[float] = None
    max_stale_defers: int = 1
    # Checkpointed PS recovery: every ckpt_every deliveries the PS state
    # (float64 weights + running-average gradient, gating scalars, staging
    # queue) snapshots atomically to ckpt_dir; a PSFault restart restores
    # the latest snapshot and drops the in-flight staging buffer (the
    # lost-window semantics — deliveries since the snapshot are gone).
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 0


@dataclasses.dataclass
class AsyncTrainResult:
    sim_result: object
    ps: ParameterServer
    final_params: dict
    reward_curve: List[Tuple[float, float]]  # (virtual time, r_i applied)
    eval_rewards: List[float]
    time_to_n_updates: Dict[int, float]

    @property
    def final_reward(self) -> float:
        tail = [r for _, r in self.reward_curve[-10:]]
        return float(np.mean(tail)) if tail else float("-inf")


class AsyncDRLTrainer:
    """The async-DRL trainer on ``device`` (default ``"cuda"``: raises
    without a card unless the caller passes ``device="cpu"``)."""

    def __init__(self, cfg: AsyncTrainConfig, device="cuda") -> None:
        self.device = dev = resolve_device(device)
        self.cfg = cfg
        env = make_env(cfg.env)
        self.env = env
        ppo_cfg = dataclasses.replace(
            cfg.ppo, obs_dim=env.obs_dim, n_actions=env.n_actions)
        self.ppo_cfg = ppo_cfg
        params0 = init_actor_critic(
            torch.Generator(device=dev).manual_seed(cfg.seed), ppo_cfg,
            device=dev)
        flat0, self.spec = flatten_params(params0)
        self.ps = ParameterServer(flat0.cpu().numpy(), cfg.ps)
        n_workers = cfg.n_clusters * cfg.workers_per_cluster
        self.worker_params = {i: params0 for i in range(n_workers)}
        # one stream per worker, seeded as repro seeds its worker keys
        self.worker_generators = {
            i: torch.Generator(device=dev).manual_seed(cfg.seed * 7919 + i)
            for i in range(n_workers)}
        self.deliveries_per_worker: Dict[int, int] = {i: 0 for i in range(n_workers)}
        self.reward_curve: List[Tuple[float, float]] = []
        self.time_to_n: Dict[int, float] = {}
        # clamp to the staging capacity: enqueueing more than queue_slots
        # distinct clusters per drain would silently drop staged gradients
        # through the full-queue rule
        self._drain_k = min(max(cfg.ps_drain_k, 1), cfg.queue_slots)
        self._dim = int(flat0.numel())
        self._ps_queue = queue_init(cfg.queue_slots, self._dim, device=dev)
        self._ps_buf: List[tuple] = []
        self._deliver_count = 0
        self.ps_restarts = 0
        self.recovered_from: List[int] = []  # snapshot step per PS restart
        rng = np.random.default_rng(cfg.seed)

        if cfg.topology is not None:
            switches = cfg.topology.switch_cfgs(
                queue=cfg.queue, reward_threshold=cfg.reward_threshold)
            ingress = list(cfg.topology.source_names)
        else:
            switches = [SwitchCfg(
                "ACC", queue=cfg.queue, queue_slots=cfg.queue_slots,
                uplink=Link(cfg.out_gbps * 1e9), next_hop=None,
                reward_threshold=cfg.reward_threshold)]
            ingress = ["ACC"]
        workers = []
        for i in range(n_workers):
            speed = 1.0 + cfg.heterogeneity * rng.uniform(-1, 1)
            cluster = i % cfg.n_clusters
            workers.append(WorkerCfg(
                worker_id=i, cluster_id=cluster,
                ingress_switch=ingress[cluster % len(ingress)],
                gen_interval=cfg.base_interval * speed, gen_jitter=0.3,
                n_updates=cfg.n_updates_per_worker,
                size_bits=int(32 * self._dim + 32)))
        self.sim_cfg = SimCfg(
            switches=switches, workers=workers, horizon=cfg.horizon,
            tx_control=cfg.tx_control, seed=cfg.seed,
            faults=cfg.faults,
            staleness_bound=cfg.staleness_bound,
            max_stale_defers=cfg.max_stale_defers,
            route_policy=(cfg.topology.route_policy
                          if cfg.topology is not None else "static"),
            payload_fn=self._make_payload,
            on_deliver=self._on_deliver, on_ack=self._on_ack,
            on_ps_restart=self._on_ps_restart)

    # -- worker side --------------------------------------------------------
    def _make_payload(self, now: float, worker_id: int):
        params = self.worker_params[worker_id]
        grads, mean_reward, _ = ppo.worker_iteration(
            params, self.worker_generators[worker_id], env=self.env,
            cfg=self.ppo_cfg, n_envs=self.cfg.n_envs)
        # worker keeps training locally until the new global model arrives
        self.worker_params[worker_id] = ppo.local_update(
            params, grads, self.cfg.local_lr)
        flat, _ = flatten_params(grads)
        return flat.cpu().numpy().astype(np.float32), float(mean_reward)

    # -- PS side --------------------------------------------------------------
    def _on_deliver(self, now: float, upd):
        self.deliveries_per_worker[upd.worker_id] += 1
        self._deliver_count += 1
        n_done = min(self.deliveries_per_worker.values())
        if n_done not in self.time_to_n:
            self.time_to_n[n_done] = now
        self._ps_buf.append((upd.cluster_id, upd.worker_id, upd.gen_time,
                             upd.reward, np.asarray(upd.payload, np.float32)))
        if len(self._ps_buf) >= self._drain_k:
            self._drain_ps_queue(now)
        if self.cfg.ckpt_dir and self.cfg.ckpt_every \
                and self._deliver_count % self.cfg.ckpt_every == 0:
            self._save_ps_checkpoint(now)
        return np.asarray(self.ps.w, np.float32)

    def _save_ps_checkpoint(self, now: float) -> None:
        """Atomic snapshot of the recoverable PS state, in ``repro``'s files
        (``aux/ps`` the float64 ``w`` and ``g_a``, ``aux/queue`` the staging
        queue in ``JaxQueueState``'s field order). ``save_checkpoint`` copies
        the queue to the host before it returns, so the next drain, which
        the CUDA ``olaf_step`` makes in place, cannot reach the snapshot.
        The staging buffer (``_ps_buf``) is deliberately NOT snapshotted:
        deliveries between the snapshot and a crash are the lost window."""
        ps = self.ps
        g_a = ps.g_a if ps.g_a is not None else np.zeros_like(ps.w)
        save_checkpoint(
            self.cfg.ckpt_dir, self._deliver_count,
            params=dict(w=np.asarray(ps.w, np.float32)),
            aux=dict(ps=dict(w=ps.w, g_a=g_a), queue=self._ps_queue),
            extra=dict(r_g=ps.r_g, has_g_a=ps.g_a is not None,
                       applied=ps.applied, rejected=ps.rejected, time=now))

    def _on_ps_restart(self, now: float) -> None:
        """PSFault recovery: the in-flight staging buffer is lost; the PS
        rolls back to the latest snapshot (weights, running average,
        gating scalars, staging queue, the queue back on the trainer's
        device). Without checkpointing configured the PS keeps its current
        weights and only loses the buffer."""
        self.ps_restarts += 1
        self._ps_buf = []
        d = self.cfg.ckpt_dir
        if not d:
            return
        step = latest_step(d)
        if step is None:
            return
        man = read_manifest(d, step)
        # the live queue is the ``like``: its tensors' device and dtypes
        like = dict(ps=dict(w=self.ps.w, g_a=np.zeros_like(self.ps.w)),
                    queue=self._ps_queue)
        _, _, _, aux = restore_checkpoint(
            d, step, params_like=dict(w=np.asarray(self.ps.w, np.float32)),
            aux_like=like)
        self.ps.w = aux["ps"]["w"]
        self.ps.g_a = aux["ps"]["g_a"] if man["extra"]["has_g_a"] else None
        self.ps.r_g = man["extra"]["r_g"]
        self.ps.applied = man["extra"]["applied"]
        self.ps.rejected = man["extra"]["rejected"]
        self._ps_queue = aux["queue"]
        self.recovered_from.append(step)

    def _drain_ps_queue(self, now: float) -> int:
        """One fused ``olaf_step`` call (burst enqueue + drain-k) over the
        staged deliveries; applies the drained block via
        ``ps.on_updates``. Returns the number of updates popped. With
        nothing staged (the final flush) the burst is empty and the call
        only drains."""
        dev = self.device
        c, w, t, r, p = (zip(*self._ps_buf) if self._ps_buf
                         else ((), (), (), (), ()))
        self._ps_buf = []
        payloads = (np.stack(p) if p
                    else np.zeros((0, self._dim), np.float32))
        burst = (torch.tensor(c, dtype=torch.int32, device=dev),
                 torch.tensor(w, dtype=torch.int32, device=dev),
                 torch.tensor(t, dtype=torch.float32, device=dev),
                 torch.tensor(r, dtype=torch.float32, device=dev),
                 torch.from_numpy(payloads).to(dev))
        self._ps_queue, out = ops.olaf_step(self._ps_queue, *burst,
                                            k=self._drain_k)
        out = {n: v.cpu().numpy() for n, v in out.items()}
        valid = out["valid"]
        if not valid.any():
            return 0
        rewards = out["reward"][valid]
        self.ps.on_updates(now, out["payload"][valid], rewards,
                           out["gen_time"][valid], out["agg_count"][valid])
        if self.ps.reward_log and self.ps.reward_log[-1][2]:
            self.reward_curve.append((now, float(rewards.max())))
        return int(valid.sum())

    def _on_ack(self, now: float, worker_id: int, payload):
        if payload is not None:
            self.worker_params[worker_id] = unflatten_params(
                torch.from_numpy(np.asarray(payload, np.float32)).to(self.device),
                self.spec)

    # -- run ------------------------------------------------------------------
    def run(self, eval_every: int = 0) -> AsyncTrainResult:
        sim = NetworkSimulator(self.sim_cfg)
        res = sim.run()
        # flush the partial staging buffer, then keep draining until the
        # staging queue pops nothing
        while self._drain_ps_queue(sim.now):
            pass
        final = unflatten_params(
            torch.from_numpy(np.asarray(self.ps.w, np.float32)).to(self.device),
            self.spec)
        evals: List[float] = []
        if eval_every:
            evals.append(ppo.evaluate(
                final, self.env,
                torch.Generator(device=self.device).manual_seed(123)))
        return AsyncTrainResult(
            sim_result=res, ps=self.ps, final_params=final,
            reward_curve=self.reward_curve, eval_rewards=evals,
            time_to_n_updates=self.time_to_n)


def run_hybrid_ppo(*, env: str = "cartpole",
                   ppo_cfg: Optional[PPOConfig] = None,
                   ps_cfg: Optional[PSConfig] = None, n_envs: int = 2,
                   local_lr: float = 5e-3, seed: int = 0,
                   sharded: bool = True, batched: bool = True,
                   topology=None, flush_cadence: bool = True,
                   sim_impl: Optional[str] = None, sim_mesh=None,
                   device="cuda", **multihop_kw):
    """Multi-switch hybrid run fed by real PPO gradients end to end: the
    counterpart of ``repro.rl.async_trainer.run_hybrid_ppo``.

    Every generated update's payload is the owning worker's flattened PPO
    gradient (its reward the episode mean) from its current local params,
    computed on ``device``; each worker draws from its own
    ``torch.Generator`` seeded ``seed * 7919 + worker_id``. The netsim
    trace carries metadata only and is replayed by
    :func:`repro_torch.core.hybrid.run_hybrid_multihop` on ``device`` (the
    ``olaf_combine`` kernel lands every window on a card), and every PS
    delivery goes through ``ParameterServer.on_updates`` with its combined
    packet's ``agg_count`` weight, reward and generation time.

    ``topology`` is a ``TopologySpec`` or a prebuilt ``SimCfg``; the
    default is the §8.3 SW1/SW2/SW3 fan-in of ``multihop_cfg(
    **multihop_kw)``. ``sim_impl`` is ``"event"``, ``"window"``, None
    (keep ``batched``) or ``"vectorized"`` (the whole scenario through
    :func:`repro_torch.core.vecsim.run_vecsim` on ``device``, the
    gradients' rewards on each worker's generation schedule); ``sim_mesh``
    shards that model (:func:`~repro_torch.core.hybrid.run_hybrid_multihop`).
    ``device``
    defaults to ``"cuda"`` and raises without a card unless the caller
    passes ``"cpu"``.

    Returns ``(HybridResult, ParameterServer, SimCfg)``.
    """
    from repro_torch.core.hybrid import run_hybrid_multihop
    from repro_torch.core.netsim import multihop_cfg
    from repro_torch.core.topology import resolve_sim_cfg

    dev = resolve_device(device)
    env_obj = make_env(env)
    pcfg = dataclasses.replace(ppo_cfg or PPOConfig(),
                               obs_dim=env_obj.obs_dim,
                               n_actions=env_obj.n_actions)
    params0 = init_actor_critic(
        torch.Generator(device=dev).manual_seed(seed), pcfg, device=dev)
    flat0, _ = flatten_params(params0)
    dim = int(flat0.numel())

    if topology is None:
        cfg = multihop_cfg("olaf", seed=seed, **multihop_kw)
    else:
        cfg = resolve_sim_cfg(topology, seed=seed, **multihop_kw)
    worker_params = {w.worker_id: params0 for w in cfg.workers}
    worker_generators = {
        w.worker_id: torch.Generator(device=dev).manual_seed(
            seed * 7919 + w.worker_id) for w in cfg.workers}

    def payload_source(now: float, worker_id: int):
        params = worker_params[worker_id]
        grads, mean_reward, _ = ppo.worker_iteration(
            params, worker_generators[worker_id], env=env_obj, cfg=pcfg,
            n_envs=n_envs)
        # the worker keeps training locally while its update is in flight
        worker_params[worker_id] = ppo.local_update(params, grads, local_lr)
        flat, _ = flatten_params(grads)
        return flat.cpu().numpy().astype(np.float32), float(mean_reward)

    hyb, cfg = run_hybrid_multihop(dim, seed=seed,
                                   payload_source=payload_source,
                                   sim_cfg=cfg, sharded=sharded,
                                   batched=batched,
                                   flush_cadence=flush_cadence,
                                   sim_impl=sim_impl, sim_mesh=sim_mesh,
                                   device=dev)
    ps = ParameterServer(flat0.cpu().numpy(), ps_cfg or PSConfig())
    for t, upd, row in hyb.delivered:  # deliveries -> reward-gated PS apply
        ps.on_updates(t, row.cpu().numpy().astype(np.float32)[None],
                      np.asarray([upd.reward]), np.asarray([upd.gen_time]),
                      np.asarray([upd.agg_count]))
    return hyb, ps, cfg


def time_to_reward_speedup(cfg_base: AsyncTrainConfig, n_target: int,
                           device="cuda") -> Tuple[float, float, float]:
    """Fig. 7 metric: FIFO time / Olaf time to deliver n_target updates from
    every worker."""
    t = {}
    for q in ("fifo", "olaf"):
        cfg = dataclasses.replace(cfg_base, queue=q)
        res = AsyncDRLTrainer(cfg, device=device).run()
        t[q] = res.time_to_n_updates.get(
            n_target, max(res.time_to_n_updates.values(), default=np.inf))
    return t["fifo"], t["olaf"], t["fifo"] / t["olaf"]
