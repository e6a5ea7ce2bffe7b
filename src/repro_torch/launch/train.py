"""Command-line entry point of the port: ``python -m repro_torch.launch.train``.

The counterpart of ``repro.launch.train``, with its flags plus ``--device``
(default ``cuda``; raises without a card). Three modes:

  * ``sync`` — plain LM training: one global batch per step,
    ``api.loss_fn`` under autograd, AdamW (:func:`run_sync`);
  * ``olaf-async`` — N workers compute gradients on their own data shards
    and push flat float32 rows through the OLAF data plane; the PS applies
    what each cycle drains (:func:`run_olaf_async`, around :func:`ps_step`);
  * ``scenario`` — a network topology scenario replayed through the hybrid
    multi-switch data plane (:func:`run_scenario`).

The LM modes train the dense, moe, ssm and hybrid families; vlm and encdec
exit as ``repro``'s do (their stub frontends have family-specific
drivers). The scenario mode takes ``--sim-impl vectorized`` (and
``--sim-dt``); ``--sim-shards``/``--sim-worker-shards`` above 1 run it
sharded over ``vecsim_mesh`` of the visible cards (the one CPU device with
``--device cpu``), as ``repro``'s over ``jax.devices()``. ``--step-impl``
picks the PS step's ``olaf_step`` route as ``repro``'s does: ``auto`` by
the device (``kernels/ops.py``), ``xla`` the plain version, ``pallas`` the
CUDA kernel (raising off a card). Examples:

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --reduced --mode olaf-async --workers 4 --steps 8 --device cpu
    python -m repro_torch.launch.train --arch smollm-360m --mode olaf-async \\
        --workers 4 --batch 32 --seq 256 --ingress-screen --steps 6
    PYTHONPATH=src python -m repro_torch.launch.train --mode scenario \\
        --topology fattree --fattree-k 4 --sim-dim 941 --sim-impl window
    PYTHONPATH=src python -m repro_torch.launch.train --mode scenario \\
        --topology fattree --fattree-k 2 --sim-dim 24 --sim-impl vectorized \\
        --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.checkpoint.ckpt import (latest_step, restore_checkpoint,
                                         save_checkpoint)
from repro_torch.configs import get_config
from repro_torch.core.aom import (TorchAoMState, aom_average, aom_init,
                                  aom_update_block, staleness_mask)
from repro_torch.core.hybrid import run_hybrid_multihop
from repro_torch.core.olaf_queue import (TorchQueueState, queue_init,
                                         screen_mask)
from repro_torch.core.topology import fattree_cfg, multirack_cfg
from repro_torch.core.txctl import (TorchTxState, TxControlConfig, txctl_ack,
                                    txctl_gate, txctl_init, txctl_set_active)
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.distributed.sharding import vecsim_mesh
from repro_torch.kernels import ops
from repro_torch.kernels.olaf_robust import MAX_ROWS
from repro_torch.models import api
from repro_torch.models.module import (flat_size, flatten_like, tree_leaves,
                                       tree_map, tree_unflatten,
                                       unflatten_like)
from repro_torch.optim.optimizers import (OptConfig, OptState, apply_updates,
                                          init_opt_state)

#: The sliding window (virtual time) of netsim's active clusters: N in the
#: ACK's feedback counts the clusters that sent within it.
ACTIVE_WINDOW = 1.0


# --------------------------------------------------------------------------
# Gradients and host-to-device staging
# --------------------------------------------------------------------------
def to_device(a, dev: torch.device) -> torch.Tensor:
    """A copy of a host array (or numpy scalar) on ``dev``; to a card
    through pinned memory without waiting (the caching host allocator keeps
    the pinned block until the copy is done), so the host runs ahead of the
    card."""
    t = torch.from_numpy(np.array(a))
    if dev.type != "cuda":
        return t
    return t.pin_memory().to(dev, non_blocking=True)


def init_params(cfg, seed: int, dev: torch.device):
    """Random weights from ``seed``, drawn on the CPU and moved to ``dev``:
    one seed gives the same model on every device, so a run on a card can
    be held to the same run on the CPU."""
    params = api.init_model(torch.Generator().manual_seed(seed), cfg)
    return tree_map(lambda x: x.to(dev), params)


def loss_and_grads(params, batch, cfg
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``api.loss_fn`` and its gradient by autograd, ``jax.value_and_grad``
    of ``repro``'s: ``(loss, grads)`` with ``grads`` in ``tree_leaves``
    order (sorted keys), each in its param's dtype."""
    leaves = [x.detach().requires_grad_(True) for x in tree_leaves(params)]
    with tracing.span("worker.forward"):
        loss = api.loss_fn(tree_unflatten(params, leaves), batch, cfg)
    with tracing.span("worker.backward"):
        grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), list(grads)


def worker_grad(params, batch, cfg, out: torch.Tensor) -> torch.Tensor:
    """One worker's update: the loss, with its flat float32 gradient written
    into ``out`` (D,) (a row of the burst buffer) in ``repro``'s order."""
    with tracing.span("worker.grad"):
        loss, grads = loss_and_grads(params, batch, cfg)
        flatten_like(grads, out)
    return loss


# --------------------------------------------------------------------------
# The PS step
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class PSConfig:
    """What stays fixed over a run of :func:`ps_step`."""

    drain_k: int
    q_max: float  # the queue capacity, piggybacked in every ACK
    tx: TxControlConfig  # Δ̄_T and the slope v of the send gate
    opt: OptConfig
    cluster_of: torch.Tensor  # (W,) int32: each worker's cluster
    screen: bool = False  # the ingress screen and the trimmed fallback
    screen_factor: float = 16.0
    robust_threshold: float = 0.25
    stale_bound: Optional[float] = None  # PS admission bound (virtual time)
    step_impl: str = "auto"  # ops.olaf_step's route: auto | xla | pallas


@dataclasses.dataclass
class PSState:
    """The whole asynchronous training plane on the PS's device."""

    queue: TorchQueueState
    params: dict
    opt_state: OptState
    tx: TorchTxState
    aom: TorchAoMState
    last_seen: torch.Tensor  # (n_clusters,) float32: last send per cluster
    med: torch.Tensor  # 0-dim float32: the screen's scale estimate
    gen: torch.Generator  # the send gate's draws


def ps_step(state: PSState, burst: Dict[str, torch.Tensor], *, cfg: PSConfig
            ) -> Tuple[PSState, Dict[str, torch.Tensor]]:
    """One PS cycle over a burst of U worker updates, ``repro``'s
    ``ps_step`` of ``run_olaf_async``, in its order:

      1. the §5 send gate (``txctl_gate``; ``burst["uniforms"]`` replaces
         the generator's draws when given);
      2. the ingress screen (``cfg.screen``);
      3. ``ops.olaf_step``: Algorithm 1 over the burst, then drain-k (one
         CUDA kernel launch on a card, which updates the queue in place);
      4. the staleness bound;
      5. the agg_count-weighted mean of the drained rows, or (under the
         screen) the trimmed combine when the screened share of the burst
         exceeds ``cfg.robust_threshold``: ``ops.olaf_robust_combine``, one
         CUDA kernel launch on a card that selects on the device;
      6. ``unflatten_like`` and 7. ``apply_updates``;
      8. the AoM integral over the drained rows;
      9. the last send time per cluster (a running max) and 10. the
         number of clusters active in the window;
      11. the multicast ACK to every worker of a drained cluster.

    Under :mod:`repro_torch.tracing` the body is the span ``ps.step``, tiled
    by ``ps.gate`` (1), ``ps.screen`` (2), ``ps.olaf_step`` (3-4),
    ``ps.combine`` (5), ``ps.apply`` (6-7) and ``ps.feedback`` (8-11 and
    the stats).

    ``burst`` holds ``now`` (0-dim float32), ``clusters``, ``workers``
    (U,) int32, ``times``, ``rewards``, ``losses`` (U,) float32,
    ``payloads`` (U, D) float32 in ``tree_leaves`` order, and optionally
    ``active`` (W,) bool (expires the drained rows of crashed workers) and
    ``uniforms`` (U,) float32, all on the PS's device. Returns the new
    state and the step's stats as 0-dim tensors; nothing is read back to
    the host.
    """
    with tracing.span("ps.step"):
        now = burst["now"]
        clusters, workers, payloads = (burst["clusters"], burst["workers"],
                                       burst["payloads"])
        with tracing.span("ps.gate"):
            send, _ = txctl_gate(state.tx, now, cfg.tx.delta_threshold,
                                 cfg.tx.v, worker_ids=workers,
                                 generator=state.gen,
                                 uniforms=burst.get("uniforms"))
        with tracing.span("ps.screen"):
            med = state.med
            zero = torch.zeros((), dtype=torch.int32, device=now.device)
            screen, n_screen = None, zero
            if cfg.screen:
                screen, med = screen_mask(payloads, med,
                                          factor=cfg.screen_factor, mask=send)
                n_screen = (send & screen).sum(dtype=torch.int32)
                n_send = send.sum(dtype=torch.int32)
        with tracing.span("ps.olaf_step"):
            queue, out = ops.olaf_step(state.queue, clusters, workers,
                                       burst["times"], burst["rewards"],
                                       payloads, math.inf, send, None,
                                       burst.get("active"), screen,
                                       k=cfg.drain_k, impl=cfg.step_impl)
            valid, n_stale = out["valid"], zero
            if cfg.stale_bound is not None:
                fresh = staleness_mask(now, out["gen_time"], cfg.stale_bound)
                n_stale = (valid & ~fresh).sum(dtype=torch.int32)
                valid = valid & fresh
        with tracing.span("ps.combine"):
            # each drained row is the mean of agg_count raw gradients: the
            # applied gradient is their exact weighted mean
            wts = valid * out["agg_count"].to(torch.float32)
            if cfg.screen:
                g_flat = ops.olaf_robust_combine(
                    out["payload"], wts, n_screen, n_send,
                    threshold=cfg.robust_threshold)
            else:
                g_flat = (wts @ out["payload"]) / torch.clamp(wts.sum(),
                                                              min=1.0)
        with tracing.span("ps.apply"):
            params, opt_state = apply_updates(
                state.params, unflatten_like(g_flat, state.params),
                state.opt_state, cfg.opt)
        with tracing.span("ps.feedback"):
            aom = aom_update_block(state.aom, now.expand(valid.shape[0]),
                                   out["gen_time"], valid)
            last_seen = state.last_seen.scatter_reduce(
                0, clusters.long(),
                torch.where(send, burst["times"], -math.inf), "amax")
            n_active = ((now - last_seen) <= ACTIVE_WINDOW).sum().to(
                torch.float32)
            acked = ((cfg.cluster_of[:, None] == out["cluster"][None, :])
                     & valid[None, :]).any(dim=1)
            tx = txctl_ack(state.tx, acked, now, n_active, cfg.q_max)
            stats = dict(loss=burst["losses"].mean(),
                         applied=valid.sum(dtype=torch.int32),
                         combined=wts.sum(),
                         # a copy: the kernel updates n_agg in place next step
                         agg_total=queue.n_agg.clone(),
                         deferred=(~send).sum(dtype=torch.int32),
                         stale=n_stale, screened=n_screen,
                         occupancy=(queue.cluster >= 0).sum(dtype=torch.int32))
    new = PSState(queue=queue, params=params, opt_state=opt_state, tx=tx,
                  aom=aom, last_seen=last_seen, med=med, gen=state.gen)
    return new, stats


STAT_KEYS = ("loss", "applied", "combined", "agg_total", "deferred", "stale",
             "screened", "occupancy")


def read_stats(pending: List[Dict[str, torch.Tensor]]) -> np.ndarray:
    """The buffered per-step stats, (steps, len(STAT_KEYS)) float64, in one
    device-to-host copy (every value is exact in float64)."""
    if not pending:
        return np.zeros((0, len(STAT_KEYS)))
    packed = torch.stack([torch.stack([row[k].to(torch.float64)
                                       for k in STAT_KEYS])
                          for row in pending])
    return packed.cpu().numpy()


# --------------------------------------------------------------------------
# olaf-async
# --------------------------------------------------------------------------
def _device_arg(args) -> str:
    """``args.device``, or ``"cuda"`` for a Namespace built without it."""
    return getattr(args, "device", "cuda")


class OlafAsyncTrainer:
    """``repro``'s ``run_olaf_async`` as an object: set-up (and resume) in
    the constructor, one PS iteration per :meth:`step`, the whole run in
    :meth:`run`.

    Workers are scheduled on the host as ``repro`` schedules them: a float64
    next-finish time per worker, the argmin finishes next, each on its own
    ``SyntheticLM`` shard. A burst of ``--burst-size`` updates reaches the
    PS per iteration; :func:`ps_step` runs on the device, and its stats are
    read back once per ``--log-every`` steps (once at the end when 0).
    """

    def __init__(self, cfg, args, device=None) -> None:
        dev = resolve_device(_device_arg(args) if device is None else device)
        self.cfg, self.args, self.device = cfg, args, dev
        W = args.workers
        opt = OptConfig(lr=args.lr, grad_clip=1.0)
        # the optional flags are read with repro's defaults, so a partial
        # Namespace (examples/lm_train.py's) runs as it does in repro;
        # a capacity below the cluster count (--queue-slots) makes the
        # congestion regime reachable, which arms the send gate
        capacity = getattr(args, "queue_slots", 0) or max(W, 4)
        drain_k = max(1, min(args.drain_k, capacity))
        screen = bool(getattr(args, "ingress_screen", False))
        if screen and dev.type == "cuda" and drain_k > MAX_ROWS:
            raise ValueError(
                f"--ingress-screen on a card combines at most {MAX_ROWS} "
                f"drained rows a step (the robust-combine kernel's sort), "
                f"and --drain-k {args.drain_k} with {capacity} queue slots "
                f"drains {drain_k}: lower --drain-k or --queue-slots")
        params = init_params(cfg, args.seed, dev)
        self.dim = flat_size(params)
        self.crash_set = sorted({int(s) for s in
                                 getattr(args, "crash_workers", "").split(",")
                                 if s})
        self.crash_at = getattr(args, "crash_at", -1)
        self.restart_at = getattr(args, "restart_at", -1)
        self.churn = bool(self.crash_set) and self.crash_at >= 0
        n_clusters = max(W // 2, 2)
        self.n_clusters = n_clusters
        self.ps_cfg = PSConfig(
            drain_k=drain_k,
            q_max=float(capacity),
            tx=TxControlConfig(
                delta_threshold=getattr(args, "txctl_threshold", 0.5),
                slope_mode=getattr(args, "txctl_mode", "fairness")),
            opt=opt,
            cluster_of=torch.arange(W, dtype=torch.int32, device=dev)
            % n_clusters,
            screen=screen,
            screen_factor=getattr(args, "screen_factor", 16.0),
            robust_threshold=getattr(args, "robust_threshold", 0.25),
            stale_bound=getattr(args, "staleness_bound", 0.0) or None,
            step_impl=getattr(args, "step_impl", "auto"))
        self.shards = [SyntheticLM(DataConfig(
            vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
            n_shards=W, shard_id=i, seed=args.seed)) for i in range(W)]
        rng = np.random.default_rng(args.seed)
        self.worker_speed = 1.0 + 0.5 * rng.random(W)
        self.worker_next = np.zeros(W)
        self.worker_step = np.zeros(W, int)
        self.active_np = np.ones(W, bool)
        self.active = (torch.ones(W, dtype=torch.bool, device=dev)
                       if self.churn else None)
        self.burst_size = max(1, args.burst_size)
        self.payloads = torch.empty((self.burst_size, self.dim),
                                    dtype=torch.float32, device=dev)
        self.state = PSState(
            queue=queue_init(capacity, self.dim, device=dev), params=params,
            opt_state=init_opt_state(params, opt),
            tx=txctl_init(W, device=dev, track_active=self.churn),
            aom=aom_init(device=dev),
            last_seen=torch.full((n_clusters,), -math.inf,
                                 dtype=torch.float32, device=dev),
            med=torch.zeros((), dtype=torch.float32, device=dev),
            gen=torch.Generator(device=dev).manual_seed(args.seed + 101))
        self.it = 0
        if args.ckpt and getattr(args, "resume", False) \
                and latest_step(args.ckpt) is not None:
            self._restore()
            print(f"resumed olaf-async from step {self.it}")
        self.pending: List[Dict[str, torch.Tensor]] = []
        # (step, loss, combined) per applied step, after each flush
        self.log_rows: List[Tuple[int, float, int]] = []
        self.deferred_total = self.stale_total = self.screened_total = 0
        self.flush_every = args.log_every if args.log_every > 0 \
            else max(args.steps, 1)

    # ---- checkpoint -----------------------------------------------------
    def snapshot_aux(self) -> dict:
        """The async plane beside params and optimizer: the queue, txctl,
        AoM and feedback state, the gate generator's state (``repro``
        stores its PRNG key) and the float64 host schedule."""
        st = self.state
        return dict(queue=st.queue, tx=st.tx, aom=st.aom,
                    last_seen=st.last_seen, med=st.med,
                    gen=st.gen.get_state(), worker_next=self.worker_next,
                    worker_step=self.worker_step, active=self.active_np)

    def save(self, step: int) -> str:
        st = self.state
        return save_checkpoint(self.args.ckpt, step, st.params, st.opt_state,
                               aux=self.snapshot_aux())

    def _restore(self) -> None:
        st = self.state
        self.it, params, opt_state, aux = restore_checkpoint(
            self.args.ckpt, params_like=st.params, opt_like=st.opt_state,
            aux_like=self.snapshot_aux())
        st.gen.set_state(aux["gen"])
        self.state = dataclasses.replace(
            st, queue=aux["queue"], params=params, opt_state=opt_state,
            tx=aux["tx"], aom=aux["aom"], last_seen=aux["last_seen"],
            med=aux["med"])
        self.worker_next = aux["worker_next"]
        self.worker_step = aux["worker_step"]
        self.active_np = aux["active"]
        if self.churn:
            self.active = to_device(self.active_np, self.device)

    # ---- one iteration --------------------------------------------------
    def _churn_events(self, it: int) -> None:
        args = self.args
        if not self.churn:
            return
        if it == self.crash_at:
            # crashed workers leave the argmin; their queued updates expire
            self.worker_next[self.crash_set] = np.inf
            self._set_active(False)
            if args.log_every:
                print(f"crash at {it}: workers {self.crash_set} down")
        if self.restart_at >= 0 and it == self.restart_at:
            # elastic rejoin, one compute interval past the live frontier
            frontier = self.worker_next[np.isfinite(self.worker_next)].max()
            for w in self.crash_set:
                self.worker_next[w] = frontier + self.worker_speed[w]
            self._set_active(True)
            if args.log_every:
                print(f"restart at {it}: workers {self.crash_set} rejoin")

    def _set_active(self, up: bool) -> None:
        self.active_np[self.crash_set] = up
        self.active = to_device(self.active_np, self.device)
        self.state.tx = txctl_set_active(self.state.tx, self.active)

    def next_burst(self) -> Dict[str, torch.Tensor]:
        """The next ``--burst-size`` worker updates, in finishing order:
        each worker's gradient at the current params written into a row
        of the burst buffer, and the burst's metadata on the device."""
        c, w_ids, t, losses = [], [], [], []
        for u in range(self.burst_size):
            w = int(np.argmin(self.worker_next))
            batch = {k: to_device(v, self.device) for k, v in
                     self.shards[w].batch(int(self.worker_step[w])).items()}
            losses.append(worker_grad(self.state.params, batch, self.cfg,
                                      self.payloads[u]))
            c.append(w % self.n_clusters)
            w_ids.append(w)
            t.append(self.worker_next[w])
            self.worker_step[w] += 1
            self.worker_next[w] += self.worker_speed[w]
        times = np.asarray(t, np.float32)
        loss = torch.stack(losses).to(torch.float32)
        burst = dict(now=to_device(np.float32(max(t)), self.device),
                     clusters=to_device(np.asarray(c, np.int32), self.device),
                     workers=to_device(np.asarray(w_ids, np.int32),
                                       self.device),
                     times=to_device(times, self.device), rewards=-loss,
                     payloads=self.payloads, losses=loss)
        if self.active is not None:
            burst["active"] = self.active
        return burst

    def step(self) -> None:
        """One PS iteration: churn events, a burst, :func:`ps_step`, the
        periodic stats read-back and checkpoint."""
        with tracing.span("trainer.step"):
            it, args = self.it, self.args
            self._churn_events(it)
            burst = self.next_burst()
            self.state, stats = ps_step(self.state, burst, cfg=self.ps_cfg)
            self.pending.append(stats)
            if len(self.pending) >= self.flush_every:
                self.flush()
                if args.log_every:
                    step, loss_v, combined = self.log_rows[-1]
                    print(f"applied {step}: loss {loss_v:.4f} "
                          f"(combined {combined} updates)")
            self.it = it + 1
            if args.ckpt and args.ckpt_every \
                    and self.it % args.ckpt_every == 0:
                self.save(self.it)

    def flush(self) -> None:
        """One host read-back for the whole batch of buffered stats."""
        k = {n: i for i, n in enumerate(STAT_KEYS)}
        for row in read_stats(self.pending):
            self.log_rows.append((len(self.log_rows) + 1,
                                  float(row[k["loss"]]),
                                  int(row[k["combined"]])))
            self.deferred_total += int(row[k["deferred"]])
            self.stale_total += int(row[k["stale"]])
            self.screened_total += int(row[k["screened"]])
        del self.pending[:]

    # ---- the run --------------------------------------------------------
    def avg_aom(self) -> float:
        finite = self.worker_next[np.isfinite(self.worker_next)]
        return float(aom_average(self.state.aom, float(finite.max())))

    def summary(self, wall: float) -> str:
        """``repro``'s closing line."""
        losses = [l for _, l, _ in self.log_rows]
        return (f"final loss {losses[-1]:.4f} (first {losses[0]:.4f}); "
                f"queue aggregations {int(self.state.queue.n_agg)}; "
                f"txctl deferred {self.deferred_total}; "
                f"stale rejected {self.stale_total}; "
                f"screened {self.screened_total}; "
                f"avg AoM {self.avg_aom():.3f} (virtual); "
                f"{self.args.steps / max(wall, 1e-9):.2f} steps/s")

    def run(self) -> "OlafAsyncTrainer":
        t0 = time.time()
        while self.it < self.args.steps:
            self.step()
        self.flush()
        if self.args.ckpt:
            self.save(self.args.steps)
        self.wall = time.time() - t0
        if self.log_rows:
            print(self.summary(self.wall))
        return self


def run_olaf_async(cfg, args, device=None) -> OlafAsyncTrainer:
    """OLAF-async data parallelism (``repro``'s ``run_olaf_async``): returns
    the finished trainer, whose ``log_rows``, counters and ``state`` hold
    the run's results."""
    return OlafAsyncTrainer(cfg, args, device).run()


# --------------------------------------------------------------------------
# sync
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SyncResult:
    losses: List[float]
    params: dict
    opt_state: OptState
    wall: float


def run_sync(cfg, args, device=None) -> SyncResult:
    """Synchronous training (``repro``'s ``run_sync``): one global batch per
    step, the loss read back every step. Resumes from ``--ckpt`` whenever
    it holds a checkpoint, as ``repro`` does."""
    dev = resolve_device(_device_arg(args) if device is None else device)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch, seed=args.seed))
    opt = OptConfig(lr=args.lr, grad_clip=1.0)
    params = init_params(cfg, args.seed, dev)
    opt_state = init_opt_state(params, opt)
    start = 0
    if args.ckpt and latest_step(args.ckpt) is not None:
        # meta likes placed on the run's device, as ``repro`` restores onto
        # ``jax.eval_shape`` trees
        p_like = api.param_spec(cfg)
        o_like = init_opt_state(p_like, opt)
        start, params, opt_state = restore_checkpoint(
            args.ckpt, params_like=p_like, opt_like=o_like,
            shardings=tree_map(lambda _: dev, p_like),
            opt_shardings=tree_unflatten(
                o_like, [dev] * len(tree_leaves(o_like))))
        print(f"resumed from step {start}")
    losses: List[float] = []
    t0 = time.time()
    for step in range(start, args.steps):
        batch = {k: to_device(v, dev) for k, v in data.batch(step).items()}
        loss, grads = loss_and_grads(params, batch, cfg)
        params, opt_state = apply_updates(
            params, tree_unflatten(params, grads), opt_state, opt)
        losses.append(float(loss))
        if args.log_every and step % args.log_every == 0:
            print(f"step {step}: loss {losses[-1]:.4f} "
                  f"({(time.time() - t0) / (step - start + 1):.2f}s/step)")
        if args.ckpt and args.ckpt_every and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt, step + 1, params, opt_state)
    if args.ckpt:
        save_checkpoint(args.ckpt, args.steps, params, opt_state)
    wall = time.time() - t0
    if losses:
        print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    return SyncResult(losses=losses, params=params, opt_state=opt_state,
                      wall=wall)


# --------------------------------------------------------------------------
# scenario
# --------------------------------------------------------------------------
def run_scenario(args):
    """Replay a topology scenario through the hybrid data plane with the
    selected backend (``event``: one event per call; ``window``: batched
    per transmission window; ``vectorized``: the vectorized model, one
    step per grid boundary, on ``--sim-dt``'s uniform grid if given) and
    print one summary line."""
    if args.topology == "fattree":
        sim_cfg = fattree_cfg(args.fattree_k, seed=args.seed,
                              spec_kw=dict(spines=args.fattree_spines))
    elif args.topology == "multirack":
        sim_cfg = multirack_cfg(seed=args.seed)
    else:
        sim_cfg = None  # §8.3 SW1/SW2/SW3 multihop default
    sim_dt = args.sim_dt
    if sim_dt not in (None, "auto"):
        sim_dt = float(sim_dt)
    sim_mesh = None
    if args.sim_shards > 1 or args.sim_worker_shards > 1:
        n_sw = len(sim_cfg.switches) if sim_cfg is not None else 3
        dev = resolve_device(args.device)
        sim_mesh = vecsim_mesh(min(n_sw, args.sim_shards),
                               worker_shards=args.sim_worker_shards,
                               devices=None if dev.type == "cuda" else [dev])
    t0 = time.time()
    hyb, _cfg = run_hybrid_multihop(args.sim_dim, seed=args.seed,
                                    sim_cfg=sim_cfg, sim_impl=args.sim_impl,
                                    sim_dt=sim_dt, sim_mesh=sim_mesh,
                                    device=args.device)
    wall = time.time() - t0
    enq = sum(qs["enqueued"] for qs in hyb.queue_stats.values())
    agg = sum(qs["aggregations"] for qs in hyb.queue_stats.values())
    drp = sum(qs["dropped"] for qs in hyb.queue_stats.values())
    impl = args.sim_impl or "window"
    print(f"scenario {args.topology} [{impl}]: "
          f"{len(hyb.delivered)} delivered, {hyb.forwarded} forwarded, "
          f"{enq} enqueued / {agg} aggregated / {drp} dropped; "
          f"{hyb.launches} combine launches, "
          f"{hyb.h2d_transfers} h2d transfers; {wall:.2f}s wall")
    return hyb


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default=None,
                    help="model config name (required outside --mode "
                         "scenario; a dense, moe, ssm or hybrid arch)")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--mode", default="sync",
                    choices=["sync", "olaf-async", "scenario"])
    ap.add_argument("--sim-impl", default=None,
                    choices=["event", "window", "vectorized"],
                    help="network simulator backend for --mode scenario: "
                         "per-event replay, per-window batched replay, or "
                         "the vectorized model (repro_torch.core.vecsim)")
    ap.add_argument("--topology", default="multihop",
                    choices=["multihop", "fattree", "multirack"])
    ap.add_argument("--fattree-k", type=int, default=2,
                    help="fat-tree arity for --topology fattree")
    ap.add_argument("--fattree-spines", type=int, default=1,
                    help="core switches for --topology fattree")
    ap.add_argument("--sim-dt", default=None,
                    help="uniform step for --sim-impl vectorized: a float "
                         "or 'auto' (largest dt within the AoM tolerance, "
                         "bisected against the exact grid on a prefix); "
                         "skips the host oracle trace entirely")
    ap.add_argument("--sim-shards", type=int, default=1,
                    help="shard the vectorized model's switch axis over "
                         "this many devices (repro_torch.distributed."
                         "sharding.vecsim_mesh)")
    ap.add_argument("--sim-worker-shards", type=int, default=1,
                    help="shard the worker/cluster axis over this many "
                         "devices (multiplies --sim-shards)")
    ap.add_argument("--sim-dim", type=int, default=64,
                    help="payload row width for --mode scenario")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--burst-size", type=int, default=2,
                    help="updates arriving per PS drain (olaf-async)")
    ap.add_argument("--drain-k", type=int, default=4,
                    help="queue slots drained per PS step (olaf-async)")
    ap.add_argument("--queue-slots", type=int, default=0,
                    help="queue capacity Q_max (0: max(workers, 4)); below "
                         "the cluster count arms the congestion gate")
    ap.add_argument("--step-impl", default="auto",
                    choices=["auto", "xla", "pallas"],
                    help="the PS step's olaf_step: the CUDA kernel "
                         "(pallas; raises off a card), the plain version "
                         "(xla), or by the device (auto)")
    ap.add_argument("--txctl-threshold", type=float, default=0.5,
                    help="Δ̄_T of the send gate (virtual time)")
    ap.add_argument("--txctl-mode", default="fairness",
                    choices=["fairness", "urgency"],
                    help="txctl staleness slope: v=Δ̄_T or v=1/Δ̄_T")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="olaf-async: resume the whole training plane from "
                         "the latest checkpoint in --ckpt")
    ap.add_argument("--crash-workers", default="",
                    help="comma-separated worker ids crashed at --crash-at")
    ap.add_argument("--crash-at", type=int, default=-1,
                    help="PS step at which --crash-workers go down")
    ap.add_argument("--restart-at", type=int, default=-1,
                    help="PS step at which crashed workers rejoin")
    ap.add_argument("--staleness-bound", type=float, default=0.0,
                    help="PS admission bound on update age (virtual time; "
                         "0: off)")
    ap.add_argument("--ingress-screen", action="store_true",
                    help="withhold non-finite / norm-outlier burst rows "
                         "before the queue (olaf-async)")
    ap.add_argument("--screen-factor", type=float, default=16.0,
                    help="screen rows with L2 norm above this factor x the "
                         "running scale estimate")
    ap.add_argument("--robust-threshold", type=float, default=0.25,
                    help="screened share of a burst above which the PS "
                         "applies the trimmed combine")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.sim_dt is not None and args.sim_dt != "auto":
        try:
            float(args.sim_dt)
        except ValueError:
            ap.error(f"--sim-dt takes a float or 'auto', not {args.sim_dt!r}")
    if args.mode == "scenario":
        return run_scenario(args)
    if args.arch is None:
        ap.error("--arch is required unless --mode scenario")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("use the family-specific example drivers for "
                         "stub-frontend archs")
    if args.mode == "sync":
        return run_sync(cfg, args)
    return run_olaf_async(cfg, args)


if __name__ == "__main__":
    main()
