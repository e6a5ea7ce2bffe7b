"""The reference's first steps of OLAF-async training: the same weights
from the seed, the same batches and schedule worked out again from the
seed (:mod:`perfbench.reference.data`), float32 worker gradients
(:mod:`perfbench.reference.lm`) and the plain PS cycle
(:mod:`perfbench.reference.ps`)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from perfbench.reference import data, lm
from perfbench.reference.compare import Trajectory, leaf_norms
from perfbench.reference.ps import PSRules, RefPS, flat_of


def rules_of(job: dict) -> PSRules:
    """The PS rules of a trainer job (``job``: the workload's trainer
    settings with their defaults filled in)."""
    W = job["workers"]
    cap = job["queue_slots"] or max(W, 4)
    return PSRules(capacity=cap, drain_k=max(1, min(job["drain_k"], cap)),
                   n_workers=W, n_clusters=max(W // 2, 2), lr=job["lr"],
                   delta_threshold=job["txctl_threshold"],
                   slope=(job["txctl_threshold"] if job["txctl_mode"]
                          == "fairness" else 1.0 / job["txctl_threshold"]),
                   screen=job["ingress_screen"])


def gate_draws(seed: int, device) -> Callable[[int], np.ndarray]:
    """The send gate's uniforms: the trainer's gate generator (seeded
    ``seed + 101`` on the PS's device), one (U,) draw per cycle."""
    gen = torch.Generator(device=device).manual_seed(seed + 101)
    return lambda U: torch.rand((U,), generator=gen,
                                device=device).cpu().numpy()


def reference_trajectory(cfg: dict, job: dict, seed: int, device, *,
                         steps: int = 3, mm: Callable = lm.mm_f32,
                         block_rows: int = 1) -> Trajectory:
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _run(cfg, job, seed, device, steps, mm, block_rows)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def _run(cfg, job, seed, device, steps, mm, block_rows) -> Trajectory:
    init = lm.draw_params(cfg, seed, device)
    rules = rules_of(job)
    ps = RefPS(init, rules)
    sched = data.Schedule(rules.n_workers, seed)
    draw = gate_draws(seed, device)
    U = max(1, job["burst_size"])
    losses, counts, grad_norms = [], [], {}
    for s in range(steps):
        deliveries = sched.burst(U)
        rows, wl = [], []
        for w, _c, st, _t in deliveries:
            b = data.token_batch(cfg["vocab_size"], job["seq"], job["batch"],
                                 rules.n_workers, w, seed, st)
            tokens = torch.from_numpy(b["tokens"]).to(device)
            labels = torch.from_numpy(b["labels"]).to(device)
            loss, grads = lm.loss_and_grads(ps.params, tokens, labels, cfg,
                                            block_rows=block_rows, mm=mm)
            rows.append(flat_of(grads))
            del grads
            wl.append(loss)
        rows = torch.stack(rows)
        times = np.array([t for *_, t in deliveries])
        now = np.float32(times.max())
        counts.append(ps.step(now, [c for _, c, _, _ in deliveries],
                              [w for w, *_ in deliveries], times, rows, draw))
        losses.append(float(np.mean(np.array(wl, np.float32))))
        del rows
        if s == 0:
            grad_norms = leaf_norms(ps.m, scale=1.0 / (1.0 - rules.b1))
    change = leaf_norms(ps.params, minus=init)
    return Trajectory(losses=losses, counts=counts, grad_norms=grad_norms,
                      change_norms=change)
