"""Parameter-server update rules for asynchronous DRL (paper §2.1).

The paper's rule: the PS stores a global reward ``r_g`` (init −inf) and a
running average gradient ``g_a``; on receiving ``(g_i, r_i)`` it applies

    if r_i > r_g:   g_a <- avg(g_a, g_i);  w <- w + γ·g_a;  r_g <- r_i

(γ = 0.001) and returns the updated global weights to the sender's cluster.
Note the sign: the workers send *ascent* directions (negated loss grads) —
the caller passes gradients already oriented for ascent, or equivalently we
apply ``w - γ·g`` for loss gradients (flag).

Beyond-paper extensions (used in §Perf / ablations):
  * ``slack`` — apply when ``r_i > r_g − slack`` (strict paper rule is 0);
  * ``staleness_tau`` — staleness-aware step: γ_eff = γ·exp(−AoM/τ), a
    continuous version of reward gating that uses the Age-of-Model directly.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class PSConfig:
    lr: float = 1e-3  # γ
    slack: float = 0.0
    staleness_tau: Optional[float] = None  # None: paper rule
    descent: bool = True  # payloads are loss gradients (apply w - γ g)


class ParameterServer:
    """Reward-gated averaging PS over flat parameter vectors."""

    def __init__(self, w0: np.ndarray, cfg: PSConfig) -> None:
        self.w = np.asarray(w0, np.float64).copy()
        self.cfg = cfg
        self.r_g = -np.inf
        self.g_a: Optional[np.ndarray] = None
        self.applied = 0
        self.rejected = 0
        self.reward_log: list = []  # (time, r_i, applied?)

    def on_update(self, now: float, payload: np.ndarray, reward: float,
                  gen_time: float) -> np.ndarray:
        """Returns the (possibly updated) global weights."""
        if reward > self.r_g - self.cfg.slack:
            g = np.asarray(payload, np.float64)
            self.g_a = g if self.g_a is None else 0.5 * (self.g_a + g)
            lr = self.cfg.lr
            if self.cfg.staleness_tau is not None:
                age = max(now - gen_time, 0.0)
                lr = lr * float(np.exp(-age / self.cfg.staleness_tau))
            step = -lr * self.g_a if self.cfg.descent else lr * self.g_a
            self.w = self.w + step
            self.r_g = max(self.r_g, reward)
            self.applied += 1
            self.reward_log.append((now, reward, True))
        else:
            self.rejected += 1
            self.reward_log.append((now, reward, False))
        return self.w

    def on_updates(self, now: float, payloads: np.ndarray, rewards: np.ndarray,
                   gen_times: np.ndarray, agg_counts: np.ndarray) -> np.ndarray:
        """Drain-k batched apply: a block of k drained updates is combined
        into one ``agg_count``-weighted mean gradient and applied through the
        same reward-gated rule, carrying the batch's best reward and freshest
        gen_time (the combined update subsumes its constituents, mirroring
        ``aggregation.aggregate``)."""
        w = np.asarray(agg_counts, np.float64)
        if w.size == 0 or w.sum() <= 0:
            return self.w
        g = (w[:, None] * np.asarray(payloads, np.float64)).sum(0) / w.sum()
        return self.on_update(now, g, float(np.max(rewards)),
                              float(np.max(gen_times)))
