"""Plain reference of the OLAF parameter server's cycle.

Written from the paper (§4 Algorithm 1 with drain-k, §5 transmission
control) and the stated PS rules, in NumPy for the queue's metadata and
plain PyTorch for the payload rows; nothing is imported from the program
under test. One :meth:`RefPS.step` takes a burst of U worker updates:

  1. the send gate: ``P_s = min(Q_max/N + v·max(Δ̂ − Δ̄_T, 0), 1)`` in the
     congestion regime (N > Q_max), 1 otherwise or before a worker's first
     ACK; a row is sent when its uniform draw is below ``P_s``;
  2. the ingress screen (optional): a sent row is rejected when it holds a
     non-finite value or its norm exceeds ``factor`` × a running scale
     estimate that each admitted row moves by at most ±10%;
  3. Algorithm 1, one row after another: a row whose cluster holds a slot
     replaces it (same worker, slot never aggregated) or is averaged into
     it (count-weighted running mean, newest time and reward); else it
     takes the first free slot while fewer than the capacity are used;
     else it is dropped;
  4. drain-k: the k occupied slots with the smallest sequence numbers are
     popped, oldest first;
  5. the applied gradient: the agg_count-weighted mean of the popped rows,
     or, when the screened share of the sent rows exceeds the robust
     threshold, that mean with each column clipped to the quantile band
     [0.25, 0.75] of the popped rows;
  6. AdamW with global-norm clipping (a non-finite norm skips the step),
     each parameter kept in its own dtype;
  7. the ACK: every worker of a popped cluster takes ``{N, Q_max}``, N the
     number of clusters that sent within the last unit of virtual time.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import numpy as np
import torch

ACTIVE_WINDOW = 1.0
f32 = np.float32


@dataclasses.dataclass(frozen=True)
class PSRules:
    capacity: int
    drain_k: int
    n_workers: int
    n_clusters: int
    lr: float
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    delta_threshold: float = 0.5
    slope: float = 0.5  # v: Δ̄_T (fairness) or 1/Δ̄_T (urgency)
    screen: bool = False
    screen_factor: float = 16.0
    robust_threshold: float = 0.25
    trim: float = 0.25


def flat_of(grads: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Gradient leaves (sorted paths) as one float32 row."""
    return torch.cat([grads[k].reshape(-1).to(torch.float32)
                      for k in sorted(grads, key=lambda p: p.split("/"))])


class RefPS:
    """The PS's whole state: parameters, AdamW moments, the queue, the
    per-worker feedback and the screen's scale estimate."""

    def __init__(self, params: Dict[str, torch.Tensor], rules: PSRules,
                 payload_dtype=torch.float32):
        """``payload_dtype``: the queue's rows and the combine's arithmetic
        (float32; bfloat16 is the control's lower precision)."""
        self.r = rules
        self.keys = sorted(params, key=lambda p: p.split("/"))
        self.params = {k: params[k].clone() for k in self.keys}
        self.m = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in self.params.items()}
        self.v = {k: torch.zeros_like(v, dtype=torch.float32)
                  for k, v in self.params.items()}
        self.t = 0
        D = sum(v.numel() for v in self.params.values())
        dev = next(iter(self.params.values())).device
        Q = rules.capacity
        self.slot_cluster = [-1] * Q
        self.slot_worker = [-1] * Q
        self.slot_seq = [None] * Q
        self.slot_count = [0] * Q
        self.slot_repl = [False] * Q
        self.payload = torch.zeros(Q, D, dtype=payload_dtype, device=dev)
        self.next_seq = 0
        W = rules.n_workers
        self.last_ack = np.zeros(W, f32)
        self.has_fb = np.zeros(W, bool)
        self.n_active = np.zeros(W, f32)
        self.q_max = np.ones(W, f32)
        self.last_seen = np.full(rules.n_clusters, -np.inf, f32)
        self.med = f32(0.0)

    # ---- 1. the gate ----------------------------------------------------
    def send_probability(self, now) -> np.ndarray:
        dh = f32(now) - self.last_ack
        over = np.maximum(dh - f32(self.r.delta_threshold), f32(0.0))
        p = np.minimum(self.q_max / np.maximum(self.n_active, f32(1.0))
                       + f32(self.r.slope) * over, f32(1.0))
        p = np.where(self.n_active <= self.q_max, f32(1.0), p)
        return np.where(self.has_fb, p, f32(1.0)).astype(f32)

    # ---- 2. the screen --------------------------------------------------
    def screen_rows(self, rows: torch.Tensor, send: np.ndarray) -> np.ndarray:
        out = np.zeros(len(send), bool)
        for u in range(len(send)):
            x = rows[u].to(torch.float64)
            finite = bool(torch.isfinite(x).all())
            n = f32(math.sqrt(float(torch.where(torch.isfinite(x), x, 0.0)
                                    .square().sum())))
            if not send[u]:
                continue
            m = self.med
            big = m > 0 and n > f32(self.r.screen_factor) * m
            out[u] = (not finite) or big
            if not out[u]:
                self.med = n if m == 0 else f32(
                    m + np.clip(n - m, -f32(0.1) * m, f32(0.1) * m))
        return out

    # ---- 3.-4. the queue ------------------------------------------------
    def enqueue(self, c, w, row):
        Q = self.r.capacity
        row = row.to(self.payload.dtype)
        hit = next((q for q in range(Q) if self.slot_cluster[q] == c), None)
        if hit is not None:
            if self.slot_repl[hit] and self.slot_worker[hit] == w:
                self.payload[hit] = row
                self.slot_count[hit] = 1
                self.slot_worker[hit] = w
                return "replace"
            n = self.slot_count[hit]
            self.payload[hit] = (self.payload[hit] * n + row) / (n + 1)
            self.slot_count[hit] = n + 1
            self.slot_worker[hit] = w
            self.slot_repl[hit] = False
            return "agg"
        used = sum(cl >= 0 for cl in self.slot_cluster)
        if used >= Q:
            return "drop"
        q = self.slot_cluster.index(-1)
        self.slot_cluster[q], self.slot_worker[q] = c, w
        self.slot_seq[q], self.next_seq = self.next_seq, self.next_seq + 1
        self.slot_count[q], self.slot_repl[q] = 1, True
        self.payload[q] = row
        return "append"

    def drain(self):
        occ = [q for q in range(self.r.capacity) if self.slot_cluster[q] >= 0]
        popped = sorted(occ, key=lambda q: (self.slot_seq[q], q))
        popped = popped[:self.r.drain_k]
        rows = self.payload[popped].clone()
        meta = [(self.slot_cluster[q], self.slot_count[q]) for q in popped]
        for q in popped:
            self.slot_cluster[q] = self.slot_worker[q] = -1
            self.slot_seq[q], self.slot_count[q] = None, 0
            self.slot_repl[q] = False
            self.payload[q] = 0.0
        return rows, meta

    # ---- 5. the combine -------------------------------------------------
    def trimmed(self, rows: torch.Tensor, wts: torch.Tensor) -> torch.Tensor:
        """Each column clipped to its [trim, 1 - trim] quantile band
        (linear interpolation) over the rows, then their weighted mean."""
        out = torch.empty(rows.shape[1], dtype=torch.float32,
                          device=rows.device)
        n, step = rows.shape[0], 1 << 24

        def band(xs, q):
            r = q * (n - 1)
            lo, w = math.floor(r), r - math.floor(r)
            return xs[lo] * (1.0 - w) + xs[min(lo + 1, n - 1)] * w

        for c0 in range(0, rows.shape[1], step):
            x = rows[:, c0:c0 + step]
            xs = torch.sort(x, dim=0).values
            lo, hi = band(xs, self.r.trim), band(xs, 1.0 - self.r.trim)
            out[c0:c0 + step] = (wts @ torch.clamp(x, min=lo, max=hi)) \
                / max(float(wts.sum()), 1.0)
        return out

    # ---- 6. AdamW -------------------------------------------------------
    def adamw(self, g_flat: torch.Tensor) -> None:
        r = self.r
        grads, off = {}, 0
        for k in self.keys:
            n = self.params[k].numel()
            # the gradient is handed over in the parameter's own dtype, and
            # clipped in it
            grads[k] = g_flat[off:off + n].view(self.params[k].shape).to(
                self.params[k].dtype)
            off += n
        if r.grad_clip > 0:
            gn = math.sqrt(sum(float(g.double().square().sum())
                               for g in grads.values()))
            scale = min(r.grad_clip / (gn + 1e-9), 1.0) if math.isfinite(gn) \
                else 0.0
            grads = {k: torch.where(
                torch.isfinite(g),
                g * torch.tensor(scale, dtype=g.dtype, device=g.device),
                torch.zeros((), dtype=g.dtype, device=g.device))
                for k, g in grads.items()}
        grads = {k: g.to(torch.float32) for k, g in grads.items()}
        self.t += 1
        bc1, bc2 = 1 - r.b1 ** self.t, 1 - r.b2 ** self.t
        for k in self.keys:
            g = grads[k]
            self.m[k] = r.b1 * self.m[k] + (1 - r.b1) * g
            self.v[k] = r.b2 * self.v[k] + (1 - r.b2) * g.square()
            u = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2) + r.eps)
            p = self.params[k].to(torch.float32)
            if r.weight_decay:
                u = u + r.weight_decay * p
            self.params[k] = (p - r.lr * u).to(self.params[k].dtype)

    # ---- the cycle ------------------------------------------------------
    def step(self, now, clusters, workers, times, rows: torch.Tensor,
             draw: Callable[[int], np.ndarray]) -> Dict[str, float]:
        """One cycle; ``draw(U)`` gives the gate's U uniforms. Returns the
        cycle's counts."""
        U = len(clusters)
        p = self.send_probability(now)[np.asarray(workers)]
        send = draw(U) < p
        screen = (self.screen_rows(rows, send) if self.r.screen
                  else np.zeros(U, bool))
        for u in range(U):
            if send[u] and not screen[u]:
                self.enqueue(int(clusters[u]), int(workers[u]), rows[u])
        popped, meta = self.drain()
        wts = torch.tensor([cnt for _, cnt in meta], dtype=torch.float32,
                           device=rows.device)
        if meta:
            g = ((wts.to(popped.dtype) @ popped)
                 / max(float(wts.sum()), 1.0)).to(torch.float32)
        else:
            g = torch.zeros(rows.shape[1], dtype=torch.float32,
                            device=rows.device)
        n_send, n_screen = int(send.sum()), int((send & screen).sum())
        if self.r.screen and meta and \
                n_screen / max(n_send, 1) > self.r.robust_threshold:
            g = self.trimmed(popped.to(torch.float32), wts)
        self.adamw(g)
        times32 = np.asarray(times, f32)
        for u in range(U):
            if send[u]:
                c = int(clusters[u])
                self.last_seen[c] = max(self.last_seen[c], times32[u])
        n_act = f32(np.sum((f32(now) - self.last_seen) <= f32(ACTIVE_WINDOW)))
        drained = {c for c, _ in meta}
        for w in range(self.r.n_workers):
            if w % self.r.n_clusters in drained:
                self.last_ack[w] = f32(now)
                self.has_fb[w] = True
                self.n_active[w] = n_act
                self.q_max[w] = f32(self.r.capacity)
        return dict(applied=len(meta), combined=float(wts.sum()),
                    deferred=U - n_send, screened=n_screen,
                    occupancy=sum(c >= 0 for c in self.slot_cluster))
