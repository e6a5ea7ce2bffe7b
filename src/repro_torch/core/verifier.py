"""Formal verification of AoM objectives with Z3 (paper §6, §12.2, §12.3).

Encodes the accelerator-engine dynamics as first-order constraints:

  * departure:  D^v(k) = A^v(k) + T_Q^v(k),   valid only if the update left
    before the next same-cluster arrival (otherwise it was aggregated /
    replaced in the queue and never departs on its own);
  * queueing:   T_Q^v(k) = Q_k^v · p/C, with Q_k^v the number of *other*
    clusters' updates present at arrival (Olaf invariant: ≤ 1 per cluster);
  * service:    any two distinct valid departures are ≥ p/C apart;
  * peak AoM:   Δ_p^v(k) = D^v(k) − A^v(l),  l the previous valid index.

Objective (AoM fairness): |avg_k Δ_p^u − avg_k Δ_p^v| ≤ ε for all cluster
pairs. Verification = UNSAT of (constraints ∧ ¬objective); a SAT result
yields a counterexample schedule.

Beyond the paper's fixed schedules, arrivals may be given as intervals
(±jitter) and transmission-control thinning as symbolic send decisions with
a rate bound — the verifier then proves the objective for *all* admissible
behaviours, which is what makes the static check useful for admission
control (§6).

A copy of ``repro.core.verifier`` (which imports no JAX): the port keeps
its own, so that it installs without ``repro``. z3 is imported lazily, and
a call that needs it raises ``ImportError`` when it is missing.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

try:
    import z3
except ImportError:  # optional dep: fail at use, not at import
    z3 = None


@dataclasses.dataclass
class VerifierConfig:
    p_over_c: float = 2.0  # service time of one model update (p/C), paper §6
    epsilon: float = 0.1  # fairness tolerance ε
    jitter: float = 0.0  # ± interval around nominal arrival times
    send_rate: Optional[float] = None  # tx-control rate bound P_s (None: all sent)
    timeout_ms: int = 120_000


@dataclasses.dataclass
class VerifyResult:
    fair: bool
    status: str  # "verified" | "violated" | "unknown"
    counterexample: Optional[Dict[str, List[float]]] = None
    solve_time_s: float = 0.0


def _encode(cfg: VerifierConfig, schedules: Sequence[Sequence[float]]):
    """Build constraints; returns (solver_constraints, per-cluster vars)."""
    if z3 is None:
        raise ImportError("repro_torch.core.verifier needs z3-solver "
                          "(pip install -r requirements-dev.txt)")
    F = len(schedules)
    s = cfg.p_over_c
    cons = []
    A: List[List[z3.ArithRef]] = []
    D: List[List[z3.ArithRef]] = []
    V: List[List[z3.BoolRef]] = []  # valid (departed un-merged)
    S: List[List[z3.BoolRef]] = []  # sent (tx-control thinning)

    for v, sched in enumerate(schedules):
        n = len(sched)
        Av = [z3.Real(f"A_{v}_{k}") for k in range(n)]
        Dv = [z3.Real(f"D_{v}_{k}") for k in range(n)]
        Vv = [z3.Bool(f"valid_{v}_{k}") for k in range(n)]
        Sv = [z3.Bool(f"sent_{v}_{k}") for k in range(n)]
        A.append(Av); D.append(Dv); V.append(Vv); S.append(Sv)
        for k, t in enumerate(sched):
            if cfg.jitter > 0:
                cons += [Av[k] >= t - cfg.jitter, Av[k] <= t + cfg.jitter]
            else:
                cons.append(Av[k] == t)
            if k > 0:
                cons.append(Av[k] > Av[k - 1])
        if cfg.send_rate is None:
            cons += [Sv[k] for k in range(n)]
        else:
            # deterministic-rate abstraction of Bernoulli thinning: over the
            # whole horizon, the sent fraction matches P_s within one update.
            cnt = z3.Sum([z3.If(b, 1, 0) for b in Sv])
            lo = max(int(n * cfg.send_rate) - 1, 1)
            hi = min(int(n * cfg.send_rate) + 1, n)
            cons += [cnt >= lo, cnt <= hi]

    # queue occupancy + departure dynamics
    for v in range(F):
        n = len(schedules[v])
        for k in range(n):
            # Q_k^v: other clusters' updates in flight at A^v(k)
            occ = []
            for u in range(F):
                if u == v:
                    continue
                for m in range(len(schedules[u])):
                    # "arrived earlier" with a deterministic tie-break on the
                    # cluster index: simultaneous arrivals would otherwise make
                    # the exact departure equation D = A + s + Q·s inconsistent
                    # with the service-separation constraint (UNSAT for the
                    # wrong reason).
                    earlier = z3.Or(A[u][m] < A[v][k],
                                    z3.And(A[u][m] == A[v][k], u < v))
                    occ.append(z3.If(
                        z3.And(S[u][m], V[u][m], earlier, D[u][m] > A[v][k]),
                        1, 0))
            q = z3.Sum(occ) if occ else z3.IntVal(0)
            cons.append(z3.Implies(S[v][k], D[v][k] == A[v][k] + s + q * s))
            # validity: no later same-cluster arrival sneaks in before departure
            nxt = _next_sent_arrival(cfg, A[v], S[v], k)
            if nxt is None:
                cons.append(V[v][k] == S[v][k])
            else:
                cons.append(V[v][k] == z3.And(S[v][k], D[v][k] < nxt))
            cons.append(z3.Implies(z3.Not(S[v][k]), z3.Not(V[v][k])))

    # service separation between distinct valid departures
    for v in range(F):
        for k in range(len(schedules[v])):
            for u in range(F):
                for m in range(len(schedules[u])):
                    if (u, m) <= (v, k):
                        continue
                    cons.append(z3.Implies(
                        z3.And(V[v][k], V[u][m]),
                        z3.Or(D[v][k] - D[u][m] >= s, D[u][m] - D[v][k] >= s)))
    return cons, A, D, V, S


def _next_sent_arrival(cfg, Av, Sv, k):
    """Arrival time of the next *sent* update after k (z3 expression)."""
    n = len(Av)
    if k + 1 >= n:
        return None
    expr = None
    for j in range(n - 1, k, -1):
        expr = Av[j] if expr is None else z3.If(Sv[j], Av[j], expr)
    # if no later update is sent at all, validity falls back to "sent"
    any_later = z3.Or([Sv[j] for j in range(k + 1, n)])
    return z3.If(any_later, expr, z3.RealVal(10 ** 9))


def _peak_terms(cfg, A, D, V, v):
    """Symbolic (sum of peak AoM, count of valid departures) for cluster v."""
    n = len(A[v])
    total = z3.RealVal(0)
    count = z3.IntVal(0)
    # prev valid arrival: fold over indices
    for k in range(n):
        prev = z3.RealVal(0)  # A(l) of the latest valid departure before k
        for i in range(k):
            prev = z3.If(V[v][i], A[v][i], prev)
        peak = D[v][k] - prev
        total = total + z3.If(V[v][k], peak, z3.RealVal(0))
        count = count + z3.If(V[v][k], 1, 0)
    return total, count


def verify_aom_fairness(schedules: Sequence[Sequence[float]],
                        cfg: Optional[VerifierConfig] = None) -> VerifyResult:
    """Check that all admissible behaviours satisfy the fairness objective.

    ``schedules[v]`` is the nominal update-generation time series of cluster
    v. Returns ``fair=True`` iff (constraints ∧ ¬fairness) is UNSAT.
    """
    import time
    cfg = cfg or VerifierConfig()
    cons, A, D, V, S = _encode(cfg, schedules)
    F = len(schedules)

    # ¬fairness: some pair of clusters differs by more than ε in average peak
    # AoM. Encoded multiplied out to avoid division by symbolic counts.
    viol = []
    sums = [_peak_terms(cfg, A, D, V, v) for v in range(F)]
    for u in range(F):
        for v in range(u + 1, F):
            su, cu = sums[u]
            sv, cv = sums[v]
            both = z3.And(cu > 0, cv > 0)
            diff = su * z3.ToReal(cv) - sv * z3.ToReal(cu)
            bound = cfg.epsilon * z3.ToReal(cu) * z3.ToReal(cv)
            viol.append(z3.And(both, z3.Or(diff > bound, -diff > bound)))

    solver = z3.Solver()
    solver.set("timeout", cfg.timeout_ms)
    solver.add(*cons)
    solver.add(z3.Or(viol))
    t0 = time.time()
    res = solver.check()
    dt = time.time() - t0
    if res == z3.unsat:
        return VerifyResult(fair=True, status="verified", solve_time_s=dt)
    if res == z3.sat:
        m = solver.model()
        cex: Dict[str, List[float]] = {}
        for v in range(F):
            cex[f"A_{v}"] = [_val(m, a) for a in A[v]]
            cex[f"D_{v}"] = [_val(m, d) for d in D[v]]
        return VerifyResult(fair=False, status="violated", counterexample=cex,
                            solve_time_s=dt)
    return VerifyResult(fair=False, status="unknown", solve_time_s=dt)


def _val(model, var) -> float:
    v = model.eval(var, model_completion=True)
    if z3.is_rational_value(v):
        return float(v.numerator_as_long()) / float(v.denominator_as_long())
    return float(v.as_decimal(10).rstrip("?"))


def uniform_schedule(interval: float, n: int, start: float = 0.0) -> List[float]:
    return [start + interval * (k + 1) for k in range(n)]


def admissible_thresholds(schedules: Sequence[Sequence[float]],
                          rates: Sequence[float],
                          cfg: Optional[VerifierConfig] = None
                          ) -> List[Tuple[float, bool]]:
    """Sweep tx-control send rates; report which satisfy the AoM objective.

    This is the paper's envisioned admission-control use: constrain the
    cluster parameter ranges to those the verifier accepts.
    """
    base = cfg or VerifierConfig()
    out = []
    for r in rates:
        c = dataclasses.replace(base, send_rate=r)
        out.append((r, verify_aom_fairness(schedules, c).fair))
    return out
