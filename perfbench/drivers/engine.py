"""Driver of the PS-engine cells: ``repro_torch.launch.train.ps_step`` in a
closed loop over congested bursts of worker updates, with no worker
gradient computed.

Set-up builds the ``OlafAsyncTrainer`` of the workload's ``job`` on
weights drawn from the seed (its PS state, ``ps_cfg`` and burst buffer
are what the engine runs on) and drives it through its first
``check_steps`` cycles, each a burst from :mod:`perfbench.reference.
traffic` written into the trainer's burst buffer and one ``ps_step``
call, as the window makes them. The window repeats that until
``--seconds`` have passed and ends at the ``synchronize`` after the last
cycle that began inside it. The time the harness takes to draw a burst is
timed apart (CUDA events) and printed. With ``--trace 1`` a CUDA-event
span wraps every ``ps_step`` call, the queue's metadata and the burst's
are kept at each ``olaf_step`` call for the least-bytes count
(:mod:`perfbench.reference.cost`), and a profiled stretch of
``profile_iters`` more cycles follows, and then as many again with the
port's own spans on (``lib/program.py``), their stats rows kept.

Once the window has closed and the trainer is freed, the reference PS
(:mod:`perfbench.reference.ps`) follows the same first cycles on the same
bursts and :mod:`perfbench.reference.compare` holds the two against the
limits.
"""
from __future__ import annotations

import gc
import time

import numpy as np
import torch

from perfbench.lib import faults, program, spans, trace
from perfbench.lib.olaf import build
from perfbench.reference import compare as C
from perfbench.reference import cost, lm
from perfbench.reference.ps import RefPS
from perfbench.reference.traffic import Traffic
from perfbench.reference.train import rules_of

CONTROL = "bfloat16"  # the reference PS's queue and combine in the control
META = ("cluster", "worker", "seq", "agg_count", "replaceable")


def to_burst(meta, rows, device) -> dict:
    """The program's burst dict: the metadata on the device (pinned host
    copies that do not wait), the rows as they lie."""
    def dev(a):
        t = torch.from_numpy(np.ascontiguousarray(a))
        return t.pin_memory().to(device, non_blocking=True) \
            if device.type == "cuda" else t

    zeros = np.zeros(len(meta.clusters), np.float32)
    return dict(now=dev(np.array(meta.now, np.float32)),
                clusters=dev(meta.clusters), workers=dev(meta.workers),
                times=dev(meta.times), rewards=dev(zeros),
                losses=dev(zeros), payloads=rows,
                uniforms=dev(meta.uniforms))


class Engine:
    """The trainer's PS state driven by the harness's bursts."""

    def __init__(self, tr, traffic: Traffic):
        self.tr, self.traffic, self.pending = tr, traffic, []
        self.draws = []  # CUDA event pairs around each burst's draw

    def cycle(self) -> None:
        from repro_torch.launch import train as T
        tr, dev = self.tr, self.tr.device
        on_card = dev.type == "cuda"
        if on_card:
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
        meta = self.traffic.next(tr.payloads)
        if on_card:
            b.record()
            self.draws.append((a, b))
        burst = to_burst(meta, tr.payloads, dev)
        tr.state, stats = T.ps_step(tr.state, burst, cfg=tr.ps_cfg)
        self.pending.append(stats)

    def counts(self, lo: int, hi: int):
        from repro_torch.launch import train as T
        rows = T.read_stats(self.pending[lo:hi])
        k = {n: i for i, n in enumerate(T.STAT_KEYS)}
        return [{n: float(r[k[n]]) for n in C.COUNTS} for r in rows]


class CycleMeta:
    """Keeps, at each ``ops.olaf_step`` call, the queue's metadata before
    it and the burst's rows that reach Algorithm 1 (sent and not
    screened): what :func:`perfbench.reference.cost.cycle_cost` reads."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.kernels import ops
        self.ops, self.real = ops, ops.olaf_step
        keep = self.calls

        def wrapper(state, clusters, workers, gen_times, rewards, payloads,
                    reward_threshold=float("inf"), send=None, capacity=None,
                    active_workers=None, screen=None, *, k, **kw):
            act = send if screen is None else send & ~screen
            keep.append(({f: getattr(state, f).clone() for f in META},
                         clusters, workers, act, k))
            return self.real(state, clusters, workers, gen_times, rewards,
                             payloads, reward_threshold, send, capacity,
                             active_workers, screen, k=k, **kw)

        ops.olaf_step = wrapper
        return self

    def __exit__(self, *exc):
        self.ops.olaf_step = self.real
        return False

    def cycle_bytes(self, dim: int, lo: int = 0):
        out = []
        for meta, c, w, act, k in self.calls[lo:]:
            m = {f: v.tolist() for f, v in meta.items()}
            out.append(cost.cycle_cost(m, c.tolist(), w.tolist(),
                                       act.tolist(), k, dim)[0])
        return out


def first_cycles(eng: Engine, init: dict, steps: int) -> C.Trajectory:
    from repro_torch.models.module import tree_paths
    tr = eng.tr
    grad_norms = {}
    for s in range(steps):
        eng.cycle()
        if s == 0:
            grad_norms = C.leaf_norms(tree_paths(tr.state.opt_state.m),
                                      scale=1.0 / (1.0 - tr.ps_cfg.opt.b1))
    change = C.leaf_norms(tree_paths(tr.state.params), minus=init)
    return C.Trajectory(losses=[], counts=eng.counts(0, steps),
                        grad_norms=grad_norms, change_norms=change)


def program_trajectory(cell: dict, config: dict, seed: int, device, *,
                       fault=None) -> C.Trajectory:
    with faults.planted(fault, engine=True):
        tr, init = build(config, cell["job"], seed, device)
        eng = Engine(tr, Traffic(cell, seed, tr.dim, device))
        return first_cycles(eng, init, cell["check_steps"])


def reference(cell: dict, config: dict, seed: int, device, *,
              precision: str = "float32") -> C.Trajectory:
    """The reference PS's first cycles on the same bursts; ``precision``
    ``"bfloat16"`` keeps its queue and combine in bfloat16 (the control)."""
    init = lm.draw_params(config, seed, device)
    rules = rules_of(cell["job"])
    ps = RefPS(init, rules, payload_dtype=getattr(torch, precision))
    D = lm.n_params(config)
    traffic = Traffic(cell, seed, D, device)
    rows = torch.empty(cell["job"]["burst_size"], D, dtype=torch.float32,
                       device=device)
    counts, grad_norms = [], {}
    for s in range(cell["check_steps"]):
        meta = traffic.next(rows)
        counts.append(ps.step(meta.now, meta.clusters, meta.workers,
                              meta.times, rows,
                              lambda U, u=meta.uniforms: u))
        if s == 0:
            grad_norms = C.leaf_norms(ps.m, scale=1.0 / (1.0 - rules.b1))
    del rows
    return C.Trajectory(losses=[], counts=counts, grad_norms=grad_norms,
                        change_norms=C.leaf_norms(ps.params, minus=init))


def run(cell: dict, config: dict, seed: int, seconds: float, traced: bool,
        device, t0: float, *, fault=None) -> dict:
    from repro_torch.launch import train as T
    job, steps = cell["job"], cell["check_steps"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    notes = []
    with faults.planted(fault, engine=True):
        t = time.perf_counter()
        tr, init = build(config, job, seed, device)
        eng = Engine(tr, Traffic(cell, seed, tr.dim, device))
        sync()
        t_build = time.perf_counter() - t
        prog = first_cycles(eng, init, steps)
        del init
        sync()
        setup_s = time.perf_counter() - t0
        notes.append(f"set-up {setup_s:.3f} s: trainer and weights "
                     f"{t_build:.3f} s, then {steps} check cycles")
        clocks = [spans.Span(T, "ps_step"), CycleMeta()] if traced else []
        for c in clocks:
            c.__enter__()
        try:
            n0, it, w0 = len(eng.draws), 0, time.perf_counter()
            while time.perf_counter() - w0 < seconds:
                eng.cycle()
                it += 1
            sync()
            window_s = time.perf_counter() - w0
            ps_ms = clocks[0].ms() if traced else []
            n_window = len(clocks[1].calls) if traced else 0
            prof = (trace.profile(eng.cycle, cell["profile_iters"])
                    if traced and on_card else None)
        finally:
            for c in reversed(clocks):
                c.__exit__(None, None, None)
        records, rows = [], []
        if traced:
            p0 = len(eng.pending)
            records = program.stretch(eng.cycle, cell["profile_iters"])
            k = list(T.STAT_KEYS)
            rows = [dict(zip(k, map(float, r)))
                    for r in T.read_stats(eng.pending[p0:])]
        counts = eng.counts(steps, steps + it)
    draw_ms = ([a.elapsed_time(b) for a, b in eng.draws[n0:n0 + it]]
               if on_card else [])
    if draw_ms:
        notes.append(f"the harness's burst draw: {np.mean(draw_ms):.3f} ms "
                     f"a burst of {job['burst_size']} rows (mean of {it}), "
                     f"inside the window")
    notes.append(f"window {window_s:.3f} s, {it} cycles")
    U, K, D = job["burst_size"], tr.ps_cfg.drain_k, tr.dim
    # an update is lost where its cycle's counts are not finite
    failed = U * sum(not np.isfinite(list(c.values())).all() for c in counts)
    ctx = {"iters": it, "window_s": window_s, "spans": {"ps_step": ps_ms},
           "profile": prof, "program_spans": records,
           "program_iters": len(rows), "program_stats": rows}
    if traced:
        param_bytes = 2 if config["dtype"] == "bfloat16" else 4
        cyc = clocks[1].cycle_bytes(D)
        steps_bytes = [sum(cost.ps_step_bytes(b, D, U, K, param_bytes)
                           .values()) for b in cyc[:n_window]]
        ctx["ps_step_least_bytes"] = sum(steps_bytes)
        if prof is not None:
            ctx["olaf_step_least_bytes"] = sum(cyc[n_window:])
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del tr, eng, clocks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = C.compare(prog, reference(cell, config, seed, device))
    notes.append(f"reference {time.perf_counter() - t:.3f} s")
    limits = cell["limits"]
    return {"e2e": {"ps_updates_per_s": it * U / window_s,
                    "setup_s": setup_s},
            "ctx": ctx, "attempted": it * U,
            "failed": int(failed),
            "correct": C.verdict(numbers, limits),
            "compared": C.held(numbers, limits),
            "memory_peak_bytes": int(peak), "notes": notes}
