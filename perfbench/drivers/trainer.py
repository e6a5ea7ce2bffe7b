"""Driver of the OLAF-async training cells.

Set-up builds one ``repro_torch.launch.train.OlafAsyncTrainer`` from the
workload's ``job`` (the program's own command-line flags) on weights the
benchmark draws on the device from the seed, and drives it through its
first ``check_steps`` PS iterations with ``OlafAsyncTrainer.step``, the
call the window makes: they warm up every shape the cell uses and are the
steps the reference follows. The window then calls ``step()`` until
``--seconds`` have passed and ends at the ``synchronize`` after the last
iteration that began inside it. With ``--trace 1`` a CUDA-event span
wraps every ``worker_grad`` and ``ps_step`` call in the window, and a
profiled stretch of ``profile_iters`` more iterations follows it, and then
as many again with the port's own spans on (``lib/program.py``).

Once the window has closed and the trainer is freed, the reference
(:mod:`perfbench.reference.train`) follows the same first steps and
:mod:`perfbench.reference.compare` holds the two against the limits.
"""
from __future__ import annotations

import gc
import time

import numpy as np

from perfbench.lib import faults, program, spans, trace
from perfbench.lib.olaf import build
from perfbench.reference import compare as C
from perfbench.reference import flops, lm
from perfbench.reference.train import reference_trajectory

CONTROL = "fp8"  # the reference's precision in the control

def first_steps(tr, init: dict, steps: int) -> C.Trajectory:
    """``steps`` iterations through ``tr.step()``, with the program's side
    of the comparison read as they pass."""
    from repro_torch.launch import train as T
    from repro_torch.models.module import tree_paths
    b1 = tr.ps_cfg.opt.b1
    grad_norms = {}
    for s in range(steps):
        tr.step()
        if s == 0:
            grad_norms = C.leaf_norms(tree_paths(tr.state.opt_state.m),
                                      scale=1.0 / (1.0 - b1))
    change = C.leaf_norms(tree_paths(tr.state.params), minus=init)
    rows = T.read_stats(tr.pending[:steps])
    k = {n: i for i, n in enumerate(T.STAT_KEYS)}
    counts = [{n: float(r[k[n]]) for n in C.COUNTS} for r in rows]
    return C.Trajectory(losses=[float(r[k["loss"]]) for r in rows],
                        counts=counts, grad_norms=grad_norms,
                        change_norms=change)


def program_trajectory(cell: dict, config: dict, seed: int, device, *,
                       fault=None) -> C.Trajectory:
    """The program's side of the check alone: set-up and its first steps,
    no window (for the calibration of the limits)."""
    with faults.planted(fault):
        tr, init = build(config, cell["job"], seed, device)
        return first_steps(tr, init, cell["check_steps"])


def reference(cell: dict, config: dict, seed: int, device, *,
              precision: str = "float32") -> C.Trajectory:
    """The reference's side; ``precision="fp8"`` is the control."""
    return reference_trajectory(config, cell["job"], seed, device,
                                steps=cell["check_steps"],
                                mm=lm.MM[precision],
                                block_rows=config["ref_block_rows"])


def run(cell: dict, config: dict, seed: int, seconds: float, traced: bool,
        device, t0: float, *, fault=None) -> dict:
    import torch
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch import train as T
    job, steps = cell["job"], cell["check_steps"]
    on_card = device.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    notes = []
    with faults.planted(fault):
        t = time.perf_counter()
        tr, init = build(config, job, seed, device)
        sync()
        t_build = time.perf_counter() - t
        prog = first_steps(tr, init, steps)
        del init
        sync()
        setup_s = time.perf_counter() - t0
        notes.append(f"set-up {setup_s:.3f} s: trainer and weights "
                     f"{t_build:.3f} s, then {steps} check steps "
                     f"{time.perf_counter() - t - t_build:.3f} s")
        clocks = ([spans.Span(T, "worker_grad"), spans.Span(T, "ps_step"),
                   spans.Label(SyntheticLM, "batch", "data.batch")]
                  if traced else [])
        for c in clocks:
            c.__enter__()
        try:
            it, w0 = 0, time.perf_counter()
            while time.perf_counter() - w0 < seconds:
                tr.step()
                it += 1
            sync()
            window_s = time.perf_counter() - w0
            grad_ms = clocks[0].ms() if traced else []
            ps_ms = clocks[1].ms() if traced else []
            prof = (trace.profile(tr.step, cell["profile_iters"])
                    if traced and on_card else None)
        finally:
            for c in reversed(clocks):
                c.__exit__(None, None, None)
        records = (program.stretch(tr.step, cell["profile_iters"])
                   if traced else [])
        stats = T.read_stats(tr.pending[steps:steps + it])
    U = tr.burst_size
    per_worker = (job["batch"] // job["workers"]) * job["seq"]
    tokens = it * U * per_worker
    loss_col = stats[:, list(T.STAT_KEYS).index("loss")]
    failed = int(np.sum(~np.isfinite(loss_col))) * U
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    del tr, stats, clocks
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    notes.append(f"window {window_s:.3f} s, {it} iterations")
    t = time.perf_counter()
    numbers = C.compare(prog, reference(cell, config, seed, device))
    notes.append(f"reference {time.perf_counter() - t:.3f} s")
    limits = cell["limits"]
    ctx = {"iters": it, "window_s": window_s, "tokens": tokens,
           "spans": {"worker_grad": grad_ms, "ps_step": ps_ms},
           "model_flops": tokens * flops.train_flops_per_token(
               config, job["seq"]),
           "profile": prof, "program_spans": records,
           "program_iters": cell["profile_iters"] if traced else 0}
    return {"e2e": {"train_tokens_per_s": tokens / window_s,
                    "setup_s": setup_s},
            "ctx": ctx, "attempted": it * U, "failed": failed,
            "correct": C.verdict(numbers, limits),
            "compared": C.held(numbers, limits),
            "memory_peak_bytes": int(peak), "notes": notes}
