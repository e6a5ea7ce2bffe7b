"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version on the card, drives the
port's main path (the async-DRL trainer, whose every PS drain is one
``olaf_step`` kernel call) at the paper's model width, times the kernels,
and ends with one JSON line ``{"ok": true, "device": {...}}``. Any failed
check raises and exits non-zero before that line. Without a CUDA card, or
without the repository beside it, it fails.

Imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.core import olaf_queue  # noqa: E402
from repro_torch.core.olaf_queue import TorchQueueState, queue_init  # noqa: E402
from repro_torch.core.txctl import TxControlConfig  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.olaf_step import olaf_step_cuda, olaf_step_plain  # noqa: E402
from repro_torch.rl.async_trainer import AsyncDRLTrainer, AsyncTrainConfig  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
RTOL, ATOL = 1e-5, 1e-6  # kernel vs plain payloads: float association only
META = ("cluster", "worker", "seq", "agg_count", "replaceable", "gen_time",
        "reward", "next_seq", "n_dropped", "n_agg", "n_repl", "n_screened")
OUT_EXACT = ("valid", "n_valid", "cluster", "worker", "agg_count",
             "gen_time", "reward")


class SmokeFailure(RuntimeError):
    pass


def require(cond, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# olaf_step: kernel against plain, bytes and bound
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Burst:
    clusters: torch.Tensor  # (S, U) int32
    workers: torch.Tensor
    gen_times: torch.Tensor  # (S, U) float32
    rewards: torch.Tensor
    payloads: torch.Tensor  # (S, U, D)
    send: torch.Tensor  # (S, U) bool
    screen: torch.Tensor
    capacity: torch.Tensor  # (S,) int32
    k: int
    thr: float

    def args(self):
        return (self.clusters, self.workers, self.gen_times, self.rewards,
                self.payloads, self.k, self.thr, self.send, self.capacity,
                self.screen)


def make_burst(gen: torch.Generator, dev, S, U, D, k, n_clusters, n_workers,
               t0, *, capacity, thr=math.inf, send_p=1.0, screen_p=0.0):
    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    ints = lambda hi: torch.randint(0, hi, (S, U), generator=gen,  # noqa: E731
                                    device=dev, dtype=torch.int32)
    return Burst(
        clusters=ints(n_clusters), workers=ints(n_workers),
        gen_times=t0 + rand(S, U), rewards=torch.randn(
            (S, U), generator=gen, device=dev),
        payloads=torch.randn((S, U, D), generator=gen, device=dev),
        send=rand(S, U) < send_p, screen=rand(S, U) < screen_p,
        capacity=torch.full((S,), capacity, dtype=torch.int32, device=dev),
        k=k, thr=thr)


def compare(want, got, what: str) -> float:
    """Exact on metadata and drain fields, RTOL/ATOL on payloads; returns
    the largest absolute payload difference."""
    (st_w, out_w), (st_g, out_g) = want, got
    for f in META:
        require(torch.equal(getattr(st_w, f), getattr(st_g, f)),
                f"{what}: state {f} differs")
    for f in OUT_EXACT:
        require(torch.equal(out_w[f], out_g[f]), f"{what}: drained {f} differs")
    err = 0.0
    for a, b, name in ((st_g.payload, st_w.payload, "state payload"),
                       (out_g["payload"], out_w["payload"], "drained payload")):
        ok = torch.allclose(a, b, rtol=RTOL, atol=ATOL)
        diff = float((a - b).abs().max()) if a.numel() else 0.0
        require(ok, f"{what}: {name} off by {diff}")
        err = max(err, diff)
    return err


def cycle_cost(state: TorchQueueState, b: Burst):
    """(bytes, operations, kernel bytes) of one cycle on this state and
    burst, per queue.

    bytes, the least the cycle must move: 4·D·(contributing burst rows +
    slot rows read + slot rows written + k drained rows) plus every metadata
    element read or written once. A slot row is read where its old payload
    weighs in (touched, no reset in the burst, pre-burst count > 0) or where
    the drain pops it untouched; it is written where its contents change
    (touched and not popped, or popped and occupied before the burst: an
    empty slot's payload is already 0). operations: one add per
    contributing element, one multiply per element of a read touched row,
    one divide per element of a touched row.

    kernel bytes, what ``olaf_step.cu`` moves: every touched or popped slot
    row read and written once, with the same burst, drained and metadata
    terms."""
    S, Q, D = state.payload.shape
    U = b.clusters.shape[1]
    K = min(b.k, Q)
    total_bytes = total_ops = kernel_bytes = 0
    for s in range(S):
        st = state.select(s)
        mid, slots, events = olaf_queue.enqueue_burst_ex(
            st, b.clusters[s], b.workers[s], b.gen_times[s], b.rewards[s],
            b.payloads[s], b.thr, b.send[s], b.capacity[s], b.screen[s])
        slots, events = slots.tolist(), events.tolist()
        last = {q: u for u, (q, e) in enumerate(zip(slots, events))
                if e == olaf_queue.EV_RESET}
        contrib = [u for u, (q, e) in enumerate(zip(slots, events))
                   if (e == olaf_queue.EV_AGG and u > last.get(q, -1))
                   or (e == olaf_queue.EV_RESET and u == last[q])]
        touched = {slots[u] for u in contrib}
        order = torch.sort(mid.seq, stable=True).indices[:K]
        popped = {int(q) for q in order if int(mid.cluster[q]) >= 0}
        occupied = {q for q, c in enumerate(st.cluster.tolist()) if c >= 0}
        counts = st.agg_count.tolist()
        weighed = {q for q in touched if q not in last and counts[q] > 0}
        reads = weighed | (popped - touched)
        writes = (touched - popped) | (popped & occupied)
        meta = 2 * Q * 25 + 2 * 5 * 4 + U * 18 + K * 21
        total_bytes += 4 * D * (len(contrib) + len(reads) + len(writes)
                                + K) + meta
        kernel_bytes += 4 * D * (len(contrib) + 2 * len(touched | popped)
                                 + K) + meta
        total_ops += D * (len(contrib) + len(weighed) + len(touched))
    return total_bytes, total_ops, kernel_bytes


def bound_ms(nbytes: int, nops: int):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_shape(name, dev, gen, S, Q, D, U, k, n_bursts, **kw):
    """Evolve one state through ``n_bursts`` cycles in kernel and plain
    version side by side. Returns (max error, final state, the state before
    the last burst, the last burst)."""
    st = TorchQueueState.stack([queue_init(Q, D, device=dev)] * S)
    err = 0.0
    for i in range(n_bursts):
        pre, b = st, make_burst(gen, dev, S, U, D, k, 2 * Q, 4, float(i), **kw)
        want = olaf_step_plain(st, *b.args())
        got = olaf_step_cuda(st.clone(), *b.args())
        torch.cuda.synchronize()
        err = max(err, compare(want, got, f"{name}[{i}]"))
        st = want[0]
    log(f"[check] {name}: S={S} Q={Q} U={U} k={k} D={D} x{n_bursts} bursts "
        f"match (max |err| {err:.3g})")
    return err, st, pre, b


def time_ms(fn, make_input, reps: int) -> float:
    """Device time of ``fn(input)`` from CUDA events, averaged over
    ``reps``. A busy-wait queued ahead of each start event keeps the card
    occupied while the host enqueues the call, so host time before the
    first launch is not counted; inputs are made outside the timed span."""
    total = 0.0
    for i in range(reps + 2):
        x = make_input()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(x)
        end.record()
        end.synchronize()
        if i >= 2:  # two warm-up calls
            total += start.elapsed_time(end)
    return total / reps


def time_shape(state, b, reps):
    kernel = time_ms(lambda st: olaf_step_cuda(st, *b.args()), state.clone,
                     reps)
    plain = time_ms(lambda st: olaf_step_plain(st, *b.args()), lambda: state,
                    reps)
    kernel2 = time_ms(lambda st: olaf_step_cuda(st, *b.args()), state.clone,
                      reps)
    nbytes, nops, kbytes = cycle_cost(state, b)
    bound, by = bound_ms(nbytes, nops)
    return dict(ms=min(kernel, kernel2), ms_runs=[kernel, kernel2],
                plain_ms=plain, bound_ms=bound, bound_by=by, bytes=nbytes,
                ops=nops, kernel_bytes=kbytes)


def device_kernels(prof):
    """Kernel name -> (calls, device µs) from a profiler trace's device
    events; empty when the trace holds none."""
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n, us = out.get(e.name, (0, 0.0))
            out[e.name] = (n + 1, us + e.time_range.elapsed_us())
    return out


def profile_kernel(state, b, reps=20):
    """Device µs per call of each launch of ``olaf_step_cuda``."""
    inputs = [state.clone() for _ in range(reps)]
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for st in inputs:
            olaf_step_cuda(st, *b.args())
        torch.cuda.synchronize()
    return {name: us / reps for name, (n, us) in device_kernels(prof).items()
            if "olaf" in name}


# ---------------------------------------------------------------------------
# the main path: AsyncDRLTrainer
# ---------------------------------------------------------------------------
class Stopwatch:
    """Wraps a callable and adds up its host wall time (the trainer's
    payload function and drain both end in a device-to-host copy, so their
    wall time includes their device work)."""

    def __init__(self, fn):
        self.fn, self.seconds, self.calls = fn, 0.0, 0

    def __call__(self, *args):
        t0 = time.perf_counter()
        try:
            return self.fn(*args)
        finally:
            self.seconds += time.perf_counter() - t0
            self.calls += 1


def trainer_cfg(**kw):
    return AsyncTrainConfig(
        env="lander", n_clusters=3, workers_per_cluster=2,
        n_updates_per_worker=4, queue_slots=2, out_gbps=1.2e-3,
        ps_drain_k=2, tx_control=TxControlConfig(), **kw)


def injected_payload_run(device):
    """The trainer with seeded payloads in place of PPO gradients, so the
    card's run can be held to the CPU's plain path on the same input."""
    class Injected(AsyncDRLTrainer):
        def _make_payload(self, now, worker_id):
            calls = self.__dict__.setdefault("_calls", {})
            calls[worker_id] = calls.get(worker_id, 0) + 1
            rng = np.random.default_rng([worker_id, calls[worker_id]])
            return (rng.normal(size=self._dim).astype(np.float32),
                    float(np.float32(rng.normal())))

    trainer = Injected(trainer_cfg(), device=device)
    trainer.ps.w = np.linspace(-1.0, 1.0, trainer._dim)
    return trainer.run()


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. the card ------------------------------------------------------
    require(torch.cuda.is_available(), "no CUDA device: this smoke run needs "
            "an NVIDIA card")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    log(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | "
        f"torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build_all()
    log(f"[build] {len(_build.sources())} kernel source(s) in "
        f"{time.perf_counter() - t0:.2f} s")
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "smem" in line or "spill" in line:
                log(f"[build] {name}: {line.strip()}")

    # ---- 3. every kernel against its plain version ------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    err_a2, _, pre_a2, b_a2 = check_shape("a: trainer Q=2", dev, gen, 1, 2,
                                          941, 2, 2, 6, capacity=2)
    err_a8, st_a8, pre_a8, b_a8 = check_shape("a: trainer Q=8", dev, gen, 1,
                                              8, 941, 8, 2, 6, capacity=8)
    err_b, _, pre_b, b_b = check_shape(
        "b: stress", dev, gen, 3, 64, 2**20 + 3, 96, 16, 2, capacity=48,
        thr=0.5, send_p=0.9, screen_p=0.1)
    empty = make_burst(gen, dev, 1, 0, 941, 2, 16, 4, 9.0, capacity=8)
    err_c = compare(olaf_step_plain(st_a8, *empty.args()),
                    olaf_step_cuda(st_a8.clone(), *empty.args()),
                    "c: U=0 drain-only")
    require(bool((st_a8.cluster >= 0).any()), "c: the drained queue was empty")
    torch.cuda.synchronize()
    log(f"[check] c: U=0 drain-only matches (max |err| {err_c:.3g})")
    max_err = max(err_a2, err_a8, err_b, err_c)

    # ---- 4. the main path: the trainer at the paper's model width ---------
    cfg = trainer_cfg()
    olaf_step_cuda.launches = 0
    t0 = time.perf_counter()
    trainer = AsyncDRLTrainer(cfg, device=dev)
    ppo_clock = Stopwatch(trainer.sim_cfg.payload_fn)
    trainer.sim_cfg.payload_fn = ppo_clock
    drain_clock = trainer._drain_ps_queue = Stopwatch(trainer._drain_ps_queue)
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = olaf_step_cuda.launches
    sim = res.sim_result
    n_iter = ppo_clock.calls  # one PPO worker iteration per sent update
    log(f"[trainer] lander D={trainer._dim} clusters=3x2 updates/worker=4 "
        f"slots=2 drain_k=2: delivered={sim.received_at_ps} "
        f"applied={res.ps.applied} rejected={res.ps.rejected} "
        f"aggregated={sum(q['aggregations'] for q in sim.queue_stats.values())} "
        f"generated={sim.generated} sent={sim.sent} deferred={sim.deferred} "
        f"avg_aom={sim.avg_aom():.6f} "
        f"wall={wall:.3f}s worker_iters={n_iter} "
        f"iters/s={n_iter / wall:.3f} "
        f"olaf_step calls={launches} (each 2 CUDA launches: resolve + "
        f"payload)")
    require(trainer._dim == 941, "the lander actor-critic is 941 floats")
    require(launches > 0, "the trainer's drains never launched the kernel")
    require(res.ps.applied > 0, "the PS applied no update")
    require(np.isfinite(res.ps.w).all(), "non-finite PS weights")
    require(all(bool(torch.isfinite(p).all()) for p in
                (res.final_params["policy"]["w"], res.final_params["value"]["w"])),
            "non-finite final parameters")
    log(f"[trainer] breakdown: PPO worker iterations {ppo_clock.seconds:.4f} s "
        f"({100 * ppo_clock.seconds / wall:.2f}%, {ppo_clock.calls} calls), "
        f"PS drains {drain_clock.seconds:.4f} s "
        f"({100 * drain_clock.seconds / wall:.2f}%, {drain_clock.calls} calls), "
        f"rest (netsim, PS apply, set-up) "
        f"{wall - ppo_clock.seconds - drain_clock.seconds:.4f} s")
    # the same run again under the profiler, for the card's busy time; the
    # idle share is that run's own (the profiler slows the host, so the
    # share against the unprofiled wall, which mixes two runs, is shown
    # only beside it)
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        AsyncDRLTrainer(cfg, device=dev).run()
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(us for _, us in kernels.values()) / 1e6
    if busy:
        log(f"[trainer] profiled run: device busy {busy:.4f} s in "
            f"{sum(n for n, _ in kernels.values())} device events over "
            f"{wall_prof:.3f} s wall: idle share {100 * (1 - busy / wall_prof):.2f}% "
            f"(the same busy time over the unprofiled run's {wall:.3f} s: "
            f"{100 * (1 - busy / wall):.2f}%)")
    else:
        log("[trainer] device busy: not measured (the profiler recorded no "
            "device events)")

    # the same trainer with seeded payloads: card (kernel) against CPU (plain)
    card, host = injected_payload_run(dev), injected_payload_run("cpu")
    for f in ("received_at_ps", "generated", "sent", "deferred",
              "raw_updates_delivered", "queue_stats", "agg_counts",
              "deliveries"):
        require(getattr(card.sim_result, f) == getattr(host.sim_result, f),
                f"injected trainer: {f} differs between card and CPU")
    require((card.ps.applied, card.ps.rejected) == (host.ps.applied,
                                                    host.ps.rejected),
            "injected trainer: PS counts differ")
    require(np.allclose(card.ps.w, host.ps.w, rtol=1e-6, atol=0),
            "injected trainer: PS weights differ")
    log(f"[trainer] injected payloads: card equals CPU plain path "
        f"(applied={card.ps.applied}, max |dw| "
        f"{float(np.abs(card.ps.w - host.ps.w).max()):.3g})")

    # ---- 5. timing ---------------------------------------------------------
    t_a = time_shape(pre_a2, b_a2, reps=50)
    t_a8 = time_shape(pre_a8, b_a8, reps=50)
    t_b = time_shape(pre_b, b_b, reps=5)
    for name, t in (("a Q=2 U=2 k=2", t_a), ("a Q=8 U=8 k=2", t_a8),
                    ("b S=3 Q=64 U=96 k=16 D=2^20+3", t_b)):
        log(f"[time] olaf_step {name}: kernel {t['ms']:.4f} ms "
            f"(runs {t['ms_runs'][0]:.4f}, {t['ms_runs'][1]:.4f}) "
            f"plain {t['plain_ms']:.4f} ms bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}, {t['bytes']} B; the kernel moves "
            f"{t['kernel_bytes']} B)")
    split = profile_kernel(pre_a2, b_a2)
    log("[time] olaf_step a Q=2 device us per launch (profiler): " + (
        ", ".join(f"{n} {us:.3f}" for n, us in split.items())
        if split else "not measured"))
    log(f"[time] total smoke wall {time.perf_counter() - t_start:.1f} s")

    entry = dict(
        name="olaf_step", route="cuda",
        source="src/repro_torch/kernels/csrc/olaf_step.cu",
        replaces="src/repro/kernels/olaf_step.py:215",
        launches=launches, max_abs_err=max_err, ms=t_a["ms"],
        plain_ms=t_a["plain_ms"], bound_ms=t_a["bound_ms"],
        bound_by=t_a["bound_by"], library_ms=None,
        bytes=t_a["bytes"], kernel_bytes=t_a["kernel_bytes"],
        cuda_launches_per_call=2, shape="S=1 Q=2 U=2 k=2 D=941 (trainer)",
        stress=dict(shape="S=3 Q=64 U=96 k=16 D=1048579", ms=t_b["ms"],
                    plain_ms=t_b["plain_ms"], bound_ms=t_b["bound_ms"],
                    bytes=t_b["bytes"], kernel_bytes=t_b["kernel_bytes"]),
        trainer_q8=dict(shape="S=1 Q=8 U=8 k=2 D=941", ms=t_a8["ms"],
                        plain_ms=t_a8["plain_ms"], bound_ms=t_a8["bound_ms"],
                        bytes=t_a8["bytes"],
                        kernel_bytes=t_a8["kernel_bytes"]))
    print(smi, flush=True)
    print(json.dumps({"kernels": [entry]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
