"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each kernel against its plain PyTorch version on the card, and drives the
port's paths at the paper's model width, each with every launch count set
to 0 just before it and read just after: the async-DRL trainer (every PS
drain is one ``olaf_step`` kernel call), the hybrid multi-switch data plane
fed by real PPO gradients (``run_hybrid_ppo``: every window lands through
the ``olaf_combine`` kernel), the fat-tree scenario command, the
vectorized simulator (``--sim-impl vectorized``: the fat-tree k=4 command
held to the window run and to the CPU, and ``repro``'s k=8 scale
configuration timed and profiled, its step loop checked for host syncs), the
``ops.olaf_enqueue`` entry point (the ``olaf_enqueue`` kernel), LM
serving of smollm-360m at full width and depth (``launch.serve.serve``
under ``attn_impl="pallas"``: every prefill layer is one
``flash_attention`` launch, every decode layer one ``decode_attention``
launch), and LM training of smollm-360m at full width (``launch.train
--mode olaf-async``: every PS step is one ``olaf_step`` launch at D =
361,821,120, the kernel held to its plain version at that shape; then
``--mode sync``; and a reduced run on the card held to the same run on the
CPU), the PS step's robust combine (``[robust]``: the ``olaf_robust_combine``
kernel against its plain composition, both branches, timed at the
engine cell's K = 4 × D = 361,821,120), and the other LM families (``[families]``: mamba2, recurrentgemma,
grok-1, arctic, internvl2 and whisper served at their published widths,
depth cut only where one card forces it, each one's first period held in
float32 to the plain route and its reduced config to the CPU; mamba2
trained olaf-async at full width; the reduced grok-1, mamba2 and
recurrentgemma olaf-async runs on the card held to the CPU's), the
trainer's checkpointed PS recovery (``[recovery]``: a PS bounce restored
from a snapshot, every drain one ``olaf_step`` launch before and after it,
card against CPU snapshot for snapshot), ``optim/compress.py``
(``[compress]``: top-k ties and non-finite inputs card against CPU, then
timed at smollm-360m's flat size), and the example drivers
(``[examples]``: the quickstart's ``olaf_combine`` demo, ``lm_train
--olaf``, ``serve_decode``), and ``repro_torch.distributed`` with the
sharded vectorized simulator (``[sharded]``: the k=8 scale configuration
on 8 switch shards held bit for bit to one device, a (2,2) mesh at k=4,
``--sim-shards``, the hybrid's switch mesh with one ``olaf_combine``
launch per shard, ``olaf_step_sharded`` with one ``olaf_step`` launch per
shard; on a one-card host every shard runs on that card), activation
checkpointing (``[remat]``: the full-width olaf-async run under
``remat_policy`` none, full and dots, counters equal, peak memory and step
wall each), and the dry-run tooling (``[dryrun]``: ``launch.dryrun --all
--fast`` on the meta device; the sharded pass of one cell per family on
the 16 × 16 mesh over a fake process group, one process each, with their
per-device ``temp_bytes`` and collective bytes by kind; then for
smollm-360m at the ``[train]`` shape on a (1, 1) mesh the predicted
argument bytes against the tensors the trainer holds on the card, and the
predicted peak, argument + temp bytes, against the sync step's
``max_memory_allocated``), and the elastic re-mesh checkpoint (``[ckpt]``, right after
``[train]``: smollm-360m's sync state saved, restored onto the card from
meta likes and resumed bit for bit as ``[train]``'s uninterrupted sync
run; a DTensor round trip over a one-rank NCCL mesh).
The attention kernels are held to their plain versions in both the
folded (BH, S, Dh) layout and the model's strided (B, S, H, Dh) one, and
timed beside SDPA; the flash backward (``[flash-bwd]``) at a smollm-360m
gradient's shape and the families' Dh 128 shapes, beside SDPA's backward,
and the training runs count its launches (one forward per attention layer,
two under remat ``full``, and one backward). It prints each kernel's ptxas registers and spills,
counts each wrapper's device kernels per call in a profiler trace (one,
and no other device operation, for each OLAF wrapper; one for each
attention kernel; or it fails), times the kernels, and the fused
``ops.olaf_forward`` boundary at the scenario's own shape beside the
composition it replaced, and ends with one JSON line ``{"ok": true,
"device": {...}}``.
Any failed check raises and exits non-zero before that line. Without a
CUDA card, or without the repository beside it, it fails.

Imports torch, numpy and ``repro_torch`` only.
"""
from __future__ import annotations

import contextlib
import dataclasses
import inspect
import io
import json
import math
import os
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.core import olaf_queue  # noqa: E402
from repro_torch.core.olaf_queue import TorchQueueState, queue_init  # noqa: E402
from repro_torch.core.netsim import FaultSpec, PSFault, WorkerFault  # noqa: E402
from repro_torch.core.txctl import TxControlConfig  # noqa: E402
from repro_torch.core import hybrid, netsim, topology, vecsim  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention_cuda,  # noqa: E402
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_cuda, flash_attention_backward_plain,
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.olaf_combine import (olaf_combine_cuda,  # noqa: E402
                                              olaf_combine_plain)
from repro_torch.kernels.olaf_enqueue import (olaf_enqueue_cuda,  # noqa: E402
                                              olaf_enqueue_plain)
from repro_torch.kernels.olaf_robust import (  # noqa: E402
    olaf_robust_combine_cuda, olaf_robust_combine_plain)
from repro_torch.kernels.olaf_step import olaf_step_cuda, olaf_step_plain  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import serve as launch_serve  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.examples import lm_train as example_lm_train  # noqa: E402
from repro_torch.examples import quickstart as example_quickstart  # noqa: E402
from repro_torch.examples import serve_decode as example_serve_decode  # noqa: E402
from repro_torch.optim import compress  # noqa: E402
from repro_torch.optim.optimizers import OptConfig, init_opt_state  # noqa: E402
from repro_torch.checkpoint.ckpt import (restore_checkpoint,  # noqa: E402
                                         save_checkpoint)
from repro_torch.models.module import tree_leaves  # noqa: E402
from repro_torch.models import api as lm_api  # noqa: E402
from repro_torch.models import module as lm_module  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.optim.async_rules import ParameterServer  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402
from repro_torch.rl.async_trainer import (AsyncDRLTrainer,  # noqa: E402
                                          AsyncTrainConfig, run_hybrid_ppo)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_OPS_PER_S = 67e12  # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12  # H100 SXM bf16 tensor cores, dense
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


def cycle_cost(state: TorchQueueState, b: Burst, dim=None):
    """(bytes, operations, kernel bytes) of one cycle on this state and
    burst, per queue. ``dim`` gives the payload width where the state and
    burst carry metadata only (zero-width payloads: the train path's D is
    too wide to resolve in the plain version just to count).

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
    row written once and read once unless a reset in the burst restarts it
    (ROADMAP hazard H16), with the same burst, drained and metadata
    terms."""
    S, Q, D = state.payload.shape
    D = D if dim is None else dim
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
        kernel_reads = (touched - set(last)) | (popped - touched)
        kernel_bytes += 4 * D * (len(contrib) + len(kernel_reads)
                                 + len(touched | popped) + K) + meta
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


def launches_per_call(call, setup, names, calls=5, markers=8, tries=4):
    """Device kernels per call of ``call(setup())`` whose names hold one of
    ``names``, and the other device operations per call, as the profiler
    traced ``calls`` calls (after one call outside the trace). The tracer
    can lose device records at either end of a trace (more so after a large
    trace), so the calls are fenced by ``markers`` spin kernels before and
    after, with a wait at each end, and a trace that lost any marker is
    taken again."""
    for attempt in range(tries):
        inputs = [setup() for _ in range(calls + 1)]
        call(inputs[0])
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            time.sleep(0.5 * (attempt + 1))
            for _ in range(markers):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            for x in inputs[1:]:
                call(x)
            for _ in range(markers):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            time.sleep(0.5 * (attempt + 1))
        events = device_kernels(prof)
        seen = sum(n for name, (n, _) in events.items()
                   if "spin_kernel" in name)
        if seen == 2 * markers:
            break
    require(seen == 2 * markers, f"the profiler traced {seen} of its "
            f"{2 * markers} marker kernels in each of {tries} traces")
    mine = sum(n for name, (n, _) in events.items()
               if any(s in name for s in names))
    other = sum(n for n, _ in events.values()) - mine - seen
    return mine / calls, other / calls


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


class InjectedTrainer(AsyncDRLTrainer):
    """The trainer with seeded payloads in place of PPO gradients, so the
    card's run can be held to the CPU's plain path on the same input."""

    def _make_payload(self, now, worker_id):
        calls = self.__dict__.setdefault("_calls", {})
        calls[worker_id] = calls.get(worker_id, 0) + 1
        rng = np.random.default_rng([worker_id, calls[worker_id]])
        return (rng.normal(size=self._dim).astype(np.float32),
                float(np.float32(rng.normal())))


def injected_trainer(cfg, device):
    trainer = InjectedTrainer(cfg, device=device)
    trainer.ps.w = np.linspace(-1.0, 1.0, trainer._dim)
    return trainer


def injected_payload_run(device):
    return injected_trainer(trainer_cfg(), device).run()



# ---------------------------------------------------------------------------
# launch counts: every path is driven with all of them at 0 and read after
# ---------------------------------------------------------------------------
COUNTED = {"olaf_step": olaf_step_cuda, "olaf_combine": olaf_combine_cuda,
           "olaf_enqueue": olaf_enqueue_cuda,
           "olaf_robust_combine": olaf_robust_combine_cuda,
           "flash_attention": flash_attention_cuda,
           "flash_attention_backward": flash_attention_backward_cuda,
           "decode_attention": decode_attention_cuda}


def reset_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0
    olaf_combine_cuda.drain_launches = 0


def read_counts() -> dict:
    """Launches per kernel; ``olaf_combine_drain`` counts the combine
    kernel's drain-only boundaries (no window lands)."""
    return {**{name: fn.launches for name, fn in COUNTED.items()},
            "olaf_combine_drain": olaf_combine_cuda.drain_launches}


# ---------------------------------------------------------------------------
# olaf_combine and olaf_enqueue: kernel against plain, bytes and bound
# ---------------------------------------------------------------------------
def make_window(gen, dev, S, Q, U, D, *, gate_hi=5, cluster_lo=0,
                cluster_hi=None, p_reset=0.3):
    """Seeded combine operands as the hybrid's flush hands them to the
    kernel: a reset slot's count enters at 0."""
    cluster_hi = Q if cluster_hi is None else cluster_hi
    slots = torch.randn((S, Q, D), generator=gen, device=dev)
    counts = torch.randint(0, 6, (S, Q), generator=gen, device=dev,
                           dtype=torch.int32)
    reset = torch.rand((S, Q), generator=gen, device=dev) < p_reset
    counts = torch.where(reset, torch.zeros_like(counts), counts)
    updates = torch.randn((S, U, D), generator=gen, device=dev)
    clusters = torch.randint(cluster_lo, cluster_hi, (S, U), generator=gen,
                             device=dev, dtype=torch.int32)
    gate = torch.randint(0, gate_hi, (S, U), generator=gen, device=dev,
                         dtype=torch.int32) if gate_hi > 0 else \
        torch.zeros((S, U), dtype=torch.int32, device=dev)
    return slots, counts, updates, clusters, gate


def check_combine(name, args) -> float:
    want = olaf_combine_plain(*args)
    got = olaf_combine_cuda(*args)
    again = olaf_combine_cuda(*args)
    torch.cuda.synchronize()
    require(torch.equal(want[1], got[1]), f"{name}: counts differ")
    diff = float((got[0] - want[0]).abs().max()) if got[0].numel() else 0.0
    require(torch.allclose(got[0], want[0], rtol=RTOL, atol=ATOL),
            f"{name}: slots off by {diff}")
    require(torch.equal(got[0], again[0]), f"{name}: not deterministic")
    S, Q, D = args[0].shape
    log(f"[check] olaf_combine {name}: S={S} Q={Q} U={args[2].shape[1]} "
        f"D={D} matches (max |err| {diff:.3g})")
    return diff


def combine_cost(slots, counts, updates, clusters, gate):
    """(bytes, operations, kernel bytes) of one combine on these inputs.
    bytes, the least the function needs: 4·D·(contributing rows + slot rows
    read where count > 0 and hits > 0 + slot rows written where hits > 0)
    plus counts, clusters and gates read once and the new counts written
    once. operations: a multiply and an add per contributing element, and
    per element of a slot with hits > 0 a multiply (count > 0), an add and
    a divide. kernel bytes, what ``olaf_combine.cu`` moves: every slot row
    read and written."""
    S, Q, D = slots.shape
    U = clusters.shape[1]
    inside = (clusters >= 0) & (clusters < Q)
    contrib = int((inside & (gate != 0)).sum())
    hits = torch.zeros((S, Q), dtype=torch.int64, device=slots.device)
    flat = (torch.arange(S, device=slots.device)[:, None] * Q
            + clusters.long().clamp(0, Q - 1))
    hits.view(-1).index_add_(0, flat[inside], gate[inside].long())
    touched = hits > 0
    weighed = int((touched & (counts > 0)).sum())
    n_touched = int(touched.sum())
    meta = 4 * (2 * S * Q + 2 * S * U)
    nbytes = 4 * D * (contrib + weighed + n_touched) + meta
    ops_ = D * (2 * contrib + weighed + 2 * n_touched)
    kernel_bytes = 4 * D * (contrib + 2 * S * Q) + meta
    return nbytes, ops_, kernel_bytes


def time_combine(args, reps):
    kernel = time_ms(lambda a: olaf_combine_cuda(*a), lambda: args, reps)
    plain = time_ms(lambda a: olaf_combine_plain(*a), lambda: args, reps)
    kernel2 = time_ms(lambda a: olaf_combine_cuda(*a), lambda: args, reps)
    nbytes, nops, kbytes = combine_cost(*args)
    bound, by = bound_ms(nbytes, nops)
    return dict(ms=min(kernel, kernel2), ms_runs=[kernel, kernel2],
                plain_ms=plain, bound_ms=bound, bound_by=by, bytes=nbytes,
                ops=nops, kernel_bytes=kbytes)


# ---------------------------------------------------------------------------
# ops.olaf_forward: the fused boundary against the composition it replaced
# ---------------------------------------------------------------------------
class ForwardCapture:
    """Wraps ``ops.olaf_forward`` while a ``with`` block runs, counts its
    calls by window width U and keeps a copy of the last call's arguments
    at each; ``args`` is that of the most common U, so that the boundary
    can be checked and timed at the path's own shape."""

    def __init__(self):
        self.calls, self._last = {}, {}

    def __enter__(self):
        self._orig = orig = ops.olaf_forward

        def wrapper(*a, **kw):
            U = a[2].shape[1]
            self.calls[U] = self.calls.get(U, 0) + 1
            self._last[U] = tuple(
                x.clone() if isinstance(x, torch.Tensor) else np.array(x)
                for x in (*a, kw["drain_hop"]))
            return orig(*a, **kw)

        ops.olaf_forward = wrapper
        return self

    def __exit__(self, *exc):
        ops.olaf_forward = self._orig
        return False

    @property
    def args(self):
        return self._last[max(self.calls, key=self.calls.get)]


def forward_composed(slots, counts, updates, clusters, gate, reset, sw, slot,
                     hop):
    """``ops.olaf_forward`` as it ran before the fusion: the reset mask,
    the combine kernel, then the gather, clear and hop mask as PyTorch
    ops, each host array put on the card by itself."""
    dev = slots.device

    def on(x, dtype):
        return torch.as_tensor(x if isinstance(x, torch.Tensor)
                               else np.asarray(x), dtype=dtype,
                               device=dev).contiguous()

    if updates.shape[1] > 0:
        counts_in = torch.where(on(reset, torch.bool),
                                torch.zeros((), dtype=counts.dtype, device=dev),
                                counts)
        slots, counts = olaf_combine_cuda(slots, counts_in, updates,
                                          on(clusters, torch.int32),
                                          on(gate, torch.int32))
    else:
        slots, counts = slots.clone(), counts.clone()
    sw, slot = on(sw, torch.int64), on(slot, torch.int64)
    drained = slots[sw, slot]
    slots[sw, slot] = 0.0
    counts[sw, slot] = 0
    hops = on(hop, torch.int32)
    drained = torch.where((hops >= -1)[:, None], drained,
                          torch.zeros((), dtype=drained.dtype, device=dev))
    return slots, counts, drained, hops


def on_card(args, dev):
    """A boundary's arguments with every host array already on the card,
    in the kernel's dtypes."""
    dtypes = (None, None, None, torch.int32, torch.int32, torch.bool,
              torch.int32, torch.int32, torch.int32)
    return tuple(x if dt is None else torch.as_tensor(
        np.asarray(x) if not isinstance(x, torch.Tensor) else x, dtype=dt,
        device=dev) for x, dt in zip(args, dtypes))


def forward_operands(gen, dev, S, Q, U, D, sw, slot, hop, *, reset=None):
    """A seeded boundary as the hybrid hands it to ``ops.olaf_forward``:
    slots, counts and updates on the card, the window's small arrays and
    the departures (``sw``, ``slot``, ``hop``) as numpy. ``reset`` names a
    slot that restarts from this window and receives two of its rows."""
    slots, counts, updates, clusters, gate = make_window(gen, dev, S, Q, U, D)
    restart = (torch.rand((S, Q), generator=gen, device=dev) < 0.3).cpu().numpy()
    clusters, gate = clusters.cpu().numpy(), gate.cpu().numpy()
    if reset is not None:
        restart[reset] = True
        clusters[reset[0], :2], gate[reset[0], :2] = reset[1], 1
    return (slots, counts, updates, clusters, gate, restart,
            np.asarray(sw, np.int64), np.asarray(slot, np.int64),
            np.asarray(hop, np.int32))


def check_forward(name, args) -> float:
    """The fused boundary (``ops.olaf_forward``) against its plain version
    and, bitwise, against the composition it replaced."""
    dev = args[0].device
    slots, counts, updates, clusters, gate, reset, sw, slot, hop = on_card(
        args, dev)
    got = ops.olaf_forward(*args[:8], drain_hop=args[8])
    want = olaf_combine_plain(slots, counts, updates, clusters, gate,
                              reset=reset, drain_sw=sw, drain_slot=slot,
                              drain_hop=hop)
    old = forward_composed(*args)
    torch.cuda.synchronize()
    require(torch.equal(got[1], want[1]), f"forward {name}: counts differ")
    require(torch.equal(got[3], hop), f"forward {name}: hops differ")
    err = 0.0
    for g, w, what in ((got[0], want[0], "slots"), (got[2], want[2], "rows")):
        diff = float((g - w).abs().max()) if g.numel() else 0.0
        require(torch.allclose(g, w, rtol=RTOL, atol=ATOL),
                f"forward {name}: {what} off by {diff}")
        err = max(err, diff)
    require(all(torch.equal(a, b) for a, b in zip(got, old)),
            f"forward {name}: differs from the composition it replaced")
    S, Q, D = slots.shape
    log(f"[check] olaf_forward {name}: S={S} Q={Q} U={updates.shape[1]} "
        f"D={D} K={sw.numel()} matches its plain version (max |err| "
        f"{err:.3g}) and the old composition bitwise")
    return err


def forward_cost(slots, counts, updates, clusters, gate, reset, sw, slot,
                 hop):
    """(bytes, operations, kernel bytes) of one boundary. bytes, the least
    it needs: 4·D·(contributing rows + slot rows read where the old value
    weighs in or a popped slot departs untouched + slot rows written where
    hits > 0 or popped + K departing rows) plus the small arrays read once
    and the counts written once; operations as ``combine_cost``. kernel
    bytes, what ``olaf_combine.cu`` moves: every slot row read and
    written, the contributing rows and the departing rows."""
    S, Q, D = slots.shape
    U, K = updates.shape[1], sw.numel()
    popped = torch.zeros((S, Q), dtype=torch.bool, device=slots.device)
    popped[sw.long(), slot.long()] = True
    meta = 4 * (2 * S * Q + 2 * S * U + 3 * K) + S * Q
    if U == 0:
        n_pop = int(popped.sum())
        return 4 * D * (2 * n_pop + K) + meta, 0, 4 * D * (2 * S * Q + K) + meta
    counts_in = torch.where(reset, torch.zeros_like(counts), counts)
    inside = (clusters >= 0) & (clusters < Q)
    contrib = int((inside & (gate != 0)).sum())
    hits = torch.zeros((S, Q), dtype=torch.int64, device=slots.device)
    flat = (torch.arange(S, device=slots.device)[:, None] * Q
            + clusters.long().clamp(0, Q - 1))
    hits.view(-1).index_add_(0, flat[inside], gate[inside].long())
    touched = hits > 0
    weighed = touched & (counts_in > 0)
    reads = int((weighed | (popped & ~touched)).sum())
    writes = int((touched | popped).sum())
    nbytes = 4 * D * (contrib + reads + writes + K) + meta
    ops_ = D * (2 * contrib + int(weighed.sum()) + 2 * int(touched.sum()))
    return nbytes, ops_, 4 * D * (contrib + 2 * S * Q + K) + meta


def time_forward(args, reps):
    """Device ms of the fused boundary and of the composition it replaced,
    in turns, from the hybrid's host arrays and from arrays already on the
    card."""
    staged = on_card(args, args[0].device)

    def fused(a):
        return ops.olaf_forward(*a[:8], drain_hop=a[8])

    def composed(a):
        return forward_composed(*a)

    out = {}
    for label, a in (("host", args), ("card", staged)):
        runs = [time_ms(fn, lambda: a, reps) for fn in
                (composed, fused, fused, composed)]
        out[label] = dict(ms=min(runs[1:3]), composed_ms=min(runs[0], runs[3]),
                          runs=runs)
    slots, counts, updates, clusters, gate, reset, sw, slot, hop = staged
    plain = time_ms(lambda a: olaf_combine_plain(
        *a[:5], reset=a[5], drain_sw=a[6], drain_slot=a[7], drain_hop=a[8]),
        lambda: staged, reps)
    nbytes, nops, kbytes = forward_cost(*staged)
    bound, by = bound_ms(nbytes, nops)
    return dict(ms=out["card"]["ms"], composed_ms=out["card"]["composed_ms"],
                host_ms=out["host"]["ms"],
                host_composed_ms=out["host"]["composed_ms"],
                runs=dict(card=out["card"]["runs"], host=out["host"]["runs"]),
                plain_ms=plain, bound_ms=bound, bound_by=by, bytes=nbytes,
                ops=nops, kernel_bytes=kbytes)


def enqueue_burst_of(gen, dev, Q, U, D, t0, *, capacity, thr=math.inf,
                     screen_p=0.0):
    """A one-queue burst for the enqueue kernel: every row sent."""
    b = make_burst(gen, dev, 1, U, D, 0, 2 * Q, 4, t0, capacity=capacity,
                   thr=thr, screen_p=screen_p)
    b.send = torch.ones_like(b.send)
    return b


def enqueue_args(b):
    return (b.clusters[0], b.workers[0], b.gen_times[0], b.rewards[0],
            b.payloads[0], b.thr, int(b.capacity[0]), b.screen[0])


def check_enqueue(name, dev, gen, Q, U, D, n_bursts, **kw):
    """Evolve one queue through ``n_bursts`` enqueues in kernel and plain
    version side by side. Returns (max error, the state before the last
    burst, the last burst)."""
    st = queue_init(Q, D, device=dev)
    err = 0.0
    for i in range(n_bursts):
        pre, b = st, enqueue_burst_of(gen, dev, Q, U, D, float(i), **kw)
        want = olaf_enqueue_plain(st, *enqueue_args(b))
        got = olaf_enqueue_cuda(st.clone(), *enqueue_args(b))
        torch.cuda.synchronize()
        for f in META:
            require(torch.equal(getattr(want, f), getattr(got, f)),
                    f"{name}[{i}]: state {f} differs")
        diff = float((got.payload - want.payload).abs().max())
        require(torch.allclose(got.payload, want.payload, rtol=RTOL,
                               atol=ATOL), f"{name}[{i}]: payload off by {diff}")
        err = max(err, diff)
        st = want
    require(int(st.n_agg) > 0, f"{name}: no aggregation")
    log(f"[check] olaf_enqueue {name}: Q={Q} U={U} D={D} x{n_bursts} bursts "
        f"match (max |err| {err:.3g}; n_agg={int(st.n_agg)} "
        f"n_dropped={int(st.n_dropped)} n_screened={int(st.n_screened)})")
    return err, pre, b


def time_enqueue(state, b, reps):
    """The enqueue is the cycle with k = 0: ``cycle_cost`` counts it."""
    args = enqueue_args(b)
    kernel = time_ms(lambda st: olaf_enqueue_cuda(st, *args), state.clone,
                     reps)
    plain = time_ms(lambda st: olaf_enqueue_plain(st, *args), lambda: state,
                    reps)
    kernel2 = time_ms(lambda st: olaf_enqueue_cuda(st, *args), state.clone,
                      reps)
    nbytes, nops, kbytes = cycle_cost(TorchQueueState.stack([state]), b)
    bound, by = bound_ms(nbytes, nops)
    return dict(ms=min(kernel, kernel2), ms_runs=[kernel, kernel2],
                plain_ms=plain, bound_ms=bound, bound_by=by, bytes=nbytes,
                ops=nops, kernel_bytes=kbytes)


# ---------------------------------------------------------------------------
# the hybrid path: run_hybrid_ppo and the scenario command
# ---------------------------------------------------------------------------
HYBRID_KW = dict(n_clusters_per_group=2, workers_per_cluster=2, horizon=0.2,
                 interval_s1=0.04, interval_s2=0.05, x1_gbps=2e-3,
                 x2_gbps=2e-3, sw3_gbps=3e-3, size_bits=30112,
                 sw12_slots=4, sw3_slots=4)
# the profiled repeats are shorter runs of the same configurations (the
# trainer's 1 of 4 updates a worker, the hybrid's first 0.1 s of 0.2: 10 of
# its 24 window landings), which keeps the script inside its time limit
TRAINER_PROFILED_UPDATES = 1
HYBRID_PROFILED_HORIZON = 0.1


class Clocks:
    """Host wall time of named functions while a ``with`` block runs: each
    (owner, attribute) is wrapped and restored on exit."""

    def __init__(self, **targets):
        self.targets = targets
        self.seconds = {name: 0.0 for name in targets}
        self.calls = {name: 0 for name in targets}
        self._saved = []

    def __enter__(self):
        for name, (owner, attr) in self.targets.items():
            orig = getattr(owner, attr)
            self._saved.append((owner, attr, orig))

            def wrapper(*a, _orig=orig, _name=name, **kw):
                t0 = time.perf_counter()
                try:
                    return _orig(*a, **kw)
                finally:
                    self.seconds[_name] += time.perf_counter() - t0
                    self.calls[_name] += 1

            setattr(owner, attr, wrapper)
        return self

    def __exit__(self, *exc):
        for owner, attr, orig in reversed(self._saved):
            setattr(owner, attr, orig)
        return False


def hybrid_ppo_run(dev):
    return run_hybrid_ppo(env="lander", device=dev, seed=0, **HYBRID_KW)


def hybrid_rows_run(dev, impl):
    """``run_hybrid_multihop`` on the PPO path's configuration with seeded
    rows in place of the gradients."""
    rows = np.random.default_rng(2024).normal(size=(64, 941)).astype(
        np.float32)
    res, _ = hybrid.run_hybrid_multihop(941, payload_rows=rows, seed=0,
                                        sim_impl=impl, device=dev,
                                        **HYBRID_KW)
    return res


HYBRID_COUNTERS = ("launches", "combined_updates", "forward_launches",
                   "switch_launches", "forwarded", "h2d_transfers",
                   "queue_stats", "residual_slot_counts", "link_dropped",
                   "rerouted")


# ---------------------------------------------------------------------------
# the vectorized simulator: the exact fat-tree run and the k=8 scale run
# ---------------------------------------------------------------------------
VECSIM_EXACT = ["--mode", "scenario", "--topology", "fattree", "--fattree-k",
                "4", "--sim-dim", "941", "--sim-impl", "vectorized"]
# repro's vecsim_scale k=8 row (benchmarks/bench_vecsim.py): 80 switches,
# 1024 workers, a coarse uniform grid of 2^-11 s (256 boundaries + tail)
VECSIM_SCALE = dict(k=8, spines=8, clusters_per_ingress=2,
                    workers_per_cluster=8, gen_interval=2.0 ** -6,
                    gen_jitter=0.3, size_bits=8192, horizon=0.125, seed=3)
VECSIM_DT = 2.0 ** -11
VECSIM_D = 941
VECSIM_WIDTH = 8  # arrival columns the k=8 bursts need (its busiest step)
VECSIM_PROFILED_STEPS = 32  # boundaries of the profiled repeat
VECSIM_SYNC_STEPS = 64  # boundaries stepped under set_sync_debug_mode("error")


def delivery_key(d):
    """A delivery's metadata with its gen_time in float32 (the vectorized
    model keeps times in float32, hazard H4; float32 rounding is monotone,
    so a float64 max rounds to the float32 max)."""
    t, u, _ = d
    return (u.cluster_id, u.worker_id, float(np.float32(u.gen_time)),
            u.agg_count, u.subsumed, t)


def compare_deliveries(want, got, what, *, time_rtol, rtol, atol) -> float:
    """The delivered metadata multisets equal, times within ``time_rtol``
    relative, rows within ``rtol``/``atol``; returns the max |err|."""
    require(len(want.delivered) == len(got.delivered) > 0,
            f"{what}: {len(want.delivered)} against {len(got.delivered)} "
            f"deliveries")
    err = 0.0
    for a, b in zip(sorted(want.delivered, key=delivery_key),
                    sorted(got.delivered, key=delivery_key)):
        require(delivery_key(a)[:5] == delivery_key(b)[:5],
                f"{what}: delivered metadata differs")
        require(abs(a[0] - b[0]) <= time_rtol * max(1.0, abs(a[0])),
                f"{what}: delivery times differ")
        pa, pb = a[2].float().cpu(), b[2].float().cpu()
        require(torch.allclose(pb, pa, rtol=rtol, atol=atol),
                f"{what}: payloads differ")
        err = max(err, float((pa - pb).abs().max()))
    return err


def vecsim_scale_cfg():
    spec = topology.fattree_spec(VECSIM_SCALE["k"],
                                 spines=VECSIM_SCALE["spines"])
    kw = {k: v for k, v in VECSIM_SCALE.items() if k not in ("k", "spines")}
    return topology.build_sim_cfg(spec, **kw)


def vecsim_rows(cfg):
    """Seeded rows, one per generation the schedule holds (an upper bound
    on the fresh sends), as the coarse-grid hybrid sizes them."""
    gen_times, _ = netsim.generation_schedule(cfg)
    n = sum(len(t) for t in gen_times.values())
    return np.random.default_rng(3).normal(size=(n, VECSIM_D)).astype(
        np.float32)


def vecsim_segment(cfg, rows, dev, n_steps):
    """The first ``n_steps`` boundaries of the scale run, staged and with
    a fresh carry, ready to step: ``(runner, carry, ts)``."""
    comp = vecsim.compile_scenario(cfg, dim=VECSIM_D, payload_rows=rows)
    grid = vecsim.uniform_grid(cfg, VECSIM_DT, allow_coarse=True)
    arrs = vecsim._stage(comp.arrays, dev)
    runner = vecsim._Runner(comp.static, arrs, VECSIM_WIDTH,
                            float(comp.arrays["horizon"]))
    ts = torch.from_numpy(grid[:n_steps]).to(dev)
    return runner, runner.init_carry(), ts


def vecsim_phase(dev, scen) -> dict:
    """``[vecsim]``: the vectorized simulator on the card.

    (1) The fat-tree k=4 scenario command with ``--sim-impl vectorized``
    at D = 941 on the trace-derived exact grid, held to the card's own
    window run (``scen``, from ``[scenario]``: counters, the delivered
    multiset, times and rows) and to the same command on the CPU (every
    field, the residual slots included). (2) ``repro``'s ``vecsim_scale`` k=8 configuration at D = 941
    through ``run_vecsim``: wall, boundaries/s, device events per step and
    the card's idle share (a profiled repeat of a segment and its
    unprofiled wall), peak memory; its counters equal a CPU run's. (3) A
    segment stepped under ``torch.cuda.set_sync_debug_mode("error")``: the
    step makes no host sync. The path launches none of the port's kernels
    (its burst is plain PyTorch, as ``repro``'s is XLA). Returns the
    exact run's launch counts."""
    t_phase = time.perf_counter()
    # ---- (1) the exact run -----------------------------------------------
    reset_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vec = launch_train.main(VECSIM_EXACT)
    torch.cuda.synchronize()
    wall_exact = time.perf_counter() - t0
    counts = read_counts()
    require(not any(counts.values()), f"the vecsim path launched a kernel: "
            f"{counts}")
    on = torch.device(dev).type
    require(all(p.device.type == on and bool(torch.isfinite(p).all())
                for _, _, p in vec.delivered), "[vecsim] exact run rows")
    # the residual slots are not compared with the window run: the window
    # replay keeps the head in service in its slot, the vectorized model
    # in its service register (so in repro too the two differ here)
    for f in ("queue_stats", "forwarded", "link_dropped", "rerouted",
              "drops_by_switch"):
        require(getattr(vec, f) == getattr(scen, f),
                f"[vecsim] exact run: {f} differs from the window run")
    err_w = compare_deliveries(scen, vec, "[vecsim] against window",
                               time_rtol=2e-5, rtol=RTOL, atol=ATOL)
    t0 = time.perf_counter()
    host = launch_train.main(VECSIM_EXACT + ["--device", "cpu"])
    wall_exact_cpu = time.perf_counter() - t0
    for f in ("queue_stats", "residual_slot_counts", "forwarded",
              "link_dropped", "rerouted", "combined_updates", "launches",
              "h2d_transfers", "drops_by_switch"):
        require(getattr(vec, f) == getattr(host, f),
                f"[vecsim] exact run: {f} differs between card and CPU")
    require(np.array_equal(vec.final_counts, host.final_counts),
            "[vecsim] exact run: final_counts differ between card and CPU")
    err_c = 0.0
    for (t_a, u_a, p_a), (t_b, u_b, p_b) in zip(host.delivered,
                                                vec.delivered):
        require(t_a == t_b and dataclasses.astuple(u_a)
                == dataclasses.astuple(u_b),
                "[vecsim] exact run: delivery metadata differs between card "
                "and CPU")
        err_c = max(err_c, float((p_b.cpu() - p_a).abs().max()))
    require(err_c <= 1e-6, f"[vecsim] exact run: card payloads differ from "
            f"the CPU's by {err_c:.3g}")
    log(f"[vecsim] fat-tree k=4 exact grid D={VECSIM_D}: {vec.launches} "
        f"steps, {len(vec.delivered)} deliveries, card wall {wall_exact:.3f} "
        f"s (CPU {wall_exact_cpu:.3f} s), {vec.h2d_transfers} h2d; equals "
        f"the window run (max |err| {err_w:.3g}) and the CPU run (max |err| "
        f"{err_c:.3g}); launch counts {counts}")

    # ---- (2) the scale run ------------------------------------------------
    cfg = vecsim_scale_cfg()
    rows = vecsim_rows(cfg)
    kw = dict(dt=VECSIM_DT, allow_coarse=True, dim=VECSIM_D,
              payload_rows=rows, width=VECSIM_WIDTH)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = vecsim.run_vecsim(cfg, device=dev, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    n_sw = len(cfg.switches)
    require(n_sw == 80 and len(cfg.workers) == 1024,
            f"the k=8 configuration has {n_sw} switches")
    require(res.passes == 1, "the k=8 run outgrew its burst width")
    require(res.delivered_payloads.device.type == on
            and bool(torch.isfinite(res.delivered_payloads).all()),
            "[vecsim] scale run rows")
    # a segment unprofiled, then the same segment profiled: every step runs
    # the same ops on the same shapes, so a segment is every step's cost
    walls = []
    for profiled in (False, True):
        runner, carry, ts = vecsim_segment(cfg, rows, dev,
                                           VECSIM_PROFILED_STEPS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            runner.run(carry, ts)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    seg_wall, seg_wall_p = walls
    kernels = device_kernels(prof)
    busy = sum(us for _, us in kernels.values()) / 1e6
    events = sum(n for n, _ in kernels.values())
    idle = idle_p = per_step = None
    if busy:
        idle, idle_p = (100 * (1 - busy / w) for w in (seg_wall, seg_wall_p))
        per_step = events / VECSIM_PROFILED_STEPS
    # the step loop under the sync check
    runner, carry, ts = vecsim_segment(cfg, rows, dev, VECSIM_SYNC_STEPS)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner.run(carry, ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the same configuration on the CPU: every counter equal
    t0 = time.perf_counter()
    res_c = vecsim.run_vecsim(cfg, device="cpu", **kw)
    wall_cpu = time.perf_counter() - t0
    for f in dataclasses.fields(res.sim):
        a, b = getattr(res.sim, f.name), getattr(res_c.sim, f.name)
        if f.name == "delivered_updates":
            a = [dataclasses.astuple(u) for u in a]
            b = [dataclasses.astuple(u) for u in b]
        require(a == b, f"[vecsim] scale run: {f.name} differs between card "
                f"and CPU")
    for f in ("aom", "n_steps", "forwarded", "residual", "h2d_transfers"):
        require(getattr(res, f) == getattr(res_c, f),
                f"[vecsim] scale run: {f} differs between card and CPU")
    require(np.array_equal(res.delivery_times, res_c.delivery_times)
            and np.array_equal(res.final_counts, res_c.final_counts),
            "[vecsim] scale run: delivery times or final counts differ")
    err_s = float((res.delivered_payloads.cpu()
                   - res_c.delivered_payloads).abs().max()) \
        if len(res.delivery_times) else 0.0
    require(err_s <= 1e-6, f"[vecsim] scale run payloads differ by {err_s}")
    rate = res.n_steps / wall
    top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:5]
    log(f"[vecsim] scale fat-tree k=8 ({n_sw} switches, {len(cfg.workers)} "
        f"workers) D={VECSIM_D} dt=2^-11 width {res.width}: "
        f"{res.n_steps} boundaries in {wall:.3f} s wall = {rate:.2f} "
        f"boundaries/s ({1e3 * wall / res.n_steps:.3f} ms/boundary), "
        f"{res.sim.sent} sent, {len(res.delivery_times)} delivered, "
        f"{res.forwarded} forwarded; peak memory {peak / 2**20:.1f} MiB "
        f"above the {base / 2**20:.1f} MiB held; CPU run {wall_cpu:.3f} s, "
        f"every counter equal (max |err| {err_s:.3g})")
    if busy:
        log(f"[vecsim] scale segment of {VECSIM_PROFILED_STEPS} boundaries: "
            f"{seg_wall:.4f} s unprofiled, profiled repeat {seg_wall_p:.4f} "
            f"s: device busy {busy:.4f} s in {events} device events "
            f"({per_step:.1f} per step): idle share {idle:.2f}% of the "
            f"unprofiled wall ({idle_p:.2f}% of the profiled one); the "
            f"largest: " + "; ".join(f"{n[:50]} x{c} {us / 1e3:.3f} ms"
                                    for n, (c, us) in top))
    else:
        log("[vecsim] device busy: not measured (the profiler recorded no "
            "device events)")
    log(f"[vecsim] {VECSIM_SYNC_STEPS} steps under set_sync_debug_mode"
        f"(\"error\"): no host sync")
    phase_s = time.perf_counter() - t_phase
    log(f"[vecsim] phase wall {phase_s:.1f} s")
    log("[vecsim] json " + json.dumps(dict(
        exact_steps=vec.launches, exact_wall_s=wall_exact,
        exact_cpu_wall_s=wall_exact_cpu, scale_wall_s=wall,
        boundaries_per_s=rate, n_steps=res.n_steps, width=res.width,
        events_per_step=per_step, idle_share=idle, idle_share_profiled=idle_p,
        peak_bytes=peak, scale_cpu_wall_s=wall_cpu, phase_s=phase_s,
        max_abs_err=max(err_w, err_c, err_s))))
    return counts


# ---------------------------------------------------------------------------
# the sharded vectorized simulator and distributed/sharding.py over a mesh
# ---------------------------------------------------------------------------
# repro's vecsim_scale switch mesh (benchmarks/bench_vecsim.py): 8 shards
SHARDED_SHARDS = 8
# first boundaries of the k=8 run held against one device: the first
# deliveries reach the PS near boundary 112
SHARDED_STEPS = 128
SHARDED_PROFILED_STEPS = 4  # boundaries of the profiled repeat
SHARDED_SYNC_STEPS = 8  # boundaries stepped under set_sync_debug_mode("error")
SHARDED_DT = 2.0 ** -8  # the k=4 runs' coarse grid (128 boundaries)
SHARDED_K4 = ["--mode", "scenario", "--topology", "fattree", "--fattree-k",
              "4", "--sim-dim", str(VECSIM_D), "--sim-impl", "vectorized",
              "--sim-dt", str(SHARDED_DT)]
SHARDED_HYBRID_DEVICES = 3  # fat-tree k=4: 21 switches, 7 a shard


def spread(n: int):
    """``n`` mesh entries over the visible cards, round robin: all on one
    card on a one-card host."""
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def sharded_segment(comp, grid, devs, n_steps, ring):
    """The sharded runner over ``devs`` ((ns, nw) devices) for the first
    ``n_steps`` boundaries, staged and with a fresh carry: ``(runner,
    carry, ts)``."""
    perm = vecsim._stripe_perm(comp.static.S, devs.shape[0])
    arrays = dict(comp.arrays)
    for k in vecsim._SWITCH_AXIS_KEYS:
        arrays[k] = comp.arrays[k][perm]
    home = devs[0, 0]
    runner = vecsim._ShardedRunner(
        comp.static, vecsim._stage(arrays, home), devs, VECSIM_WIDTH,
        float(comp.arrays["horizon"]), ring)
    return runner, runner.init_carry(), \
        torch.from_numpy(grid[:n_steps]).to(home)


def compare_carries(one: dict, split: dict, shards: list, key2_off: int):
    """The one-device carry against the sharded one gathered to the mesh's
    first device (original switch order): every tensor bit for bit (the
    delivery and drop logs up to their scratch row); the transit ring by
    its times (the ghost ring) and each shard's live rows against the one
    ring's row in their slot. Returns the count of tensors compared."""
    n = [0]

    def eq(a, b, what):
        require(a.shape == b.shape and a.dtype == b.dtype
                and torch.equal(a, b), f"[sharded] carry {what} differs")
        n[0] += 1

    for key in one:
        if key in ("dlv", "drp"):
            # each log's scratch row past its end takes every discarded
            # write, in no set order on a card (H21): it is not compared
            for f, v in one[key].items():
                w = split[key][f]
                eq(v[:-1] if v.dim() else v, w[:-1] if w.dim() else w,
                   f"{key}.{f}")
        elif key != "tr":
            vecsim._tree_map(lambda a, b, k=key: eq(a, b, k), one[key],
                             split[key])
    eq(one["tr"]["time"], split["ghost"], "transit ring times")
    live = 0
    for x in shards:
        tr = x["tr"]
        m = torch.isfinite(tr["time"])
        slot = (tr["key2"][m] - key2_off).long()
        live += int(m.sum())
        for f, v in one["tr"].items():
            eq(tr[f][m], v[slot], f"transit ring {f}")
    require(live == int(torch.isfinite(one["tr"]["time"]).sum()),
            "[sharded] the local rings hold other rows than the one ring")
    return n[0]


def vecsim_results_equal(a, b, what, *, atol=0.0) -> float:
    """Every ``VecSimResult`` field equal; payloads bit for bit, or within
    ``atol`` (card against CPU). Returns the max |err| of the payloads."""
    for f in dataclasses.fields(a.sim):
        x, y = getattr(a.sim, f.name), getattr(b.sim, f.name)
        if f.name == "delivered_updates":
            x = [dataclasses.astuple(u) for u in x]
            y = [dataclasses.astuple(u) for u in y]
        require(x == y, f"{what}: {f.name} differs")
    for f in ("aom", "n_steps", "forwarded", "residual", "h2d_transfers"):
        require(getattr(a, f) == getattr(b, f), f"{what}: {f} differs")
    require(np.array_equal(a.delivery_times, b.delivery_times)
            and np.array_equal(a.final_counts, b.final_counts),
            f"{what}: delivery times or final counts differ")
    pa, pb = a.delivered_payloads.cpu(), b.delivered_payloads.cpu()
    err = float((pa - pb).abs().max()) if pa.numel() else 0.0
    require(torch.equal(pa, pb) if atol == 0.0 else err <= atol,
            f"{what}: payloads differ by {err}")
    return err


class CombineCheck:
    """Replaces ``ops.olaf_combine_multi`` inside a ``with`` block and holds
    every call's result (the kernel's, on the card) to
    ``olaf_combine_plain`` on clones of the same operands and reset mask:
    counts exact, slots within RTOL/ATOL. ``err`` is the largest slot
    difference, ``shapes`` the switch counts the calls saw."""

    def __init__(self, what):
        self.what, self.calls, self.err, self.shapes = what, 0, 0.0, set()

    def __enter__(self):
        self._orig = orig = ops.olaf_combine_multi

        def wrapper(*a, reset=None, **kw):
            before = [x.clone() for x in a]
            rs = None if reset is None else reset.clone()
            got = orig(*a, reset=reset, **kw)
            want = olaf_combine_plain(*before[:4], before[4].to(torch.int32),
                                      reset=rs)
            self.calls += 1
            self.shapes.add(a[0].shape[0])
            what = f"{self.what}: olaf_combine call {self.calls}"
            require(torch.equal(want[1], got[1]), f"{what}: counts differ")
            diff = float((got[0] - want[0]).abs().max())
            require(torch.allclose(got[0], want[0], rtol=RTOL, atol=ATOL),
                    f"{what}: slots off by {diff}")
            self.err = max(self.err, diff)
            return got

        ops.olaf_combine_multi = wrapper
        return self

    def __exit__(self, *exc):
        ops.olaf_combine_multi = self._orig
        return False


def hybrid_rows_equal(got, want, what, atol) -> float:
    """Every counter and trace field of two hybrid results equal, the
    delivered rows within ``atol``; returns the largest row difference."""
    for f in HYBRID_COUNTERS + ("drops_by_switch",):
        require(getattr(got, f) == getattr(want, f),
                f"[sharded] hybrid vs the {what} run: {f} differs")
    require(np.array_equal(got.final_counts, want.final_counts)
            and len(got.delivered) == len(want.delivered) > 0,
            f"[sharded] hybrid vs the {what} run: final counts or "
            f"deliveries differ")
    err = 0.0
    for (t_a, u_a, p_a), (t_b, u_b, p_b) in zip(got.delivered,
                                                want.delivered):
        require(t_a == t_b and dataclasses.astuple(u_a)
                == dataclasses.astuple(u_b), f"[sharded] hybrid vs the "
                f"{what} run: delivery metadata differs")
        err = max(err, float((p_a.cpu() - p_b.cpu()).abs().max()))
    require(err <= atol, f"[sharded] hybrid vs the {what} run: rows differ "
            f"by {err}")
    return err


def sharded_phase(dev, pre_b, b_b) -> dict:
    """``[sharded]``: ``repro_torch.distributed`` and the sharded
    vectorized simulator over meshes of devices (on a one-card host every
    mesh entry is that card).

    (a) ``repro``'s ``vecsim_scale`` k=8 configuration at full width on
    the 8-way switch mesh of ``benchmarks/bench_vecsim.py``: its first
    ``SHARDED_STEPS`` boundaries held bit for bit to the one-device runner
    on the same segment (every tensor of the carry after the gather and the
    inverse permutation), both timed; a profiled repeat for the device
    events per boundary and the idle share; peak memory; then (f) a
    sharded segment under ``set_sync_debug_mode("error")``. (b) A (2,2)
    mesh on the fat-tree k=4 scenario (coarse grid, D = 941) against the
    one-device card run and the same call on the CPU, and with a forced
    local-ring and a forced width retry. (c) The scenario command with
    ``--sim-shards 4`` against the same command without it. (d) The hybrid
    (fat-tree k=4, windowed replay) with ``sharded=True`` over 3 mesh
    entries: 3 ``olaf_combine`` launches per flush, equal to the one-launch
    run. (e) ``olaf_step_sharded`` over 3 shards at the stress shape: 3
    launches, equal to one ``olaf_step_multi`` launch, also with a
    heterogeneous capacity vector. Returns each path's launch counts and
    the numbers."""
    from repro_torch.distributed import sharding
    t_phase = time.perf_counter()
    out = {}
    # ---- (a) k=8 at full width on 8 switch shards --------------------------
    cfg = vecsim_scale_cfg()
    rows = vecsim_rows(cfg)
    comp = vecsim.compile_scenario(cfg, dim=VECSIM_D, payload_rows=rows)
    grid = vecsim.uniform_grid(cfg, VECSIM_DT, allow_coarse=True)
    st = comp.static
    mesh = sharding.vecsim_mesh(len(cfg.switches),
                                devices=spread(SHARDED_SHARDS))
    devs = np.asarray(mesh.devices)
    require(mesh.shape == {"switch": SHARDED_SHARDS, "worker": 1}
            and len(cfg.switches) == 80 and len(cfg.workers) == 1024
            and st.D == VECSIM_D, f"[sharded] k=8 mesh {mesh.shape}")
    log(f"[sharded] k=8 mesh {mesh.shape} on "
        f"{[str(d) for d in devs.flat]}; S={st.S} (80 real) W={st.W} "
        f"D={st.D}, dt=2^-11, the first {SHARDED_STEPS} of {len(grid)} "
        f"boundaries")
    # the one-device runner on the same segment, timed
    runner1, carry1, ts1 = vecsim_segment(cfg, rows, dev, SHARDED_STEPS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one = runner1.run(carry1, ts1)
    torch.cuda.synchronize()
    wall1 = time.perf_counter() - t0
    ring = vecsim._default_ring(comp, SHARDED_SHARDS)
    while True:
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        runner, carry, ts = sharded_segment(comp, grid, devs, SHARDED_STEPS,
                                            ring)
        reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry = runner.run(carry, ts)
        torch.cuda.synchronize()
        wall8 = time.perf_counter() - t0
        counts_a = read_counts()
        peak = torch.cuda.max_memory_allocated() - base
        split = runner.gather(carry)
        if not bool(split["ovf"]["trl"]) or ring >= st.Rt:
            break
        log(f"[sharded] a local transit ring of {ring} slots overflowed: "
            f"repeating with {min(st.Rt, 2 * ring)}")
        ring = min(st.Rt, 2 * ring)
    require(not bool(split["ovf"]["trl"]), "[sharded] local ring overflow")
    require(int(split["max_active"]) <= runner.U
            and int(one["max_active"]) <= runner1.U,
            "[sharded] the segment outgrew its burst width")
    require(not any(counts_a.values()), f"[sharded] the sharded vecsim "
            f"launched a kernel: {counts_a}")
    n_cmp = compare_carries(one, split, carry["sw"], runner.key2_off)
    n_dlv, n_sent = int(split["dlv"]["n"]), int(split["sent"])
    require(n_sent > 0 and int(split["forwarded"]) > 0 and n_dlv > 0,
            "[sharded] the segment sent, forwarded or delivered nothing")
    rate1, rate8 = SHARDED_STEPS / wall1, SHARDED_STEPS / wall8
    log(f"[sharded] k=8 segment: 8 shards {wall8:.3f} s = {rate8:.3f} "
        f"boundaries/s, one device {wall1:.3f} s = {rate1:.3f} boundaries/s "
        f"(x{rate1 / rate8:.2f}); local ring {ring} of Rt={st.Rt} slots; "
        f"{n_sent} sent, {int(split['forwarded'])} forwarded, {n_dlv} "
        f"delivered; the gathered carry equals the one-device carry bit for "
        f"bit ({n_cmp} tensors: every counter, delivery time and row, AoM, "
        f"the queues and residual slots, the transit ring); peak memory "
        f"{peak / 2**20:.1f} MiB above the {base / 2**20:.1f} MiB held; "
        f"launch counts {counts_a}")
    del one, carry1, runner1
    # a segment unprofiled, then the same segment profiled
    walls = []
    for profiled in (False, True):
        runner_p, carry_p, ts_p = sharded_segment(
            comp, grid, devs, SHARDED_PROFILED_STEPS, ring)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            runner_p.run(carry_p, ts_p)
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    kernels = device_kernels(prof)
    busy = sum(us for _, us in kernels.values()) / 1e6
    events = sum(n for n, _ in kernels.values())
    idle = idle_p = per_step = None
    if busy:
        idle, idle_p = (100 * (1 - busy / w) for w in walls)
        per_step = events / SHARDED_PROFILED_STEPS
        log(f"[sharded] k=8 segment of {SHARDED_PROFILED_STEPS} boundaries "
            f"on 8 shards: {walls[0]:.4f} s unprofiled, profiled repeat "
            f"{walls[1]:.4f} s: device busy {busy:.4f} s in {events} device "
            f"events ({per_step:.1f} per boundary): idle share {idle:.2f}% "
            f"of the unprofiled wall ({idle_p:.2f}% of the profiled one)")
    else:
        log("[sharded] device busy: not measured (the profiler recorded no "
            "device events)")
    # ---- (f) a sharded segment makes no host sync ------------------------
    runner_s, carry_s, ts_s = sharded_segment(comp, grid, devs,
                                              SHARDED_SYNC_STEPS, ring)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        runner_s.run(carry_s, ts_s)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log(f"[sharded] {SHARDED_SYNC_STEPS} sharded k=8 boundaries under "
        f"set_sync_debug_mode(\"error\"): no host sync")
    del runner_p, carry_p, runner_s, carry_s, runner, carry, split

    # ---- (b) a (2,2) mesh on the fat-tree k=4 scenario ---------------------
    cfg4 = topology.fattree_cfg(4, seed=0, spec_kw=dict(spines=1))
    gen_times, _ = netsim.generation_schedule(cfg4)
    rows4 = np.random.default_rng(4).normal(
        size=(sum(len(t) for t in gen_times.values()), VECSIM_D)).astype(
            np.float32)
    kw = dict(dt=SHARDED_DT, allow_coarse=True, dim=VECSIM_D,
              payload_rows=rows4)
    four = spread(4)
    one4 = vecsim.run_vecsim(cfg4, device=dev, **kw)
    reset_counts()
    t0 = time.perf_counter()
    split4 = vecsim.run_vecsim(cfg4, mesh=(2, 2), device=four, **kw)
    torch.cuda.synchronize()
    wall4 = time.perf_counter() - t0
    counts_b = read_counts()
    require(not any(counts_b.values()), f"[sharded] k=4 launched a kernel: "
            f"{counts_b}")
    # a local ring of 8 slots overflows (16 hold this run) and 1 column
    # does: one pass retries both
    forced = vecsim.run_vecsim(cfg4, mesh=(2, 2), device=four, rt_loc=8,
                               width=1, **kw)
    t0 = time.perf_counter()
    host4 = vecsim.run_vecsim(cfg4, mesh=(2, 2), device=["cpu"] * 4, **kw)
    wall4_cpu = time.perf_counter() - t0
    require(len(one4.delivery_times) > 0 and one4.forwarded > 0,
            "[sharded] the k=4 run delivered nothing")
    require(forced.passes >= 2 and forced.ring > 8 and forced.width > 1,
            f"[sharded] the forced retries did not run ({forced.passes} "
            f"passes, ring {forced.ring}, width {forced.width})")
    vecsim_results_equal(one4, split4, "[sharded] k=4 (2,2) vs one device")
    vecsim_results_equal(one4, forced, "[sharded] k=4 forced retries")
    err_b = vecsim_results_equal(split4, host4, "[sharded] k=4 card vs CPU",
                                 atol=1e-6)
    log(f"[sharded] fat-tree k=4 dt=2^-8 D={VECSIM_D} on a (2,2) mesh "
        f"({[str(d) for d in four]}): {split4.n_steps} boundaries in "
        f"{wall4:.3f} s (CPU mesh {wall4_cpu:.3f} s), "
        f"{len(split4.delivery_times)} delivered; equals the one-device card "
        f"run bit for bit and the CPU run (max |err| {err_b:.3g}); forced "
        f"retries: {forced.passes} passes to ring {forced.ring}, width "
        f"{forced.width}, same bits; launch counts {counts_b}")

    # ---- (c) the scenario command with --sim-shards ---------------------
    reset_counts()
    cli = launch_train.main(SHARDED_K4 + ["--sim-shards", "4"])
    torch.cuda.synchronize()
    counts_c = read_counts()
    plain = launch_train.main(SHARDED_K4)
    cli_mesh = sharding.vecsim_mesh(4)  # what the command built
    for f in ("queue_stats", "residual_slot_counts", "forwarded",
              "link_dropped", "rerouted", "combined_updates", "launches",
              "h2d_transfers", "drops_by_switch"):
        require(getattr(cli, f) == getattr(plain, f),
                f"[sharded] --sim-shards 4: {f} differs")
    require(np.array_equal(cli.final_counts, plain.final_counts)
            and len(cli.delivered) == len(plain.delivered) > 0,
            "[sharded] --sim-shards 4: final counts or deliveries differ")
    for (t_a, u_a, p_a), (t_b, u_b, p_b) in zip(cli.delivered,
                                                plain.delivered):
        require(t_a == t_b and dataclasses.astuple(u_a)
                == dataclasses.astuple(u_b) and torch.equal(p_a, p_b),
                "[sharded] --sim-shards 4: a delivery differs")
    log(f"[sharded] launch.train --sim-shards 4 (mesh {cli_mesh.shape} on "
        f"this host): {len(cli.delivered)} delivered, every counter and row "
        f"equal to the unsharded command; launch counts {counts_c}")

    # ---- (d) the hybrid's switch mesh --------------------------------------
    hkw = dict(sim_cfg=cfg4, sharded=True, seed=0)
    three = spread(SHARDED_HYBRID_DEVICES)
    reset_counts()
    with CombineCheck("[sharded] hybrid") as chk:
        hyb3, _ = hybrid.run_hybrid_multihop(VECSIM_D, device=three, **hkw)
        torch.cuda.synchronize()
    counts_d = read_counts()
    reset_counts()
    hyb1, _ = hybrid.run_hybrid_multihop(VECSIM_D, device=dev, **hkw)
    torch.cuda.synchronize()
    counts_d1 = read_counts()
    hybc, _ = hybrid.run_hybrid_multihop(
        VECSIM_D, device=["cpu"] * SHARDED_HYBRID_DEVICES, **hkw)
    require(counts_d["olaf_combine"] == SHARDED_HYBRID_DEVICES
            * hyb3.launches == chk.calls > 0, f"[sharded] hybrid: {counts_d} "
            f"combine launches ({chk.calls} calls) for {hyb3.launches} "
            f"flushes over 3 shards")
    require(counts_d1["olaf_combine"] == hyb1.launches,
            "[sharded] hybrid: one launch per flush on one device")
    per_shard = len(cfg4.switches) // SHARDED_HYBRID_DEVICES
    require(chk.shapes == {per_shard}, f"[sharded] hybrid: switches per "
            f"shard {chk.shapes}")
    err_d = hybrid_rows_equal(hyb3, hyb1, "one-launch card", 1e-6)
    err_dc = hybrid_rows_equal(hyb3, hybc, "CPU", 1e-6)
    log(f"[sharded] hybrid fat-tree k=4 D={VECSIM_D} sharded over "
        f"{[str(d) for d in three]}: {hyb3.launches} flushes, "
        f"{counts_d['olaf_combine']} olaf_combine launches (one device: "
        f"{counts_d1['olaf_combine']}), each of the {chk.calls} calls "
        f"({per_shard} switches) held to olaf_combine_plain on clones "
        f"(max |err| {chk.err:.3g}); {len(hyb3.delivered)} delivered, "
        f"every counter "
        f"and trace field equal to the one-launch card run (rows max |err| "
        f"{err_d:.3g}) and to the same call over ['cpu'] * 3, the plain "
        f"route (rows max |err| {err_dc:.3g})")

    # ---- (e) olaf_step_sharded at the stress shape ------------------------
    smesh = sharding.switch_mesh(3, devices=three)
    args = (b_b.clusters, b_b.workers, b_b.gen_times, b_b.rewards,
            b_b.payloads, b_b.thr, b_b.send)
    hetero = torch.tensor([48, 64, 17], dtype=torch.int32, device=dev)
    err_e = 0.0
    for caps in (b_b.capacity, hetero):
        reset_counts()
        want = ops.olaf_step_multi(pre_b.clone(), *args, capacity=caps,
                                   k=b_b.k)
        torch.cuda.synchronize()
        require(read_counts()["olaf_step"] == 1,
                "[sharded] olaf_step_multi is not one launch")
        reset_counts()
        got = sharding.olaf_step_sharded(pre_b.clone(), *args,
                                         capacities=caps, k=b_b.k,
                                         mesh=smesh)
        torch.cuda.synchronize()
        counts_e = read_counts()
        require(counts_e["olaf_step"] == 3, f"[sharded] olaf_step_sharded "
                f"made {counts_e['olaf_step']} launches, not 3")
        err_e = max(err_e, compare(want, got, "[sharded] olaf_step_sharded"))
        if caps is hetero:
            plain_h = olaf_step_plain(pre_b.clone(), *args[:5], b_b.k,
                                      b_b.thr, b_b.send, hetero)
            err_e = max(err_e, compare(plain_h, want,
                                       "[sharded] olaf_step_multi capacities"))
    log(f"[sharded] olaf_step_sharded S=3 Q=64 U=96 k=16 D=2^20+3 over "
        f"{[str(d) for d in three]}: 3 launches, equals one olaf_step_multi "
        f"launch (capacity 48, and [48, 64, 17] also against the plain "
        f"version; max |err| {err_e:.3g})")
    phase_s = time.perf_counter() - t_phase
    log(f"[sharded] phase wall {phase_s:.1f} s")
    out.update(
        counts={"sharded vecsim k=8": counts_a, "sharded k=4": counts_b,
                "sharded cli": counts_c, "sharded hybrid": counts_d,
                "sharded step": counts_e},
        boundaries_per_s=rate8, one_device_boundaries_per_s=rate1,
        events_per_step=per_step, idle_share=idle,
        idle_share_profiled=idle_p, peak_bytes=peak, ring=ring,
        step_err=err_e, combine_err=max(chk.err, err_dc),
        combine_one_launch_err=err_d, vecsim_cpu_err=err_b,
        phase_s=phase_s)
    log("[sharded] json " + json.dumps(
        {k: v for k, v in out.items() if k != "counts"}))
    return out


# ---------------------------------------------------------------------------
# flash_attention and decode_attention: kernel against plain, bound, SDPA
# ---------------------------------------------------------------------------
# kernel vs plain: float32 within float association; bf16 outputs within
# about two bf16 ulps (each side rounds its float32 result once)
ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}
ATTN_DTYPES = (torch.bfloat16, torch.float32)
# name: (BH, Sq, Sk, Dh, causal, window, q_offset)
FLASH_SHAPES = {
    "a": (120, 512, 512, 64, True, 0, 0),  # the smollm-360m prefill, B=8
    "b": (120, 2048, 2048, 64, True, 0, 0),
    "c": (16, 1000, 1000, 256, True, 128, 0),  # ragged, gemma's head dim
    "d": (64, 256, 768, 128, True, 0, 512),
    "e": (48, 1500, 1500, 64, False, 0, 0),  # whisper's encoder, B=4
}
# the model's (B, S, H, Dh) layout, q/k/v strided views into fused (B, S,
# 3, H, Dh) projections, read in place by the kernel:
# name: (B, Sq, Sk, H, Dh, causal, window, q_offset)
FLASH_MODEL_SHAPES = {
    "a/model": (8, 512, 512, 15, 64, True, 0, 0),  # the smollm-360m prefill
    "c/model": (2, 1000, 1000, 8, 256, True, 128, 0),
    "d/model": (4, 256, 768, 16, 128, True, 0, 512),
    "f/model": (4, 512, 512, 48, 128, True, 0, 0),  # grok-1's prefill
    # recurrentgemma's prefill: 2,304 tokens past its 2,048 window
    "g/model": (2, 2304, 2304, 16, 256, True, 2048, 0),
    "h/model": (4, 512, 512, 56, 128, True, 0, 0),  # arctic's prefill
    "i/model": (4, 768, 768, 64, 128, True, 0, 0),  # internvl2: 256 + 512
}
# model shapes whose k/v are expanded from fewer heads, as ``expand_kv``
# gives them (contiguous (B, S, H, Dh) copies): name -> kv heads
FLASH_MODEL_KV = {"f/model": 8, "g/model": 1, "h/model": 8, "i/model": 8}
# name: (B, KV, rep, S, Dh, positions)
DECODE_SHAPES = {
    "a": (8, 5, 3, 552, 64, "spread"),  # the serve cache, rows at 0..551
    "b": (8, 5, 3, 32768, 64, "end"),  # the decode_32k length
    "c": (4, 1, 8, 1000, 256, "random"),
    "d": (4, 12, 1, 80, 64, "spread"),  # whisper's decoder, rep 1
    "e": (4, 8, 6, 528, 128, "spread"),  # grok-1's decode, rep 6
}
PLAIN_SCORE_BYTES = 2**30  # the plain flash runs over BH in slices this big


def peak_ops(dtype) -> float:
    return BF16_OPS_PER_S if dtype == torch.bfloat16 else FP32_OPS_PER_S


def attn_bound_ms(nbytes: int, nops: int, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / peak_ops(dtype) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def flash_inputs(gen, dev, shape, dtype):
    BH, Sq, Sk, Dh = shape[:4]
    return tuple(torch.randn((BH, S, Dh), generator=gen, device=dev).to(dtype)
                 for S in (Sq, Sk, Sk))


def flash_model_inputs(gen, dev, shape, dtype, kv_heads=None):
    """q from a fused (B, Sq, 3, H, Dh) projection, k and v from a fused
    (B, Sk, 3, H, Dh) one: strided (B, S, H, Dh) views, not copies; with
    ``kv_heads``, k and v are (B, Sk, kv_heads, Dh) expanded to H heads
    (head h reads kv head h // rep)."""
    B, Sq, Sk, H, Dh = shape[:5]
    xq, xkv = (torch.randn((B, S, 3, H, Dh), generator=gen, device=dev)
               .to(dtype) for S in (Sq, Sk))
    if kv_heads is None:
        return xq[:, :, 0], xkv[:, :, 1], xkv[:, :, 2]
    heads = torch.arange(H, device=dev) // (H // kv_heads)
    k, v = (xkv[:, :, i, :kv_heads].index_select(2, heads) for i in (1, 2))
    return xq[:, :, 0], k, v


def folded_shape(shape):
    """A (B, Sq, Sk, H, Dh, ...) model-layout shape as (B·H, Sq, Sk, Dh, ...)."""
    B, Sq, Sk, H, Dh, causal, window, q_offset = shape
    return (B * H, Sq, Sk, Dh, causal, window, q_offset)


def flash_kw(shape):
    return dict(causal=shape[4], window=shape[5], q_offset=shape[6])


def plain_sliced(fn, q, k, *rest, **kw):
    """A plain attention function over slices of the batch (the first axis
    of every operand), so its dense scores fit (either layout: a (B, S, H,
    Dh) slice holds H heads); a tuple result is joined part by part."""
    heads = q.shape[2] if q.dim() == 4 else 1
    per = max(1, PLAIN_SCORE_BYTES // (4 * heads * q.shape[1] * k.shape[1]))
    parts = [fn(*(x[i:i + per] for x in (q, k, *rest)), **kw)
             for i in range(0, q.shape[0], per)]
    if isinstance(parts[0], tuple):
        return tuple(torch.cat(p) for p in zip(*parts))
    return torch.cat(parts)


def flash_plain_sliced(q, k, v, **kw):
    return plain_sliced(flash_attention_plain, q, k, v, **kw)


def flash_cost(shape, itemsize: int):
    """(bytes, operations) of one call: q rows with a live key read once,
    every output row written once, key/value rows live for some query read
    once; 4·Dh operations per live (query, key) pair."""
    BH, Sq, Sk, Dh, causal, window, q_offset = shape
    qpos = np.arange(Sq) + q_offset
    hi = np.minimum(Sk - 1, qpos) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(0, qpos - window + 1) if window else np.zeros(Sq, np.int64)
    n = np.maximum(hi - lo + 1, 0)
    edges = np.zeros(Sk + 1, np.int64)
    np.add.at(edges, lo[n > 0], 1)
    np.add.at(edges, hi[n > 0] + 1, -1)
    k_live = int((np.cumsum(edges)[:Sk] > 0).sum())
    nbytes = itemsize * Dh * BH * (int((n > 0).sum()) + Sq + 2 * k_live)
    return nbytes, 4 * Dh * BH * int(n.sum())


def flash_library(q, k, v, shape):
    """``F.scaled_dot_product_attention`` on the same inputs, seen as (1,
    BH, S, Dh) or, in the model layout, (B, H, S, Dh) views (its fused
    backends take four dimensions): ``is_causal`` for a plain causal mask,
    else the boolean mask (True = attend)."""
    _, Sq, Sk, _, causal, window, q_offset = shape
    if q.dim() == 4:
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    else:
        q, k, v = q[None], k[None], v[None]
    if causal and not window and not q_offset and Sq == Sk:
        return lambda _: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return lambda _: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def decode_inputs(gen, dev, shape, dtype):
    B, KV, rep, S, Dh, rule = shape
    q = torch.randn((B, KV, rep, Dh), generator=gen, device=dev).to(dtype)
    kc, vc = (torch.randn((B, S, KV, Dh), generator=gen, device=dev).to(dtype)
              for _ in range(2))
    if rule == "spread":
        pos = torch.linspace(0, S - 1, B, device=dev).round()
    elif rule == "end":
        pos = S - 1 - torch.arange(B, device=dev)
    else:
        pos = torch.randint(0, S, (B,), generator=gen, device=dev)
    return q, kc, vc, pos.to(torch.int32)


def decode_cost(shape, pos, itemsize: int):
    """(bytes, operations): the q row, the k/v rows at positions <= pos and
    the output, each once; 4·Dh operations per (head, live position)."""
    B, KV, rep, S, Dh, _ = shape
    rows = int(torch.clamp(pos.to(torch.int64) + 1, max=S).sum())
    nbytes = itemsize * (2 * B * KV * rep * Dh + 2 * rows * KV * Dh)
    return nbytes, 4 * Dh * KV * rep * rows


def decode_library(q, kc, vc, pos):
    """SDPA with ``enable_gqa`` over the caches' (B, KV, S, Dh) views and a
    (B, 1, 1, S) mask of the positions <= pos."""
    B, KV, rep, Dh = q.shape
    qh = q.reshape(B, KV * rep, 1, Dh)
    kt, vt = kc.transpose(1, 2), vc.transpose(1, 2)
    mask = (torch.arange(kc.shape[1], device=q.device)[None, :]
            <= pos[:, None])[:, None, None, :]
    return lambda _: F.scaled_dot_product_attention(qh, kt, vt, attn_mask=mask,
                                                    enable_gqa=True)


def allclose_text(got, want, tol) -> str:
    """The bound ``torch.allclose(got, want, rtol=tol, atol=tol)`` checks,
    and the worst element's share of it."""
    diff = (got.float() - want.float()).abs()
    share = float((diff / (tol + tol * want.float().abs())).max())
    return (f"bound |err| <= atol + rtol*|plain| with rtol {tol} and atol "
            f"{tol}; worst element at {share:.3g} of its bound")


def check_attention(dev, gen):
    """Every flash and decode shape in both dtypes: kernel against plain.
    Returns {(kind, name, dtype): (max |err|, inputs)}."""
    out = {}
    for name, shape in FLASH_SHAPES.items():
        for dtype in ATTN_DTYPES:
            q, k, v = flash_inputs(gen, dev, shape, dtype)
            got = flash_attention_cuda(q, k, v, **flash_kw(shape))
            want = flash_plain_sliced(q, k, v, **flash_kw(shape))
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dtype]
            require(bool(torch.isfinite(got).all()), f"flash {name}: non-finite")
            require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                    f"flash {name} {dtype}: off by {err}")
            log(f"[check] flash_attention {name} {str(dtype)[6:]}: "
                f"BH={shape[0]} Sq={shape[1]} Sk={shape[2]} Dh={shape[3]} "
                f"causal={shape[4]} window={shape[5]} q_offset={shape[6]} "
                f"matches (max |err| {err:.3g}; "
                f"{allclose_text(got, want, tol)})")
            out[("flash", name, dtype)] = (err, (q, k, v))
    for name, mshape in FLASH_MODEL_SHAPES.items():
        shape = folded_shape(mshape)
        for dtype in ATTN_DTYPES:
            q, k, v = flash_model_inputs(gen, dev, mshape, dtype,
                                         FLASH_MODEL_KV.get(name))
            require(not q.is_contiguous(), f"flash {name}: q is not a view")
            got = flash_attention_cuda(q, k, v, **flash_kw(shape))
            want = flash_plain_sliced(q, k, v, **flash_kw(shape))
            torch.cuda.synchronize()
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dtype]
            require(got.shape == q.shape and bool(torch.isfinite(got).all()),
                    f"flash {name}: shape or non-finite")
            require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                    f"flash {name} {dtype}: off by {err}")
            log(f"[check] flash_attention {name} {str(dtype)[6:]}: (B, S, H, "
                f"Dh) views (k/v from {FLASH_MODEL_KV.get(name, mshape[3])} "
                f"heads) B={mshape[0]} Sq={mshape[1]} Sk={mshape[2]} "
                f"H={mshape[3]} Dh={mshape[4]} strides {tuple(q.stride())} "
                f"causal={mshape[5]} window={mshape[6]} q_offset={mshape[7]} "
                f"matches (max |err| {err:.3g}; "
                f"{allclose_text(got, want, tol)})")
            out[("flash", name, dtype)] = (err, (q, k, v))
    for name, shape in DECODE_SHAPES.items():
        for dtype in ATTN_DTYPES:
            q, kc, vc, pos = decode_inputs(gen, dev, shape, dtype)
            got = decode_attention_cuda(q, kc, vc, pos)
            again = [decode_attention_cuda(q, kc, vc, pos) for _ in range(2)]
            want = decode_attention_plain(q, kc, vc, pos)
            torch.cuda.synchronize()
            require(all(torch.equal(got, x) for x in again),
                    f"decode {name} {dtype}: repeated calls differ (the merge "
                    f"must not depend on the order blocks finish)")
            err = float((got.float() - want.float()).abs().max())
            tol = ATTN_TOL[dtype]
            require(torch.allclose(got.float(), want.float(), rtol=tol, atol=tol),
                    f"decode {name} {dtype}: off by {err}")
            log(f"[check] decode_attention {name} {str(dtype)[6:]}: "
                f"B={shape[0]} KV={shape[1]} rep={shape[2]} S={shape[3]} "
                f"Dh={shape[4]} pos {pos.tolist()} matches (max |err| "
                f"{err:.3g}; {allclose_text(got, want, tol)}); 3 calls "
                f"bitwise equal")
            out[("decode", name, dtype)] = (err, (q, kc, vc, pos))
    return out


def time_attention(checked, reps: int):
    """Kernel, plain, SDPA and the kernel again for every checked input;
    the bound from this run's inputs."""
    rows = {}
    for (kind, name, dtype), (err, x) in checked.items():
        itemsize = torch.finfo(dtype).bits // 8
        if kind == "flash":
            shape = (FLASH_SHAPES[name] if name in FLASH_SHAPES
                     else folded_shape(FLASH_MODEL_SHAPES[name]))
            kw = flash_kw(shape)
            kernel_fn = lambda _: flash_attention_cuda(*x, **kw)  # noqa: E731
            plain_fn = lambda _: flash_plain_sliced(*x, **kw)  # noqa: E731
            library_fn = flash_library(*x, shape)
            nbytes, nops = flash_cost(shape, itemsize)
        else:
            shape = DECODE_SHAPES[name]
            kernel_fn = lambda _: decode_attention_cuda(*x)  # noqa: E731
            plain_fn = lambda _: decode_attention_plain(*x)  # noqa: E731
            library_fn = decode_library(*x)
            nbytes, nops = decode_cost(shape, x[3], itemsize)
        kernel = time_ms(kernel_fn, lambda: None, reps)
        plain = time_ms(plain_fn, lambda: None, max(2, reps // 4))
        library = time_ms(library_fn, lambda: None, reps)
        kernel2 = time_ms(kernel_fn, lambda: None, reps)
        bound, by = attn_bound_ms(nbytes, nops, dtype)
        ms = min(kernel, kernel2)
        rate = (f"{nops / ms / 1e9:.1f} TFLOP/s" if kind == "flash"
                else f"{nbytes / ms / 1e6:.1f} GB/s")
        rows[(kind, name, dtype)] = dict(
            dtype=str(dtype)[6:], ms=ms,
            ms_runs=[kernel, kernel2], plain_ms=plain, library_ms=library,
            bound_ms=bound, bound_by=by, bytes=nbytes, ops=nops,
            max_abs_err=err, share_of_bound=bound / ms,
            vs_library=ms / library, rate=rate)
        log(f"[time] {kind}_attention {name} {str(dtype)[6:]}: kernel "
            f"{ms:.4f} ms (runs {kernel:.4f}, {kernel2:.4f}) "
            f"plain {plain:.4f} ms SDPA {library:.4f} ms bound {bound:.6f} ms "
            f"({by}: {nbytes} B, {nops} operations); {rate}, "
            f"{100 * bound / ms:.1f}% of the bound, {ms / library:.2f}x SDPA")
    return rows


# ---------------------------------------------------------------------------
# the flash backward: kernels against the plain backward, bound, SDPA's
# ---------------------------------------------------------------------------
# name: (B, Sq, Sk, H, Dh, causal, window, q_offset); q a strided view of a
# fused projection, k and v expanded from FLASH_BWD_KV heads as ``expand_kv``
# gives them
FLASH_BWD_SHAPES = {
    "train": (16, 2048, 2048, 15, 64, True, 0, 0),  # a smollm-360m gradient
    "f/model": (4, 512, 512, 48, 128, True, 0, 0),  # grok-1's prefill
    "h128/window": (2, 2304, 2304, 16, 128, True, 2048, 0),  # Dh 128, a window
    "d/model": (4, 256, 768, 16, 128, True, 0, 512),  # a q offset, ragged tiles
}
FLASH_BWD_KV = {"train": 5, "f/model": 8, "h128/window": 1}
# each gradient within 1e-2 of its largest element: both sides round P and
# dS to bf16 from float32 values summed in other orders, so an element may
# land a bf16 ulp (2^-8 relative) apart, and the sums over keys of those
# differences stay inside 1e-2 of the largest element (0.0046 at most, dK
# at the train shape; 0.0032 over 14 smaller shapes); the output's
# log-sum-exp within 1e-5
FLASH_BWD_TOL = 1e-2
FLASH_BWD_LSE_TOL = 1e-5


def flash_backward_cost(shape):
    """(bytes, operations) of one backward call: q, k, v, out and dout read
    and dq, dk, dv written once (bf16), lse read; seven products of 2·Dh
    operations per live (query, key) pair."""
    B, Sq, Sk, H, Dh = shape[:5]
    _, nops = flash_cost(folded_shape(shape), 2)
    nbytes = 2 * Dh * B * H * (4 * Sq + 4 * Sk) + 4 * B * H * Sq
    return nbytes, nops * 7 // 2  # flash_cost counts the forward's two


def flash_backward_library(q, k, v, shape):
    """SDPA's backward on the same inputs as (B, H, S, Dh) views (a yardstick
    only: the port never calls it): the graph of one forward, then the
    gradient of its output, timed alone."""
    _, Sq, Sk, _, _, causal, window, q_offset = shape
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    if causal and not window and not q_offset and Sq == Sk:
        o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True)
    else:
        qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
        kpos = torch.arange(Sk, device=q.device)[None, :]
        mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        o = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    g = torch.randn_like(o)
    return lambda _: torch.autograd.grad(o, (qt, kt, vt), g, retain_graph=True)


def flash_backward_phase(dev, gen, reps: int = 5) -> dict:
    """The backward kernels (pre-pass, dK/dV, dQ) at the train shape and the
    families' Dh 128 shapes, bf16: against the plain backward from the
    kernel's own output and log-sum-exp (``FLASH_BWD_TOL``), bit for bit on
    a second call, three device kernels and nothing else per call; then
    timed beside the bound, the plain version and SDPA's backward."""
    rows = {}
    for name, shape in FLASH_BWD_SHAPES.items():
        B, Sq, Sk, H, Dh, causal, window, q_offset = shape
        kw = flash_kw(folded_shape(shape))
        q, k, v = flash_model_inputs(gen, dev, (B, Sq, Sk, H, Dh), torch.bfloat16,
                                     FLASH_BWD_KV.get(name))
        out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
        dout = torch.randn(out.shape, generator=gen, device=dev).to(torch.bfloat16)
        got = flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
        again = flash_attention_backward_cuda(q, k, v, out, lse, dout, **kw)
        torch.cuda.synchronize()
        require(all(torch.equal(a, b) for a, b in zip(got, again)),
                f"flash backward {name}: two calls differ")
        want = plain_sliced(flash_attention_backward_plain, q, k, v, out, lse,
                            dout, **kw)
        plain_out, plain_lse = plain_sliced(flash_attention_plain, q, k, v,
                                            return_lse=True, **kw)
        live = torch.isfinite(plain_lse)
        require(torch.equal(torch.isfinite(lse), live)
                and float((lse - plain_lse)[live].abs().max()) <= FLASH_BWD_LSE_TOL,
                f"flash {name}: the log-sum-exp differs from the plain one")
        errs = {}
        for n, a, b in zip(("dq", "dk", "dv"), got, want):
            scale = float(b.float().abs().max())
            errs[n] = float((a.float() - b.float()).abs().max()) / scale
            require(bool(torch.isfinite(a).all()) and errs[n] <= FLASH_BWD_TOL,
                    f"flash backward {name} {n}: off by {errs[n]:.3g} of its "
                    f"largest element")
        del want, plain_out, plain_lse
        x = (q, k, v, out, lse, dout)
        mine, other = launches_per_call(
            lambda a: flash_attention_backward_cuda(*a, **kw), lambda: x,
            ("flash_bwd_",))
        require(mine == 3 and other == 0, f"flash backward {name}: {mine:g} "
                f"kernels and {other:g} other device operations per call")
        kernel = time_ms(lambda a: flash_attention_backward_cuda(*a, **kw),
                         lambda: x, reps)
        plain = time_ms(lambda a: plain_sliced(flash_attention_backward_plain,
                                               *a, **kw), lambda: x, 2)
        library = time_ms(flash_backward_library(q, k, v, shape), lambda: None,
                          reps)
        fwd_lse = time_ms(lambda a: flash_attention_cuda(*a[:3], return_lse=True,
                                                         **kw), lambda: x, reps)
        fwd = time_ms(lambda a: flash_attention_cuda(*a[:3], **kw), lambda: x, reps)
        fwd_plain = time_ms(lambda a: plain_sliced(
            flash_attention_plain, *a[:3], return_lse=True, **kw), lambda: x, 2)
        fwd_library = time_ms(flash_library(q, k, v, folded_shape(shape)),
                              lambda: None, reps)
        kernel2 = time_ms(lambda a: flash_attention_backward_cuda(*a, **kw),
                          lambda: x, reps)
        nbytes, nops = flash_backward_cost(shape)
        bound, by = attn_bound_ms(nbytes, nops, torch.bfloat16)
        ms = min(kernel, kernel2)
        rows[name] = dict(shape=shape, ms=ms, ms_runs=[kernel, kernel2],
                          plain_ms=plain, library_ms=library, bound_ms=bound,
                          bound_by=by, bytes=nbytes, ops=nops,
                          share_of_bound=bound / ms, vs_library=ms / library,
                          rel_err=errs, forward_ms=fwd, forward_lse_ms=fwd_lse,
                          forward_plain_ms=fwd_plain,
                          forward_library_ms=fwd_library,
                          kernels_per_call=mine)
        log(f"[flash-bwd] {name} B={B} Sq={Sq} Sk={Sk} H={H} Dh={Dh} causal="
            f"{causal} window={window} q_offset={q_offset} bf16: matches the "
            f"plain backward (max |err| over the largest element: "
            + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
            + f"; bound {FLASH_BWD_TOL}), 2 calls bitwise equal, {mine:g} "
            f"kernels and {other:g} other device operations per call; kernel "
            f"{ms:.4f} ms (runs {kernel:.4f}, {kernel2:.4f}) plain {plain:.4f} "
            f"ms SDPA backward {library:.4f} ms bound {bound:.6f} ms ({by}: "
            f"{nbytes} B, {nops} operations); {nops / ms / 1e9:.1f} TFLOP/s, "
            f"{100 * bound / ms:.1f}% of the bound, {ms / library:.2f}x SDPA; "
            f"forward {fwd:.4f} ms, with the log-sum-exp {fwd_lse:.4f} ms "
            f"(its plain version {fwd_plain:.4f} ms, SDPA {fwd_library:.4f} ms)")
        del x, got, again, q, k, v, out, lse, dout
        torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# the serve path: smollm-360m at full width and depth
# ---------------------------------------------------------------------------
SERVE = dict(arch="smollm-360m", batch=8, prompt_len=512, gen=32, seed=0)
SERVE_TOL = 1e-3  # float32 kernel route against the plain route, logits


def serve_cfg(**kw):
    return dataclasses.replace(get_config(SERVE["arch"]), **kw)


def serve_run(cfg, params, dev):
    return launch_serve.serve(cfg, batch=SERVE["batch"],
                              prompt_len=SERVE["prompt_len"], gen=SERVE["gen"],
                              temperature=0.0, seed=SERVE["seed"], device=dev,
                              params=params)


def serve_phase(dev) -> dict:
    """``launch.serve.serve`` at full width and depth under
    ``attn_impl="pallas"``, counted from 0; a profiled repeat for the idle
    share; the float32 kernel route against the plain route. Returns the
    launch counts of the counted run."""
    cfg_s = serve_cfg(attn_impl="pallas")
    B_s, P_s, gen_s = SERVE["batch"], SERVE["prompt_len"], SERVE["gen"]
    params_s = lm_api.init_model(
        torch.Generator(dev).manual_seed(SERVE["seed"]), cfg_s)
    serve_run(cfg_s, params_s, dev)  # warm-up: cuBLAS handles, allocator
    reset_counts()
    served = serve_run(cfg_s, params_s, dev)
    serve_counts = read_counts()
    toks = served.tokens
    log(f"[serve] {cfg_s.name} {cfg_s.n_layers} layers d_model={cfg_s.d_model} "
        f"heads={cfg_s.n_heads}/{cfg_s.n_kv_heads} head_dim={cfg_s.hd} "
        f"vocab={cfg_s.vocab} {cfg_s.dtype} "
        f"({lm_module.count_params(params_s)} parameters, seeded random), "
        f"attn_impl=pallas, B={B_s} P={P_s} gen={gen_s} greedy: "
        f"{served.summary()}; prefill {served.prefill_s * 1e3:.3f} ms, decode "
        f"{served.decode_s / gen_s * 1e3:.4f} ms/token, "
        f"{B_s * gen_s / served.decode_s:.1f} tok/s; launch counts "
        f"{serve_counts}; tokens[0][:8] {toks[0][:8].tolist()}")
    require(serve_counts["flash_attention"] == cfg_s.n_layers,
            f"serve: {serve_counts['flash_attention']} flash launches, one per "
            f"prefill layer expected ({cfg_s.n_layers})")
    require(serve_counts["decode_attention"] == cfg_s.n_layers * gen_s,
            f"serve: {serve_counts['decode_attention']} decode calls, "
            f"{cfg_s.n_layers} x {gen_s} expected")
    require(toks.shape == (B_s, gen_s + 1) and toks.min() >= 0
            and toks.max() < cfg_s.vocab, "serve: tokens out of range")
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        serve_run(cfg_s, params_s, dev)
        torch.cuda.synchronize()
    wall_sp = time.perf_counter() - t0
    kernels_s = device_kernels(prof)
    busy_s = sum(us for _, us in kernels_s.values()) / 1e6
    if busy_s:
        fl = [(c, us) for n, (c, us) in kernels_s.items()
              if "flash_wgmma" in n or "flash_kernel" in n]
        dec = [(c, us) for n, (c, us) in kernels_s.items() if "decode_kernel" in n]
        fl_us, dec_us = sum(us for _, us in fl), sum(us for _, us in dec)
        top = sorted(kernels_s.items(), key=lambda kv: -kv[1][1])[:6]
        log(f"[serve] profiled repeat: device busy {busy_s:.4f} s in "
            f"{sum(n for n, _ in kernels_s.values())} device events over "
            f"{wall_sp:.3f} s wall: idle share {100 * (1 - busy_s / wall_sp):.2f}%; "
            f"flash {fl_us / 1e3:.4f} ms in {sum(c for c, _ in fl)} launches, "
            f"decode {dec_us / 1e3:.4f} ms in {sum(c for c, _ in dec)} "
            f"launches; the largest: " + "; ".join(
                f"{n[:60]} x{c} {us / 1e3:.3f} ms" for n, (c, us) in top))
    else:
        log("[serve] device busy: not measured (the profiler recorded no "
            "device events)")
    # the kernel route against the plain route, float32, teacher-forced
    p32 = lm_module.cast_tree(params_s, torch.float32)
    got = teacher_forced_logits(p32, serve_cfg(dtype="float32",
                                               attn_impl="pallas"), dev, B_s,
                                P_s, toks)
    want = teacher_forced_logits(p32, serve_cfg(dtype="float32",
                                                attn_impl="full"), dev, B_s,
                                 P_s, toks)
    torch.cuda.synchronize()
    route_err = [float((g - w).abs().max()) for g, w in zip(got, want)]
    require(bool(torch.isfinite(got).all()), "serve f32: non-finite logits")
    require(torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL),
            f"serve f32: kernel route off the plain route by {max(route_err)} "
            f"(per step {route_err})")
    log(f"[serve] float32 kernel route (pallas) vs plain route (full), "
        f"teacher-forced on the served tokens: prefill logits max |err| "
        f"{route_err[0]:.3g}, {gen_s} decode steps max |err| "
        f"{max(route_err[1:]):.3g} (tolerance {SERVE_TOL})")
    return serve_counts


# ---------------------------------------------------------------------------
# LM training: launch.train --mode olaf-async / sync (the PS step)
# ---------------------------------------------------------------------------
TRAIN_FULL = ["--arch", "smollm-360m", "--mode", "olaf-async", "--workers",
              "4", "--batch", "32", "--seq", "256", "--burst-size", "2",
              "--drain-k", "4", "--ingress-screen", "--steps", "6",
              "--log-every", "0"]
TRAIN_SYNC = ["--arch", "smollm-360m", "--mode", "sync", "--batch", "32",
              "--seq", "256", "--steps", "3", "--log-every", "0"]
TRAIN_REDUCED = ["--arch", "smollm-360m", "--reduced", "--mode",
                 "olaf-async", "--workers", "4", "--batch", "8", "--seq",
                 "16", "--steps", "8", "--burst-size", "2", "--drain-k", "4",
                 "--ingress-screen", "--staleness-bound", "0.6",
                 "--crash-workers", "1", "--crash-at", "2", "--restart-at",
                 "5", "--log-every", "0"]
TRAIN_D = 361_821_120  # smollm-360m's parameters: the flat update's width
TRAIN_TOL = 1e-4  # reduced card run against the CPU run: losses, AoM


class EventClock:
    """Replaces ``module.name`` while a ``with`` block runs and records a
    CUDA event pair around each call: the device time from the call's first
    operation to its last, gaps included (the host may enqueue slower than
    the card runs)."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn, self.pairs = getattr(module, name), []

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False

    def __call__(self, *a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.fn(*a, **kw)
        end.record()
        self.pairs.append((start, end))
        return out

    def ms(self):
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


class CycleCapture:
    """Replaces ``ops.olaf_step`` for one call inside a ``with`` block and
    keeps a clone of the queue before it and the call's burst operands."""

    def __enter__(self):
        self._orig = orig = ops.olaf_step

        def wrapper(state, *a, **kw):
            self.state = state.clone()
            self.args, self.k = a, kw["k"]
            return orig(state, *a, **kw)

        ops.olaf_step = wrapper
        return self

    def __exit__(self, *exc):
        ops.olaf_step = self._orig
        return False

    def kernel_args(self):
        """``olaf_step_cuda``'s arguments after the state: the kernel runs
        the cycle; ``ops`` applies the churn mask after it."""
        clusters, workers, times, rewards, payloads, thr, send, cap, _, \
            screen = self.args
        return (clusters, workers, times, rewards, payloads, self.k, thr,
                send, cap, screen)

    def metadata_burst(self):
        """The state and burst with zero-width payloads, for ``cycle_cost``
        (one queue, an S axis of 1)."""
        st = TorchQueueState(**{n: (v[:, :0] if n == "payload" else v)[None]
                                for n, v in self.state.fields().items()})
        c, w, t, r, pay, k, thr, send, _, screen = self.kernel_args()
        one = lambda x: x[None]  # noqa: E731
        return st, Burst(
            clusters=one(c), workers=one(w), gen_times=one(t),
            rewards=one(r), payloads=one(pay[:, :0]), send=one(send),
            screen=one(screen) if screen is not None else torch.zeros_like(
                one(send)),
            capacity=torch.full((1,), st.cluster.shape[1], dtype=torch.int32,
                                device=send.device), k=k, thr=thr)


class StepCheck:
    """Replaces ``ops.olaf_step`` inside a ``with`` block and holds every
    call's result (the kernel's, on the card) to ``olaf_step_plain`` on a
    clone of the same queue and the same burst, with ``ops``'s churn mask
    applied to both; ``err`` is the largest payload difference."""

    def __init__(self, what):
        self.what, self.calls, self.err = what, 0, 0.0

    def __enter__(self):
        self._orig = orig = ops.olaf_step
        sig = inspect.signature(orig)

        def wrapper(state, *a, **kw):
            p = sig.bind(state, *a, **kw)
            p.apply_defaults()
            p = p.arguments
            before = state.clone()
            got = orig(state, *a, **kw)
            want = olaf_step_plain(
                before, p["clusters"], p["workers"], p["gen_times"],
                p["rewards"], p["payloads"], p["k"], p["reward_threshold"],
                p["send"], p["capacity"], p["screen"])
            if p["active_workers"] is not None:
                want = (want[0], ops.expire_inactive_drains(
                    want[1], p["active_workers"]))
            self.calls += 1
            self.err = max(self.err, compare(
                want, got, f"{self.what}: olaf_step call {self.calls}"))
            return got

        ops.olaf_step = wrapper
        return self

    def __exit__(self, *exc):
        ops.olaf_step = self._orig
        return False


def ps_step_bytes(cap: CycleCapture, D: int, param_bytes: int):
    """The least bytes of one PS step: the ``olaf_step`` cycle's
    (``cycle_cost`` on this step's own queue and burst), AdamW's (the
    gradient, each param, m and v read once; each param, m and v written
    once), the screen's (the burst rows read once) and the weighted mean's
    (the K drained rows read, one row written)."""
    st, b = cap.metadata_burst()
    cycle, _, kernel_bytes = cycle_cost(st, b, dim=D)
    U, K = b.clusters.shape[1], min(b.k, st.cluster.shape[1])
    parts = dict(cycle=cycle, adamw=D * (3 * param_bytes + 16),
                 screen=4 * U * D, mean=4 * (K + 1) * D)
    return sum(parts.values()), parts, cycle, kernel_bytes


def train_phase(dev) -> dict:
    """``launch.train`` at full smollm-360m width: olaf-async (counted
    from 0; CUDA-event times of the worker gradients and the PS steps; a
    profiled repeat of one step for the idle share), the ``olaf_step``
    kernel against its plain version at the path's own shape, then sync;
    then the reduced olaf-async run on the card against the CPU run.
    Returns the launch counts and the numbers for the kernel line."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()  # by the phases before this one
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with EventClock(launch_train, "worker_grad") as grad_clock, \
            EventClock(launch_train, "ps_step") as ps_clock:
        tr = launch_train.main(TRAIN_FULL)
        torch.cuda.synchronize()
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = tr.args.steps
    grad_ms, ps_ms = grad_clock.ms(), ps_clock.ms()
    losses = [l for _, l, _ in tr.log_rows]
    params = tree_leaves(tr.state.params)
    require(tr.dim == TRAIN_D, f"train: D = {tr.dim}, not {TRAIN_D}")
    require(counts["olaf_step"] == counts["olaf_robust_combine"] == steps
            == len(ps_ms), f"train: {counts['olaf_step']} olaf_step and "
            f"{counts['olaf_robust_combine']} olaf_robust_combine launches in "
            f"{steps} PS steps, one each per step expected")
    require(len(losses) == steps and all(math.isfinite(l) for l in losses),
            f"train: losses {losses}")
    # every attention layer of every gradient on the flash pair: the forward
    # kernel in the forward and again in remat's recompute, one backward
    n_layers, n_grads = tr.cfg.n_layers, len(grad_ms)
    fwd_per_grad = n_layers * (2 if tr.cfg.remat else 1)
    require(counts["flash_attention"] == fwd_per_grad * n_grads
            and counts["flash_attention_backward"] == n_layers * n_grads,
            f"train: {counts['flash_attention']} flash forward and "
            f"{counts['flash_attention_backward']} backward launches in "
            f"{n_grads} gradients of {n_layers} layers; {fwd_per_grad} and "
            f"{n_layers} a gradient expected")
    require(sum(c for _, _, c in tr.log_rows) > 0, "train: nothing applied")
    require(all(bool(torch.isfinite(x).all()) for x in params)
            and bool(torch.isfinite(tr.state.queue.payload).all()),
            "train: non-finite params or queue")
    qbytes = sum(v.nbytes for v in tr.state.queue.fields().values())
    per_step_grad = [a + b for a, b in zip(grad_ms[::2], grad_ms[1::2])]
    log(f"[train] olaf-async smollm-360m full width "
        f"({params[0].dtype}, seeded random weights): D={tr.dim} "
        f"({tr.dim * 4} B a row), queue Q={tr.state.queue.cluster.shape[0]} "
        f"{qbytes} B, workers 4 batch 32 seq 256 burst 2 drain_k 4 screen "
        f"on, remat {tr.cfg.remat_policy if tr.cfg.remat else 'off'}; "
        f"{steps} steps in {tr.wall:.3f} s = {steps / tr.wall:.3f} "
        f"steps/s; olaf_step launches {counts['olaf_step']}, "
        f"olaf_robust_combine launches {counts['olaf_robust_combine']}, "
        f"flash_attention {counts['flash_attention']} and its backward "
        f"{counts['flash_attention_backward']} in {n_grads} gradients "
        f"({fwd_per_grad} and {n_layers} a gradient; counted from 0); "
        f"peak memory {peak} B ({peak / 2**30:.2f} GiB; {held} B of it "
        f"held before the run, so the run's own {(peak - held) / 2**30:.2f} "
        f"GiB); loss first "
        f"{losses[0]:.6f} last {losses[-1]:.6f}")
    log(f"[train] CUDA events per step: worker gradients (2 per step) "
        f"{', '.join(f'{x:.2f}' for x in per_step_grad)} ms; PS step "
        f"{', '.join(f'{x:.3f}' for x in ps_ms)} ms (mean of steps 2-"
        f"{steps}: gradients {np.mean(per_step_grad[1:]):.3f} ms, PS step "
        f"{np.mean(ps_ms[1:]):.3f} ms)")
    # one more step on the host clock, then a profiled repeat of one whole
    # step (two gradients and the PS step): the profiler slows the host
    # (a trace of thousands of launches), so its busy time is also shown
    # over the unprofiled step's wall
    walls = []
    for profiled in (False, True):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with (torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
              if profiled else contextlib.nullcontext()) as prof:
            tr.step()
            tr.flush()
            torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    wall_1, wall_p = walls
    kernels = device_kernels(prof)
    busy = sum(us for _, us in kernels.values()) / 1e6
    idle = idle_p = None
    if busy:
        idle, idle_p = (100 * (1 - busy / w) for w in (wall_1, wall_p))
        top = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]
        log(f"[train] one step: {wall_1:.4f} s wall unprofiled; profiled "
            f"repeat: device busy {busy:.4f} s in "
            f"{sum(n for n, _ in kernels.values())} device events: idle "
            f"share {idle:.2f}% of the unprofiled step's wall ({idle_p:.2f}% "
            f"of the profiled repeat's {wall_p:.3f} s); the largest: "
            + "; ".join(f"{n[:60]} x{c} {us / 1e3:.3f} ms"
                        for n, (c, us) in top))
    else:
        log("[train] device busy: not measured (the profiler recorded no "
            "device events)")
    # one more step with its queue and burst kept: the PS step's bound,
    # and the kernel against its plain version at the path's own shape
    with CycleCapture() as cap:
        tr.step()
    param_bytes = params[0].element_size()
    del tr, params
    torch.cuda.empty_cache()
    ps_bytes, parts, cycle_bytes, kernel_bytes = ps_step_bytes(
        cap, TRAIN_D, param_bytes)
    ps_bound = ps_bytes / HBM_BYTES_PER_S * 1e3
    kargs = cap.kernel_args()
    want = olaf_step_plain(cap.state, *kargs)
    got = olaf_step_cuda(cap.state.clone(), *kargs)
    torch.cuda.synchronize()
    err = compare(want, got, "train: olaf_step at the path's shape")
    del want, got
    torch.cuda.empty_cache()
    t_k = time_ms(lambda st: olaf_step_cuda(st, *kargs), cap.state.clone, 3)
    t_p = time_ms(lambda st: olaf_step_plain(st, *kargs), lambda: cap.state, 2)
    k_bound = cycle_bytes / HBM_BYTES_PER_S * 1e3
    shape = f"S=1 Q={cap.state.cluster.shape[0]} U={kargs[0].shape[0]} " \
            f"K={cap.k} D={TRAIN_D}"
    log(f"[train] PS step byte bound {ps_bound:.4f} ms ({ps_bytes} B: "
        + ", ".join(f"{k} {v}" for k, v in parts.items())
        + f") against {np.mean(ps_ms[1:]):.3f} ms measured = "
        f"{100 * ps_bound / np.mean(ps_ms[1:]):.2f}% of the bound")
    log(f"[train] olaf_step at the path's shape {shape}: matches its plain "
        f"version (max |err| {err:.3g}); kernel {t_k:.4f} ms, plain "
        f"{t_p:.4f} ms, bound {k_bound:.4f} ms (bytes, {cycle_bytes} B; the "
        f"kernel moves {kernel_bytes} B) = {100 * k_bound / t_k:.2f}% of "
        f"the bound")
    del cap
    torch.cuda.empty_cache()
    # sync at the same width
    res = launch_train.main(TRAIN_SYNC)
    torch.cuda.synchronize()
    require(len(res.losses) == 3 and all(math.isfinite(l) for l in res.losses),
            f"train sync: losses {res.losses}")
    log(f"[train] sync smollm-360m full width, batch 32 seq 256: 3 steps in "
        f"{res.wall:.3f} s ({3 / res.wall:.3f} steps/s, the loss read back "
        f"every step); losses {[round(l, 6) for l in res.losses]}")
    # reduced size: the card against the CPU
    reset_counts()
    card = launch_train.main(TRAIN_REDUCED)
    torch.cuda.synchronize()
    reduced_launches = read_counts()["olaf_step"]
    host = launch_train.main(TRAIN_REDUCED + ["--device", "cpu"])
    for f in ("deferred_total", "stale_total", "screened_total"):
        require(getattr(card, f) == getattr(host, f),
                f"train reduced: {f} differs between card and CPU")
    require([c for *_, c in card.log_rows] == [c for *_, c in host.log_rows],
            "train reduced: combined counts differ")
    for f in META:  # the rewards are the workers' -loss: floats
        a, b = getattr(card.state.queue, f).cpu(), getattr(host.state.queue, f)
        require(torch.allclose(a, b, rtol=TRAIN_TOL) if f == "reward"
                else torch.equal(a, b), f"train reduced: queue {f} differs")
    l_card = np.array([l for _, l, _ in card.log_rows])
    l_host = np.array([l for _, l, _ in host.log_rows])
    require(np.allclose(l_card, l_host, rtol=TRAIN_TOL, atol=0),
            f"train reduced: losses {l_card} vs {l_host}")
    require(np.isclose(card.avg_aom(), host.avg_aom(), rtol=TRAIN_TOL),
            "train reduced: avg AoM")
    require(reduced_launches == 8, "train reduced: olaf_step launches")
    log(f"[train] reduced olaf-async (churn, staleness bound 0.6, screen) "
        f"card equals CPU: stale {card.stale_total}, deferred "
        f"{card.deferred_total}, screened {card.screened_total}, n_agg "
        f"{int(card.state.queue.n_agg)} exact; losses max rel diff "
        f"{float(np.max(np.abs(l_card - l_host) / np.abs(l_host))):.3g} "
        f"(rtol {TRAIN_TOL}); olaf_step launches {reduced_launches}")
    log(f"[train] phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, shape=shape, ms=t_k, plain_ms=t_p,
                bound_ms=k_bound, bytes=cycle_bytes, kernel_bytes=kernel_bytes,
                max_abs_err=err, ps_step_ms=float(np.mean(ps_ms[1:])),
                ps_step_bound_ms=ps_bound, step_s=wall_1,
                idle_share=idle, idle_share_profiled=idle_p,
                peak_bytes=peak - held, sync=res)


# ---------------------------------------------------------------------------
# the PS step's robust combine: weighted mean, trimmed fallback, selection
# ---------------------------------------------------------------------------
ROBUST_K = 4  # the engine cell's drain-k
ROBUST_THRESHOLD = 0.25  # PSConfig.robust_threshold's default
ROBUST_TOL = 1e-6  # rtol and atol: the rows summed in another order than cuBLAS's


def robust_counts(dev, selected: bool):
    """(n_screen, n_send) on the card: 2 of 7 sent rows screened selects
    the trimmed combine at the threshold 0.25, 1 of 7 the mean."""
    return (torch.tensor(2 if selected else 1, dtype=torch.int32, device=dev),
            torch.tensor(7, dtype=torch.int32, device=dev))


def robust_rows(gen, dev, K, D, pad=0):
    """K rows of D normal floats in a (K, D + pad) block, row 1 scaled by
    10^3 (as the engine cell's faulty rows are) and a few non-finite
    entries; with ``pad`` the rows are the view starting one float in."""
    base = torch.randn((K, D + pad), generator=gen, device=dev)
    base[1].mul_(1e3)
    for value, row, at in ((math.nan, 0, 7), (math.inf, 2, 11),
                           (-math.inf, 3, 13)):
        base[row, at::max(D // 5, 1)] = value
    return base[:, 1:1 + D] if pad else base


def check_robust(rows, w, what: str) -> float:
    """The kernel against the plain composition for both branches: NaN and
    ±inf at the same places, the rest within ROBUST_TOL. Returns the
    largest difference."""
    err = 0.0
    for selected in (False, True):
        counts = robust_counts(rows.device, selected)
        got = olaf_robust_combine_cuda(rows, w, *counts,
                                       threshold=ROBUST_THRESHOLD)
        want = olaf_robust_combine_plain(rows, w, *counts,
                                         threshold=ROBUST_THRESHOLD)
        torch.cuda.synchronize()
        branch = "trimmed" if selected else "mean"
        for pick in (torch.isnan, torch.isposinf, torch.isneginf):
            require(torch.equal(pick(got), pick(want)),
                    f"robust {what} {branch}: {pick.__name__} differ")
        fin = torch.isfinite(want)
        require(torch.allclose(got[fin], want[fin], rtol=ROBUST_TOL,
                               atol=ROBUST_TOL),
                f"robust {what} {branch}: differs from the plain version")
        if bool(fin.any()):
            err = max(err, float((got[fin] - want[fin]).abs().max()))
        del got, want, fin
    log(f"[robust] {what}: K={rows.shape[0]} D={rows.shape[1]} row stride "
        f"{rows.stride(0)}, both branches match the plain composition (max "
        f"|err| {err:.3g})")
    return err


def robust_phase(dev) -> dict:
    """``ops.olaf_robust_combine``'s kernel against its plain composition
    at D = 2**20 + 3 (contiguous, and a column view one float past a
    16-byte boundary) and at the engine cell's shape (K = 4, D = TRAIN_D,
    agg counts 1, 2, 1, 3): both branches checked and timed, the plain
    composition timed (it computes both), the screen-off path's cuBLAS
    mean timed at the same shape, the bound by bytes (K rows read, one
    written), and device kernels per call."""
    gen = torch.Generator(device=dev).manual_seed(28)
    w = torch.tensor([1.0, 2.0, 1.0, 3.0], device=dev)
    small = robust_rows(gen, dev, ROBUST_K, 2**20 + 3)
    err = check_robust(small, w, "D=2^20+3")
    err = max(err, check_robust(robust_rows(gen, dev, ROBUST_K, 2**20 + 3,
                                            pad=5), w, "D=2^20+3 column view"))
    per_call = {sel: launches_per_call(
        lambda a, c=robust_counts(dev, sel): ops.olaf_robust_combine(
            *a, *c, threshold=ROBUST_THRESHOLD),
        lambda: (small, w), ("olaf_robust",)) for sel in (False, True)}
    for sel, (mine, other) in per_call.items():
        log(f"[launches] olaf_robust_combine ({'trimmed' if sel else 'mean'}"
            f"): {mine:g} kernel launch(es) and {other:g} other device "
            f"operation(s) per call (profiler, 5 calls)")
        require((mine, other) == (1, 0), "olaf_robust_combine: not one "
                "kernel and nothing else per call")
    del small
    torch.cuda.empty_cache()
    K, D = ROBUST_K, TRAIN_D
    rows = robust_rows(gen, dev, K, D)
    err = max(err, check_robust(rows, w, "the engine's shape"))
    torch.cuda.empty_cache()
    times = {}
    for sel in (False, True):
        counts = robust_counts(dev, sel)
        times[sel] = [time_ms(lambda _: olaf_robust_combine_cuda(
            rows, w, *counts, threshold=ROBUST_THRESHOLD), lambda: None, 10)
            for _ in range(2)]
    counts = robust_counts(dev, True)
    plain = time_ms(lambda _: olaf_robust_combine_plain(
        rows, w, *counts, threshold=ROBUST_THRESHOLD), lambda: None, 3)
    # the screen-off path's step 5 (both train cells) at the same shape
    cublas = time_ms(lambda _: (w @ rows) / torch.clamp(w.sum(), min=1.0),
                     lambda: None, 10)
    nbytes = 4 * (K + 1) * D
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms = {("trimmed" if sel else "mean"): min(t) for sel, t in times.items()}
    for branch, t in ms.items():
        log(f"[time] olaf_robust_combine K={K} D={D} {branch}: kernel "
            f"{t:.4f} ms (runs {', '.join(f'{x:.4f}' for x in times[branch == 'trimmed'])}) "
            f"bound {bound:.4f} ms (bytes, {nbytes} B) = "
            f"{100 * bound / t:.2f}% of the bound; the plain composition "
            f"(both branches and the selection) {plain:.4f} ms")
    log(f"[time] the screen-off weighted mean (cuBLAS product, clamp and "
        f"division) K={K} D={D}: {cublas:.4f} ms = "
        f"{100 * bound / cublas:.2f}% of the same bound; the kernel's mean "
        f"branch {ms['mean']:.4f} ms")
    del rows
    torch.cuda.empty_cache()
    return dict(ms=ms, plain_ms=plain, cublas_mean_ms=cublas,
                bound_ms=bound, bytes=nbytes,
                max_abs_err=err, shape=f"K={K} D={D}",
                cuda_launches_per_call=per_call[False][0])


# ---------------------------------------------------------------------------
# activation checkpointing: the full-width olaf-async run under each policy
# ---------------------------------------------------------------------------
REMAT_POLICIES = ("none", "full", "dots")
REMAT_TOL = 1e-4  # losses across the policies (H19: AdamW amplifies noise)


@contextlib.contextmanager
def remat_policy(policy):
    """``launch.train`` builds its config with ``remat_policy=policy``."""
    orig = launch_train.get_config

    def get(name):
        return dataclasses.replace(orig(name), remat=True,
                                   remat_policy=policy)

    launch_train.get_config = get
    try:
        yield
    finally:
        launch_train.get_config = orig


def gradient_events(tr, cfg):
    """Device events of one worker gradient of ``tr`` under ``cfg`` (a
    profiled call), and that gradient (a float32 row)."""
    batch = {k: launch_train.to_device(v, tr.device)
             for k, v in tr.shards[0].batch(0).items()}
    out = torch.empty(tr.dim, dtype=torch.float32, device=tr.device)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        launch_train.worker_grad(tr.state.params, batch, cfg, out)
        torch.cuda.synchronize()
    return sum(n for n, _ in device_kernels(prof).values()), out


def remat_phase(dev) -> dict:
    """``TRAIN_FULL`` under ``remat_policy`` none, full and dots, each
    counted from 0: peak memory above what earlier phases hold, the step
    wall, device events per worker gradient, ``olaf_step`` launches (one
    per PS step); every counter equal across the policies, the losses
    within ``REMAT_TOL``; one worker gradient at the same weights and
    batch under each policy, compared bit for bit."""
    t_phase = time.perf_counter()
    runs, counts = {}, {}
    tr = None
    for policy in REMAT_POLICIES:
        del tr
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        with remat_policy(policy), \
                EventClock(launch_train, "worker_grad") as grad_clock:
            tr = launch_train.main(TRAIN_FULL)
            torch.cuda.synchronize()
        counts[policy] = read_counts()
        peak = torch.cuda.max_memory_allocated() - held
        steps = tr.args.steps
        require(counts[policy]["olaf_step"] == steps,
                f"remat {policy}: {counts[policy]['olaf_step']} olaf_step "
                f"launches in {steps} PS steps")
        require(tr.cfg.remat and tr.cfg.remat_policy == policy,
                f"remat {policy}: the trainer ran {tr.cfg.remat_policy}")
        grad_ms = grad_clock.ms()
        runs[policy] = dict(
            peak_bytes=peak, step_s=tr.wall / steps,
            grad_ms=float(np.mean(grad_ms[2:])),
            losses=[l for _, l, _ in tr.log_rows],
            combined=[c for *_, c in tr.log_rows],
            totals=(tr.deferred_total, tr.stale_total, tr.screened_total),
            queue={f: getattr(tr.state.queue, f).cpu() for f in META
                   if f != "reward"})
        log(f"[remat] {policy}: peak {peak} B ({peak / 2**30:.2f} GiB above "
            f"the {held} B held before); {steps} steps in {tr.wall:.3f} s = "
            f"{tr.wall / steps:.4f} s a step; worker gradient "
            f"{runs[policy]['grad_ms']:.2f} ms (CUDA events, mean of "
            f"gradients 3-{len(grad_ms)}); olaf_step launches "
            f"{counts[policy]['olaf_step']} (counted from 0); losses "
            f"{[round(l, 6) for l in runs[policy]['losses']]}")
    # one worker gradient at the last run's weights and one batch, profiled,
    # under each policy
    grads = {}
    for policy in REMAT_POLICIES:
        runs[policy]["events_per_grad"], grads[policy] = gradient_events(
            tr, dataclasses.replace(tr.cfg, remat_policy=policy))
    del tr
    log("[remat] device events per worker gradient (one profiled call at "
        "the same weights and batch): " + ", ".join(
            f"{p} {runs[p]['events_per_grad']}" for p in REMAT_POLICIES))
    base = runs["none"]
    for policy in REMAT_POLICIES[1:]:
        r = runs[policy]
        same = {k: v for k, v in counts[policy].items() if k != "flash_attention"}
        require(same == {k: v for k, v in counts["none"].items()
                         if k != "flash_attention"}
                and counts[policy]["flash_attention"]
                == 2 * counts["none"]["flash_attention"] > 0
                and r["combined"] == base["combined"]
                and r["totals"] == base["totals"]
                and all(torch.equal(v, base["queue"][f])
                        for f, v in r["queue"].items()),
                f"remat {policy}: counters differ from none (the flash "
                f"forward twice as often: the recompute)")
        require(np.allclose(r["losses"], base["losses"], rtol=REMAT_TOL,
                            atol=0), f"remat {policy}: losses {r['losses']} "
                f"vs {base['losses']}")
    diffs = {p: float((grads[p] - grads["none"]).abs().max())
             for p in REMAT_POLICIES[1:]}
    log("[remat] counters equal across the policies (deferred, stale, "
        f"screened {base['totals']}, combined {base['combined']}, the queue's "
        f"metadata); losses within rtol {REMAT_TOL}; one worker gradient at "
        "the same weights and batch: " + "; ".join(
            f"{p} {'bitwise equal to none' if d == 0 else f'max |diff| {d:.3g} from none'}"
            for p, d in diffs.items()))
    log(f"[remat] phase wall {time.perf_counter() - t_phase:.1f} s")
    del grads
    torch.cuda.empty_cache()
    return dict(counts=counts, runs={p: {k: r[k] for k in (
        "peak_bytes", "step_s", "grad_ms", "events_per_grad")}
        for p, r in runs.items()}, grad_diff=diffs)


# ---------------------------------------------------------------------------
# the dry run: the sweep on the meta device, then one card's bytes
# ---------------------------------------------------------------------------
DRYRUN_SHAPE = ShapeCfg("train", seq_len=256, global_batch=32, kind="train")
DRYRUN_SYNC = TRAIN_SYNC[:TRAIN_SYNC.index("--steps")] + [
    "--steps", "1", "--log-every", "0"]


class BatchCapture:
    """Replaces ``launch_train.loss_and_grads`` inside a ``with`` block and
    keeps the last batch it was given."""

    def __enter__(self):
        self._orig = orig = launch_train.loss_and_grads

        def wrapper(params, batch, cfg):
            self.batch = batch
            return orig(params, batch, cfg)

        launch_train.loss_and_grads = wrapper
        return self

    def __exit__(self, *exc):
        launch_train.loss_and_grads = self._orig
        return False


DRYRUN_STEPS = 10  # timed sync steps without the count
DRYRUN_TOP_OPS = 6  # the plain step's ops printed by their bytes
DRYRUN_CELLS = [("smollm-360m", "train_4k"), ("grok-1-314b", "decode_32k"),
                ("mamba2-130m", "prefill_32k"),
                ("recurrentgemma-9b", "decode_32k"),
                ("internvl2-76b", "prefill_32k"),
                ("whisper-small", "decode_32k")]


def _sync_opt() -> OptConfig:
    """The optimizer ``launch.train --mode sync`` steps with at its default
    ``--lr`` (``DRYRUN_SYNC`` sets none)."""
    return OptConfig(lr=launch_train.build_parser().get_default("lr"),
                     grad_clip=1.0)


def _meta_like(tree):
    """Meta tensors of ``tree``'s leaves' shapes, strides and dtypes."""
    return lm_module.tree_unflatten(tree, [
        torch.empty_strided(x.shape, x.stride(), dtype=x.dtype,
                            device="meta") for x in tree_leaves(tree)])


def counted_train_step(params, opt_state, batch, cfg, opt, trace=None):
    """``dryrun.train_step`` under ``dryrun.StepCost``: its ``cost``."""
    with dryrun.StepCost(trace) as counter:
        dryrun.train_step(params, opt_state, batch, cfg, opt)
    return counter.cost()


def bytes_by_op(trace) -> dict:
    out: dict = {}
    for row in trace:
        out[row[0]] = out.get(row[0], 0) + row[3]
    return out


def one_period_diff(cfg, opt) -> tuple:
    """Bytes by aten op of one period of the (1, 1) sharded pass less the
    plain step's on meta tensors of the same specs: the op-by-op source of
    any difference between the two. Returns ``(total, {op: bytes})``."""
    one_cfg = dataclasses.replace(cfg, n_layers=lm.period_len(cfg))
    sharded, plain = [], []
    dryrun.sharded_fit(one_cfg, DRYRUN_SHAPE, make_host_mesh(1, 1), opt,
                       trace=sharded)
    pspec = lm_api.param_spec(one_cfg)
    counted_train_step(pspec, init_opt_state(pspec, opt),
                       lm_api.input_specs(one_cfg, DRYRUN_SHAPE), one_cfg,
                       opt, plain)
    a, b = bytes_by_op(sharded), bytes_by_op(plain)
    diff = {k: a.get(k, 0) - b.get(k, 0) for k in set(a) | set(b)}
    return (sum(diff.values()),
            {k: v for k, v in sorted(diff.items(), key=lambda kv: -abs(kv[1]))
             if v})


def transcendentals_by_op(path) -> dict:
    """``{op: (transcendentals, {result spec: ops})}`` of an ``--hlo-dump``
    op trace (the 1-period probe), the ops that count any."""
    col = dryrun.TRACE_COLUMNS.index
    out: dict = {}
    for ln in pathlib.Path(path).read_text().splitlines():
        if ln.startswith("#"):
            continue
        row = ln.split("\t")
        n = int(row[col("transcendentals")])
        if n:
            entry = out.setdefault(row[0], [0, {}])
            entry[0] += n
            spec = row[col("results")]
            entry[1][spec] = entry[1].get(spec, 0) + 1
    return dict(sorted(out.items(), key=lambda kv: -kv[1][0]))


def dryrun_phase(dev, smi: str) -> dict:
    """The dry run. One process per family runs ``python -m
    repro_torch.launch.dryrun`` on one cell (``DRYRUN_CELLS``) of the 16 ×
    16 mesh, its sharded pass on a fake process group (per-device
    ``temp_bytes``, collective bytes by kind); meanwhile, here, the fast
    pass over every cell of both meshes (``--all --fast``: its summary line
    and seconds), then smollm-360m at the ``[train]`` shape on a (1, 1)
    mesh: the predicted argument bytes (params, AdamW m/v, step, one batch)
    against the summed ``nbytes`` of the same tensors as ``launch.train
    --mode sync`` holds them on the card, and the predicted peak (argument
    + temp bytes of the sharded pass) against the step's
    ``torch.cuda.max_memory_allocated``. Then the cost record: one
    ``dryrun.train_step`` on the trainer's tensors on the card under
    ``dryrun.StepCost`` equals, count for count, the same step on meta
    tensors of their shapes (a kernel launched through ``ctypes`` would be
    invisible to the count and show as a gap), with the ops that move most
    of its bytes, timed without the count (CUDA events, the median, least
    and most of ``DRYRUN_STEPS`` steps) for its counted eager bytes over
    that time, set beside the card's 3.35 TB/s, and set beside the (1, 1)
    sharded pass's ``cost`` with the op-by-op source of their difference;
    each cell's ``cost``, its bytes at least its argument + output bytes.
    ``main`` prints the phase's numbers again as one ``[dryrun] summary``
    line near the end of the output."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as out_dir:
        cell_dir = pathlib.Path(out_dir) / "cells"
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=str(pathlib.Path(__file__).resolve().parent
                                  / "src"))
        cells = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", a,
             "--shape", s, "--single-pod", "--hlo-dump", "--out",
             str(cell_dir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for a, s in DRYRUN_CELLS]
        try:
            text = io.StringIO()
            with contextlib.redirect_stdout(text):
                rc = dryrun.main(["--all", "--fast", "--out", out_dir])
            n_records = len(list(pathlib.Path(out_dir).glob("*.json")))
            sweep_s = time.perf_counter() - t0
            summary = [ln for ln in text.getvalue().splitlines()
                       if ln.startswith("dry-run summary")]
            require(rc == 0 and summary and n_records == 80,
                    f"dryrun sweep: rc {rc}, {n_records} records, {summary}")
            log(f"[dryrun] --all --fast, both meshes, on the meta device: "
                f"{summary[0]} in {sweep_s:.1f} s")
            one = make_host_mesh(1, 1)
            cfg = get_config("smollm-360m")
            opt = _sync_opt()
            fit = dryrun.memory_fit(cfg, DRYRUN_SHAPE, one, opt)
            t1 = time.perf_counter()
            pred = dryrun.sharded_probes(cfg, DRYRUN_SHAPE, one, opt)
            pred_s = time.perf_counter() - t1
            torch.cuda.empty_cache()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            reset_counts()
            with BatchCapture() as cap:
                res = launch_train.main(DRYRUN_SYNC)
                torch.cuda.synchronize()
            counts = read_counts()
            allocated = torch.cuda.memory_allocated() - held
            peak = torch.cuda.max_memory_allocated() - held
            parts = dict(params=tree_leaves(res.params),
                         opt_state=tree_leaves(res.opt_state),
                         inputs=list(cap.batch.values()))
            on_card = {k: sum(x.nbytes for x in v) for k, v in parts.items()}
            require(all(x.device.type == "cuda" for v in parts.values()
                        for x in v),
                    "dryrun: the trainer's tensors are not on the card")
            require(sum(on_card.values()) == fit["argument_bytes"]
                    and on_card == fit["arguments"],
                    f"dryrun: predicted {fit['arguments']} B, the trainer "
                    f"holds {on_card} B")
            predicted = fit["argument_bytes"] + pred["temp_bytes"]
            require(pred["temp_bytes"] > 0
                    and pred["collectives"]["total_bytes"] == 0,
                    f"dryrun: (1, 1) sharded pass {pred}")
            log(f"[dryrun] smollm-360m train seq {DRYRUN_SHAPE.seq_len} batch "
                f"{DRYRUN_SHAPE.global_batch} on a (1, 1) mesh ({smi}): "
                f"predicted argument bytes {fit['argument_bytes']} "
                f"({fit['arguments']}) equal the trainer's tensors on the "
                f"card ({on_card}); predicted temp {pred['temp_bytes']} B "
                f"(probes {pred['probes']}, {pred_s:.1f} s), so a peak of "
                f"argument + temp {predicted} B ({predicted / 2**30:.2f} GiB);"
                f" the sync step's max_memory_allocated {peak} B "
                f"({peak / 2**30:.2f} GiB): gap {peak - predicted} B "
                f"({(peak - predicted) / 2**30:+.2f} GiB, "
                f"{(peak - predicted) / peak:+.1%} of the measured); "
                f"memory_allocated after it {allocated} B")
            # the count follows aten ops, and the meta step takes the plain
            # routes: so does the counted and timed step on the card (the
            # flash pair's ctypes launches would be a gap in the count)
            cfg = dataclasses.replace(cfg, attn_impl="full")
            step_args = (res.params, res.opt_state, cap.batch)
            card = counted_train_step(*step_args, cfg, opt)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trace = []
            meta = counted_train_step(*map(_meta_like, step_args), cfg, opt,
                                      trace)
            meta_s = time.perf_counter() - t1
            top = sorted(bytes_by_op(trace).items(), key=lambda kv: -kv[1])[
                :DRYRUN_TOP_OPS]
            del trace
            require(card == meta and all(v > 0 for v in card.values()),
                    f"dryrun: the sync step's cost on the card {card} "
                    f"differs from the same step on meta {meta}")
            times = []
            for i in range(DRYRUN_STEPS + 1):  # one warm-up, then timed
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                dryrun.train_step(*step_args, cfg, opt)
                end.record()
                end.synchronize()
                if i:
                    times.append(start.elapsed_time(end))
            step_ms = float(np.median(times))
            rate = card["bytes_accessed"] / (step_ms / 1e3)
            period_diff, by_op = one_period_diff(cfg, opt)
            pc = pred["cost"]
            gap = pc["bytes_accessed"] - card["bytes_accessed"]
            log(f"[dryrun] cost of one sync step, smollm-360m seq "
                f"{DRYRUN_SHAPE.seq_len} batch {DRYRUN_SHAPE.global_batch} "
                f"({smi}): bytes_accessed {card['bytes_accessed']}, flops "
                f"{card['flops']}, transcendentals {card['transcendentals']}"
                f", equal on the card and on meta (meta count {meta_s:.1f} "
                f"s); most bytes by op: " + ", ".join(
                    f"{k} {v} ({v / card['bytes_accessed']:.1%})"
                    for k, v in top))
            log(f"[dryrun] the step without the count, {len(times)} steps "
                f"by CUDA events: median {step_ms:.3f} ms, min "
                f"{min(times):.3f}, max {max(times):.3f} "
                f"({[round(t, 3) for t in times]}): counted eager bytes over "
                f"the median step time {rate / 1e9:.1f} GB/s (the card's HBM "
                f"rate 3.35 TB/s; the count is unfused aten-level traffic, "
                f"not a measured HBM rate)")
            log(f"[dryrun] the (1, 1) sharded pass's cost {pc} (probes "
                f"{pred['probes']}): bytes {gap:+d} from the plain step's "
                f"({gap / card['bytes_accessed']:+.2%}), flops "
                f"{pc['flops'] - card['flops']:+d}, transcendentals "
                f"{pc['transcendentals'] - card['transcendentals']:+d}; one "
                f"period differs by {period_diff:+d} B, by op: " + ", ".join(
                    f"{k} {v:+d}" for k, v in list(by_op.items())[:8]))
            del res, parts, cap, step_args
            torch.cuda.empty_cache()
            records = {}
            for (a, s), proc in zip(DRYRUN_CELLS, cells):
                out, _ = proc.communicate(timeout=900)
                path = cell_dir / f"{a}__{s}__pod_16x16.json"
                require(proc.returncode == 0 and path.exists(),
                        f"dryrun {a} {s}: rc {proc.returncode}: "
                        f"{out[-2000:]}")
                rec = json.loads(path.read_text())
                mem, coll, cost = (rec["memory"], rec["collectives"],
                                   rec["cost"])
                floor = mem["argument_bytes"] + mem["output_bytes"]
                require(rec["status"] == "ok" and mem["temp_bytes"] > 0
                        and cost["bytes_accessed"] >= floor
                        and min(cost.values()) > 0
                        and mem["per_device_total"] == (
                            mem["argument_bytes"] + mem["output_bytes"]
                            + mem["temp_bytes"])
                        and set(coll["per_kind"]) >= {
                            "all-gather", "all-reduce", "reduce-scatter",
                            "all-to-all", "collective-permute"},
                        f"dryrun {a} {s}: {rec}")
                records[f"{a} {s}"] = dict(
                    temp_bytes=mem["temp_bytes"],
                    per_device_total=mem["per_device_total"],
                    fits=mem["fits_h100_80gb"], collectives=coll["per_kind"],
                    cost=cost, seconds=rec["sharded"]["seconds"])
                log(f"[dryrun] {a} {s} pod_16x16 (sharded pass, probes "
                    f"{rec['sharded']['probes']}, "
                    f"{rec['sharded']['seconds']:.1f} s): per device "
                    f"argument {mem['argument_bytes']} B, output "
                    f"{mem['output_bytes']} B, temp {mem['temp_bytes']} B, "
                    f"total {mem['per_device_total']} B (fits 80 GiB: "
                    f"{mem['fits_h100_80gb']}); collectives "
                    f"{coll['total_bytes']} B: " + ", ".join(
                        f"{k} {v}" for k, v in coll["per_kind"].items())
                    + f"; cost {cost} (bytes {cost['bytes_accessed'] / floor:.1f}"
                    f"x argument + output)")
                by_op = transcendentals_by_op(
                    cell_dir / f"{a}__{s}__pod_16x16.ops.txt")
                records[f"{a} {s}"]["probe_transcendentals"] = {
                    k: v[0] for k, v in by_op.items()}
                log(f"[dryrun] {a} {s}: the 1-period probe's "
                    f"transcendentals by op (torch {torch.__version__}): "
                    + ", ".join(f"{k} {n} (" + ", ".join(
                        f"{c}x {spec}" for spec, c in specs.items()) + ")"
                        for k, (n, specs) in by_op.items()))
        finally:
            for proc in cells:
                if proc.poll() is None:
                    proc.kill()
                    proc.communicate()
    log(f"[dryrun] phase wall {time.perf_counter() - t0:.1f} s")
    return dict(counts=counts, sweep_s=sweep_s, summary=summary[0],
                predicted=predicted, allocated=allocated, peak=peak,
                cost=card, step_ms=step_ms, step_ms_min=min(times),
                step_ms_max=max(times), counted_gb_s=rate / 1e9,
                predicted_cost=pc, cells=records)


# ---------------------------------------------------------------------------
# [ckpt]: the elastic re-mesh checkpoint of the sync state at full width
# ---------------------------------------------------------------------------
CKPT_SYNC = TRAIN_SYNC[:TRAIN_SYNC.index("--steps")] + ["--log-every", "0"]
CKPT_ARCH = TRAIN_SYNC[TRAIN_SYNC.index("--arch") + 1]


def same_bits(a, b) -> bool:
    """Equal dtype, shape and bytes (a DTensor: its local tensor; NaNs and
    signed zeros told apart)."""
    a, b = (x.to_local() if hasattr(x, "to_local") else x for x in (a, b))
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(a.reshape(-1).view(torch.uint8),
                            b.reshape(-1).view(torch.uint8)))


def trees_same_bits(a, b) -> bool:
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(same_bits(x, y) for x, y in zip(la, lb))


def synced_wall(fn, *a, **kw):
    """``(seconds, fn(*a, **kw))``, the card synchronized before and
    after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn(*a, **kw)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def on_device(tree, dev):
    """A tree of ``tree``'s structure with ``dev`` at every leaf: the
    shardings that place a restore on one device."""
    return lm_module.tree_unflatten(tree, [dev] * len(tree_leaves(tree)))


class Timed:
    """Replaces ``module.name`` inside a ``with`` block: each call's wall
    (:func:`synced_wall`) in ``seconds``, its arguments and result handed
    to ``check`` where given."""

    def __init__(self, module, name, check=None):
        self.module, self.name, self.check = module, name, check
        self.fn, self.seconds = getattr(module, name), []

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)
        return False

    def __call__(self, *a, **kw):
        seconds, out = synced_wall(self.fn, *a, **kw)
        self.seconds.append(seconds)
        if self.check is not None:
            self.check(a, kw, out)
        return out


def dtensor_round_trip(state, ckpt_dir: str, dev) -> dict:
    """``state`` (params, AdamW state) placed by ``sharding.to_named`` with
    smollm-360m's ``params_pspecs_cfg``/``opt_state_pspecs`` over a (1, 1)
    ("data", "model") mesh of one NCCL rank on ``dev`` (gloo on the CPU),
    saved from the DTensors, restored from meta likes onto the plain device
    and back onto the placements. Opens its own process group and closes
    it, after an error too."""
    import socket
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed import sharding as SH
    from repro_torch.optim.optimizers import opt_state_pspecs

    require(not dist.is_initialized(), "ckpt: a process group is open")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://localhost:{port}", rank=0,
                            world_size=1)
    try:
        dm = init_device_mesh(dev.type, (1, 1),
                              mesh_dim_names=("data", "model"))
        cfg, opt = get_config(CKPT_ARCH), _sync_opt()
        p_like = lm_api.param_spec(cfg)
        o_like = init_opt_state(p_like, opt)
        p_spec = SH.params_pspecs_cfg(p_like, dm, cfg)
        o_spec = opt_state_pspecs(p_spec, opt)
        placed = (SH.to_named(state[0], p_spec, dm),
                  SH.to_named(state[1], o_spec, dm))
        shardings = (SH.named_shardings(p_like, p_spec, dm),
                     SH.named_shardings(o_like, o_spec, dm))
        out = {}
        with tempfile.TemporaryDirectory(dir=ckpt_dir) as d:
            out["save_s"], _ = synced_wall(save_checkpoint, d, 1, *placed)
            for name, (p_sh, o_sh) in (
                    ("plain", (on_device(p_like, dev),
                               on_device(o_like, dev))),
                    ("placed", shardings)):
                out[f"restore_{name}_s"], (_, params, opt_state) = \
                    synced_wall(restore_checkpoint, d, params_like=p_like,
                                opt_like=o_like, shardings=p_sh,
                                opt_shardings=o_sh)
                want = state if name == "plain" else placed
                out[f"{name}_bitwise"] = trees_same_bits(
                    (params, opt_state), want)
                if name == "placed":
                    out["placements_equal"] = all(
                        x.placements == y.placements == sh.placements()
                        for x, y, sh in zip(tree_leaves((params, opt_state)),
                                            tree_leaves(placed),
                                            tree_leaves(shardings)))
                del params, opt_state
        out["placements"] = sorted({str(x.placements)
                                    for x in tree_leaves(placed)})
        return out
    finally:
        dist.destroy_process_group()


def ckpt_phase(dev, smi: str, uninterrupted) -> dict:
    """``[ckpt]``: smollm-360m's sync state at the ``[train]`` shape
    (params and AdamW m, v; D = 361,821,120), counted from 0: the one-step
    run saving its state (``--ckpt``); ``[train]``'s three-step run
    (``uninterrupted``) resumed from that step, whose restore is from meta
    likes (``api.param_spec``) placed on the card (``shardings``) and
    bitwise the saved state, and whose losses, params and optimizer state
    after the next two steps are bitwise the uninterrupted run's. A meta
    like without a sharding raises. Then the restored state's DTensor round
    trip over a one-rank NCCL mesh (:func:`dtensor_round_trip`). Save and
    restore walls beside the card's name and power limit."""
    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    reset_counts()
    steps = int(TRAIN_SYNC[TRAIN_SYNC.index("--steps") + 1])
    restored = {}

    def check_restore(a, kw, out):
        step, params, opt_state = out
        restored.update(step=step, params=trees_same_bits(params, one.params),
                        opt=trees_same_bits(opt_state, one.opt_state),
                        meta=all(x.is_meta for x in tree_leaves(
                            (kw["params_like"], kw["opt_like"]))),
                        on_card=all(x.device.type == dev.type for x in
                                    tree_leaves((params, opt_state))),
                        state=(params, opt_state))

    with tempfile.TemporaryDirectory() as d:
        with Timed(launch_train, "save_checkpoint") as saves:
            one = launch_train.main(CKPT_SYNC + ["--steps", "1", "--ckpt", d])
            nbytes = os.path.getsize(pathlib.Path(d) / "ckpt_00000001.npz")
            with Timed(launch_train, "restore_checkpoint",
                       check_restore) as restores:
                resumed = launch_train.main(
                    CKPT_SYNC + ["--steps", str(steps), "--ckpt", d])
        torch.cuda.synchronize()
        counts = read_counts()
        state = restored.pop("state")
        require(restored == dict(step=1, params=True, opt=True, meta=True,
                                 on_card=True),
                f"ckpt: the resume's restore from meta likes {restored}")
        require(resumed.losses == uninterrupted.losses[1:],
                f"ckpt: resumed losses {resumed.losses} against the "
                f"uninterrupted {uninterrupted.losses}")
        require(trees_same_bits(resumed.params, uninterrupted.params)
                and trees_same_bits(resumed.opt_state,
                                    uninterrupted.opt_state),
                "ckpt: the resumed steps' state differs from the "
                "uninterrupted run's")
        try:
            restore_checkpoint(d, 1, params_like=lm_api.param_spec(
                get_config(CKPT_ARCH)))
            raised = ""
        except ValueError as e:
            raised = str(e)
        require("meta like" in raised,
                "ckpt: a meta like without a sharding did not raise")
        n_leaves = len(tree_leaves(state))
        del one, resumed
        rt = dtensor_round_trip(state, d, dev)
    require(rt["plain_bitwise"] and rt["placed_bitwise"]
            and rt["placements_equal"], f"ckpt: DTensor round trip {rt}")
    # no OLAF kernel in a sync run; the flash pair on every attention layer
    # of its 3 gradients (1 saved, 2 resumed), the forward twice (remat)
    n_attn = get_config(CKPT_ARCH).n_layers * steps
    require(counts["flash_attention"] == 2 * n_attn
            and counts["flash_attention_backward"] == n_attn
            and not any(v for k, v in counts.items()
                        if not k.startswith("flash_attention")),
            f"ckpt: kernel launches {counts}")
    save_s, restore_s = saves.seconds, restores.seconds[0]
    log(f"[ckpt] smollm-360m sync state at batch 32 seq 256 ({smi}): "
        f"{n_leaves} leaves, {nbytes} B as npz ({nbytes / 2**30:.2f} GiB, "
        f"bf16 params widened to float32); save {save_s[0]:.2f} s "
        f"({nbytes / save_s[0] / 1e9:.2f} GB/s; the resumed run's final "
        f"save {save_s[-1]:.2f} s); restore from meta likes onto the card "
        f"{restore_s:.2f} s ({nbytes / restore_s / 1e9:.2f} GB/s), every "
        f"leaf bitwise the saved state; the next {steps - 1} steps' losses, "
        f"params and AdamW state bitwise the uninterrupted run's; a meta "
        f"like without a sharding raises ValueError; launch counts {counts}")
    log(f"[ckpt] DTensor round trip over a one-rank NCCL (1, 1) mesh "
        f"(placements {rt['placements']}): save from DTensors "
        f"{rt['save_s']:.2f} s, restore onto the plain card "
        f"{rt['restore_plain_s']:.2f} s and back onto the placements "
        f"{rt['restore_placed_s']:.2f} s, each bitwise; phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, bytes=nbytes, save_s=save_s[0],
                restore_s=restore_s, dtensor=rt)


# ---------------------------------------------------------------------------
# the other families: moe, ssm, hybrid, vlm and encdec served at full width,
# moe/ssm/hybrid trained
# ---------------------------------------------------------------------------
# arch: (layers on the card, B, P); full published widths from configs/,
# depth cut only where one card forces it (grok 2 of 64, arctic 1 of 35,
# internvl2 4 of 80)
FAMILIES = {
    "mamba2-130m": (24, 4, 512),
    "recurrentgemma-9b": (38, 2, 2304),  # past the 2048 window: the ring wraps
    "grok-1-314b": (2, 4, 512),
    "arctic-480b": (1, 4, 512),
    "internvl2-76b": (4, 4, 512),
    "whisper-small": (12, 4, 64),
}
FAMILY_GEN = 16
FAMILY_TOL = 1e-4  # reduced configs, float32: the card against the CPU
# arctic's one layer is 54 GB in float32: its float32 check keeps this many
# of its 128 experts (every width as published)
ARCTIC_F32_EXPERTS = 16
FAMILY_TRAIN_FULL = ["--arch", "mamba2-130m", "--mode", "olaf-async",
                     "--workers", "4", "--batch", "32", "--seq", "256",
                     "--burst-size", "2", "--drain-k", "4", "--steps", "3",
                     "--log-every", "0"]
FAMILY_TRAIN_REDUCED = ["--reduced", "--mode", "olaf-async", "--workers", "4",
                        "--batch", "8", "--seq", "16", "--burst-size", "2",
                        "--drain-k", "4", "--steps", "4", "--log-every", "0"]


def family_cfg(arch, **kw):
    depth = FAMILIES[arch][0]
    return dataclasses.replace(get_config(arch), n_layers=depth, **kw)


def expected_launches(cfg, gen):
    """(flash, decode) launches of one served run under ``"pallas"``: one
    flash per attention layer of the prefill (whisper: each encoder and
    decoder layer), one decode per non-windowed attention layer and step
    (the hybrid's windowed layers decode through the plain masked
    attention)."""
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers, cfg.n_layers * gen
    n_attn = sum(k in ("attn", "moe") for k in lm.layer_plan(cfg))
    return n_attn, 0 if cfg.window else n_attn * gen


def first_period(params, cfg):
    """The params of the model cut to its first period (one layer;
    recurrentgemma one (rec, rec, attn) period; whisper one encoder and one
    decoder layer; arctic's layer with its first ``ARCTIC_F32_EXPERTS``
    experts), as views, and that model's config."""
    if cfg.family == "encdec":
        keep = {k: v for k, v in params.items() if "layers" not in k}
        keep["enc_layers"] = lm_module.tree_map(lambda x: x[:1],
                                                params["enc_layers"])
        keep["dec_layers"] = lm_module.tree_map(lambda x: x[:1],
                                                params["dec_layers"])
        return keep, dataclasses.replace(cfg, n_layers=1, n_enc_layers=1)
    keep = {k: v for k, v in params.items() if k not in ("layers", "tail")}
    keep["layers"] = lm_module.tree_map(lambda x: x[:1], params["layers"])
    cfg = dataclasses.replace(cfg, n_layers=len(lm.split_plan(cfg)[0]))
    if cfg.name == "arctic-480b":
        E = min(ARCTIC_F32_EXPERTS, cfg.n_experts)
        moe = keep["layers"]["sub_0"]["moe"]  # a fresh dict of tree_map's
        moe["router"] = moe["router"][..., :E]
        for w in ("wg", "wu", "wd"):
            moe[w] = moe[w][:, :E]
        cfg = dataclasses.replace(cfg, n_experts=E)
    return keep, cfg


def teacher_forced_logits(params, cfg, dev, B, P, tokens):
    """Prefill logits, then the logits of every decode step fed ``tokens``
    (the picks of a run served with seed 0, whose prompts these are) at the
    served positions: (gen + 1, B, V)."""
    gen = tokens.shape[1] - 1
    offset = launch_serve.position_offset(cfg)
    inputs = launch_serve.prompt_inputs(cfg, B, P, 0, dev)
    out = []
    with torch.inference_mode():
        logits, caches = lm_api.prefill(params, inputs, cfg)
        out.append(logits[:, -1])
        caches = lm_module.tree_map(launch_serve._grow, lm_api.make_caches(
            cfg, B, offset + P + gen + 8, device=dev), caches)
        for i in range(gen):
            tok = torch.as_tensor(tokens[:, i], device=dev)
            pos = torch.full((B,), offset + P + i, dtype=torch.int32,
                             device=dev)
            logits, caches = lm_api.decode_step(
                params, caches, {"token": tok, "pos": pos}, cfg)
            out.append(logits)
    return torch.stack(out)


def profiled_family(params, cfg, dev, B, P, n_decode=4):
    """Under the profiler: the prefill alone, then ``n_decode`` decode
    steps from its caches. Returns (prefill, decode) dicts of device busy
    s, wall s and device events."""
    offset = launch_serve.position_offset(cfg)
    inputs = launch_serve.prompt_inputs(cfg, B, P, 0, dev)
    out = {}
    with torch.inference_mode():
        for part in ("prefill", "decode"):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                if part == "prefill":
                    logits, caches = lm_api.prefill(params, inputs, cfg)
                else:
                    for i in range(n_decode):
                        pos = torch.full((B,), offset + P + i,
                                         dtype=torch.int32, device=dev)
                        logits, caches = lm_api.decode_step(
                            params, caches, {"token": token, "pos": pos}, cfg)
                        token = torch.argmax(logits[:, :cfg.vocab], -1).to(
                            torch.int32)
                torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k = device_kernels(prof)
            out[part] = dict(busy_s=sum(us for _, us in k.values()) / 1e6,
                             wall_s=wall,
                             events=sum(n for n, _ in k.values()))
            if part == "prefill":
                caches = lm_module.tree_map(
                    launch_serve._grow, lm_api.make_caches(
                        cfg, B, offset + P + n_decode + 8, device=dev), caches)
                token = torch.argmax(logits[:, -1, :cfg.vocab], -1).to(
                    torch.int32)
    out["decode"]["events_per_step"] = out["decode"]["events"] / n_decode
    out["decode"]["steps"] = n_decode
    return out


def reduced_card_vs_cpu(arch, dev):
    """The reduced config (float32, its own ``attn_impl``: the kernels take
    no head dim of 16), its weights drawn on the CPU: served on the card,
    then teacher-forced on the card and on the CPU with the served tokens.
    Returns the logits' max |err|."""
    cfg = get_config(arch).reduced()
    host = lm_api.init_model(torch.Generator().manual_seed(0), cfg)
    card = lm_module.tree_map(lambda x: x.to(dev), host)
    B, P = 2, 20
    toks = launch_serve.serve(cfg, batch=B, prompt_len=P, gen=4,
                              temperature=0.0, device=dev, params=card).tokens
    got = teacher_forced_logits(card, cfg, dev, B, P, toks)
    want = teacher_forced_logits(host, cfg, torch.device("cpu"), B, P, toks)
    err = float((got.cpu() - want).abs().max())
    require(torch.allclose(got.cpu(), want, rtol=FAMILY_TOL, atol=FAMILY_TOL),
            f"families {arch} reduced: card off the CPU by {err}")
    return err


def families_phase(dev, smi) -> dict:
    """Each arch served at full width through ``launch.serve.serve`` under
    ``attn_impl="pallas"`` (bf16, seeded random weights, greedy), counted
    from 0, one arch at a time with its weights freed before the next; the
    prefill and a few decode steps profiled; its first period's float32
    kernel route against the plain route, teacher-forced on the served
    tokens; the reduced config on the card against the CPU. Then training:
    full-width mamba2 olaf-async, and the reduced olaf-async runs of grok-1,
    mamba2 and recurrentgemma on the card against the CPU. Returns the
    launch counts per path and the numbers per arch."""
    t_phase = time.perf_counter()
    counts, rows = {}, {}
    for arch, (depth, B, P) in FAMILIES.items():
        t_arch = time.perf_counter()
        cfg = family_cfg(arch, attn_impl="pallas")
        torch.cuda.empty_cache()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        params = lm_api.init_model(torch.Generator(dev).manual_seed(0), cfg)
        n_params = lm_module.count_params(params)
        launch_serve.serve(cfg, batch=B, prompt_len=P, gen=2, temperature=0.0,
                           device=dev, params=params)  # warm-up
        reset_counts()
        served = launch_serve.serve(cfg, batch=B, prompt_len=P,
                                    gen=FAMILY_GEN, temperature=0.0,
                                    device=dev, params=params)
        c = counts[arch] = read_counts()
        peak = torch.cuda.max_memory_allocated() - held
        toks = served.tokens
        want_fl, want_dec = expected_launches(cfg, FAMILY_GEN)
        require((c["flash_attention"], c["decode_attention"])
                == (want_fl, want_dec),
                f"families {arch}: flash {c['flash_attention']}, decode "
                f"{c['decode_attention']} launches; {want_fl}, {want_dec} "
                f"expected")
        require(toks.shape == (B, FAMILY_GEN + 1) and toks.min() >= 0
                and toks.max() < cfg.vocab, f"families {arch}: tokens")
        prof = profiled_family(params, cfg, dev, B, P)
        pre, dec = prof["prefill"], prof["decode"]
        # the first period in float32: the kernel route against the plain
        # route, teacher-forced on the served tokens
        sliced, cfg32 = first_period(params, cfg)
        p32 = lm_module.cast_tree(sliced, torch.float32)
        del params, sliced
        torch.cuda.empty_cache()
        cfg32 = dataclasses.replace(cfg32, dtype="float32")
        got = teacher_forced_logits(p32, cfg32, dev, B, P, toks)
        want = teacher_forced_logits(p32, dataclasses.replace(cfg32, attn_impl="full"),
                             dev, B, P, toks)
        route_err = float((got - want).abs().max())
        require(bool(torch.isfinite(got).all()), f"families {arch}: f32 logits")
        require(torch.allclose(got, want, rtol=SERVE_TOL, atol=SERVE_TOL),
                f"families {arch} f32: kernel route off the plain route by "
                f"{route_err}")
        del p32, got, want
        torch.cuda.empty_cache()
        host_err = reduced_card_vs_cpu(arch, dev)
        # idle shares against the served (unprofiled) walls: the profiler
        # slows the host, and its first trace pays its own start-up
        idle_pre = 100 * (1 - pre["busy_s"] / served.prefill_s)
        idle_dec = 100 * (1 - dec["busy_s"] / dec["steps"]
                          / (served.decode_s / FAMILY_GEN))
        rows[arch] = dict(
            layers=cfg.n_layers, params=n_params, B=B, P=P, gen=FAMILY_GEN,
            prefill_ms=served.prefill_s * 1e3,
            decode_ms_per_token=served.decode_s / FAMILY_GEN * 1e3,
            decode_events_per_step=dec["events_per_step"],
            prefill_events=pre["events"], prefill_idle_share=idle_pre,
            decode_idle_share=idle_dec, peak_bytes=peak,
            flash=c["flash_attention"], decode=c["decode_attention"],
            f32_route_err=route_err, reduced_card_vs_cpu_err=host_err,
            wall_s=time.perf_counter() - t_arch)
        log(f"[families] {arch} ({cfg.family}) {cfg.n_layers} layers"
            + (f" + {cfg.n_enc_layers} encoder" if cfg.n_enc_layers else "")
            + f" d_model={cfg.d_model} vocab={cfg.vocab} {cfg.dtype} "
            f"({n_params} parameters, seeded random), attn_impl=pallas, "
            f"B={B} P={P} gen={FAMILY_GEN} greedy | {smi}: prefill "
            f"{served.prefill_s * 1e3:.3f} ms, decode "
            f"{served.decode_s / FAMILY_GEN * 1e3:.4f} ms/token; launches "
            f"flash {c['flash_attention']} decode {c['decode_attention']} "
            f"(expected {want_fl}, {want_dec}); profiled prefill {pre['events']} "
            f"device events, busy {pre['busy_s'] * 1e3:.3f} ms (its own wall "
            f"{pre['wall_s'] * 1e3:.3f} ms): idle {idle_pre:.2f}% of the served "
            f"prefill; profiled decode {dec['events_per_step']:.1f} device "
            f"events and {dec['busy_s'] / dec['steps'] * 1e3:.3f} ms busy per "
            f"step (its own wall {dec['wall_s'] / dec['steps'] * 1e3:.3f} ms): "
            f"idle {idle_dec:.2f}% of the served step; peak memory {peak / 2**30:.2f} GiB above "
            f"the {held / 2**30:.2f} GiB held; float32 "
            f"first period{f' ({ARCTIC_F32_EXPERTS} of 128 experts)' if arch == 'arctic-480b' else ''} "
            f"kernel route vs plain max |err| {route_err:.3g} (tolerance "
            f"{SERVE_TOL}); reduced config card vs CPU max |err| "
            f"{host_err:.3g} (tolerance {FAMILY_TOL}); tokens[0][:8] "
            f"{toks[0][:8].tolist()}; {rows[arch]['wall_s']:.1f} s")
    # training: full-width mamba2 olaf-async, one olaf_step launch per step
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    tr = launch_train.main(FAMILY_TRAIN_FULL)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    c = counts["train mamba2-130m"] = read_counts()
    losses = [l for _, l, _ in tr.log_rows]
    width = lm_module.count_params(tr.state.params)
    require(tr.dim == width and c["olaf_step"] == tr.args.steps == len(losses)
            and all(math.isfinite(l) for l in losses),
            f"families train mamba2: D {tr.dim}, launches {c['olaf_step']}, "
            f"losses {losses}")
    peak = torch.cuda.max_memory_allocated() - held
    log(f"[families] train mamba2-130m olaf-async full width | {smi}: D="
        f"{tr.dim}, {tr.args.steps} PS steps in {wall:.3f} s, olaf_step "
        f"launches {c['olaf_step']}, losses {[round(l, 6) for l in losses]}, "
        f"peak memory {peak / 2**30:.2f} GiB")
    rows["train mamba2-130m"] = dict(D=tr.dim, wall_s=wall, losses=losses,
                                     peak_bytes=peak)
    del tr
    torch.cuda.empty_cache()
    for arch in ("grok-1-314b", "mamba2-130m", "recurrentgemma-9b"):
        argv = ["--arch", arch] + FAMILY_TRAIN_REDUCED
        card = launch_train.main(argv)
        host = launch_train.main(argv + ["--device", "cpu"])
        l_card = np.array([l for _, l, _ in card.log_rows])
        l_host = np.array([l for _, l, _ in host.log_rows])
        require([n for *_, n in card.log_rows] == [n for *_, n in host.log_rows]
                and np.allclose(l_card, l_host, rtol=FAMILY_TOL, atol=0),
                f"families train {arch} reduced: {l_card} vs {l_host}")
        log(f"[families] train {arch} reduced olaf-async: card equals CPU "
            f"(losses max rel diff "
            f"{float(np.max(np.abs(l_card - l_host) / np.abs(l_host))):.3g}, "
            f"rtol {FAMILY_TOL}; combined counts equal)")
    log(f"[families] phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, rows=rows)


# ---------------------------------------------------------------------------
# [recovery]: checkpointed PS recovery in AsyncDRLTrainer
# ---------------------------------------------------------------------------
RECOVERY_RTOL, RECOVERY_ATOL = 1e-5, 1e-6  # snapshot payloads, card vs CPU


def recovery_cfg(ckpt_dir):
    """``tests/test_node_faults.py``'s churn configuration (two worker
    crashes, a slowed worker, one PS bounce at 0.9) on the lander
    actor-critic, a snapshot every 3 deliveries."""
    faults = FaultSpec(
        workers=[WorkerFault(worker=1, crash_t=0.4, restart_delay=0.5),
                 WorkerFault(worker=3, crash_t=0.6),
                 WorkerFault(worker=2, slowdown=2.0)],
        ps=[PSFault(restart_t=0.9, recovery=0.05)])
    return AsyncTrainConfig(
        env="lander", n_clusters=2, workers_per_cluster=2,
        n_updates_per_worker=8, queue="olaf", horizon=3.0, seed=3,
        out_gbps=1e-3, tx_control=TxControlConfig(ack_timeout=0.3,
                                                  max_retries=2),
        faults=faults, staleness_bound=0.5, max_stale_defers=1,
        ckpt_dir=ckpt_dir, ckpt_every=3)


def recovery_run(device, ckpt_dir):
    """The injected-payload trainer under :func:`recovery_cfg`, with the
    ``olaf_step`` launches of each drain, the drain at which each restore
    landed, and the wall time (synchronised) of each snapshot and
    restore."""
    tr = injected_trainer(recovery_cfg(ckpt_dir), device)
    rec = dict(per_drain=[], restored_at=[], save_s=[], restore_s=[])
    drain, save, restart = (tr._drain_ps_queue, tr._save_ps_checkpoint,
                            tr._on_ps_restart)
    on_card = torch.device(device).type == "cuda"

    def timed(fn, into, *a):
        t0 = time.perf_counter()
        out = fn(*a)
        if on_card:
            torch.cuda.synchronize()
        into.append(time.perf_counter() - t0)
        return out

    def counted_drain(now):
        before = olaf_step_cuda.launches
        n = drain(now)
        rec["per_drain"].append(olaf_step_cuda.launches - before)
        return n

    def counted_restart(now):
        timed(restart, rec["restore_s"], now)
        rec["restored_at"].append(len(rec["per_drain"]))

    tr._drain_ps_queue = counted_drain
    tr._save_ps_checkpoint = lambda now: timed(save, rec["save_s"], now)
    tr.sim_cfg.on_ps_restart = counted_restart
    return tr, tr.run(), rec


def compare_snapshots(card_dir, host_dir) -> float:
    """Every snapshot of the card's run against the CPU run's: the same
    steps and keys, integers and bools exact, floats within
    ``RECOVERY_RTOL``/``RECOVERY_ATOL``, the manifests' ``extra`` equal.
    Returns the largest float difference."""
    names = sorted(pathlib.Path(card_dir).iterdir())
    require([n.name for n in names]
            == sorted(n.name for n in pathlib.Path(host_dir).iterdir()),
            "recovery: the card and the CPU wrote other snapshot files")
    err = 0.0
    for path in names:
        other = pathlib.Path(host_dir) / path.name
        if path.suffix == ".json":
            require(json.loads(path.read_text())["extra"]
                    == json.loads(other.read_text())["extra"],
                    f"recovery: {path.name} extra differs")
        elif path.suffix == ".npz":
            with np.load(path) as a, np.load(other) as b:
                require(sorted(a.files) == sorted(b.files),
                        f"recovery: {path.name} keys differ")
                for k in a.files:
                    x, y = a[k], b[k]
                    require(x.dtype == y.dtype and x.shape == y.shape,
                            f"recovery: {path.name} {k} dtype or shape")
                    if x.dtype.kind == "f":
                        require(np.allclose(x, y, rtol=RECOVERY_RTOL,
                                            atol=RECOVERY_ATOL),
                                f"recovery: {path.name} {k} differs")
                        fin = np.isfinite(x)  # the -inf reward sentinels
                        err = max(err, float(np.abs(x[fin] - y[fin])
                                             .max(initial=0)))
                    else:
                        require(np.array_equal(x, y),
                                f"recovery: {path.name} {k} differs")
    return err


def recovery_phase(dev) -> dict:
    """``[recovery]``: the trainer with a PS bounce and snapshots every 3
    deliveries, on the card (counted from 0) and on the CPU, each writing
    its own temporary directory."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as card_dir, \
            tempfile.TemporaryDirectory() as host_dir:
        reset_counts()
        tr, res, rec = recovery_run(dev, card_dir)
        torch.cuda.synchronize()
        counts = read_counts()
        htr, hres, _ = recovery_run("cpu", host_dir)
        sr, hsr = res.sim_result, hres.sim_result
        after = len(rec["per_drain"]) - rec["restored_at"][0] \
            if rec["restored_at"] else 0
        log(f"[recovery] lander D={tr._dim} churn + PS bounce, snapshot "
            f"every 3 deliveries: delivered={sr.received_at_ps} "
            f"applied={res.ps.applied} rejected={res.ps.rejected} "
            f"ps_restarts={tr.ps_restarts} recovered_from={tr.recovered_from} "
            f"drains={len(rec['per_drain'])} ({after} after the restore) "
            f"olaf_step launches per drain {sorted(set(rec['per_drain']))}; "
            f"launch counts {counts}")
        require(tr._dim == 941, "the lander actor-critic is 941 floats")
        require(rec["per_drain"] and all(n == 1 for n in rec["per_drain"]),
                "recovery: a drain was not exactly one olaf_step launch")
        require(counts["olaf_step"] == len(rec["per_drain"]),
                "recovery: olaf_step launched outside the drains")
        require(after > 0, "recovery: no drain after the restore")
        require(tr.recovered_from and tr.recovered_from == htr.recovered_from,
                f"recovery: recovered_from {tr.recovered_from} vs the CPU's "
                f"{htr.recovered_from}")
        require(sr.ps_restarts == tr.ps_restarts == 1, "recovery: one bounce")
        for f in dataclasses.fields(sr):
            if f.name != "delivered_updates":
                require(getattr(sr, f.name) == getattr(hsr, f.name),
                        f"recovery: {f.name} differs between card and CPU")
        require((res.ps.applied, res.ps.rejected)
                == (hres.ps.applied, hres.ps.rejected),
                "recovery: PS counts differ")
        require(np.allclose(res.ps.w, hres.ps.w, rtol=1e-6, atol=0),
                "recovery: PS weights differ")
        require(all(v.device.type == tr.device.type
                    for v in tr._ps_queue.fields().values()),
                "recovery: the restored queue left the card")
        snap_err = compare_snapshots(card_dir, host_dir)
        n_snap = len(list(pathlib.Path(card_dir).glob("*.npz")))
    save_ms = 1e3 * sum(rec["save_s"]) / max(len(rec["save_s"]), 1)
    restore_ms = 1e3 * sum(rec["restore_s"]) / max(len(rec["restore_s"]), 1)
    log(f"[recovery] card equals CPU: counters, recovered_from, PS counts; "
        f"max |dw| {float(np.abs(res.ps.w - hres.ps.w).max()):.3g} "
        f"(rtol 1e-6); {n_snap} snapshots equal (ints exact, floats max "
        f"|err| {snap_err:.3g}, rtol {RECOVERY_RTOL} atol {RECOVERY_ATOL}); "
        f"{save_ms:.3f} ms per snapshot ({len(rec['save_s'])}), "
        f"{restore_ms:.3f} ms per restore ({len(rec['restore_s'])}); "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts, save_ms=save_ms, restore_ms=restore_ms,
                n_snapshots=n_snap, drains=len(rec["per_drain"]),
                drains_after_restore=after)


# ---------------------------------------------------------------------------
# [compress]: optim/compress.py on the card
# ---------------------------------------------------------------------------
COMPRESS_CHECK_D = 2**20 + 3
COMPRESS_D = TRAIN_D  # smollm-360m's flat update


def compress_cases(gen, dev, D):
    """(name, g, k): ties at the k-th magnitude with signed zeros, and the
    same with NaN and ±inf sprinkled in."""
    mags = torch.tensor([0.0, 0.25, 0.5, 4.0], device=dev)
    pick = torch.randint(0, 4, (D,), generator=gen, device=dev)
    sign = torch.randint(0, 2, (D,), generator=gen, device=dev) * 2.0 - 1.0
    ties = mags[pick] * sign  # magnitude 0 carries -0.0 and 0.0
    n4 = int((pick == 3).sum())
    wild = ties.clone()
    where = torch.randint(0, D, (3, 64), generator=gen, device=dev)
    wild[where[0]] = math.nan
    wild[where[1]] = math.inf
    wild[where[2]] = -math.inf
    return [("ties", ties, n4 + 1000), ("ties k=1", ties, 1),
            ("nonfinite", wild, n4 + 1000), ("k=D", ties[:4099], 4099)]


def compress_phase(dev, smi) -> dict:
    """``[compress]``: ``topk_compress`` on the card against the CPU on the
    tie and non-finite cases (indices and value bits exact); then, at
    smollm-360m's flat size, ``topk_compress`` (k = D/1000) and
    ``int8_quantize`` timed with CUDA events, beside ``torch.topk`` alone
    (which finds the same set up to ties, in no fixed order)."""
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(19)
    for name, g, k in compress_cases(gen, dev, COMPRESS_CHECK_D):
        i_card, v_card = compress.topk_compress(g, k)
        i_host, v_host = compress.topk_compress(g.cpu(), k)
        require(torch.equal(i_card.cpu(), i_host),
                f"compress {name}: indices differ between card and CPU")
        require(torch.equal(v_card.cpu().view(torch.int32),
                            v_host.view(torch.int32)),
                f"compress {name}: value bits differ between card and CPU")
        q_card, s_card = compress.int8_quantize(g)
        q_host, s_host = compress.int8_quantize(g.cpu())
        require(torch.equal(q_card.cpu(), q_host)
                and s_card.item() == s_host.item(),
                f"compress {name}: int8_quantize differs")
        log(f"[compress] {name} D={g.numel()} k={k}: card equals CPU "
            f"(indices, value bits, int8 codes and scale)")
    D, k = COMPRESS_D, COMPRESS_D // 1000
    g = torch.randn(D, generator=gen, device=dev)
    idx, vals = compress.topk_compress(g, k)
    kth = vals.abs().min()
    require(idx.numel() == k and bool((vals.abs()[:-1] >= vals.abs()[1:]).all())
            and int((g.abs() > kth).sum()) < k
            and torch.equal(g[idx.long()], vals),
            "compress: the full-size top-k is not the k largest, in order")
    q, scale = compress.int8_quantize(g)
    require(bool(((compress.int8_dequantize(q, scale) - g).abs()
                  <= scale * 0.51).all()), "compress: int8 error bound")
    del idx, vals, q
    t_topk = time_ms(lambda x: compress.topk_compress(x, k), lambda: g, 3)
    t_lib = time_ms(lambda x: torch.topk(x.abs(), k, sorted=False),
                    lambda: g, 3)
    t_q = time_ms(compress.int8_quantize, lambda: g, 3)
    log(f"[compress] D={D} k={k} float32 on {smi}: topk_compress "
        f"{t_topk:.3f} ms, torch.topk of |g| alone {t_lib:.3f} ms, "
        f"int8_quantize {t_q:.3f} ms (CUDA events, 3 reps); phase wall "
        f"{time.perf_counter() - t_phase:.1f} s")
    del g
    torch.cuda.empty_cache()
    return dict(topk_ms=t_topk, torch_topk_ms=t_lib, int8_ms=t_q, D=D, k=k)


# ---------------------------------------------------------------------------
# [examples]: the port's example drivers on the card
# ---------------------------------------------------------------------------
def examples_phase(dev) -> dict:
    """``[examples]``: the quickstart (its kernel demo one ``olaf_combine``
    launch, held to the plain version; then the kernel at the demo's shape
    on seeded operands), ``lm_train --olaf --steps 4`` (one ``olaf_step``
    launch per PS step, each held to the plain version on the same queue
    and burst; then the whole run against the CPU's) and ``serve_decode``
    for smollm-360m, each on the card with the counts set to 0 just before
    it."""
    t_phase = time.perf_counter()
    counts = {}
    reset_counts()
    quick = example_quickstart.main([])
    torch.cuda.synchronize()
    counts["examples quickstart"] = read_counts()
    require(counts["examples quickstart"]["olaf_combine"] == 1,
            "quickstart: not one olaf_combine launch")
    require(quick["equal"] and quick["counts_equal"],
            "quickstart: the kernel differs from its plain version")
    # the demo's all-ones updates make every slot 1.0: seeded operands at
    # its shape (4 slots of 256, 8 updates) tell the kernel's weighting apart
    gen = torch.Generator(device=dev).manual_seed(19)
    seeded_err = check_combine("quickstart shape, seeded",
                               make_window(gen, dev, 1, 4, 8, 256))
    log(f"[examples] quickstart: olaf_combine kernel == plain (demo max "
        f"|err| {quick['max_abs_err']:.3g}, counts {quick['counts']}; seeded "
        f"at its shape {seeded_err:.3g}); launch counts "
        f"{counts['examples quickstart']}")
    reset_counts()
    with StepCheck("lm_train") as step_check:
        lm = example_lm_train.main(["--olaf", "--steps", "4"])
        torch.cuda.synchronize()
    counts["examples lm_train"] = read_counts()
    losses = [l for _, l, _ in lm.log_rows]
    require(len(losses) == 4 and all(map(math.isfinite, losses)),
            f"lm_train: losses {losses}")
    require(counts["examples lm_train"]["olaf_step"] == 4
            == step_check.calls,
            "lm_train: not one olaf_step launch per PS step")
    host = example_lm_train.main(["--olaf", "--steps", "4", "--device",
                                  "cpu"])
    for f in ("deferred_total", "stale_total", "screened_total"):
        require(getattr(lm, f) == getattr(host, f),
                f"lm_train: {f} differs between card and CPU")
    require([c for *_, c in lm.log_rows] == [c for *_, c in host.log_rows],
            "lm_train: combined counts differ between card and CPU")
    l_host = [l for _, l, _ in host.log_rows]
    require(np.allclose(losses, l_host, rtol=TRAIN_TOL, atol=0),
            f"lm_train: losses {losses} vs the CPU's {l_host}")
    log(f"[examples] lm_train --olaf --steps 4 (D={lm.dim}): losses "
        f"{losses}; each olaf_step launch == plain on its own queue and "
        f"burst (max |err| {step_check.err:.3g}); card equals CPU: combined "
        f"{[c for *_, c in lm.log_rows]}, losses max rel diff "
        f"{float(np.max(np.abs(np.subtract(losses, l_host)) / np.abs(l_host))):.3g}"
        f" (rtol {TRAIN_TOL}); launch counts {counts['examples lm_train']}")
    del lm, host
    reset_counts()
    served = example_serve_decode.main(["--arch", "smollm-360m"])
    torch.cuda.synchronize()
    counts["examples serve_decode"] = read_counts()
    tokens = served["smollm-360m"].tokens
    require(tokens.shape == (2, 13) and (tokens >= 0).all(),
            "serve_decode: tokens")
    log(f"[examples] serve_decode smollm-360m reduced: tokens "
        f"{tokens.shape}; launch counts {counts['examples serve_decode']}; "
        f"phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(counts=counts,
                combine_err=max(quick["max_abs_err"], seeded_err),
                step_err=step_check.err)


def demangle(names):
    """mangled -> readable kernel name (``void flash_wgmma<128>``), as the
    toolkit's ``cu++filt -p`` prints it; the mangled names where that
    tool is missing or fails."""
    names = sorted(set(names))
    filt = pathlib.Path(_build._nvcc()).with_name("cu++filt")
    if names and filt.exists():
        res = subprocess.run([str(filt), "-p", *names], capture_output=True,
                             text=True, timeout=60)
        lines = res.stdout.splitlines()
        if res.returncode == 0 and len(lines) == len(names):
            return dict(zip(names, lines))
    return {n: n for n in names}


def ptxas_kernels(text: str):
    """(mangled kernel name, "N registers, S B smem, spill stores/loads")
    per kernel of one source's ``nvcc -Xptxas -v`` output."""
    out, label, spill = [], None, ""
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            label, spill = m.group(1), ""
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            spill = f"spill stores {m.group(1)} B, spill loads {m.group(2)} B"
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and label:
            smem = re.search(r"(\d+) bytes smem", m.group(2))
            out.append((label, f"{m.group(1)} registers, static smem "
                        f"{smem.group(1) if smem else 0} B, {spill}"))
            label = None
    return out


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
    ptxas = {name: ptxas_kernels(text) for name, text in logs.items()}
    labels = demangle(m for rows in ptxas.values() for m, _ in rows)
    for name, rows in ptxas.items():
        for mangled, info in rows:
            log(f"[build] {name} {labels[mangled]}: {info}")

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

    # olaf_combine: (a) the hybrid's shape, (b) a fat-tree k=4 shape with
    # out-of-range cluster ids, (c) every gate zero
    comb = {}
    for U in (4, 8, 16):
        comb[f"a U={U}"] = make_window(gen, dev, 3, 4, U, 941)
    comb["b"] = make_window(gen, dev, 21, 8, 64, 2**18 + 3, cluster_lo=-1,
                            cluster_hi=9)
    comb["c"] = make_window(gen, dev, 3, 4, 8, 941, gate_hi=0)
    comb_err = max(check_combine(name, args) for name, args in comb.items())
    # olaf_enqueue: the PS staging shape, and a stress shape with screen,
    # capacity and a finite threshold
    enq_err_a, pre_ea, b_ea = check_enqueue("a", dev, gen, 8, 16, 941, 6,
                                            capacity=8)
    enq_err_b, pre_eb, b_eb = check_enqueue("b", dev, gen, 64, 96,
                                            2**20 + 3, 2, capacity=48,
                                            thr=0.5, screen_p=0.1)
    enq_err = max(enq_err_a, enq_err_b)
    # ops.olaf_forward, the fused boundary: the scenario's shape (S=21 Q=8
    # U=4 D=941 K=1) from the hybrid's host arrays and from arrays on the
    # card, a drained slot the same window resets, hop -2 and a duplicate
    # departure, and a drain-only boundary (U = 0)
    fwd_host = forward_operands(gen, dev, 21, 8, 4, 941, [5], [3], [-1])
    fwd_card = on_card(fwd_host, dev)
    fwd_cases = dict(
        scenario=fwd_host, scenario_on_card=fwd_card,
        reset_drained=forward_operands(gen, dev, 3, 4, 8, 941, [1, 2, 1],
                                       [2, 0, 2], [0, -2, 1], reset=(1, 2)),
        drain_only=forward_operands(gen, dev, 21, 8, 0, 941, [4, 20],
                                    [7, 0], [-1, 3]))
    fwd_err = max(check_forward(name, a) for name, a in fwd_cases.items())
    # flash_attention and decode_attention at every listed shape, bf16 and f32
    attn_checked = check_attention(dev, gen)
    # the backward kernels at the train shape and the Dh 128 shapes
    flash_bwd = flash_backward_phase(dev, gen)
    # device kernels per wrapper call, as the profiler traces them (the
    # wrapper's count adds one per call by construction and cannot show it),
    # before any large trace of the paths, after which the tracer loses
    # records
    def forward(a):
        return ops.olaf_forward(*a[:8], drain_hop=a[8])

    ea_args = enqueue_args(b_ea)

    per_call = {  # the trainer's drain: send, screen and capacity left out
        "olaf_step": launches_per_call(
            lambda st: olaf_step_cuda(st, *b_a2.args()[:6]), pre_a2.clone,
            ("olaf_",)),
        "olaf_combine": launches_per_call(
            lambda a: olaf_combine_cuda(*a), lambda: comb["a U=4"],
            ("olaf_combine",)),
        "olaf_enqueue": launches_per_call(  # args read back before the trace
            lambda st: olaf_enqueue_cuda(st, *ea_args), pre_ea.clone,
            ("olaf_",)),
        "olaf_forward": launches_per_call(forward, lambda: fwd_card,
                                          ("olaf_",)),
        "olaf_forward host arrays": launches_per_call(
            forward, lambda: fwd_host, ("olaf_",))}
    for dtype in ATTN_DTYPES:
        fx = attn_checked[("flash", "a", dtype)][1]
        dx = attn_checked[("decode", "a", dtype)][1]
        per_call[("flash_attention", dtype)] = launches_per_call(
            lambda x: flash_attention_cuda(*x, **flash_kw(FLASH_SHAPES["a"])),
            lambda: fx, ("flash_wgmma", "flash_kernel"))
        per_call[("decode_attention", dtype)] = launches_per_call(
            lambda x: decode_attention_cuda(*x), lambda: dx, ("decode_kernel",))
    for key, (mine, other) in per_call.items():
        name = key if isinstance(key, str) else f"{key[0]} {str(key[1])[6:]}"
        log(f"[launches] {name}: {mine:g} kernel launch(es) and {other:g} "
            f"other device operation(s) per call (profiler, 5 calls)")
        require(mine == 1, f"{name}: {mine:g} kernel launches per call, "
                f"not one")
        if isinstance(key, str):  # the OLAF wrappers: nothing else on the card
            most = 1 if key == "olaf_forward host arrays" else 0
            require(other <= most, f"{name}: {other:g} other device "
                    f"operations per call, more than {most} (the host "
                    f"arrays' one copy)")

    # ---- 4. the main path: the trainer at the paper's model width ---------
    cfg = trainer_cfg()
    reset_counts()
    t0 = time.perf_counter()
    trainer = AsyncDRLTrainer(cfg, device=dev)
    ppo_clock = Stopwatch(trainer.sim_cfg.payload_fn)
    trainer.sim_cfg.payload_fn = ppo_clock
    drain_clock = trainer._drain_ps_queue = Stopwatch(trainer._drain_ps_queue)
    res = trainer.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    trainer_counts = read_counts()
    launches = trainer_counts["olaf_step"]
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
        f"olaf_step calls={launches} (each one CUDA launch); launch counts "
        f"{trainer_counts}")
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
    # a shorter run under the profiler, for the card's busy time: the same
    # configuration at TRAINER_PROFILED_UPDATES updates a worker (the
    # profiler slows the host about threefold); the idle share is that
    # run's own
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        AsyncDRLTrainer(dataclasses.replace(
            cfg, n_updates_per_worker=TRAINER_PROFILED_UPDATES),
            device=dev).run()
        torch.cuda.synchronize()
    wall_prof = time.perf_counter() - t0
    kernels = device_kernels(prof)
    busy = sum(us for _, us in kernels.values()) / 1e6
    if busy:
        log(f"[trainer] profiled run at {TRAINER_PROFILED_UPDATES} update(s) "
            f"a worker: device busy {busy:.4f} s in "
            f"{sum(n for n, _ in kernels.values())} device events over "
            f"{wall_prof:.3f} s wall: idle share "
            f"{100 * (1 - busy / wall_prof):.2f}%")
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

    # ---- 4b. the hybrid path: run_hybrid_ppo at the paper's model width ---
    clock_targets = dict(
        ppo_iter=(ppo, "worker_iteration"), ppo_local=(ppo, "local_update"),
        netsim=(netsim.NetworkSimulator, "run"),
        replay_window=(hybrid.HybridMultiSwitchDataPlane, "feed_window"),
        classify=(hybrid.HybridMultiSwitchDataPlane, "_classify_run"),
        flush=(hybrid.HybridMultiSwitchDataPlane, "flush"),
        result=(hybrid.HybridMultiSwitchDataPlane, "result"),
        ps_apply=(ParameterServer, "on_updates"))
    reset_counts()
    t0 = time.perf_counter()
    with Clocks(**clock_targets) as clk:
        hyb, ps, hcfg = hybrid_ppo_run(dev)
        torch.cuda.synchronize()
    wall_h = time.perf_counter() - t0
    hybrid_counts = read_counts()
    sec = clk.seconds
    n_ppo = clk.calls["ppo_iter"]
    aggs = {n: q["aggregations"] for n, q in hyb.queue_stats.items()}
    log(f"[hybrid] run_hybrid_ppo lander D={hyb.delivered[0][2].numel() if hyb.delivered else 0} "
        f"SW1/SW2->SW3 clusters 2x2 per group, slots 4: "
        f"generated={n_ppo} delivered={len(hyb.delivered)} "
        f"applied={ps.applied} rejected={ps.rejected} "
        f"aggregations={aggs} agg_counts={[u.agg_count for _, u, _ in hyb.delivered]} "
        f"combine launches={hyb.launches} departures={hyb.forward_launches} "
        f"combined_updates={hyb.combined_updates} h2d={hyb.h2d_transfers} "
        f"forwarded={hyb.forwarded} wall={wall_h:.3f}s "
        f"launch counts {hybrid_counts}")
    require(len(hcfg.workers) == 8, "the hybrid config has 8 workers")
    require(hyb.delivered and hyb.delivered[0][2].numel() == 941,
            "the hybrid delivered no 941-float row")
    require(hybrid_counts["olaf_combine"] > 0,
            "the hybrid path never launched olaf_combine")
    require(hybrid_counts["olaf_combine"] == hyb.launches,
            "one combine kernel launch per window landing")
    require(ps.applied > 0, "the hybrid PS applied no update")
    require(ps.applied + ps.rejected == len(hyb.delivered),
            "a delivery bypassed the PS")
    require(np.isfinite(ps.w).all(), "non-finite hybrid PS weights")
    require(any(u.agg_count > 1 for _, u, _ in hyb.delivered),
            "no combined packet reached the PS")
    require(all(v > 0 for v in aggs.values()),
            "a switch aggregated nothing")
    require(all(p.device.type == "cuda" and bool(torch.isfinite(p).all())
                for _, _, p in hyb.delivered), "a delivered row is off the card "
            "or non-finite")
    ppo_s = sec["ppo_iter"] + sec["ppo_local"]
    replay_s = sec["replay_window"] + sec["result"]
    kernel_s = sec["flush"]  # staging, window puts and kernel dispatches
    log(f"[hybrid] breakdown of {wall_h:.4f} s: PPO iterations {ppo_s:.4f} s "
        f"({100 * ppo_s / wall_h:.2f}%, {n_ppo} calls); netsim trace "
        f"{sec['netsim'] - ppo_s:.4f} s "
        f"({100 * (sec['netsim'] - ppo_s) / wall_h:.2f}%); replay "
        f"{replay_s:.4f} s ({100 * replay_s / wall_h:.2f}%: classify "
        f"{sec['classify']:.4f} s, staging + kernels {kernel_s:.4f} s in "
        f"{clk.calls['flush']} flushes, final flush + read-back "
        f"{sec['result']:.4f} s); PS apply {sec['ps_apply']:.4f} s "
        f"({100 * sec['ps_apply'] / wall_h:.2f}%); rest (set-up, row "
        f"read-back) {wall_h - sec['netsim'] - replay_s - sec['ps_apply']:.4f} s")
    # the same configuration over HYBRID_PROFILED_HORIZON under the
    # profiler; the idle share is that run's own
    t0 = time.perf_counter()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_hybrid_ppo(env="lander", device=dev, seed=0, **dict(
            HYBRID_KW, horizon=HYBRID_PROFILED_HORIZON))
        torch.cuda.synchronize()
    wall_hp = time.perf_counter() - t0
    kernels_h = device_kernels(prof)
    busy_h = sum(us for _, us in kernels_h.values()) / 1e6
    comb_us = sum(us for n, (_, us) in kernels_h.items() if "olaf_combine" in n)
    if busy_h:
        log(f"[hybrid] profiled run over a {HYBRID_PROFILED_HORIZON} s "
            f"horizon: device busy {busy_h:.4f} s in "
            f"{sum(n for n, _ in kernels_h.values())} device events over "
            f"{wall_hp:.3f} s wall: idle share "
            f"{100 * (1 - busy_h / wall_hp):.2f}%; "
            f"olaf_combine_kernel {comb_us / 1e3:.4f} ms in "
            f"{sum(c for n, (c, _) in kernels_h.items() if 'olaf_combine' in n)} "
            f"launches")
    else:
        log("[hybrid] device busy: not measured (the profiler recorded no "
            "device events)")

    # seeded rows on the same configuration: both card backends bitwise
    # equal, the card within tolerance of the CPU's plain path
    reset_counts()
    rows_w = hybrid_rows_run(dev, "window")
    rows_e = hybrid_rows_run(dev, "event")
    rows_c = hybrid_rows_run("cpu", "window")
    torch.cuda.synchronize()
    require(len(rows_w.delivered) == len(rows_e.delivered)
            == len(rows_c.delivered) > 0, "injected rows: delivery counts")
    rows_err = 0.0
    for (t0_, u0, p0), (t1, u1, p1), (t2, u2, p2) in zip(
            rows_w.delivered, rows_e.delivered, rows_c.delivered):
        require(t0_ == t1 == t2 and u0.agg_count == u1.agg_count
                == u2.agg_count, "injected rows: delivery metadata")
        require(torch.equal(p0, p1), "injected rows: card backends differ")
        require(torch.allclose(p0.cpu(), p2, rtol=RTOL, atol=ATOL),
                "injected rows: card differs from the CPU")
        rows_err = max(rows_err, float((p0.cpu() - p2).abs().max()))
    for f in HYBRID_COUNTERS:
        require(getattr(rows_w, f) == getattr(rows_c, f),
                f"injected rows: {f} differs between card and CPU")
        if f != "h2d_transfers":
            require(getattr(rows_w, f) == getattr(rows_e, f),
                    f"injected rows: {f} differs between the backends")
    require(np.array_equal(rows_w.final_counts, rows_c.final_counts),
            "injected rows: final counts")
    log(f"[hybrid] injected rows: card event == card window bitwise "
        f"({len(rows_w.delivered)} deliveries, {rows_w.launches} launches), "
        f"card vs CPU max |err| {rows_err:.3g}, counters equal")

    # ---- 4c. the scenario command: fat-tree k=4 at D = 941 ----------------
    reset_counts()
    t0 = time.perf_counter()
    with ForwardCapture() as scen_fwd:
        scen = launch_train.main(["--mode", "scenario", "--topology",
                                  "fattree", "--fattree-k", "4", "--sim-dim",
                                  "941", "--sim-impl", "window"])
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    scenario_counts = read_counts()
    require(scenario_counts["olaf_combine"] == scen.launches > 0,
            "the scenario never launched olaf_combine")
    require(len(scen.switch_launches) == 21,
            f"fat-tree k=4 has 21 switches, the run {len(scen.switch_launches)}")
    require(all(bool(torch.isfinite(p).all()) and p.device.type == "cuda"
                for _, _, p in scen.delivered), "scenario rows")
    log(f"[scenario] fat-tree k=4: {len(scen.switch_launches)} switches, "
        f"wall {wall_s:.3f} s, launch counts {scenario_counts}, "
        f"ops.olaf_forward calls by window width {scen_fwd.calls}")
    require(sum(scen_fwd.calls.values()) > 0,
            "the scenario never called ops.olaf_forward")
    fwd_err = max(fwd_err, check_forward("scenario's own", scen_fwd.args))

    # ---- 4c'. the vectorized simulator: k=4 exact, k=8 scale ---------------
    vecsim_counts = vecsim_phase(dev, scen)

    # ---- 4c''. the sharded simulator and distributed/sharding.py ----------
    sharded = sharded_phase(dev, pre_b, b_b)
    max_err = max(max_err, sharded["step_err"])

    # ---- 4d. the enqueue entry point: a stream of bursts at D = 941 -------
    reset_counts()
    st_card = queue_init(8, 941, device=dev)
    st_host = queue_init(8, 941, device="cpu")
    for i in range(6):
        b = enqueue_burst_of(gen, dev, 8, 16, 941, 20.0 + i, capacity=6,
                             thr=1.0, screen_p=0.1)
        args = enqueue_args(b)
        st_card = ops.olaf_enqueue(st_card, *args)
        st_host = olaf_enqueue_plain(
            st_host, *(a.cpu() if isinstance(a, torch.Tensor) else a
                       for a in args))
    torch.cuda.synchronize()
    enqueue_counts = read_counts()
    for f in META:
        require(torch.equal(getattr(st_card, f).cpu(), getattr(st_host, f)),
                f"enqueue path: {f} differs between card and CPU")
    require(torch.allclose(st_card.payload.cpu(), st_host.payload, rtol=RTOL,
                           atol=ATOL), "enqueue path: payload")
    require(enqueue_counts["olaf_enqueue"] == 6,
            "ops.olaf_enqueue did not launch its kernel once per burst")
    log(f"[enqueue] ops.olaf_enqueue x6 bursts Q=8 U=16 D=941: card equals "
        f"CPU (n_agg={int(st_card.n_agg)} n_repl={int(st_card.n_repl)} "
        f"n_dropped={int(st_card.n_dropped)} "
        f"n_screened={int(st_card.n_screened)}), launch counts "
        f"{enqueue_counts}")

    # ---- 4e. LM serving: smollm-360m at full width and depth ---------------
    serve_counts = serve_phase(dev)

    # ---- 4f. LM training with the OLAF-async PS step, full width ------------
    train = train_phase(dev)
    max_err = max(max_err, train["max_abs_err"])

    # ---- 4f'. the elastic re-mesh checkpoint of [train]'s sync state -------
    ckpt = ckpt_phase(dev, smi, train.pop("sync"))

    # ---- 4f'''. the PS step's robust combine at the engine cell's shape --
    robust = robust_phase(dev)
    max_err = max(max_err, robust["max_abs_err"])

    # ---- 4f''. activation checkpointing; the dry run -----------------------
    remat = remat_phase(dev)
    dry = dryrun_phase(dev, smi)

    # ---- 4g. the other families: moe, ssm, hybrid, vlm, encdec -----------
    families = families_phase(dev, smi)

    # ---- 4h. checkpointed PS recovery, compression, the example drivers --
    recovery = recovery_phase(dev)
    compress_phase(dev, smi)
    examples = examples_phase(dev)
    max_err = max(max_err, examples["step_err"])

    # ---- 5. timing ---------------------------------------------------------
    # the timer's floor: one kernel that adds 1 to one element, timed as
    # every kernel below is (the small OLAF shapes sit a few µs above it)
    one = torch.zeros(1, device=dev)
    floor_ms = time_ms(lambda _: one.add_(1), lambda: None, 50)
    log(f"[time] timer floor: one-element add_ {floor_ms:.5f} ms")
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
    t_ca = {U: time_combine(comb[f"a U={U}"], reps=50) for U in (4, 16)}
    t_cb = time_combine(comb["b"], reps=10)
    t_ea = time_enqueue(pre_ea, b_ea, reps=50)
    t_eb = time_enqueue(pre_eb, b_eb, reps=5)
    for name, t in (("olaf_combine a S=3 Q=4 U=4 D=941", t_ca[4]),
                    ("olaf_combine a S=3 Q=4 U=16 D=941", t_ca[16]),
                    ("olaf_combine b S=21 Q=8 U=64 D=2^18+3", t_cb),
                    ("olaf_enqueue a Q=8 U=16 D=941", t_ea),
                    ("olaf_enqueue b Q=64 U=96 D=2^20+3", t_eb)):
        log(f"[time] {name}: kernel {t['ms']:.4f} ms "
            f"(runs {t['ms_runs'][0]:.4f}, {t['ms_runs'][1]:.4f}) "
            f"plain {t['plain_ms']:.4f} ms bound {t['bound_ms']:.6f} ms "
            f"({t['bound_by']}, {t['bytes']} B; the kernel moves "
            f"{t['kernel_bytes']} B)")
    t_fwd = time_forward(scen_fwd.args, reps=50)
    fwd_shape = ("S={} Q={} U={} D={} K={}".format(
        *scen_fwd.args[0].shape[:2], scen_fwd.args[2].shape[1],
        scen_fwd.args[0].shape[2], len(scen_fwd.args[6])))
    log(f"[time] olaf_forward {fwd_shape} (the scenario's): fused "
        f"{t_fwd['ms']:.4f} ms, the old composition {t_fwd['composed_ms']:.4f} "
        f"ms (arrays on the card; runs {t_fwd['runs']['card']}); from the "
        f"hybrid's host arrays fused {t_fwd['host_ms']:.4f} ms, composition "
        f"{t_fwd['host_composed_ms']:.4f} ms (runs {t_fwd['runs']['host']}); "
        f"plain {t_fwd['plain_ms']:.4f} ms bound {t_fwd['bound_ms']:.6f} ms "
        f"({t_fwd['bound_by']}, {t_fwd['bytes']} B; the kernel moves "
        f"{t_fwd['kernel_bytes']} B)")
    attn_times = time_attention(attn_checked, reps=10)
    log(f"[time] total smoke wall {time.perf_counter() - t_start:.1f} s")
    paths = dict(trainer=trainer_counts, hybrid_ppo=hybrid_counts,
                 scenario=scenario_counts, vecsim=vecsim_counts,
                 enqueue=enqueue_counts,
                 serve=serve_counts, train=train["counts"],
                 **{f"serve {a}" if not a.startswith("train") else a: c
                    for a, c in families["counts"].items()},
                 recovery=recovery["counts"], **examples["counts"],
                 **sharded["counts"],
                 **{f"remat {p}": c for p, c in remat["counts"].items()},
                 **{"dryrun sync": dry["counts"],
                    "ckpt sync": ckpt["counts"]})

    def by_path(name):
        return {p: c[name] for p, c in paths.items()}

    no_library = ("none: no single PyTorch call computes the function "
                  "(a weighted segment mean with skip rules / Algorithm 1's "
                  "sequential resolve)")

    entry = dict(
        name="olaf_step", route="cuda",
        source="src/repro_torch/kernels/csrc/olaf_step.cu",
        replaces="src/repro/kernels/olaf_step.py:215",
        launches=train["counts"]["olaf_step"], max_abs_err=max_err,
        ms=t_a["ms"],
        plain_ms=t_a["plain_ms"], bound_ms=t_a["bound_ms"],
        bound_by=t_a["bound_by"], library_ms=None,
        bytes=t_a["bytes"], kernel_bytes=t_a["kernel_bytes"],
        cuda_launches_per_call=per_call["olaf_step"][0],
        shape="S=1 Q=2 U=2 k=2 D=941 (trainer)",
        stress=dict(shape="S=3 Q=64 U=96 k=16 D=1048579", ms=t_b["ms"],
                    plain_ms=t_b["plain_ms"], bound_ms=t_b["bound_ms"],
                    bytes=t_b["bytes"], kernel_bytes=t_b["kernel_bytes"]),
        trainer_q8=dict(shape="S=1 Q=8 U=8 k=2 D=941", ms=t_a8["ms"],
                        plain_ms=t_a8["plain_ms"], bound_ms=t_a8["bound_ms"],
                        bytes=t_a8["bytes"],
                        kernel_bytes=t_a8["kernel_bytes"]),
        train=dict(shape=f"{train['shape']} (launch.train olaf-async, the "
                         f"main path: one launch per PS step)",
                   **{k: train[k] for k in (
                       "ms", "plain_ms", "bound_ms", "bytes", "kernel_bytes",
                       "max_abs_err", "ps_step_ms", "ps_step_bound_ms",
                       "step_s", "idle_share", "idle_share_profiled",
                       "peak_bytes")}),
        remat=dict(path="TRAIN_FULL under remat_policy none, full, dots: "
                        "one launch per PS step each",
                   **remat["runs"], grad_max_abs_diff=remat["grad_diff"]),
        recovery=dict(
            path="AsyncDRLTrainer with a PS bounce and snapshots every 3 "
                 "deliveries (lander D=941): one launch per drain",
            **{k: recovery[k] for k in ("save_ms", "restore_ms",
                                        "n_snapshots", "drains",
                                        "drains_after_restore")}),
        timer_floor_ms=floor_ms, launches_by_path=by_path("olaf_step"))
    combine_entry = dict(
        name="olaf_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/olaf_combine.cu",
        replaces="src/repro/kernels/olaf_combine.py:95",
        launches=hybrid_counts["olaf_combine"],
        max_abs_err=max(comb_err, fwd_err, examples["combine_err"],
                        sharded["combine_err"]),
        ms=t_ca[4]["ms"], plain_ms=t_ca[4]["plain_ms"],
        bound_ms=t_ca[4]["bound_ms"], bound_by=t_ca[4]["bound_by"],
        library_ms=None, library_note=no_library,
        bytes=t_ca[4]["bytes"], kernel_bytes=t_ca[4]["kernel_bytes"],
        cuda_launches_per_call=per_call["olaf_combine"][0],
        shape="S=3 Q=4 U=4 D=941 (hybrid window)",
        u16=dict(shape="S=3 Q=4 U=16 D=941", **{
            k: t_ca[16][k] for k in ("ms", "plain_ms", "bound_ms", "bytes",
                                     "kernel_bytes")}),
        fattree=dict(shape="S=21 Q=8 U=64 D=262147", **{
            k: t_cb[k] for k in ("ms", "plain_ms", "bound_ms", "bytes",
                                 "kernel_bytes")}),
        forward=dict(
            entry="ops.olaf_forward, the whole boundary in the same kernel",
            shape=f"{fwd_shape} (the scenario's)", max_abs_err=fwd_err,
            calls_in_scenario=sum(scen_fwd.calls.values()),
            cuda_launches_per_call=per_call["olaf_forward"][0],
            other_device_ops_per_call=per_call["olaf_forward"][1],
            host_arrays_other_device_ops_per_call=per_call[
                "olaf_forward host arrays"][1],
            **{k: t_fwd[k] for k in ("ms", "composed_ms", "host_ms",
                                     "host_composed_ms", "plain_ms",
                                     "bound_ms", "bound_by", "bytes",
                                     "kernel_bytes")}),
        drain_only_launches_by_path=by_path("olaf_combine_drain"),
        launches_by_path=by_path("olaf_combine"))
    enqueue_entry = dict(
        name="olaf_enqueue", route="cuda",
        source="src/repro_torch/kernels/csrc/olaf_step.cu",
        replaces="src/repro/kernels/olaf_combine.py:356",
        launches=enqueue_counts["olaf_enqueue"], max_abs_err=enq_err,
        ms=t_ea["ms"], plain_ms=t_ea["plain_ms"], bound_ms=t_ea["bound_ms"],
        bound_by=t_ea["bound_by"], library_ms=None, library_note=no_library,
        bytes=t_ea["bytes"], kernel_bytes=t_ea["kernel_bytes"],
        cuda_launches_per_call=per_call["olaf_enqueue"][0],
        shape="Q=8 U=16 D=941",
        stress=dict(shape="Q=64 U=96 D=1048579 capacity=48", **{
            k: t_eb[k] for k in ("ms", "plain_ms", "bound_ms", "bytes",
                                 "kernel_bytes")}),
        launches_by_path=by_path("olaf_enqueue"))

    robust_entry = dict(
        name="olaf_robust_combine", route="cuda",
        source="src/repro_torch/kernels/csrc/olaf_robust.cu",
        replaces="none (repro's ps_step leaves the weighted mean, "
                 "jax_trimmed_combine and their jnp.where to XLA)",
        launches=train["counts"]["olaf_robust_combine"],
        max_abs_err=robust["max_abs_err"], ms=robust["ms"]["mean"],
        ms_trimmed=robust["ms"]["trimmed"], plain_ms=robust["plain_ms"],
        bound_ms=robust["bound_ms"], bound_by="bytes", library_ms=None,
        library_note="none: no single PyTorch call computes the trimmed "
                     "combine", bytes=robust["bytes"],
        cuda_launches_per_call=robust["cuda_launches_per_call"],
        shape=f"{robust['shape']} (the engine cell's drained block)",
        launches_by_path=by_path("olaf_robust_combine"))

    def attn_entry(kind, source, replaces, head_shape):
        name = f"{kind}_attention"
        head = attn_times[(kind, "a", torch.bfloat16)]
        errs = {dt: max(r["max_abs_err"] for (k, _, d), r in attn_times.items()
                        if k == kind and d == dt) for dt in ATTN_DTYPES}
        return dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=serve_counts[name], max_abs_err=max(errs.values()),
            max_abs_err_f32=errs[torch.float32],
            max_abs_err_bf16=errs[torch.bfloat16], ms=head["ms"],
            plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
            bound_by=head["bound_by"], library_ms=head["library_ms"],
            library_call="torch.nn.functional.scaled_dot_product_attention",
            bytes=head["bytes"], ops=head["ops"],
            cuda_launches_per_call={str(dt)[6:]: per_call[(name, dt)][0]
                                    for dt in ATTN_DTYPES},
            shape=head_shape,
            shapes={f"{n} {r['dtype']}": {k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "bytes", "ops", "max_abs_err", "share_of_bound", "vs_library",
                "rate")}
                for (k, n, _), r in attn_times.items() if k == kind},
            launches_by_path=by_path(name))

    flash_entry = attn_entry(
        "flash", "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:83",
        "BH=120 Sq=Sk=512 Dh=64 causal bf16 (the smollm-360m prefill, B=8)")
    bwd_head = flash_bwd["train"]
    flash_bwd_entry = dict(
        name="flash_attention_backward", route="cuda",
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="none (repro's Pallas flash kernel is forward-only; repro "
                 "trains through XLA's dense attention)",
        launches=train["counts"]["flash_attention_backward"],
        max_rel_err=max(e for r in flash_bwd.values()
                        for e in r["rel_err"].values()),
        ms=bwd_head["ms"], plain_ms=bwd_head["plain_ms"],
        bound_ms=bwd_head["bound_ms"], bound_by=bwd_head["bound_by"],
        library_ms=bwd_head["library_ms"],
        library_call="the backward of torch.nn.functional."
                     "scaled_dot_product_attention",
        bytes=bwd_head["bytes"], ops=bwd_head["ops"],
        cuda_launches_per_call=bwd_head["kernels_per_call"],
        shape="B=16 S=2048 H=15 Dh=64 causal bf16 (a smollm-360m gradient)",
        forward_ms=bwd_head["forward_ms"],
        forward_lse_ms=bwd_head["forward_lse_ms"],
        shapes={n: {k: r[k] for k in (
            "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bytes",
            "ops", "rel_err", "share_of_bound", "vs_library", "forward_ms",
            "forward_lse_ms", "forward_plain_ms", "forward_library_ms")}
            for n, r in flash_bwd.items()},
        launches_by_path=by_path("flash_attention_backward"))
    decode_entry = attn_entry(
        "decode", "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:68",
        "B=8 KV=5 rep=3 S=552 Dh=64 bf16, pos 0..551 (the serve cache)")
    log("[families] " + json.dumps(families["rows"]))
    log("[dryrun] summary " + json.dumps({
        k: dry[k] for k in ("cost", "predicted_cost", "step_ms", "step_ms_min",
                            "step_ms_max", "counted_gb_s", "peak",
                            "predicted")}
        | {"cells": {c: r["cost"] for c, r in dry["cells"].items()},
           "probe_transcendentals": {
               c: r["probe_transcendentals"]
               for c, r in dry["cells"].items()}}))
    log("[ckpt] summary " + json.dumps(
        {k: ckpt[k] for k in ("bytes", "save_s", "restore_s", "dtensor")}))
    print(smi, flush=True)
    print(json.dumps({"kernels": [entry, combine_entry, enqueue_entry,
                                  robust_entry, flash_entry,
                                  flash_bwd_entry, decode_entry]}),
          flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
