"""A profiled stretch of a run, reduced to the numbers the per-layer
metrics and the result line's ``breakdown`` read.

:func:`profile` runs ``step()`` a few times under ``torch.profiler``
(host and device activity) inside a ``perfbench.window`` label and
returns a :class:`Profile`: the device operations (kernels, copies and
fills), their busy time as the union of their intervals inside the
window, the window's length, each operation's calls and time by name, and
the idle gaps between device operations, each named by the innermost
``perfbench.*`` label the host was in when the gap began.
"""
from __future__ import annotations

import dataclasses
import re
import time
from typing import Callable, Dict, List, Tuple

WINDOW = "perfbench.window"
PROGRAM = "olaf."  # ``repro_torch.tracing.PREFIX``: the port's span labels
TOP = 10
_PART = re.compile(r"[A-Za-z_]\w*(?:Functor|_kernel|_cuda|Kernel|_impl)\w*")
_GENERIC = {"elementwise_kernel", "vectorized_elementwise_kernel",
            "unrolled_elementwise_kernel", "gpu_kernel_impl",
            "gpu_kernel_impl_nocast", "reduce_kernel", "index_elementwise_kernel",
            "AUnaryFunctor", "BUnaryFunctor", "BinaryFunctor"}


def short_name(name: str) -> str:
    """A device operation's name cut to what tells it apart: a template
    kernel's outer name and the first functor or kernel named inside it
    (``elementwise_kernel<masked_fill_kernel>``); a short name as it is."""
    if len(name) <= 80:
        return name
    name = name.replace("(anonymous namespace)::", "")
    head, _, rest = name.partition("<")
    outer = head.split("(", 1)[0].replace("void ", "").rsplit("::", 1)[-1]
    inner = [m for m in _PART.findall(rest)
             if m not in _GENERIC and m != outer]
    return f"{outer}<{inner[0]}>" if inner else outer


@dataclasses.dataclass
class Profile:
    iters: int
    window_s: float  # the traced window, on the trace's clock
    wall_s: float  # the same window on the host clock
    busy_s: float  # union of the device operations' intervals
    device_events: int
    ops: Dict[str, Tuple[int, float]]  # name -> (calls, seconds)
    gaps: Dict[str, float]  # host label -> idle seconds

    def breakdown(self) -> dict:
        ops = sorted(self.ops.items(), key=lambda kv: -kv[1][1])[:TOP]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": [[n, s] for n, (_, s) in ops],
                "idle_gaps": [[n, s] for n, s in gaps]}


def merge(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(device: List[Tuple[float, float, str]],
           host: List[Tuple[float, float, str]], iters: int,
           wall_s: float) -> Profile:
    """``device`` and ``host`` as (start µs, end µs, name) on one clock;
    ``host`` holds the ``perfbench.*`` labels, the window among them."""
    win = [(a, b) for a, b, n in host if n == WINDOW]
    if not win:
        raise RuntimeError("the profiled window's label is not in the trace")
    w0, w1 = win[0]
    inside = [(max(a, w0), min(b, w1), n) for a, b, n in device
              if b > w0 and a < w1]
    busy = merge([(a, b) for a, b, _ in inside])
    ops: Dict[str, Tuple[int, float]] = {}
    for a, b, n in inside:
        c, s = ops.get(n, (0, 0.0))
        ops[n] = (c + 1, s + (b - a) / 1e6)
    labels = [(a, b, n) for a, b, n in host if n != WINDOW]
    gaps: Dict[str, float] = {}
    edges = [w0] + [x for ab in busy for x in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        within = [(a, n) for a, b, n in labels if a <= g0 < b]
        name = max(within)[1] if within else "host (outside the labelled calls)"
        gaps[name] = gaps.get(name, 0.0) + (g1 - g0) / 1e6
    return Profile(iters=iters, window_s=(w1 - w0) / 1e6, wall_s=wall_s,
                   busy_s=sum(b - a for a, b in busy) / 1e6,
                   device_events=len(inside), ops=ops, gaps=gaps)


def profile(step: Callable[[], None], iters: int) -> Profile:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, record_function

    torch.cuda.synchronize()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            for _ in range(iters):
                step()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device, host = split(prof.events(), DeviceType.CUDA)
    return reduce(device, host, iters, wall)


def split(events, cuda) -> Tuple[list, list]:
    """The profiler's ``events`` as (device operations, the harness's host
    labels), each (start µs, end µs, name); ``cuda`` is the device type of
    the device's timeline. A label is also drawn on that timeline: it is
    no device operation. The port's span labels (``olaf.*``) are neither,
    so no idle gap is named after them."""
    device, host = [], []
    for e in events:
        tr = e.time_range
        if e.name.startswith(PROGRAM):
            continue
        if e.name.startswith("perfbench."):
            if e.device_type != cuda:
                host.append((tr.start, tr.end, e.name))
        elif e.device_type == cuda:
            device.append((tr.start, tr.end, short_name(e.name)))
    return device, host
