"""Spans at the layer boundaries of the training step.

``span(name)`` marks one call of a layer: the trainer's iteration
(``trainer.step``), a worker gradient (``worker.grad``, ``.forward``,
``.backward``), a period of the layer stack (``model.period``, which fires
again in each recompute under remat), a mixer (``model.attention``,
``model.ssd``) and the phases of the PS step (``ps.step``, ``ps.gate``,
``ps.screen``, ``ps.olaf_step``, ``ps.combine``, ``ps.apply``,
``ps.feedback``).

Tracing is off by default: ``span()`` then reads one module flag and
returns a shared null context, with no profiler label, CUDA event or
allocation. After :func:`enable`, each span

  * opens ``torch.profiler.record_function("olaf.<name>")``, so a profiled
    stretch shows it on the clock of the device operations;
  * records a CUDA event pair on the current stream once the process uses
    CUDA (so a step on the CPU in such a process gets a device time that
    is not its own), none while the stream is captured into a CUDA graph;
  * stamps its host start and end with ``time.time_ns()``, the Unix clock
    of the profiler's events (``trace_start_ns()`` plus an event's
    ``time_range``, in µs);
  * keeps its id and its parent's id. Parents come from one stack for the
    whole process, not one per thread: under non-reentrant activation
    checkpointing autograd recomputes a period on its own device thread
    while the caller waits in ``torch.autograd.grad``, and the recomputed
    period still belongs to the backward that asked for it.

:func:`take` waits for the device once, turns each event pair into device
milliseconds and returns the closed spans in the order they opened,
forgetting them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from typing import List, Optional

import torch

PREFIX = "olaf."

_on = False
_ids = itertools.count(1)
_open: List[int] = []  # ids of the open spans, innermost last
_closed: List["_Span"] = []
_NULL = contextlib.nullcontext()


@dataclasses.dataclass(frozen=True)
class Record:
    """One closed span. ``device_ms`` is the time between its two CUDA
    events (first operation to last, gaps included), ``None`` where it
    recorded none."""

    name: str
    id: int
    parent: Optional[int]
    start_ns: int
    end_ns: int
    device_ms: Optional[float]


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def span(name: str):
    """A context manager around one call of the layer ``name``."""
    return _Span(name) if _on else _NULL


class _Span:
    __slots__ = ("name", "id", "parent", "label", "events", "start_ns",
                 "end_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> "_Span":
        self.id = next(_ids)
        self.parent = _open[-1] if _open else None
        _open.append(self.id)
        self.events = None
        if torch.cuda.is_initialized() and \
                not torch.cuda.is_current_stream_capturing():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
        self.start_ns = time.time_ns()
        self.label = torch.profiler.record_function(PREFIX + self.name)
        self.label.__enter__()
        if self.events:
            self.events[0].record()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events:
            self.events[1].record()
        self.label.__exit__(*exc)
        self.end_ns = time.time_ns()
        _open.remove(self.id)
        _closed.append(self)
        return False


def take() -> List[Record]:
    """The spans closed since the last call, in the order they opened,
    each with its device time; waits once for the device where any span
    recorded events."""
    spans = sorted(_closed, key=lambda s: s.id)
    del _closed[:]
    if any(s.events for s in spans):
        torch.cuda.synchronize()
    return [Record(s.name, s.id, s.parent, s.start_ns, s.end_ns,
                   s.events[0].elapsed_time(s.events[1]) if s.events
                   else None) for s in spans]
