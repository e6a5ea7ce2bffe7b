"""Spans around the calls into the program's layers, taken from the
benchmark's side.

:class:`Span` replaces ``module.name`` while a ``with`` block runs (the
program looks the name up in its module at each call, so the stand-in is
what it calls) and records, around each call, a CUDA event pair and a
profiler label ``perfbench.<name>``: the device time from the call's first
operation to its last, gaps included, and, in a profiled stretch, what the
host was doing while the device idled. Off a card it records nothing.
"""
from __future__ import annotations

from typing import Any, List


class Span:
    def __init__(self, module: Any, name: str, label: str = ""):
        self.module, self.name = module, name
        self.label = f"perfbench.{label or name}"
        self.fn = getattr(module, name)
        self.pairs: List[tuple] = []

    def __enter__(self) -> "Span":
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc) -> bool:
        setattr(self.module, self.name, self.fn)
        return False

    def __call__(self, *a, **kw):
        import torch
        on_card = torch.cuda.is_available() and torch.cuda.is_initialized()
        with torch.profiler.record_function(self.label):
            if not on_card:
                return self.fn(*a, **kw)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = self.fn(*a, **kw)
            end.record()
            self.pairs.append((start, end))
            return out

    def ms(self) -> List[float]:
        """Milliseconds of every call so far (synchronises the card)."""
        if not self.pairs:
            return []
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.pairs]


class Label:
    """A profiler label around every call of ``obj.name`` (a method on a
    class, or a function in a module), without any timing."""

    def __init__(self, obj: Any, name: str, label: str):
        self.obj, self.name, self.label = obj, name, f"perfbench.{label}"
        self.fn = getattr(obj, name)

    def __enter__(self) -> "Label":
        import torch
        fn, label = self.fn, self.label

        def wrapped(*a, **kw):
            with torch.profiler.record_function(label):
                return fn(*a, **kw)

        setattr(self.obj, self.name, wrapped)
        return self

    def __exit__(self, *exc) -> bool:
        setattr(self.obj, self.name, self.fn)
        return False
