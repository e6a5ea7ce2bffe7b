"""The port's own spans (``repro_torch.tracing``) in a traced run.

:func:`stretch` runs a step a few times with the port's tracing on and
returns its closed spans; the drivers call it under ``--trace 1`` after
the profiled stretch and put what it returns into ``ctx``:

* ``program_spans``: the ``tracing.Record`` of every span, in the order
  they opened, each with its id and its parent's id and, on a card, its
  device milliseconds (first operation to last, gaps included);
* ``program_iters``: the iterations (trainer) or cycles (engine) run;
* ``program_stats`` (engine): the stretch's stats rows, one dict a cycle.

:func:`span_ms` is what a per-layer reader calls.
"""
from __future__ import annotations

from typing import Callable, Optional


def stretch(step: Callable[[], None], iters: int) -> list:
    """``step()`` ``iters`` times with the port's spans on; the records."""
    from repro_torch import tracing
    tracing.enable()
    try:
        for _ in range(iters):
            step()
        return tracing.take()
    finally:
        tracing.disable()


def span_ms(ctx: dict, *names: str, under: Optional[str] = None,
            per: Optional[str] = None) -> Optional[float]:
    """Device ms of the spans named ``names`` in the stretch, summed (only
    those with an ancestor named ``under``, where given), per iteration of
    the stretch or, with ``per``, per span named ``per``. ``None`` where
    there is none, or one has no device time (off a card)."""
    recs, iters = ctx.get("program_spans"), ctx.get("program_iters")
    if not recs or not iters:
        return None
    by_id = {r.id: r for r in recs}

    def below(r) -> bool:
        p = by_id.get(r.parent)
        while p is not None:
            if p.name == under:
                return True
            p = by_id.get(p.parent)
        return False

    ms = [r.device_ms for r in recs
          if r.name in names and (under is None or below(r))]
    if not ms or None in ms:
        return None
    n = iters if per is None else sum(r.name == per for r in recs)
    return sum(ms) / n if n else None
