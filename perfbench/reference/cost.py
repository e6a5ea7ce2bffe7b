"""The least bytes and operations of the PS engine's cycle, from shapes
and the cycle's own metadata. Frozen copies of ``chip_smoke.py``'s
``cycle_cost``, ``ps_step_bytes`` and ``bound_ms``, with Algorithm 1's
resolve written out here on the metadata alone (the smoke script asks the
program's ``olaf_queue.enqueue_burst_ex``), so the yardstick does not move
with the program.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from perfbench.lib.peaks import PEAKS

EV_DROP, EV_AGG, EV_RESET = 0, 1, 2
EMPTY_SEQ = 2**31 - 1
HBM = PEAKS["H100"]["hbm_bytes"]
FP32 = PEAKS["H100"]["fp32_flops"]


def resolve(meta: Dict[str, List[int]], clusters, workers, act
            ) -> Tuple[List[int], List[int], Dict[str, List[int]]]:
    """Algorithm 1 over one burst on the queue's metadata (``cluster``,
    ``worker``, ``seq``, ``agg_count``, ``replaceable``; capacity = the
    slot count, reward thresholds off): the slot and event of each row and
    the metadata after the burst."""
    m = {k: list(v) for k, v in meta.items()}
    nseq = max([s for s in m["seq"] if s != EMPTY_SEQ], default=-1) + 1
    slots, events = [], []
    Q = len(m["cluster"])
    for c, w, a in zip(clusters, workers, act):
        hit = next((q for q in range(Q) if m["cluster"][q] == c), None)
        free = next((q for q in range(Q) if m["cluster"][q] < 0), 0)
        slot = hit if hit is not None else free
        full = all(x >= 0 for x in m["cluster"])
        if not a or (hit is None and full):
            slots.append(slot)
            events.append(EV_DROP)
            continue
        if hit is not None and not (m["replaceable"][hit]
                                    and m["worker"][hit] == w):
            m["agg_count"][hit] += 1
            m["replaceable"][hit] = 0
            ev = EV_AGG
        else:
            if hit is None:
                m["seq"][slot], nseq = nseq, nseq + 1
                m["replaceable"][slot] = 1
            m["agg_count"][slot] = 1
            ev = EV_RESET
        m["cluster"][slot], m["worker"][slot] = c, w
        slots.append(slot)
        events.append(ev)
    return slots, events, m


def cycle_cost(meta: Dict[str, List[int]], clusters, workers, act, k: int,
               dim: int) -> Tuple[int, int]:
    """(bytes, operations) of one ``olaf_step`` cycle: 4·D·(contributing
    burst rows + slot rows read + slot rows written + k drained rows) plus
    every metadata element read or written once. A slot row is read where
    its old payload weighs in (touched, no reset in the burst, pre-burst
    count > 0) or where the drain pops it untouched; it is written where
    its contents change. Operations: one add per contributing element, one
    multiply per element of a read touched row, one divide per element of
    a touched row."""
    Q, U, K = len(meta["cluster"]), len(clusters), min(k, len(meta["cluster"]))
    slots, events, mid = resolve(meta, clusters, workers, act)
    last = {q: u for u, (q, e) in enumerate(zip(slots, events))
            if e == EV_RESET}
    contrib = [u for u, (q, e) in enumerate(zip(slots, events))
               if (e == EV_AGG and u > last.get(q, -1))
               or (e == EV_RESET and u == last[q])]
    touched = {slots[u] for u in contrib}
    order = sorted(range(Q), key=lambda q: (mid["seq"][q], q))[:K]
    popped = {q for q in order if mid["cluster"][q] >= 0}
    occupied = {q for q, c in enumerate(meta["cluster"]) if c >= 0}
    weighed = {q for q in touched
               if q not in last and meta["agg_count"][q] > 0}
    reads = weighed | (popped - touched)
    writes = (touched - popped) | (popped & occupied)
    meta_bytes = 2 * Q * 25 + 2 * 5 * 4 + U * 18 + K * 21
    nbytes = 4 * dim * (len(contrib) + len(reads) + len(writes) + K) \
        + meta_bytes
    return nbytes, dim * (len(contrib) + len(weighed) + len(touched))


def ps_step_bytes(cycle_bytes: int, dim: int, U: int, K: int,
                  param_bytes: int) -> Dict[str, int]:
    """The least bytes of one PS step: the cycle's, AdamW's (the gradient,
    each param, m and v read once; each param, m and v written once), the
    screen's (the burst rows read once) and the weighted mean's (the K
    drained rows read, one row written)."""
    return dict(cycle=cycle_bytes, adamw=dim * (3 * param_bytes + 16),
                screen=4 * U * dim, mean=4 * (K + 1) * dim)


def bound_s(nbytes: int, nops: int = 0) -> float:
    return max(nbytes / HBM, nops / FP32)
