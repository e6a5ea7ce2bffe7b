"""Update semantics for OLAF opportunistic aggregation.

An *update* is one asynchronous DRL model update (paper: one UDP packet):
a flattened gradient payload tagged with ``(cluster_id, worker_id)``, the
generation timestamp (for Age-of-Model), and the episode mean reward used
for convergence-preserving gating (paper §3).

Combining rules (paper §3 "Opportunistic Update Aggregation"):
  * same cluster, rewards within ``reward_threshold``  -> AGGREGATE (average)
  * incoming reward higher by more than the threshold  -> REPLACE
  * incoming reward lower by more than the threshold   -> DROP
  * same worker and the waiting update is un-aggregated -> REPLACE
    (the newer update subsumes the older one's experience; Alg. 1 lines 9-13)

``reward_threshold=None`` disables gating (pure Algorithm 1 behaviour).
"""
from __future__ import annotations

import dataclasses
import enum
import math
from typing import Iterator, Optional

import numpy as np
import torch


class Action(enum.Enum):
    AGGREGATE = "aggregate"
    REPLACE = "replace"
    DROP = "drop"
    APPEND = "append"


@dataclasses.dataclass
class Update:
    """One asynchronous model update in flight."""

    cluster_id: int
    worker_id: int
    gen_time: float  # when the worker generated it (virtual seconds)
    reward: float  # episode mean reward r_i carried in the packet
    payload: Optional[np.ndarray] = None  # flattened gradient (None = metadata-only sim)
    agg_count: int = 1  # how many raw updates were *aggregated* into this one (Fig. 6 CDF)
    subsumed: int = 1  # raw updates whose information this one carries
    #   (aggregated + replaced-away); used for loss accounting (Tab. 1)
    size_bits: int = 2048  # wire size (paper microbench: 2048-bit packets)
    seq: int = -1  # departure-order sequence number (queue internal)
    replaceable: bool = True  # replace_status flag: un-aggregated, same-worker replace OK
    retx: int = 0  # 0 = fresh send; k>0 = k-th ACK-timeout retransmission
    #   of a previously sent update (same gen_time, same payload)
    uids: Optional[frozenset] = None  # unique ids of the fresh sends whose
    #   information this packet carries. A retransmitted copy reuses the
    #   original's uid, so counting distinct delivered uids never exceeds
    #   the number of fresh sends (the delivery_rate <= 1 invariant).
    defers: int = 0  # times this update was deferred by the PS staleness
    #   admission control and re-queued at the egress switch to recombine
    corrupt: Optional[tuple] = None  # payload-corruption marker
    #   ``(mode, seed, factor)`` stamped by a CorruptionFault at send time.
    #   ``None`` = clean. The marker travels with the metadata trace so
    #   both hybrid consumers can apply the identical byte damage
    #   (``apply_corruption`` in netsim) without shipping payloads.

    def clone(self) -> "Update":
        return dataclasses.replace(
            self, payload=None if self.payload is None else self.payload.copy()
        )


def gate(incoming_reward: float, waiting_reward: float,
         reward_threshold: Optional[float]) -> Action:
    """Reward-gating decision for two same-cluster updates (paper §3)."""
    if reward_threshold is None:
        return Action.AGGREGATE
    diff = incoming_reward - waiting_reward
    if abs(diff) <= reward_threshold:
        return Action.AGGREGATE
    if diff > reward_threshold:
        return Action.REPLACE
    return Action.DROP


def aggregate(waiting: Update, incoming: Update) -> Update:
    """Merge ``incoming`` into ``waiting`` in place of the waiting update.

    Gradient payloads are averaged (paper: ``g_a = avg(g_a, g_i)``); the
    merged update inherits the *queue position* (seq) of the waiting update
    and the *freshness* (gen_time) of the newer one — an aggregated model
    subsumes the older experience, so its age is the newer update's age
    (cf. Fig. 5: aggregation lowers the AoM).
    """
    if waiting.payload is not None and incoming.payload is not None:
        # Weighted mean so that k-fold aggregation equals the mean of the
        # k raw gradients irrespective of arrival order.
        w_n, i_n = waiting.agg_count, incoming.agg_count
        payload = (waiting.payload * w_n + incoming.payload * i_n) / (w_n + i_n)
    else:
        payload = incoming.payload if incoming.payload is not None else waiting.payload
    return dataclasses.replace(
        incoming,
        payload=payload,
        agg_count=waiting.agg_count + incoming.agg_count,
        subsumed=waiting.subsumed + incoming.subsumed,
        gen_time=max(waiting.gen_time, incoming.gen_time),
        reward=max(waiting.reward, incoming.reward),
        seq=waiting.seq,
        replaceable=False,  # an aggregation disables same-worker replacement
        uids=_merge_uids(waiting.uids, incoming.uids),
        defers=max(waiting.defers, incoming.defers),
        # averaging a tainted payload taints the merge — either side's
        # corruption survives (incoming's marker wins for determinism)
        corrupt=incoming.corrupt if incoming.corrupt is not None
        else waiting.corrupt,
    )


def replace(waiting: Update, incoming: Update) -> Update:
    """Newer update takes the waiting update's queue position outright."""
    out = incoming.clone() if incoming.payload is not None else dataclasses.replace(incoming)
    out.seq = waiting.seq
    out.subsumed = waiting.subsumed + incoming.subsumed
    # the replacing update subsumes the waiting one's information, so its
    # delivery also covers the waiting update's fresh sends
    out.uids = _merge_uids(waiting.uids, incoming.uids)
    out.defers = max(waiting.defers, incoming.defers)
    # replacement discards the waiting payload bytes entirely, so only the
    # incoming update's corruption marker (already on ``out``) survives —
    # a clean replacement *heals* a tainted slot.
    return out


def _merge_uids(a: Optional[frozenset], b: Optional[frozenset]) -> Optional[frozenset]:
    if a is None:
        return b
    if b is None:
        return a
    return a | b


# ---------------------------------------------------------------------------
# Robust combining (payload-integrity fallback at PS egress)
# ---------------------------------------------------------------------------
# When ingress screening flags a large fraction of a drained block, the
# trainer falls back from the plain weighted mean to a *winsorized*
# (per-coordinate trimmed) combine: every coordinate is clipped into the
# [trim, 1-trim] weighted-sample quantile band of the valid rows before
# averaging, so a single exploding or non-finite row cannot dominate the
# merged gradient. These numpy versions are the sequential oracle;
# :func:`trimmed_combine_torch` is the device twin, which the PS step
# applies on the CPU and which the CUDA kernel of
# ``kernels/olaf_robust.py`` is held to on a card.

def coordinate_clip(rows: np.ndarray, bound: float) -> np.ndarray:
    """Clip every coordinate of every row into ``[-bound, bound]``
    (non-finite coordinates collapse to the nearest bound / zero)."""
    out = np.nan_to_num(rows, nan=0.0, posinf=bound, neginf=-bound)
    return np.clip(out, -bound, bound)


def trimmed_combine(rows: np.ndarray, weights: np.ndarray,
                    trim: float = 0.25) -> np.ndarray:
    """Winsorized weighted mean over the rows with ``weights > 0``.

    Per coordinate, values are clipped into the [trim, 1-trim] quantile
    band of the *valid* rows, then averaged with the original weights.
    With no valid rows the combine is all-zero (a skipped PS step).
    """
    rows = np.asarray(rows, np.float64)
    weights = np.asarray(weights, np.float64)
    valid = weights > 0
    if not valid.any():
        return np.zeros(rows.shape[-1], rows.dtype)
    masked = np.where(valid[:, None], rows, np.nan)
    lo = np.nanquantile(masked, trim, axis=0)
    hi = np.nanquantile(masked, 1.0 - trim, axis=0)
    clipped = np.clip(np.nan_to_num(rows, nan=0.0, posinf=0.0,
                                    neginf=0.0), lo, hi)
    wts = weights * valid
    return (wts[:, None] * clipped).sum(0) / max(wts.sum(), 1.0)


#: Columns per slice where a device function walks a (rows, D) block: at
#: D = 3.6e8 (smollm-360m's flat gradient) a whole-width temporary of a
#: drained block would be 5.8 GB, a slice of 2^24 columns is 268 MB.
COLUMN_CHUNK = 1 << 24


def column_slices(d: int, chunk: int = COLUMN_CHUNK) -> Iterator[slice]:
    """Consecutive column slices of at most ``chunk`` covering ``[0, d)``."""
    for lo in range(0, d, chunk):
        yield slice(lo, min(lo + chunk, d))


def _sorted_nan_last(x: torch.Tensor):
    """Each column of ``x`` (K, C) sorted, and its count of non-NaN entries
    (float32). NaN entries are sorted as +inf: a column's first ``count``
    entries are its non-NaN values in order, and no later entry is read
    (:func:`_quantile_of_sorted`). The sort is a network of elementwise
    min/max over the rows (K rounds of odd-even transposition, K²/2
    compare-exchanges): at K = 4 and 3.6e8 columns it takes the trimmed
    combine from 355 ms with ``torch.sort`` (which also sorts indices) to
    134 ms on an H100."""
    nan = torch.isnan(x)
    counts = (~nan).sum(dim=0).to(torch.float32)
    rows = list(torch.where(nan, math.inf, x).unbind(0))
    for rnd in range(len(rows)):
        for i in range(rnd % 2, len(rows) - 1, 2):
            a, b = rows[i], rows[i + 1]
            rows[i], rows[i + 1] = torch.minimum(a, b), torch.maximum(a, b)
    return torch.stack(rows), counts


def _quantile_of_sorted(xs: torch.Tensor, counts: torch.Tensor,
                        q: float) -> torch.Tensor:
    """``jnp.nanquantile``'s linear interpolation on sorted columns; NaN
    where a column has no non-NaN entry."""
    r = q * (counts - 1.0)
    low, high = torch.floor(r), torch.ceil(r)
    high_w = r - low
    low_w = 1.0 - high_w
    top = counts - 1.0
    low = torch.clamp(torch.minimum(low, top), min=0.0).long()
    high = torch.clamp(torch.minimum(high, top), min=0.0).long()
    low_v = xs.gather(0, low[None])[0]
    high_v = xs.gather(0, high[None])[0]
    return torch.where(counts > 0, low_v * low_w + high_v * high_w, math.nan)


def nanquantile_linear(x: torch.Tensor, q: float) -> torch.Tensor:
    """Quantile ``q`` of each column of ``x`` (K, C) over its non-NaN
    entries, with linear interpolation written as ``jnp.nanquantile``
    writes it: ``low·(1 − w) + high·w``. ``torch.nanquantile`` takes
    ``torch.lerp``, which gives NaN where this gives ±inf (a column
    ``[1, inf]`` at 0.75; ROADMAP hazard H18). An all-NaN column gives
    NaN."""
    return _quantile_of_sorted(*_sorted_nan_last(x), q)


def trimmed_combine_torch(rows: torch.Tensor, weights: torch.Tensor,
                          trim: float = 0.25) -> torch.Tensor:
    """Device twin of :func:`trimmed_combine`, the counterpart of
    ``repro``'s ``jax_trimmed_combine``: the drained ``(K, D)`` block,
    ``weights`` its ``valid · agg_count`` (K,) float32, -> the winsorized
    weighted mean ``(D,)`` float32.

    Per column, the quantile band ``[trim, 1 − trim]`` of the rows with
    weight > 0 (NaN where none is; taken as 0 after ``nan_to_num``, which
    also turns ±inf into the float32 extremes); non-finite entries are
    zeroed before the clip. Computed over column slices
    (:data:`COLUMN_CHUNK`), each column on its own as a whole-width pass
    would; no value is read back to the host."""
    valid = weights > 0
    wts = weights * valid
    denom = torch.clamp(wts.sum(), min=1.0)
    out = torch.empty(rows.shape[1], dtype=torch.float32, device=rows.device)
    for sl in column_slices(rows.shape[1]):
        x = rows[:, sl]
        xs, counts = _sorted_nan_last(torch.where(valid[:, None], x,
                                                  math.nan))
        lo = torch.nan_to_num(_quantile_of_sorted(xs, counts, trim), nan=0.0)
        hi = torch.nan_to_num(_quantile_of_sorted(xs, counts, 1.0 - trim),
                              nan=0.0)
        safe = torch.where(torch.isfinite(x), x, 0.0)
        out[sl] = (wts @ torch.clamp(safe, min=lo, max=hi)) / denom
    return out
