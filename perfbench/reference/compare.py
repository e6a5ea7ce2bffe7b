"""The comparison that decides ``correct`` for a training cell.

A :class:`Trajectory` is what one side did in its first steps: each
step's loss (the mean of its burst's worker losses), each step's counts
(``applied``, ``combined``, ``deferred``, ``screened``, ``occupancy``),
the norm of the first gradient as the optimizer took it (worked out from
its first moment after one step: m₁ = (1 − β₁)·g) and the norm of each
parameter's change after the last step, both per leaf, where each layer's
slice of a stacked parameter is a leaf of its own.

:func:`compare` gives the numbers held against the cell's limits:

* ``loss_gap``: the largest |L_prog − L_ref| / |L_ref| over the steps;
* ``grad_gap``, ``change_gap``: over the leaves, the largest gap between
  the two sides' norms, |n_prog − n_ref|, over the reference's norm of
  that leaf or of the median leaf, whichever is larger. ``change_gap``
  leaves out the leaves whose reference gradient is under a thousandth of
  the median leaf's (a bias under a softmax moves by round-off alone);
* ``count_diffs``: the number of step counts that differ (limit 0).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

COUNTS = ("applied", "combined", "deferred", "screened", "occupancy")
NEGLIGIBLE = 1e-3  # a leaf whose reference gradient is below this share of
# the median leaf's is left out of the change


@dataclasses.dataclass
class Trajectory:
    losses: List[float]
    counts: List[Dict[str, float]]
    grad_norms: Dict[str, float]
    change_norms: Dict[str, float]


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              keep=lambda k: True) -> Dict[str, float]:
    """Each kept leaf's |n_prog − n_ref| / max(n_ref, median n_ref)."""
    keys = [k for k in ref if keep(k)]
    if not keys:
        return {}
    r = np.array([ref[k] for k in keys], np.float64)
    p = np.array([prog.get(k, np.nan) for k in keys], np.float64)
    floor = np.maximum(r, np.median(r))
    gap = np.abs(p - r) / np.where(floor > 0, floor, 1.0)
    return dict(zip(keys, np.where(np.isfinite(gap), gap, np.inf).tolist()))


def _norm_gap(prog, ref, keep) -> float:
    return max(leaf_gaps(prog, ref, keep).values(), default=0.0)


def moved(ref: Trajectory):
    """The leaves the change is compared on: those whose reference
    gradient is at least NEGLIGIBLE of the median leaf's."""
    rg = np.array(list(ref.grad_norms.values()))
    med = float(np.median(rg)) if rg.size else 0.0
    return {k for k, v in ref.grad_norms.items() if v >= NEGLIGIBLE * med}


def compare(prog: Trajectory, ref: Trajectory) -> Dict[str, float]:
    """The numbers of the check; ``loss_gap`` only where the reference has
    losses (a cell that runs the PS step alone has none)."""
    out = {}
    if ref.losses:
        lp, lr = np.array(prog.losses), np.array(ref.losses)
        if lp.shape != lr.shape:
            out["loss_gap"] = float("inf")
        else:
            g = np.abs(lp - lr) / np.abs(lr)
            out["loss_gap"] = float(np.max(np.where(np.isfinite(g), g,
                                                    np.inf)))
    keep = moved(ref)
    diffs = sum(1 for a, b in zip(prog.counts, ref.counts)
                for k in COUNTS if a.get(k) != b.get(k))
    diffs += abs(len(prog.counts) - len(ref.counts)) * len(COUNTS)
    out["grad_gap"] = _norm_gap(prog.grad_norms, ref.grad_norms,
                                lambda k: True)
    out["change_gap"] = _norm_gap(prog.change_norms, ref.change_norms,
                                  lambda k: k in keep)
    out["count_diffs"] = float(diffs)
    return out


def held(numbers: Dict[str, float], limits: Dict[str, float]
         ) -> Dict[str, tuple]:
    """The numbers the cell compares (those its limits name), each with
    its limit; a limit whose number is missing pairs with infinity."""
    return {k: (numbers.get(k, float("inf")), lim) for k, lim in
            limits.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit."""
    return all(v <= lim for v, lim in held(numbers, limits).values())


def leaf_norms(tree: Dict[str, "object"], minus=None, scale: float = 1.0
               ) -> Dict[str, float]:
    """Per-leaf norms of ``{path: tensor}`` (of ``tree - minus`` where
    ``minus`` is given), times ``scale``; a stacked parameter (a path under
    ``layers/``) gives one leaf per layer, ``path[i]``."""
    import torch
    names, vals = [], []
    for k in sorted(tree, key=lambda p: p.split("/")):
        t = tree[k].to(torch.float32)
        if minus is not None:
            t = t - minus[k].to(torch.float32)
        if k.startswith("layers/"):
            n = torch.linalg.vector_norm(t.to(torch.float32).reshape(
                t.shape[0], -1), dim=1)
            names += [f"{k}[{i}]" for i in range(t.shape[0])]
            vals.append(n)
        else:
            names.append(k)
            vals.append(torch.linalg.vector_norm(t.to(torch.float32))[None])
    v = (torch.cat(vals).double() * scale).cpu().numpy()
    return dict(zip(names, map(float, v)))
