"""Minimal functional parameter helpers: the counterpart of ``repro.models.module``.

Params are plain nested dicts of tensors; a layer stack stores its params
with a leading ``L`` axis, as ``repro`` does, so a checkpoint of one
package maps key for key onto the other. ``repro`` scans over that axis;
the port loops over it in Python (:func:`run_periods`), each period under
``cfg``'s activation checkpointing (``remat``, ``remat_policy``) while
autograd records.

Draws come from a ``torch.Generator`` with ``repro``'s distributions; the
bits differ from ``jax.random``'s (ROADMAP hazard H3), so parity tests
carry ``repro``'s weights across with ``transformer.params_from_jax``.
A :class:`Draws` pairs the generator with the device the weights land on,
which is the generator's own or the meta device (``api.param_spec``
builds every shape there with no allocation).

:func:`tree_leaves` walks a tree in ``jax.tree_util``'s order (a dict's
keys sorted, a dataclass's fields in order, ``None`` no leaf), which is the
order of ``repro``'s flat gradient vector and of its checkpoints' ``opt/``
and ``aux/`` entries (ROADMAP hazard H17); :func:`tree_paths` keeps a
dict's insertion order and names leaves by path.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Any, Callable, Dict, List, NamedTuple, Optional

import numpy as np
import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch import tracing

Params = Dict[str, Any]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class Draws(NamedTuple):
    """The random source of an init: ``generator`` draws, and the tensors
    land on ``device``, the generator's own device or the meta device (a
    ``torch.Generator`` cannot live there; a meta draw allocates nothing
    and leaves the generator as it was)."""

    generator: torch.Generator
    device: torch.device

    @classmethod
    def of(cls, gen: torch.Generator, device=None) -> "Draws":
        """``gen``'s draws on ``device`` (default: the generator's)."""
        return cls(gen, torch.device(device) if device is not None
                   else gen.device)


def normal(gen: Draws, shape, std: float, dtype) -> torch.Tensor:
    """``std`` · N(0, 1) drawn in float32 on ``gen.device``, then cast."""
    x = torch.randn(tuple(shape), generator=gen.generator,
                    dtype=torch.float32, device=gen.device)
    return (std * x).to(dtype)


def dense_init(gen: Draws, in_dim: int, out_shape, dtype,
               std: Optional[float] = None) -> torch.Tensor:
    """Weight of shape (in_dim, *out_shape), fan-in scaled."""
    if std is None:
        std = 1.0 / math.sqrt(in_dim)
    shape = (in_dim,) + tuple(np.atleast_1d(out_shape).tolist())
    return normal(gen, shape, std, dtype)


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of nested dicts and tuples of one structure."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    if isinstance(trees[0], tuple):
        return tuple(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def stack_draws(n: int, make: Callable[[], Params]) -> Params:
    """``n >= 1`` trees drawn by ``make()`` in turn, stacked on a new
    leading axis: each is copied into its slot as soon as it is drawn and
    then dropped, so the draws cost one tree above the stack (stacking a
    list of them would hold every tree twice); one tree is its own stack,
    seen through a leading axis of 1."""
    if n == 1:
        return tree_map(lambda x: x[None], make())
    out = None
    for i in range(n):
        tree = make()
        if out is None:
            out = tree_map(lambda x: x.new_empty((n,) + tuple(x.shape)), tree)
        tree_map(lambda dst, src: dst[i].copy_(src), out, tree)
        del tree
    return out


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable`` over
    aten ops: keep the output of a product with no batch dims, recompute
    the rest. ``torch.einsum`` lowers a weight product ("bsd,df->bsf") to
    ``bmm`` over a unit batch and an attention product ("bqhd,bshd->bhqs")
    or an expert product to ``bmm`` over B·H or E, so a ``bmm`` counts as
    batch-free when its batch is 1 (an attention over one row and one
    head is kept too, where ``repro`` would recompute it)."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.addmm.default) or (
            op is aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def remat_wrap(body: Callable, cfg) -> Callable:
    """``body`` under ``cfg``'s activation checkpointing, ``repro``'s
    ``_remat_wrap``: ``full`` recomputes the whole period in the backward
    (``torch.utils.checkpoint``, non-reentrant), ``dots`` keeps the outputs
    of the products with no batch dims (:func:`_save_dots`) and recomputes
    the rest. The body itself where ``cfg`` is None, ``cfg.remat`` is off,
    the policy is ``none``, or autograd records nothing (``torch.no_grad``,
    ``torch.inference_mode``: serving and decode never enter
    ``checkpoint``). ``repro`` also pins the saved carry behind
    ``lax.optimization_barrier`` so XLA cannot hoist a cast of the whole
    saved stack; eager PyTorch hoists nothing and has no counterpart."""
    policy = getattr(cfg, "remat_policy", "full")
    if (not getattr(cfg, "remat", False) or policy == "none"
            or not torch.is_grad_enabled()):
        return body
    if policy == "dots":
        ctx = functools.partial(create_selective_checkpoint_contexts,
                                _save_dots)
        return lambda c, p: checkpoint(body, c, p, use_reentrant=False,
                                       context_fn=ctx)
    if policy != "full":
        raise ValueError(f"unknown remat_policy {policy!r}: "
                         f"use full, dots or none")
    return lambda c, p: checkpoint(body, c, p, use_reentrant=False)


FSDP_AXES = ("pod", "data")


def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (checked without importing
    ``torch.distributed`` for a plain tensor)."""
    if type(x) is torch.Tensor or not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def fsdp_gather(x):
    """A DTensor weight gathered over the batch (FSDP) axes, its other
    placements kept, as FSDP gathers a layer's weights before it runs (the
    backward reduce-scatters the gradient back to the shards); anything
    else as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate
    names = x.device_mesh.mesh_dim_names
    pl = tuple(Replicate() if n in FSDP_AXES else p
               for n, p in zip(names, x.placements))
    return x if pl == tuple(x.placements) else x.redistribute(
        x.device_mesh, pl)


def run_periods(body: Callable, carry, stacked_params: Params, *, cfg=None):
    """Loop ``body(carry, period_params) -> (carry, out)`` over the leading
    axis of ``stacked_params`` (a dict, or a tuple of dicts sliced
    together), each period under ``cfg``'s remat policy
    (:func:`remat_wrap`). Returns ``(carry, outs)`` with ``outs`` stacked
    on a new leading axis, or ``None`` when the body returns ``None``. On
    DTensors each period's weights (the first dict of a tuple: the others
    are caches, written in place) are gathered over the FSDP axes inside
    the period (:func:`fsdp_gather`; under remat the gather is recomputed
    in the backward, not saved), unless the carry is one token a row (a
    decode step reads its weights where they lie and moves activations,
    as ``repro``'s decode constraints arrange). Each period runs under a
    ``model.period`` span inside the remat wrapper, so a recompute opens
    it again."""
    leaves = list(tree_paths(stacked_params).values())
    n = leaves[0].shape[0] if leaves else 0
    if leaves and is_dtensor(leaves[0]):
        inner = body

        def body(c, p):  # noqa: F811 — the gathering body
            if c.dim() == 3 and c.shape[1] == 1:
                return inner(c, p)
            if isinstance(p, tuple):
                return inner(c, (tree_map(fsdp_gather, p[0]),) + p[1:])
            return inner(c, tree_map(fsdp_gather, p))

    def period(c, p):
        with tracing.span("model.period"):
            return body(c, p)

    fn = remat_wrap(period, cfg)
    ys = []
    for i in range(n):
        carry, y = fn(carry, tree_map(lambda x: x[i], stacked_params))
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    return carry, tree_map(lambda *xs: torch.stack(xs), *ys)


def count_params(params: Params) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_paths(params).values())


def tree_paths(params, prefix: str = "") -> Dict[str, Any]:
    """Flatten params to a {'a/b/c': leaf} path map; a tuple's items are
    keyed by their index."""
    items = (params.items() if isinstance(params, dict)
             else enumerate(params) if isinstance(params, tuple) else None)
    if items is None:
        return {prefix: params}
    out: Dict[str, Any] = {}
    for k, v in items:
        out.update(tree_paths(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def cast_tree(params: Params, dtype: torch.dtype) -> Params:
    """Every floating leaf cast to ``dtype`` (a new tree; the rest as is)."""
    return tree_map(lambda x: x.to(dtype) if x.is_floating_point() else x,
                    params)


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_leaves``'s order: a dict's values by
    sorted key, a tuple's (or NamedTuple's) items in order, a dataclass's
    fields in declaration order; ``None`` is an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for item in tree for x in tree_leaves(item)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [x for f in dataclasses.fields(tree)
                for x in tree_leaves(getattr(tree, f.name))]
    return [tree]


def tree_unflatten(like, leaves: List[Any]):
    """A tree of ``like``'s structure holding ``leaves`` in
    :func:`tree_leaves` order (the inverse of that walk)."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(x) for x in t))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        if dataclasses.is_dataclass(t) and not isinstance(t, type):
            return dataclasses.replace(t, **{
                f.name: build(getattr(t, f.name))
                for f in dataclasses.fields(t)})
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("tree_unflatten: more leaves than the tree holds")
    return out


def flat_size(tree) -> int:
    """Elements over every leaf: the width D of :func:`flatten_like`."""
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree))


def flatten_like(tree, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every leaf raveled to float32 and concatenated in
    :func:`tree_leaves` order: ``repro``'s ``flatten`` of a gradient tree
    (sorted keys, H17). Writes into ``out`` (a (D,) float32 tensor, e.g. a
    row of a burst buffer) when given, with no other whole-width copy."""
    leaves = tree_leaves(tree)
    if out is None:
        out = torch.empty(flat_size(tree), dtype=torch.float32,
                          device=leaves[0].device)
    off = 0
    for x in leaves:
        n = x.numel()
        out[off:off + n].copy_(x.reshape(-1))
        off += n
    if off != out.numel():
        raise ValueError(f"flatten_like: the leaves hold {off} elements, "
                         f"out {out.numel()}")
    return out


def unflatten_like(flat: torch.Tensor, like):
    """``flat`` (D,) cut into ``like``'s leaves in :func:`tree_leaves`
    order, each reshaped and cast to its leaf's dtype (a view where the
    dtype already matches): ``repro``'s ``unflatten_like``."""
    leaves, off = [], 0
    for x in tree_leaves(like):
        n = x.numel()
        leaves.append(flat[off:off + n].view(x.shape).to(x.dtype))
        off += n
    if off != flat.numel():
        raise ValueError(f"unflatten_like: {flat.numel()} elements for "
                         f"leaves of {off}")
    return tree_unflatten(like, leaves)
