"""AdamW and SGD over a param tree: the counterpart of
``repro.optim.optimizers`` (``OptConfig``, ``OptState``, ``init_opt_state``,
``apply_updates``).

Plain functions of tensors that return a new tree and a new state, as
``repro``'s do; the arithmetic is ``repro``'s, expression for expression,
including the skipped step: with clipping on, a non-finite global norm
zeroes the whole gradient, and non-finite elements are zeroed. The global
norm sums the leaves in ``jax.tree_util``'s order (sorted keys,
:func:`repro_torch.models.module.tree_leaves`). :func:`opt_state_pspecs`
gives the state's per-dim sharding specs, those of its params. The same
functions run on DTensors (the dry run's sharded pass): each moment placed
as its param, the global norm a sum of per-shard partial sums.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.models.module import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"  # adamw | sgd
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 0.0  # global-norm clip; 0 disables
    momentum: float = 0.9  # sgd


class OptState(NamedTuple):
    step: torch.Tensor  # int32, 0-dim
    m: Any  # float32 tree like the params
    v: Optional[Any]  # float32 tree (adamw) or None (sgd)


def init_opt_state(params, cfg: OptConfig) -> OptState:
    """Zero moments in float32 beside each param, step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)

    step = torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)
    return OptState(step=step, m=tree_map(zeros, params),
                    v=tree_map(zeros, params) if cfg.kind == "adamw" else None)


def _global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in ``tree_leaves`` order) of each
    leaf's float32 sum of squares."""
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tree_leaves(tree)))


def apply_updates(params, grads, state: OptState, cfg: OptConfig
                  ) -> Tuple[Any, OptState]:
    """One optimizer step: ``(new params, new state)``; the inputs are left
    as they are. Nothing is read back to the host."""
    if cfg.grad_clip > 0:
        gn = _global_norm(grads)
        # a non-finite norm would make the scale NaN and wipe every param:
        # zero the gradient instead (a skipped step)
        scale = torch.where(torch.isfinite(gn),
                            torch.clamp(cfg.grad_clip / (gn + 1e-9), max=1.0),
                            0.0)
        grads = tree_map(lambda g: torch.where(
            torch.isfinite(g), g * scale.to(g.dtype), torch.zeros_like(g)),
            grads)
    step = state.step + 1
    if cfg.kind == "adamw":
        b1, b2 = cfg.b1, cfg.b2
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32),
                     state.m, grads)
        v = tree_map(lambda v_, g: b2 * v_ + (1 - b2)
                     * torch.square(g.to(torch.float32)), state.v, grads)
        bc1 = 1 - b1 ** step.to(torch.float32)
        bc2 = 1 - b2 ** step.to(torch.float32)

        def upd(p, m_, v_):
            u = (m_ / bc1) / (torch.sqrt(v_ / bc2) + cfg.eps)
            if cfg.weight_decay:
                u = u + cfg.weight_decay * p.to(torch.float32)
            return (p.to(torch.float32) - cfg.lr * u).to(p.dtype)

        return tree_map(upd, params, m, v), OptState(step=step, m=m, v=v)
    if cfg.kind != "sgd":
        raise ValueError(f"unknown optimizer {cfg.kind!r}: use adamw or sgd")
    m = tree_map(lambda m_, g: cfg.momentum * m_ + g.to(torch.float32),
                 state.m, grads)
    new_params = tree_map(
        lambda p, m_: (p.to(torch.float32) - cfg.lr * m_).to(p.dtype),
        params, m)
    return new_params, OptState(step=step, m=m, v=None)


def opt_state_pspecs(param_specs, cfg: OptConfig) -> OptState:
    """The state's specs (``distributed.sharding``'s per-dim tuples): each
    moment sharded like its param, ``step`` (0-dim) replicated."""
    return OptState(step=(), m=param_specs,
                    v=param_specs if cfg.kind == "adamw" else None)
