"""PPO actor-critic networks with policy/value parameter sharing (§2.1, §8.2).

A shared tanh MLP trunk with a policy head and a value head, small by design
so that one model update fits a single jumbo frame (§10). Parameters are a
plain nested dict of tensors in ``repro``'s layout — ``{"trunk": [{"w", "b"},
...], "policy": {"w", "b"}, "value": {"w", "b"}}`` with each ``w`` of shape
(d_in, d_out) — so that :func:`flatten_params` gives ``repro``'s flat
update vector (the order of ``jax.tree_util.tree_flatten``: dict keys
sorted, lists in order).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

Params = Dict[str, Any]


def init_actor_critic(generator: torch.Generator, cfg, *, device) -> Params:
    """Fan-in scaled normal weights and zero biases, drawn from
    ``generator`` (which lives on ``device``)."""
    def normal(d_in, d_out, std):
        return std * torch.randn((d_in, d_out), generator=generator,
                                 device=device, dtype=torch.float32)

    def zeros(n):
        return torch.zeros((n,), device=device, dtype=torch.float32)

    trunk = []
    d_in = cfg.obs_dim
    for _ in range(cfg.n_hidden_layers):
        trunk.append({"w": normal(d_in, cfg.hidden, math.sqrt(2.0 / d_in)),
                      "b": zeros(cfg.hidden)})
        d_in = cfg.hidden
    return {
        "trunk": trunk,
        "policy": {"w": normal(d_in, cfg.n_actions, 0.01),
                   "b": zeros(cfg.n_actions)},
        "value": {"w": normal(d_in, 1, 1.0), "b": zeros(1)},
    }


def apply_actor_critic(params: Params, obs: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """obs: (..., obs_dim) -> (logits (..., A), value (...,))."""
    h = obs
    for lyr in params["trunk"]:
        h = torch.tanh(h @ lyr["w"] + lyr["b"])
    logits = h @ params["policy"]["w"] + params["policy"]["b"]
    value = (h @ params["value"]["w"] + params["value"]["b"])[..., 0]
    return logits, value


def tree_leaves(tree) -> List[Any]:
    """Leaves in ``jax.tree_util.tree_flatten``'s order: dict keys sorted,
    lists in order. Dicts and lists are the only containers, so a shape
    tuple is a leaf."""
    if isinstance(tree, dict):
        return [x for key in sorted(tree) for x in tree_leaves(tree[key])]
    if isinstance(tree, list):
        return [x for sub in tree for x in tree_leaves(sub)]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over matching leaves of trees of the same structure."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, tree[key], *(r[key] for r in rest))
                for key in tree}
    if isinstance(tree, list):
        return [tree_map(fn, *subs) for subs in zip(tree, *rest)]
    return fn(tree, *rest)


def flatten_params(params: Params) -> Tuple[torch.Tensor, Any]:
    """Params -> flat vector (one 'model update' / packet payload) and the
    spec (the tree of leaf shapes) :func:`unflatten_params` rebuilds from."""
    flat = torch.cat([x.reshape(-1) for x in tree_leaves(params)])
    return flat, tree_map(lambda x: tuple(x.shape), params)


def unflatten_params(flat: torch.Tensor, spec) -> Params:
    """Inverse of :func:`flatten_params`."""
    pieces = iter(torch.split(flat, [math.prod(s) for s in tree_leaves(spec)]))
    return _rebuild(spec, lambda shape: next(pieces).reshape(shape))


def _rebuild(spec, take):
    """The tree of ``spec`` with ``take(shape)`` at each leaf, called in
    :func:`tree_leaves`' order."""
    if isinstance(spec, dict):
        built = {key: _rebuild(spec[key], take) for key in sorted(spec)}
        return {key: built[key] for key in spec}
    if isinstance(spec, list):
        return [_rebuild(sub, take) for sub in spec]
    return take(spec)


def params_from_jax(tree, *, device) -> Params:
    """Carry a ``repro`` parameter tree (nested dicts/lists of numpy or
    anything ``np.asarray`` takes) across as float32 tensors on ``device``,
    in the same layout."""
    return tree_map(lambda x: torch.tensor(np.asarray(x, np.float32),
                                           device=device), tree)
