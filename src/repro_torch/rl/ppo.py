"""PPO (clipped surrogate) in PyTorch — the paper's training algorithm.

One worker iteration = batched rollout (a loop over time, a leading env
axis) -> GAE advantages -> clipped PPO loss -> gradient by autograd. The
update packet carries the gradient and the episode mean reward (paper
§2.1), so :func:`worker_iteration` returns exactly that pair; applying
updates is the PS's job. Random draws come from an explicit
``torch.Generator`` on the rollout's device.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.rlnets import (apply_actor_critic, tree_leaves,
                                       tree_map)


class Rollout(NamedTuple):
    obs: torch.Tensor  # (T, N, obs_dim)
    actions: torch.Tensor  # (T, N)
    logp: torch.Tensor  # (T, N)
    values: torch.Tensor  # (T, N)
    rewards: torch.Tensor  # (T, N)
    dones: torch.Tensor  # (T, N)
    last_value: torch.Tensor  # (N,)


@torch.no_grad()
def collect_rollout(params, env, generator: torch.Generator, n_envs: int,
                    rollout_len: int) -> Rollout:
    states = env.reset(generator, n_envs)
    cols = {k: [] for k in ("obs", "actions", "logp", "values", "rewards",
                            "dones")}
    for _ in range(rollout_len):
        obs = env.obs(states)
        logits, values = apply_actor_critic(params, obs)
        logp_all = F.log_softmax(logits, dim=-1)
        actions = torch.multinomial(logp_all.exp(), 1,
                                    generator=generator)[:, 0]
        logp = logp_all.gather(-1, actions[:, None])[:, 0]
        new_states, _, rewards, dones = env.step(states, actions)
        # auto-reset finished envs
        fresh = env.reset(generator, n_envs)
        states = torch.where(dones[:, None], fresh, new_states)
        for k, v in zip(cols, (obs, actions, logp, values, rewards, dones)):
            cols[k].append(v)
    _, last_value = apply_actor_critic(params, env.obs(states))
    return Rollout(**{k: torch.stack(v) for k, v in cols.items()},
                   last_value=last_value)


def gae(rollout: Rollout, gamma: float, lam: float):
    adv_next = torch.zeros_like(rollout.last_value)
    v_next = rollout.last_value
    advs = []
    dones = rollout.dones.to(torch.float32)
    for t in range(rollout.rewards.shape[0] - 1, -1, -1):
        r, v, nonterm = rollout.rewards[t], rollout.values[t], 1.0 - dones[t]
        delta = r + gamma * v_next * nonterm - v
        adv_next = delta + gamma * lam * nonterm * adv_next
        v_next = v
        advs.append(adv_next)
    advs = torch.stack(advs[::-1])
    return advs, advs + rollout.values


def ppo_loss(params, batch, cfg):
    obs, actions, logp_old, advs, returns = batch
    logits, values = apply_actor_critic(params, obs)
    logp_all = F.log_softmax(logits, dim=-1)
    logp = logp_all.gather(-1, actions[..., None])[..., 0]
    ratio = torch.exp(logp - logp_old)
    # population std (ddof 0), as jnp.std; torch's default is ddof 1
    advs_n = (advs - advs.mean()) / (advs.std(correction=0) + 1e-8)
    pg1 = ratio * advs_n
    pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * advs_n
    policy_loss = -torch.minimum(pg1, pg2).mean()
    value_loss = torch.square(values - returns).mean()
    ent = -(F.softmax(logits, dim=-1) * logp_all).sum(-1).mean()
    return policy_loss + cfg.value_coef * value_loss - cfg.entropy_coef * ent


def loss_and_grad(params, batch, cfg) -> Tuple[torch.Tensor, Any]:
    """``jax.value_and_grad(ppo_loss)``: the loss and a gradient tree of
    ``params``' structure."""
    leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss = ppo_loss(leaves, batch, cfg)
    ps = tree_leaves(leaves)
    grads = dict(zip(map(id, ps), torch.autograd.grad(loss, ps)))
    return loss.detach(), tree_map(lambda p: grads[id(p)], leaves)


def worker_iteration(params, generator: torch.Generator, *, env, cfg,
                     n_envs: int = 8) -> Tuple[Any, torch.Tensor, torch.Tensor]:
    """One async-worker step: rollout -> (gradient tree, mean_reward, loss).

    The gradient is what goes on the wire (paper: the update packet carries
    g_i and the episode mean reward r_i).
    """
    rollout = collect_rollout(params, env, generator, n_envs, cfg.rollout_len)
    advs, returns = gae(rollout, cfg.gamma, cfg.gae_lambda)
    batch = (rollout.obs, rollout.actions, rollout.logp, advs, returns)
    loss, grads = loss_and_grad(params, batch, cfg)
    # mean episodic reward proxy: sum of rewards / number of episodes
    n_eps = torch.clamp(rollout.dones.sum().to(torch.float32), min=1.0)
    mean_reward = rollout.rewards.sum() / n_eps
    return grads, mean_reward, loss


def local_update(params, grads, lr: float):
    """Worker-side local step (keeps training until the ACK returns)."""
    return tree_map(lambda p, g: p - lr * g, params, grads)


@torch.no_grad()
def evaluate(params, env, generator: torch.Generator, n_envs: int = 16,
             horizon: int = 500) -> float:
    """Deterministic-policy average return."""
    states = env.reset(generator, n_envs)
    total = torch.zeros(n_envs, device=states.device)
    alive = torch.ones(n_envs, device=states.device)
    for _ in range(horizon):
        logits, _ = apply_actor_critic(params, env.obs(states))
        states, _, rewards, dones = env.step(states, logits.argmax(dim=-1))
        total = total + rewards * alive
        alive = alive * (1.0 - dones.to(torch.float32))
    return float(total.mean())
