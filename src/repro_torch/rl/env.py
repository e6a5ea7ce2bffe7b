"""Batched PyTorch RL environments (a leading env axis in place of ``vmap``).

Two environments, the arithmetic of ``repro.rl.env`` step for step:
  * ``CartPole`` — fast-converging control task;
  * ``LanderLite`` — a simplified LunarLander (8-dim obs, 4 actions: noop /
    left / main / right thruster), the paper's workload shape
    (LunarLander-v3, §2.1) without the Box2D dependency.

API: ``env.reset(generator, n) -> states (n, obs_dim)``;
``env.step(states, actions) -> (states, obs, rewards, dones)``;
``env.obs(states)``. States are float32 on the generator's device.
"""
from __future__ import annotations

import dataclasses

import torch


def _uniform(generator: torch.Generator, n: int, lo: float, hi: float):
    u = torch.rand((n,), generator=generator, device=generator.device,
                   dtype=torch.float32)
    return lo + (hi - lo) * u


@dataclasses.dataclass(frozen=True)
class CartPole:
    obs_dim: int = 4
    n_actions: int = 2
    gravity: float = 9.8
    masscart: float = 1.0
    masspole: float = 0.1
    length: float = 0.5
    force_mag: float = 10.0
    dt: float = 0.02
    x_limit: float = 2.4
    theta_limit: float = 12 * 3.14159 / 180

    def reset(self, generator: torch.Generator, n: int) -> torch.Tensor:
        return torch.stack([_uniform(generator, n, -0.05, 0.05)
                            for _ in range(4)], dim=-1)

    def obs(self, state) -> torch.Tensor:
        return state

    def step(self, state, action):
        x, x_dot, th, th_dot = state.unbind(-1)
        force = torch.where(action == 1, self.force_mag, -self.force_mag)
        total_m = self.masscart + self.masspole
        pm_l = self.masspole * self.length
        costh, sinth = torch.cos(th), torch.sin(th)
        temp = (force + pm_l * th_dot ** 2 * sinth) / total_m
        th_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - self.masspole * costh ** 2 / total_m))
        x_acc = temp - pm_l * th_acc * costh / total_m
        x = x + self.dt * x_dot
        x_dot = x_dot + self.dt * x_acc
        th = th + self.dt * th_dot
        th_dot = th_dot + self.dt * th_acc
        state = torch.stack([x, x_dot, th, th_dot], dim=-1)
        done = (x.abs() > self.x_limit) | (th.abs() > self.theta_limit)
        reward = torch.where(done, 0.0, 1.0)
        return state, state, reward, done


@dataclasses.dataclass(frozen=True)
class LanderLite:
    """Simplified 2-D lander: land near the origin with low speed, upright."""

    obs_dim: int = 8
    n_actions: int = 4  # noop, left thruster, main engine, right thruster
    gravity: float = -1.0
    main_power: float = 2.0
    side_power: float = 0.6
    dt: float = 0.05

    def reset(self, generator: torch.Generator, n: int) -> torch.Tensor:
        x = _uniform(generator, n, -0.5, 0.5)
        vx = _uniform(generator, n, -0.2, 0.2)
        # state: x, y, vx, vy, theta, omega, left_contact, right_contact
        zero = torch.zeros_like(x)
        return torch.stack([x, zero + 1.4, vx, zero, zero, zero, zero, zero],
                           dim=-1)

    def obs(self, state) -> torch.Tensor:
        return state

    def step(self, state, action):
        x, y, vx, vy, th, om = state[..., :6].unbind(-1)
        main = (action == 2).to(torch.float32)
        left = (action == 1).to(torch.float32)
        right = (action == 3).to(torch.float32)
        # thrust along the body axis; side thrusters rotate
        ax = -torch.sin(th) * self.main_power * main
        ay = torch.cos(th) * self.main_power * main + self.gravity
        om = om + self.dt * (left - right) * self.side_power * 4.0
        th = th + self.dt * om
        vx = vx + self.dt * ax
        vy = vy + self.dt * ay
        x = x + self.dt * vx
        y = y + self.dt * vy

        landed = (y <= 0.0) & (vy.abs() < 0.5) & (th.abs() < 0.35)
        crashed = (y <= 0.0) & ~landed
        out = x.abs() > 1.5
        done = landed | crashed | out

        # shaped reward (gym-style potential shaping)
        shaping = (-1.2 * torch.sqrt(x * x + y * y)
                   - 1.0 * torch.sqrt(vx * vx + vy * vy)
                   - 0.8 * th.abs())
        s = state
        prev_shaping = (-1.2 * torch.sqrt(s[..., 0] ** 2 + s[..., 1] ** 2)
                        - 1.0 * torch.sqrt(s[..., 2] ** 2 + s[..., 3] ** 2)
                        - 0.8 * s[..., 4].abs())
        reward = (shaping - prev_shaping) - 0.03 * main - 0.003 * (left + right)
        reward = (reward + torch.where(landed, 10.0, 0.0)
                  + torch.where(crashed, -10.0, 0.0))

        contact = torch.where(y <= 0.0, 1.0, 0.0)
        new_state = torch.stack([x, y.clamp(min=0.0), vx, vy, th, om,
                                 contact, contact], dim=-1)
        return new_state, new_state, reward, done


def make_env(name: str):
    return {"cartpole": CartPole(), "lander": LanderLite()}[name]
