"""Environments, PPO and the asynchronous DRL trainer."""
