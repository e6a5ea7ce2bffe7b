"""The paper's own workload: distributed PPO actor-critic with parameter
sharing between policy and value networks (§2.1, §8.2). Sized so one model
update fits a single jumbo frame (paper §10: no fragmentation)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    obs_dim: int = 8          # LunarLander-style observation
    n_actions: int = 4
    hidden: int = 24          # 2 hidden layers; ~1.1k params -> fits a frame
    n_hidden_layers: int = 2
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    entropy_coef: float = 0.01
    value_coef: float = 0.5
    lr: float = 1e-3          # paper: gamma=0.001 at the PS
    rollout_len: int = 256
    epochs: int = 4
    minibatches: int = 4


CONFIG = PPOConfig()
