"""Model FLOPs of a training step, counted from the configuration.

6 operations per parameter per token (forward 2, backward 4), the tied
embedding counted once as the output projection, plus causal attention's
score and value products: 2·S·d_attn per token per layer forward, half of
the full S² square, so 6·L·S·d_attn for training. Recomputation under
activation checkpointing is not counted. The Mamba-2 SSD scan's own
products (inside and across chunks) are left out: it counts 6·N alone.
A copy of ``launch/roofline.py::model_flops``'s 6·N·tokens of the port,
with the attention term added. A configuration that names a reference
module of its own (:mod:`perfbench.reference.models`) is counted by that
module's ``train_flops_per_token``.
"""
from __future__ import annotations

from perfbench.reference.lm import n_params
from perfbench.reference.models import model_of


def train_flops_per_token(cfg: dict, seq: int) -> float:
    model = model_of(cfg)
    if model is not None:
        return model.train_flops_per_token(cfg, seq)
    flops = 6.0 * n_params(cfg)
    if cfg["family"] == "dense":
        d_attn = cfg["hidden_size"]  # heads × head size
        flops += 6.0 * cfg["num_hidden_layers"] * seq * d_attn
    return flops
