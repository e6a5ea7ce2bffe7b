"""Family-dispatching model API: the counterpart of ``repro.models.api``.

Entry points keyed by the shape kind, with ``repro``'s batch dicts:
``loss_fn(params, {"tokens", "labels"})`` (training),
``forward(params, {"tokens"})``, ``prefill(params, {"tokens"})`` and
``decode_step(params, caches, {"token", "pos"})`` (which updates the caches
in place). The vlm family also takes ``batch["patches"]`` (B, n_patches,
d_model) and the encdec family ``batch["frames"]`` (B, enc_frames,
d_model): stub frontends, as in ``repro``. ``param_spec``, ``cache_spec``
and ``input_specs`` come with the tooling slice (ROADMAP queue 1 item 8).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF

Params = Dict[str, Any]


def init_model(gen: torch.Generator, cfg: ArchConfig) -> Params:
    """Random weights drawn from ``gen``, on ``gen``'s device."""
    if cfg.family == "encdec":
        return ED.init_encdec(gen, cfg)
    return TF.init_lm(gen, cfg)


def loss_fn(params, batch, cfg: ArchConfig) -> torch.Tensor:
    if cfg.family == "encdec":
        return ED.encdec_loss(params, batch, cfg)
    return TF.lm_loss(params, batch, cfg)


def forward(params, batch, cfg: ArchConfig) -> torch.Tensor:
    if cfg.family == "encdec":
        return ED.encdec_forward(params, batch["frames"], batch["tokens"], cfg)
    return TF.lm_forward(params, batch["tokens"], cfg,
                         patches=batch.get("patches"))


def prefill(params, batch, cfg: ArchConfig):
    if cfg.family == "encdec":
        return ED.encdec_prefill(params, batch["frames"], batch["tokens"], cfg)
    return TF.lm_prefill(params, batch["tokens"], cfg,
                         patches=batch.get("patches"))


def decode_step(params, caches, batch, cfg: ArchConfig):
    if cfg.family == "encdec":
        return ED.encdec_decode_step(params, caches, batch["token"],
                                     batch["pos"], cfg)
    return TF.lm_decode_step(params, caches, batch["token"], batch["pos"], cfg)


def make_caches(cfg: ArchConfig, batch: int, cache_len: int, *,
                device) -> Params:
    if cfg.family == "encdec":
        return ED.init_encdec_caches(cfg, batch, cache_len, device=device)
    return TF.init_caches(cfg, batch, cache_len, device=device)
