"""Family-dispatching model API: the counterpart of ``repro.models.api``.

Entry points keyed by the shape kind, with ``repro``'s batch dicts:
``loss_fn(params, {"tokens", "labels"})`` (training),
``forward(params, {"tokens"})``, ``prefill(params, {"tokens"})`` and
``decode_step(params, caches, {"token", "pos"})`` (which updates the caches
in place). The vlm family also takes ``batch["patches"]`` (B, n_patches,
d_model) and the encdec family ``batch["frames"]`` (B, enc_frames,
d_model): stub frontends, as in ``repro``.

``param_spec``, ``cache_spec`` and ``input_specs`` are the dry run's
stand-ins: trees of tensors on the meta device, with ``repro``'s shapes
and dtypes (integer inputs int32, hazard H4) and no allocation, the
counterparts of ``repro``'s ``ShapeDtypeStruct`` trees.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.models import encdec as ED
from repro_torch.models import transformer as TF
from repro_torch.models.module import dtype_of

Params = Dict[str, Any]
META = torch.device("meta")


def init_model(gen: torch.Generator, cfg: ArchConfig,
               vocab_pad_multiple: int = 1, *, device=None) -> Params:
    """Random weights drawn from ``gen``, on ``device`` (default: the
    generator's), the vocabulary padded to ``vocab_pad_multiple``."""
    if cfg.family == "encdec":
        return ED.init_encdec(gen, cfg, vocab_pad_multiple, device=device)
    return TF.init_lm(gen, cfg, vocab_pad_multiple, device=device)


def param_spec(cfg: ArchConfig, vocab_pad_multiple: int = 1) -> Params:
    """The parameter tree on the meta device: shapes and dtypes only."""
    return init_model(torch.Generator(), cfg, vocab_pad_multiple,
                      device=META)


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


def cache_spec(cfg: ArchConfig, batch: int, cache_len: int) -> Params:
    """The decode caches on the meta device."""
    return make_caches(cfg, batch, cache_len, device=META)


def input_specs(cfg: ArchConfig, shape: ShapeCfg) -> Dict[str, Any]:
    """Meta stand-ins for the inputs of the entry point of ``shape.kind``:
    tokens and labels (train), tokens (prefill), or token, pos and caches
    of ``seq_len`` positions behind the vlm's patches (decode)."""
    B, S = shape.global_batch, shape.seq_len
    dt, i32 = dtype_of(cfg.dtype), torch.int32

    def meta(shp, dtype):
        return torch.empty(shp, dtype=dtype, device=META)

    if shape.kind in ("train", "prefill"):
        specs: Dict[str, Any] = {"tokens": meta((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = meta((B, S), i32)
        if cfg.family == "vlm":
            specs["patches"] = meta((B, cfg.n_patches, cfg.d_model), dt)
        if cfg.family == "encdec":
            specs["frames"] = meta((B, cfg.enc_frames, cfg.d_model), dt)
        return specs
    if shape.kind == "decode":
        cache_len = S + (cfg.n_patches if cfg.family == "vlm" else 0)
        return {"token": meta((B,), i32), "pos": meta((B,), i32),
                "caches": cache_spec(cfg, B, cache_len)}
    raise ValueError(shape.kind)
