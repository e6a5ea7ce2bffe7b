"""Decoder-only LM of the dense, moe, ssm, hybrid and vlm families: the
counterpart of ``repro.models.transformer``.

Layers are grouped into repeating periods (dense: period 1, ``["attn"]``;
recurrentgemma: period 3, ``["rec", "rec", "attn"]``) whose params are
stacked on a leading axis, key for key as ``repro``
(``params["layers"]["sub_0"]``); the port loops over the periods in Python,
each under ``cfg``'s remat policy (``module.run_periods``), and the layers
left over (38 = 12·3 + 2) follow as ``params["tail"]``, without remat, as
in ``repro``.
Layer kinds: ``attn`` (attention + MLP), ``moe`` (attention + the
mixture-of-experts FFN, :mod:`~repro_torch.models.moe`), ``rec`` (the
RG-LRU block + MLP, :mod:`~repro_torch.models.rglru`) and ``ssm`` (the
Mamba-2 block, :mod:`~repro_torch.models.ssm`). The vlm family prepends
projected stub patch embeddings to the text and returns logits over the
text positions only. Four entry points:

  * :func:`lm_forward`     — full-sequence logits;
  * :func:`lm_loss`        — next-token cross entropy, differentiable by
    autograd through every attention route (``"pallas"``, and ``"auto"``
    on a card in bf16, through the flash kernel pair's backward);
  * :func:`lm_prefill`     — forward + caches (inference prefill);
  * :func:`lm_decode_step` — one token against the caches, which it
    updates in place (``index_put_`` and ``copy_``; ``repro`` returns new
    caches and its jit donates the old ones): treat the passed-in caches
    as consumed.

``attn_impl="pallas"`` routes prefill attention to the flash kernel
(:func:`repro_torch.kernels.ops.flash_attention`), as ``repro`` does, and
the decode of a non-windowed attn or moe layer to the decode kernel
(:func:`repro_torch.kernels.ops.decode_attention`) with q folded to
(B, KV, rep, Dh) against the unexpanded cache. ``repro`` decodes through
the plain ``layers.decode_attention`` under every ``attn_impl``; the two
compute the same function (ROADMAP queue 3, the decode route). The
hybrid's windowed layers decode through the plain masked attention, as in
``repro``.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as KOPS
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as RG
from repro_torch.models import ssm as SSM
from repro_torch.models.module import (Draws, dense_init, dtype_of,
                                       run_periods, stack_draws, tree_map)
from repro_torch.optim.optimizers import OptState

Params = Dict[str, Any]


# --------------------------------------------------------------------------
# Layer plan / periods
# --------------------------------------------------------------------------
def layer_plan(cfg: ArchConfig) -> List[str]:
    if cfg.family in ("dense", "vlm"):
        return ["attn"] * cfg.n_layers
    if cfg.family == "moe":
        return ["moe"] * cfg.n_layers
    if cfg.family == "ssm":
        return ["ssm"] * cfg.n_layers
    if cfg.family == "hybrid":
        pat = cfg.block_pattern or ("rec",)
        return [pat[i % len(pat)] for i in range(cfg.n_layers)]
    raise ValueError(cfg.family)


def period_len(cfg: ArchConfig) -> int:
    return len(cfg.block_pattern) if cfg.block_pattern else 1


def split_plan(cfg: ArchConfig) -> Tuple[List[str], int, List[str]]:
    """(period_plan, n_stacked_periods, tail_plan)."""
    plan = layer_plan(cfg)
    per = period_len(cfg)
    n_full = cfg.n_layers // per
    return plan[:per], n_full, plan[n_full * per:]


# --------------------------------------------------------------------------
# Init
# --------------------------------------------------------------------------
def _attn_window(cfg: ArchConfig, kind: str) -> int:
    # hybrid archs use *local* attention in their attention layers
    return cfg.window if (cfg.family == "hybrid" and kind == "attn") else 0


def init_layer(gen: Draws, cfg: ArchConfig, kind: str) -> Params:
    dt, d, dev = dtype_of(cfg.dtype), cfg.d_model, gen.device
    if kind in ("attn", "moe"):
        p = {"ln1": L.init_norm(cfg.norm, d, dt, dev),
             "attn": L.init_attention(gen, cfg, dt),
             "ln2": L.init_norm(cfg.norm, d, dt, dev)}
        if kind == "moe":
            p["moe"] = MOE.init_moe(gen, d, cfg.d_ff, cfg.n_experts, cfg.act,
                                    dt, cfg.dense_residual)
        else:
            p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act, dt)
        return p
    if kind == "rec":
        return {"ln1": L.init_norm(cfg.norm, d, dt, dev),
                "rec": RG.init_rglru_block(gen, cfg, dt),
                "ln2": L.init_norm(cfg.norm, d, dt, dev),
                "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.act, dt)}
    if kind == "ssm":
        return {"ln1": L.init_norm(cfg.norm, d, dt, dev),
                "ssm": SSM.init_ssm_block(gen, cfg, dt)}
    raise ValueError(kind)


def padded_vocab(cfg: ArchConfig, multiple: int) -> int:
    """The vocabulary rounded up to ``multiple`` (the model axis, so the
    embedding shards; ``unembed`` masks the padded logits)."""
    return -(-cfg.vocab // multiple) * multiple


def init_lm(gen, cfg: ArchConfig, vocab_pad_multiple: int = 1, *,
            device=None) -> Params:
    """Random weights at ``cfg``'s shapes, drawn from ``gen`` onto
    ``device`` (default: the generator's device; ``"meta"`` allocates
    nothing), with the vocabulary padded to ``vocab_pad_multiple``."""
    gen = Draws.of(gen, device)
    dt = dtype_of(cfg.dtype)
    period_plan, n_full, tail = split_plan(cfg)
    params: Params = {
        "embedding": L.init_embedding(gen, padded_vocab(cfg,
                                                        vocab_pad_multiple),
                                      cfg.d_model, dt, cfg.tie_embeddings),
        "final_norm": L.init_norm(cfg.norm, cfg.d_model, dt, gen.device),
    }
    params["layers"] = stack_draws(n_full, lambda: {
        f"sub_{i}": init_layer(gen, cfg, kind)
        for i, kind in enumerate(period_plan)})
    if tail:
        params["tail"] = {f"layer_{i}": init_layer(gen, cfg, kind)
                          for i, kind in enumerate(tail)}
    if cfg.family == "vlm":
        params["patch_proj"] = dense_init(gen, cfg.d_model, (cfg.d_model,), dt)
    return params


def params_from_jax(tree, *, device) -> Params:
    """``repro``'s param pytree, as numpy arrays (or anything
    ``np.asarray`` takes), as the port's dict on ``device``: key for key,
    layout for layout. bfloat16 leaves are carried bit for bit (through
    ``uint16``, with no ``ml_dtypes`` import); float32 leaves convert
    directly."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def opt_state_from_jax(state, *, device):
    """``repro``'s ``OptState`` (``step``, ``m``, ``v``; ``v`` None for
    SGD) as the port's :class:`~repro_torch.optim.optimizers.OptState` on
    ``device``, each moment tree carried as :func:`params_from_jax`
    carries the params."""
    return OptState(
        step=torch.from_numpy(np.array(state.step, np.int32)).to(device),
        m=params_from_jax(state.m, device=device),
        v=None if state.v is None else params_from_jax(state.v,
                                                       device=device))


# --------------------------------------------------------------------------
# Per-layer apply (train forward / prefill / decode)
# --------------------------------------------------------------------------
def _rope(cfg: ArchConfig, x, positions):
    if cfg.rope_style == "none":
        return x
    rd = cfg.hd // 2 if cfg.rope_style == "partial" else cfg.hd
    return L.apply_rope(x, positions, cfg.rope_theta, rotary_dim=rd)


def _attn_block(p, x, cfg: ArchConfig, kind: str, positions):
    """Pre-norm attention over the whole sequence; returns the new residual
    and the unexpanded, rotated k/v."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    q, k, v = L.qkv(p["attn"], h, cfg)
    q, k = _rope(cfg, q, positions), _rope(cfg, k, positions)
    with tracing.span("model.attention"):
        ctx = L.attention_any(q, L.expand_kv(k, cfg), L.expand_kv(v, cfg),
                              causal=True, window=_attn_window(cfg, kind),
                              impl=cfg.attn_impl, chunk=cfg.attn_chunk)
    return x + L.out_proj(p["attn"], ctx, cfg), k, v


def _ffn_block(p, x, cfg: ArchConfig):
    """The second half of an attn, moe or rec layer: the pre-norm MLP, or
    the mixture of experts."""
    h = L.apply_norm(cfg.norm, p["ln2"], x)
    if "moe" in p:
        return x + MOE.apply_moe(p["moe"], h, cfg)
    return x + L.apply_mlp(p["mlp"], h, cfg.act, cfg)


def apply_layer_train(p, x, cfg: ArchConfig, kind: str, positions):
    """Forward of one layer over the whole sequence."""
    if kind in ("attn", "moe"):
        x, _, _ = _attn_block(p, x, cfg, kind, positions)
        return _ffn_block(p, x, cfg)
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    if kind == "rec":
        return _ffn_block(p, x + RG.apply_rglru_train(p["rec"], h, cfg), cfg)
    if kind == "ssm":
        return x + SSM.apply_ssm_train(p["ssm"], h, cfg)
    raise ValueError(kind)


def init_layer_cache(cfg: ArchConfig, kind: str, batch: int, cache_len: int,
                     *, device):
    dt = dtype_of(cfg.dtype)
    if kind == "rec":
        return RG.init_rglru_cache(cfg, batch, dt, device=device)
    if kind == "ssm":
        return SSM.init_ssm_cache(cfg, batch, dt, device=device)
    if kind not in ("attn", "moe"):
        raise ValueError(kind)
    S = cfg.window if _attn_window(cfg, kind) else cache_len
    shape = (batch, S, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def init_caches(cfg: ArchConfig, batch: int, cache_len: int, *,
                device) -> Params:
    period_plan, n_full, tail = split_plan(cfg)
    layers = {f"sub_{i}": init_layer_cache(cfg, kind, batch, cache_len,
                                           device=device)
              for i, kind in enumerate(period_plan)}
    caches: Params = {"layers": tree_map(
        lambda x: x[None].repeat((n_full,) + (1,) * x.dim()), layers)}
    if tail:
        caches["tail"] = {f"layer_{i}": init_layer_cache(
            cfg, kind, batch, cache_len, device=device)
            for i, kind in enumerate(tail)}
    return caches


def apply_layer_prefill(p, x, cfg: ArchConfig, kind: str, positions):
    """Full-sequence forward that also returns the decode cache."""
    if kind == "rec":
        y, cache = RG.rglru_prefill(
            p["rec"], L.apply_norm(cfg.norm, p["ln1"], x), cfg)
        return _ffn_block(p, x + y, cfg), cache
    if kind == "ssm":
        y, cache = SSM.ssm_prefill(
            p["ssm"], L.apply_norm(cfg.norm, p["ln1"], x), cfg)
        return x + y, cache
    x, k, v = _attn_block(p, x, cfg, kind, positions)
    x = _ffn_block(p, x, cfg)
    # each layer's cache placed as the prefill's outputs are (a no-op on
    # plain tensors)
    dims = L.cache_dims(cfg, k.shape[2])
    k, v = L.constrain(k, cfg, dims), L.constrain(v, cfg, dims)
    window = _attn_window(cfg, kind)
    if not window:
        return x, {"k": k, "v": v}
    # ring buffer of exactly `window` slots; decode masks unwritten slots
    return x, {"k": _ring(k, window), "v": _ring(v, window)}


def _ring(k, window: int):
    """The prefill's ring buffer of ``window`` slots: slot ``pos % window``
    holds position ``pos`` of the last ``min(S, window)``, the rest zeros.
    Built by slices alone, which a DTensor can run (it has no rule to
    write a slice of its sequence, and some torch versions none for
    ``roll``)."""
    S = k.shape[1]
    keep = min(S, window)
    kc = torch.cat([k[:, S - keep:], k.new_zeros(
        (k.shape[0], window - keep) + tuple(k.shape[2:]))], dim=1)
    shift = (S - keep) % window  # rolled right by ``shift``
    return torch.cat([kc[:, window - shift:], kc[:, :window - shift]], dim=1)


def write_token(cache, slot, val) -> None:
    """``cache[b, slot[b]] = val[b]`` for every row ``b``, in place, on a
    DTensor cache: each rank writes its local shard (the row's position
    offset by the shard's start where the sequence is sharded, the write
    kept only where the slot falls in the shard), since a DTensor
    ``index_put_`` that needs a placement change has no rule."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    mesh, pl = cache.device_mesh, tuple(cache.placements)

    def shard_of(p, dims):  # the cache's dim -> val's / slot's dim
        return (Shard(dims[p.dim]) if isinstance(p, Shard)
                and dims.get(p.dim) is not None else Replicate())

    v_dims = {0: 0, 2: 1, 3: 2}
    v_loc = val.redistribute(mesh, tuple(shard_of(p, v_dims) for p in pl)
                             ).to_local()
    s_loc = slot.redistribute(mesh, tuple(shard_of(p, {0: 0}) for p in pl)
                              ).to_local()
    c_loc = cache.to_local()
    _, offset = compute_local_shape_and_global_offset(cache.shape, mesh, pl)
    s = s_loc - offset[1]
    mine = (s >= 0) & (s < c_loc.shape[1])
    s = s.clamp(0, c_loc.shape[1] - 1)
    rows = torch.arange(c_loc.shape[0], device=c_loc.device)
    c_loc.index_put_((rows, s), torch.where(mine[:, None, None], v_loc,
                                            c_loc[rows, s]))


def _decode_kernel_route(q, kc, vc, pos, cfg: ArchConfig):
    """q (B,1,H,Dh) folded to (B,KV,rep,Dh) against the unexpanded caches.
    The fold is right only when head h reads kv head h // rep, which
    ``kv_head_map`` gives when no head is padded (hazard H14)."""
    H, KV = cfg.n_heads, cfg.n_kv_heads
    if cfg.padded_heads != H or H % KV != 0:
        raise ValueError(
            f"{cfg.name}: attn_impl='pallas' decodes with q folded to "
            f"(B, KV, rep, Dh), which needs padded_heads == n_heads and "
            f"n_heads % n_kv_heads == 0 (got {cfg.padded_heads}, {H}, {KV})")
    B, _, _, Dh = q.shape
    ctx = KOPS.decode_attention(q.reshape(B, KV, H // KV, Dh), kc, vc, pos)
    return ctx.reshape(B, 1, H, Dh)


def _masked_decode_attn(q, k_cache, v_cache, valid):
    s = torch.einsum("bqhd,bshd->bhqs", q, k_cache).to(torch.float32)
    s = s / math.sqrt(q.shape[-1])
    s = s.masked_fill(~valid[:, None, None, :], -float("inf"))
    p_attn = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p_attn, v_cache)


def apply_layer_decode(p, x, cache, pos, cfg: ArchConfig, kind: str):
    """x: (B,1,d); pos: (B,) int32, the absolute position of the incoming
    token. Writes the token's k/v (or the new recurrent state) into
    ``cache`` in place; returns ``(x, cache)``."""
    h = L.apply_norm(cfg.norm, p["ln1"], x)
    if kind in ("rec", "ssm"):
        step = RG.apply_rglru_decode if kind == "rec" else SSM.apply_ssm_decode
        y, new = step(p[kind], h, cache, cfg)
        for name, t in new.items():
            cache[name].copy_(t)
        return (_ffn_block(p, x + y, cfg) if kind == "rec" else x + y), cache
    q, k, v = L.qkv(p["attn"], h, cfg)
    q, k = _rope(cfg, q, pos[:, None]), _rope(cfg, k, pos[:, None])
    # the decode streams the (sequence-sharded) cache with the heads
    # replicated, as ``repro``'s: q follows
    q = L.constrain(q, cfg, ("batch", None, None, None))
    window = _attn_window(cfg, kind)
    kc, vc = cache["k"], cache["v"]
    rows = torch.arange(x.shape[0], device=x.device)
    slot = pos.to(torch.int64) % window if window else pos.to(torch.int64)
    if L.is_dtensor(kc):
        write_token(kc, slot, k[:, 0])
        write_token(vc, slot, v[:, 0])
    else:
        kc.index_put_((rows, slot), k[:, 0])
        vc.index_put_((rows, slot), v[:, 0])
    if window:
        j = torch.arange(kc.shape[1], device=x.device)[None, :]
        stored_pos = pos[:, None] - torch.remainder(pos[:, None] - j, window)
        ctx = _masked_decode_attn(q, L.expand_kv(kc, cfg, decode=True),
                                  L.expand_kv(vc, cfg, decode=True),
                                  stored_pos >= 0)
    elif cfg.attn_impl == "pallas":
        ctx = _decode_kernel_route(q, kc, vc, pos, cfg)
    else:
        ctx = L.decode_attention(q, L.expand_kv(kc, cfg, decode=True),
                                 L.expand_kv(vc, cfg, decode=True), pos)
    x = x + L.out_proj(p["attn"], ctx, cfg)
    return _ffn_block(p, x, cfg), cache


# --------------------------------------------------------------------------
# Model-level entry points
# --------------------------------------------------------------------------
def _embed(params, cfg: ArchConfig, tokens):
    """Token embeddings, placed as the residual stream (a vocab-sharded
    lookup of DTensors is a partial sum over the vocab shards until
    then)."""
    x = L.embed(params["embedding"], tokens, scale_by_dim=cfg.embed_scale)
    return L.constrain(x, cfg, L.residual_dims(cfg, x.shape[1]))


def _embed_inputs(params, cfg: ArchConfig, tokens, patches=None):
    """Token embeddings, behind the projected patch embeddings for vlm."""
    x = _embed(params, cfg, tokens)
    if cfg.family != "vlm":
        return L.constrain(x, cfg, L.residual_dims(cfg, x.shape[1]))
    if patches is None:
        raise ValueError(f"{cfg.name}: the vlm family needs stub patch "
                         f"embeddings (batch['patches'])")
    img = torch.einsum("bpd,de->bpe", patches.to(x.dtype), params["patch_proj"])
    x = torch.cat([img, x], dim=1)
    return L.constrain(x, cfg, L.residual_dims(cfg, x.shape[1]))


def _text(cfg: ArchConfig, x, tokens):
    """The text positions of the residual (vlm drops its patch prefix)."""
    return x[:, -tokens.shape[1]:, :] if cfg.family == "vlm" else x


def lm_forward(params, tokens, cfg: ArchConfig, patches=None) -> torch.Tensor:
    """Full-sequence forward -> logits over the text positions (B, S, V)."""
    period_plan, _, tail_plan = split_plan(cfg)
    x = _embed_inputs(params, cfg, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def period_body(h, pp):
        for i, kind in enumerate(period_plan):
            h = apply_layer_train(pp[f"sub_{i}"], h, cfg, kind, positions)
        return h, None

    x, _ = run_periods(period_body, x, params["layers"], cfg=cfg)
    for i, kind in enumerate(tail_plan):
        x = apply_layer_train(params["tail"][f"layer_{i}"], x, cfg, kind,
                              positions)
    x = _text(cfg, L.apply_norm(cfg.norm, params["final_norm"], x), tokens)
    return L.unembed(params["embedding"], x, true_vocab=cfg.vocab, cfg=cfg)


def lm_loss(params, batch, cfg: ArchConfig) -> torch.Tensor:
    """Mean next-token cross entropy of ``batch["tokens"]`` against
    ``batch["labels"]`` (a 0-dim float32)."""
    logits = lm_forward(params, batch["tokens"], cfg,
                        patches=batch.get("patches"))
    return L.cross_entropy(logits, batch["labels"], cfg)


def lm_prefill(params, tokens, cfg: ArchConfig, patches=None):
    """Forward over the prompt (behind the patches for vlm) ->
    (last-position logits (B, 1, V), caches)."""
    period_plan, _, tail_plan = split_plan(cfg)
    x = _embed_inputs(params, cfg, tokens, patches)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]

    def period_body(h, pp):
        caches = {}
        for i, kind in enumerate(period_plan):
            h, caches[f"sub_{i}"] = apply_layer_prefill(pp[f"sub_{i}"], h,
                                                        cfg, kind, positions)
        return h, caches

    x, stacked = run_periods(period_body, x, params["layers"], cfg=cfg)
    caches: Params = {"layers": stacked}
    if tail_plan:
        caches["tail"] = {}
        for i, kind in enumerate(tail_plan):
            x, caches["tail"][f"layer_{i}"] = apply_layer_prefill(
                params["tail"][f"layer_{i}"], x, cfg, kind, positions)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    logits = L.unembed(params["embedding"], x[:, -1:, :], true_vocab=cfg.vocab,
                       cfg=cfg)
    return logits, caches


def lm_decode_step(params, caches, token, pos, cfg: ArchConfig):
    """token: (B,) int; pos: (B,) int32 absolute position. Returns
    ``(logits (B, V), caches)``; the caches are updated in place."""
    period_plan, _, tail_plan = split_plan(cfg)
    x = _embed(params, cfg, token[:, None])

    def period_body(h, inp):
        pp, pc = inp
        for i, kind in enumerate(period_plan):
            h, _ = apply_layer_decode(pp[f"sub_{i}"], h, pc[f"sub_{i}"], pos,
                                      cfg, kind)
        return h, None

    x, _ = run_periods(period_body, x, (params["layers"], caches["layers"]),
                       cfg=cfg)
    for i, kind in enumerate(tail_plan):
        x, _ = apply_layer_decode(params["tail"][f"layer_{i}"], x,
                                  caches["tail"][f"layer_{i}"], pos, cfg, kind)
    x = L.apply_norm(cfg.norm, params["final_norm"], x)
    logits = L.unembed(params["embedding"], x, true_vocab=cfg.vocab, cfg=cfg)
    return logits[:, 0, :], caches
