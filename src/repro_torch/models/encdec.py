"""Whisper-style encoder-decoder backbone [arXiv:2212.04356]: the
counterpart of ``repro.models.encdec``.

The conv/mel frontend is a stub: the inputs are precomputed frame
embeddings (B, enc_frames, d_model). Positions are sinusoidal. The decode
caches are, per decoder layer, a growing self-attention KV cache and the
cross-attention K/V computed once from the encoder output.

Under ``attn_impl="pallas"`` the encoder's (non-causal) and the decoder's
(causal) prefill self-attention run the flash kernel, and the decoder's
self-attention decode the decode kernel (as the dense family's, ROADMAP
queue 3 "the decode route"); cross-attention is plain PyTorch, as it is
plain XLA in ``repro``.

Dtypes (hazard H23): the encoder computes in the promoted dtype of its
frames and its weights, as JAX's promotion makes ``repro``'s do: float32
frames run a bf16 model's encoder in float32, its weights cast to float32
layer by layer (torch promotes no matmul). The decoder computes in the
model's dtype: the cross K/V are projected from the encoder states in
their dtype and held in the model's, the dtype ``make_caches`` holds them
in. ``repro``'s bf16 decoder has no result to follow there: the float32
cross-attention turns its layer scan's carry float32, and the scan raises.
"""
from __future__ import annotations

import math
from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as TF
from repro_torch.models.module import (Draws, cast_tree, dtype_of,
                                       run_periods, stack_draws)

Params = Dict[str, Any]


def _sin_freqs(d_model: int) -> np.ndarray:
    dim = d_model // 2
    return np.exp(-np.log(10000.0) * np.arange(dim, dtype=np.float32)
                  / dim).astype(np.float32)


def sinusoidal(positions: torch.Tensor, d_model: int, dtype) -> torch.Tensor:
    ang = positions.to(torch.float32)[..., None] * L._on_device(
        _sin_freqs, d_model, device=positions.device)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)


def _init_enc_layer(gen, cfg: ArchConfig, dt):
    d, dev = cfg.d_model, gen.device
    return {"ln1": L.init_norm(cfg.norm, d, dt, dev),
            "attn": L.init_attention(gen, cfg, dt),
            "ln2": L.init_norm(cfg.norm, d, dt, dev),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.act, dt)}


def _init_dec_layer(gen, cfg: ArchConfig, dt):
    d, dev = cfg.d_model, gen.device
    return {"ln1": L.init_norm(cfg.norm, d, dt, dev),
            "self_attn": L.init_attention(gen, cfg, dt),
            "ln_x": L.init_norm(cfg.norm, d, dt, dev),
            "cross_attn": L.init_attention(gen, cfg, dt),
            "ln2": L.init_norm(cfg.norm, d, dt, dev),
            "mlp": L.init_mlp(gen, d, cfg.d_ff, cfg.act, dt)}


def init_encdec(gen, cfg: ArchConfig, vocab_pad_multiple: int = 1, *,
                device=None) -> Params:
    """Random weights at ``cfg``'s shapes, drawn from ``gen`` onto
    ``device`` as ``transformer.init_lm`` draws them."""
    gen = Draws.of(gen, device)
    dt, d, dev = dtype_of(cfg.dtype), cfg.d_model, gen.device
    return {
        "embedding": L.init_embedding(gen, TF.padded_vocab(
            cfg, vocab_pad_multiple), d, dt, cfg.tie_embeddings),
        "enc_layers": stack_draws(cfg.n_enc_layers,
                                  lambda: _init_enc_layer(gen, cfg, dt)),
        "dec_layers": stack_draws(cfg.n_layers,
                                  lambda: _init_dec_layer(gen, cfg, dt)),
        "enc_final": L.init_norm(cfg.norm, d, dt, dev),
        "dec_final": L.init_norm(cfg.norm, d, dt, dev),
    }


def _self_attn(p, x, cfg: ArchConfig, causal: bool):
    q, k, v = L.qkv(p, x, cfg)
    ctx = L.attention_any(q, L.expand_kv(k, cfg), L.expand_kv(v, cfg),
                          causal=causal, impl=cfg.attn_impl,
                          chunk=cfg.attn_chunk)
    return L.out_proj(p, ctx, cfg), k, v


def _cross_kv(p, enc_out, dtype, cfg=None):
    """The encoder states' cross K/V (B, F, KV, Dh), projected in the
    states' dtype and held in ``dtype``."""
    return tuple(L.head_proj(enc_out, p[w].to(enc_out.dtype), cfg,
                             None).to(dtype) for w in ("wk", "wv"))


def _cross_attn(p, x, k, v, cfg: ArchConfig):
    """Unmasked attention of x's queries over the encoder's unexpanded k/v
    (B, F, KV, Dh), plain PyTorch."""
    q = L.head_proj(L.constrain(x, cfg, ("batch", None, None)), p["wq"],
                    cfg, L.head_label(cfg))
    q = L.constrain(q, cfg, ("batch", None, L.head_label(cfg), None))
    ke, ve = L.expand_kv(k, cfg), L.expand_kv(v, cfg)
    pl = tuple(q.placements) if L.is_dtensor(q) else None
    ctx = L.shard_local(_cross_core, pl, (pl, pl, pl), q, ke, ve)
    return L.out_proj(p, ctx, cfg)


def _cross_core(q, ke, ve):
    """Unmasked attention of q (B, S, H, Dh) over ke, ve (B, F, H, Dh);
    each (batch, head) on its own."""
    s = torch.einsum("bqhd,bshd->bhqs", q, ke).to(torch.float32)
    pa = torch.softmax(s / math.sqrt(q.shape[-1]), dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", pa, ve)


def _mlp(p, x, cfg: ArchConfig):
    return x + L.apply_mlp(p["mlp"], L.apply_norm(cfg.norm, p["ln2"], x),
                           cfg.act, cfg)


def encode(params, frames, cfg: ArchConfig) -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings -> encoder states, in the
    promoted dtype of the frames and the weights (H23)."""
    dt = torch.promote_types(frames.dtype, dtype_of(cfg.dtype))
    x = (frames + sinusoidal(torch.arange(frames.shape[1],
                                          device=frames.device)[None, :],
                             cfg.d_model, frames.dtype)).to(dt)

    def body(h, p):
        p = cast_tree(p, dt)
        a, _, _ = _self_attn(p["attn"], L.apply_norm(cfg.norm, p["ln1"], h),
                             cfg, causal=False)
        return _mlp(p, h + a, cfg), None

    x, _ = run_periods(body, x, params["enc_layers"], cfg=cfg)
    return L.apply_norm(cfg.norm, cast_tree(params["enc_final"], dt), x)


def _embed_dec(params, tokens, positions, cfg: ArchConfig):
    x = L.embed(params["embedding"], tokens)
    x = L.constrain(x, cfg, L.residual_dims(cfg, x.shape[1]))
    return x + sinusoidal(positions, cfg.d_model, x.dtype)


def _dec_layer(p, x, enc_out, cfg: ArchConfig):
    """One decoder layer over the whole prefix; returns the new residual and
    the layer's decode cache."""
    a, k, v = _self_attn(p["self_attn"], L.apply_norm(cfg.norm, p["ln1"], x),
                         cfg, causal=True)
    x = x + a
    kx, vx = _cross_kv(p["cross_attn"], enc_out, x.dtype, cfg)
    x = x + _cross_attn(p["cross_attn"], L.apply_norm(cfg.norm, p["ln_x"], x),
                        kx, vx, cfg)
    return _mlp(p, x, cfg), {"self_k": k, "self_v": v, "cross_k": kx,
                             "cross_v": vx}


def _decoder(params, frames, tokens, cfg: ArchConfig):
    enc_out = encode(params, frames, cfg)
    positions = torch.arange(tokens.shape[1], device=tokens.device)[None, :]
    x = _embed_dec(params, tokens, positions, cfg)
    x, caches = run_periods(lambda h, p: _dec_layer(p, h, enc_out, cfg), x,
                            params["dec_layers"], cfg=cfg)
    return L.apply_norm(cfg.norm, params["dec_final"], x), caches


def encdec_forward(params, frames, tokens, cfg: ArchConfig) -> torch.Tensor:
    """Teacher-forcing forward -> logits (B, S, vocab)."""
    x, _ = _decoder(params, frames, tokens, cfg)
    return L.unembed(params["embedding"], x, true_vocab=cfg.vocab, cfg=cfg)


def encdec_loss(params, batch, cfg: ArchConfig) -> torch.Tensor:
    logits = encdec_forward(params, batch["frames"], batch["tokens"], cfg)
    return L.cross_entropy(logits, batch["labels"], cfg)


# ---------------------------------------------------------------------------
# Inference
# ---------------------------------------------------------------------------
def init_encdec_caches(cfg: ArchConfig, batch: int, cache_len: int, *,
                       device) -> Params:
    dt = dtype_of(cfg.dtype)
    kv = (cfg.n_layers, batch, cache_len, cfg.n_kv_heads, cfg.hd)
    xkv = (cfg.n_layers, batch, cfg.enc_frames, cfg.n_kv_heads, cfg.hd)
    return {"self_k": torch.zeros(kv, dtype=dt, device=device),
            "self_v": torch.zeros(kv, dtype=dt, device=device),
            "cross_k": torch.zeros(xkv, dtype=dt, device=device),
            "cross_v": torch.zeros(xkv, dtype=dt, device=device)}


def encdec_prefill(params, frames, tokens, cfg: ArchConfig):
    """Encode, run the decoder over the prefix -> (last-position logits (B,
    1, V), decode caches)."""
    x, caches = _decoder(params, frames, tokens, cfg)
    logits = L.unembed(params["embedding"], x[:, -1:, :], true_vocab=cfg.vocab,
                       cfg=cfg)
    # the caches placed as the prefill's outputs are (plain: as they are)
    caches = {k: L.constrain(c, cfg, (None,) + L.cache_dims(cfg, c.shape[3]))
              for k, c in caches.items()}
    return logits, caches


def encdec_decode_step(params, caches, token, pos, cfg: ArchConfig):
    """One decoder token against the caches, whose self-attention K/V it
    writes in place. Returns ``(logits (B, V), caches)``."""
    x = _embed_dec(params, token[:, None], pos[:, None], cfg)
    rows = torch.arange(token.shape[0], device=token.device)
    slot = pos.to(torch.int64)

    def body(h, inp):
        p, c = inp
        q, k, v = L.qkv(p["self_attn"], L.apply_norm(cfg.norm, p["ln1"], h),
                        cfg)
        q = L.constrain(q, cfg, ("batch", None, None, None))
        kc, vc = c["self_k"], c["self_v"]
        if L.is_dtensor(kc):
            TF.write_token(kc, slot, k[:, 0])
            TF.write_token(vc, slot, v[:, 0])
        else:
            kc.index_put_((rows, slot), k[:, 0])
            vc.index_put_((rows, slot), v[:, 0])
        if cfg.attn_impl == "pallas":
            ctx = TF._decode_kernel_route(q, kc, vc, pos, cfg)
        else:
            ctx = L.decode_attention(q, L.expand_kv(kc, cfg, decode=True),
                                     L.expand_kv(vc, cfg, decode=True), pos)
        h = h + L.out_proj(p["self_attn"], ctx, cfg)
        h = h + _cross_attn(p["cross_attn"],
                            L.apply_norm(cfg.norm, p["ln_x"], h),
                            c["cross_k"], c["cross_v"], cfg)
        return _mlp(p, h, cfg), None

    x, _ = run_periods(body, x, (params["dec_layers"], caches), cfg=cfg)
    x = L.apply_norm(cfg.norm, params["dec_final"], x)
    logits = L.unembed(params["embedding"], x, true_vocab=cfg.vocab, cfg=cfg)
    return logits[:, 0, :], caches
