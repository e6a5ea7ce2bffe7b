"""Transformer layer library: norms, RoPE, GQA/MQA attention, gated MLPs.

The counterpart of ``repro.models.layers``, function for function, with
``repro``'s layouts and cast points. Attention is computed in the
full-head layout (B, S, H, Dh) with KV heads expanded by a static gather
(GQA repeat). Strategies:

  * ``full``     — one einsum + softmax;
  * ``chunked``  — flash-style online softmax over KV blocks with causal
                   block skipping (forward only);
  * ``pallas``   — the hand-written flash kernel pair (forward and
                   backward) through
                   :func:`repro_torch.kernels.ops.flash_attention` (the
                   plain versions on the CPU);
  * ``auto``     — ``pallas`` for a CUDA bf16 q with Dh 64 or 128
                   (:func:`flash_route`), else ``full`` up to 2048
                   positions and ``chunked`` beyond;
  * ``decode``   — single-query attention against a KV cache.

``repro`` annotates activations with sharding constraints from logical
dim labels (``constrain``), and the port calls :func:`constrain` at the
same places. The labels resolve to per-dim specs (:func:`constrain_spec`,
:func:`head_label`, :func:`residual_dims`); on a DTensor (a tensor placed
over a torch ``DeviceMesh``) :func:`constrain` redistributes it to its
spec's placements, as ``with_sharding_constraint`` does, and a plain
tensor passes through it as it is. Where an op has no DTensor rule the
op takes a form both run (:func:`unembed`'s pad mask, :func:`head_proj`),
or the DTensor path its own (:func:`cross_entropy`, whose plain path keeps
its ``gather``).
All softmax/normalization accumulation is float32 whatever the
activation dtype.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import BACKWARD_HEAD_DIMS
from repro_torch.models.module import (Draws, dense_init, fsdp_gather,
                                      is_dtensor, normal)


# --------------------------------------------------------------------------
# Activation sharding constraints (the specs only)
# --------------------------------------------------------------------------
def constrain_spec(shape: Sequence[int], cfg, dims: Sequence[Optional[str]]
                   ) -> Optional[Tuple]:
    """``repro``'s ``constrain`` spec for a tensor of ``shape``: one entry
    per dim, ``None``, a mesh axis name or a tuple of names, from the
    labels ``dims``: "batch" (pod+data, else data, else None), "tp" (model
    where divisible), "fsdp" (data where divisible), "sp" (model, where
    ``cfg.seq_shard_acts`` and divisible), None. Each mesh axis at most
    once per tensor. ``None`` (no constraint) unless ``cfg.shard_acts``
    and ``cfg.mesh_axes`` are set."""
    if not getattr(cfg, "shard_acts", False) or not cfg.mesh_axes:
        return None
    sizes = dict(cfg.mesh_axes)
    spec, used = [], set()

    def fits(size, n):
        return size % n == 0 and size >= n

    for label, size in zip(dims, shape):
        entry = None
        if label == "batch" and "data" not in used:
            ba = tuple(a for a in ("pod", "data") if a in sizes)
            n = int(np.prod([sizes[a] for a in ba])) if ba else 1
            if ba and fits(size, n):
                entry = ba if len(ba) > 1 else ba[0]
            elif "data" in sizes and fits(size, sizes["data"]):
                entry = "data"
        elif label in ("tp", "sp") and "model" not in used:
            ok = fits(size, sizes.get("model", 1))
            if label == "sp":
                ok = ok and getattr(cfg, "seq_shard_acts", False)
            entry = "model" if ok else None
        elif label == "fsdp" and "data" not in used:
            entry = "data" if fits(size, sizes.get("data", 1)) else None
        if entry is not None:
            used.update((entry,) if isinstance(entry, str) else entry)
        spec.append(entry)
    return tuple(spec)


def placements_for(x, cfg, dims: Sequence[Optional[str]]):
    """The DTensor placements of :func:`constrain_spec` for ``x`` (a
    DTensor) over its mesh; ``None`` where there is no constraint."""
    spec = constrain_spec(x.shape, cfg, dims)
    if spec is None:
        return None
    from repro_torch.distributed.sharding import to_placements
    mesh = x.device_mesh
    return to_placements(spec, tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def constrain(x: torch.Tensor, cfg, dims: Sequence[Optional[str]]
              ) -> torch.Tensor:
    """``repro``'s ``with_sharding_constraint`` by logical labels: a
    DTensor redistributed to the placements of :func:`constrain_spec`
    (an axis the spec leaves out is replicated), and its gradient
    redistributed to the same placements in the backward, as the
    constraint's transpose pins the cotangent in JAX; a plain tensor, or
    no mesh context on ``cfg``, passes through unchanged."""
    if cfg is None or not is_dtensor(x):
        return x
    placements = placements_for(x, cfg, dims)
    if placements is None:
        return x
    if tuple(x.placements) != placements:
        x = x.redistribute(x.device_mesh, placements)
    if x.requires_grad:
        x = _GradPlacedLike.apply(x)
    return x


class _GradPlacedLike(torch.autograd.Function):
    """The identity on a DTensor whose gradient is redistributed to the
    forward's placements: a constraint's transpose, and what a view's
    backward (an unflatten) needs to find a layout the forward could
    take. A gradient that is a partial sum over an axis the forward
    replicates stays one (its reduction waits for the layout it ends in:
    a gathered weight's gradient is reduce-scattered to its shards, not
    all-reduced first)."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        want = tuple(p if p.is_partial() and f.is_replicate() else f
                     for p, f in zip(g.placements, ctx.placements))
        if tuple(g.placements) == want:
            return g
        return g.redistribute(ctx.mesh, want)


def shard_local(fn, out_placements, in_placements, *args):
    """``fn(*args)`` on plain tensors; on DTensors, ``fn`` on each rank's
    local shards (``local_map``): each tensor argument redistributed to its
    entry of ``in_placements`` (``None`` for a non-tensor), each output
    placed by its entry of ``out_placements`` (one tuple of placements for
    one output). An input replicated over a mesh axis that some output is
    split over gets its gradient as a ``Partial`` sum there (each rank adds
    only its own part); the others get theirs in their own placements. For
    an op with no DTensor rule whose work is local to a shard (attention
    over a batch and head shard, a row's routing, the SSD chunks)."""
    mesh = next((a.device_mesh for a in args if is_dtensor(a)), None)
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Placement, Replicate
    from torch.distributed.tensor.experimental import local_map
    outs = ([out_placements] if out_placements
            and isinstance(out_placements[0], Placement) else out_placements)
    split = [any(o is not None and not isinstance(o[i], Replicate)
                 for o in outs) for i in range(mesh.ndim)]
    grads = [None if pl is None else tuple(
        Partial() if isinstance(p, Replicate) and split[i] else p
        for i, p in enumerate(pl)) for pl in in_placements]
    if outs is not out_placements:
        out_placements = list(out_placements)  # one output
    return local_map(fn, out_placements=out_placements,
                     in_placements=in_placements, in_grad_placements=grads,
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def model_axis(cfg) -> int:
    """The size of the mesh's model axis in ``cfg.mesh_axes`` (1 without
    one)."""
    return dict(cfg.mesh_axes).get("model", 1) if cfg.mesh_axes else 1


def cache_dims(cfg, n_kv: int) -> Tuple[Optional[str], ...]:
    """The labels of one layer's (B, S, KV, Dh) decode cache, as
    ``sharding.cache_pspecs`` places it (``repro``'s ``out_shardings`` of a
    prefill): the kv heads over the model axis where they divide it, else
    the sequence."""
    return (("batch", None, "tp", None) if n_kv % model_axis(cfg) == 0
            else ("batch", "tp", None, None))


def head_label(cfg) -> Optional[str]:
    """Sharding label for the attention-head dim under the current mode."""
    return "tp" if cfg.attn_mode in ("head", "padded") else None


def residual_dims(cfg, seq_len: int):
    """Residual-stream constraint labels: decode (seq 1) shards d_model
    over data; otherwise the sequence over model (sequence parallel)."""
    if seq_len == 1:
        return ("batch", None, "fsdp")
    return ("batch", "sp", None)


# --------------------------------------------------------------------------
# Norms (reduction in float32, the elementwise multiply in the input dtype,
# as ``repro``)
# --------------------------------------------------------------------------
def init_rmsnorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p, x, eps: float = 1e-6):
    xf = x.to(torch.float32)
    inv = torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return x * inv.to(x.dtype) * p["scale"]


def init_layernorm(d: int, dtype, device):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x, eps: float = 1e-5):
    xf = x.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps)
    out = (x - mu.to(x.dtype)) * inv.to(x.dtype)
    return out * p["scale"] + p["bias"]


def apply_norm(kind: str, p, x):
    return rmsnorm(p, x) if kind == "rmsnorm" else layernorm(p, x)


def init_norm(kind: str, d: int, dtype, device):
    return (init_rmsnorm(d, dtype, device) if kind == "rmsnorm"
            else init_layernorm(d, dtype, device))


# --------------------------------------------------------------------------
# Rotary position embeddings (llama half-split; ``rotary_dim`` < head_dim
# gives the partial/2d rotary used by ChatGLM)
# --------------------------------------------------------------------------
def rope_freqs(head_dim: int, rotary_dim: int, theta: float) -> np.ndarray:
    dim = rotary_dim // 2
    return 1.0 / (theta ** (np.arange(0, dim, dtype=np.float32) * 2.0 / rotary_dim))


@functools.lru_cache(maxsize=None)
def _on_device(fn, *args, device) -> torch.Tensor:
    """``torch.from_numpy(fn(*args))`` on ``device``, made once: a copy from
    the host on every call would stall the host on the card's queue."""
    return torch.from_numpy(fn(*args)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               rotary_dim: Optional[int] = None) -> torch.Tensor:
    """x: (B, S, ..., Dh); positions: (B, S) or (S,). A DTensor ``x`` is
    rotated shard by shard (the positions follow its batch shards)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        pl = tuple(x.placements)
        pos_pl = None
        if is_dtensor(positions):
            pos_pl = tuple(Shard(0) if p == Shard(0) and positions.dim() == 2
                           else Replicate() for p in pl)
        if any(isinstance(p, Shard) and p.dim == 1 for p in pl):
            raise ValueError(f"apply_rope: the sequence is sharded ({pl})")
        return shard_local(
            lambda x_, p_: apply_rope(x_, p_, theta, rotary_dim),
            pl, (pl, pos_pl), x, positions)
    dh = x.shape[-1]
    rd = rotary_dim or dh
    freqs = _on_device(rope_freqs, dh, rd, theta, device=x.device)
    pos = positions.to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[..., None] * freqs  # (B, S, rd/2)
    for _ in range(x.dim() - 3):
        angles = angles[:, :, None]
    cos, sin = torch.cos(angles), torch.sin(angles)
    x_rot, x_pass = x[..., :rd], x[..., rd:]
    x1, x2 = x_rot[..., : rd // 2], x_rot[..., rd // 2:]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.cat([r1.to(x.dtype), r2.to(x.dtype), x_pass], dim=-1)


# --------------------------------------------------------------------------
# Attention
# --------------------------------------------------------------------------
def init_attention(gen: Draws, cfg, dtype):
    """Q/O padded to cfg.padded_heads (zero rows keep the math exact)."""
    d, H, Hp, KV, Dh = (cfg.d_model, cfg.n_heads, cfg.padded_heads,
                        cfg.n_kv_heads, cfg.hd)
    wq = dense_init(gen, d, (H, Dh), dtype)
    wk = dense_init(gen, d, (KV, Dh), dtype)
    wv = dense_init(gen, d, (KV, Dh), dtype)
    wo = normal(gen, (H, Dh, d), 1.0 / math.sqrt(H * Dh), dtype)
    if Hp != H:
        wq = torch.cat([wq, wq.new_zeros((d, Hp - H, Dh))], dim=1)
        wo = torch.cat([wo, wo.new_zeros((Hp - H, Dh, d))], dim=0)
    return {"wq": wq, "wk": wk, "wv": wv, "wo": wo}


def _pinned(w):
    """A DTensor weight whose gradient keeps its placements
    (:class:`_GradPlacedLike`); a plain tensor as it is."""
    return _GradPlacedLike.apply(w) if is_dtensor(w) else w


def head_proj(x, w, cfg, label: Optional[str]):
    """``einsum("bsd,dhe->bshe", x, w)`` as one product over the flattened
    (h, e) dim, on a DTensor constrained to the heads' placement before it
    is unflattened (DTensor's einsum may shard the flattened dim over an
    axis the heads do not divide, and then cannot unflatten it)."""
    spec = constrain_spec((x.shape[0], x.shape[1], w.shape[1], w.shape[2]),
                          cfg, ("batch", None, label, None))
    y = torch.matmul(x, _pinned(w.flatten(1)))
    y = constrain(y, cfg, ("batch", None,
                           "tp" if spec and spec[2] is not None else None))
    return y.unflatten(-1, tuple(w.shape[1:]))


def qkv(p, x, cfg=None):
    """Project to q:(B,S,Hp,Dh) and unexpanded k/v:(B,S,KV,Dh)."""
    hl = head_label(cfg) if cfg is not None else None
    x = constrain(x, cfg, ("batch", None, None))  # one gather for all 3
    return (head_proj(x, p["wq"], cfg, hl), head_proj(x, p["wk"], cfg, None),
            head_proj(x, p["wv"], cfg, None))


def expand_kv(k: torch.Tensor, cfg, decode: bool = False) -> torch.Tensor:
    """(B,S,KV,Dh) -> (B,S,Hp,Dh) static GQA gather (padded heads map to
    their group's kv head; their q rows are zero). ``decode`` keeps the
    sequence dim over the model axis (a decode streams the cache with the
    heads replicated), as ``repro``'s."""
    dims = (("batch", "tp", None, None) if decode
            else ("batch", None, head_label(cfg), None))
    if is_dtensor(k):
        return _expand_kv_sharded(k, cfg, dims)
    out = k.index_select(2, _on_device(cfg.kv_head_map, device=k.device))
    return constrain(out, cfg, dims)


def _expand_kv_sharded(k, cfg, dims):
    """:func:`expand_kv` of a DTensor, on each rank's shard (an
    ``index_select`` backward has no DTensor rule in some torch versions):
    the output placed by ``dims``, k with its kv heads whole, each rank
    gathering the heads of its own slice of the map."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset

    from repro_torch.distributed.sharding import to_placements

    idx = _on_device(cfg.kv_head_map, device=k.device)
    shape = tuple(k.shape[:2]) + (idx.numel(),) + tuple(k.shape[3:])
    spec = constrain_spec(shape, cfg, dims)
    mesh = k.device_mesh
    out_pl = to_placements(spec, tuple(mesh.mesh_dim_names),
                           tuple(mesh.shape))
    in_pl = tuple(Replicate() if p == Shard(2) else p for p in out_pl)
    local, off = compute_local_shape_and_global_offset(shape, mesh, out_pl)
    mine = idx[off[2]:off[2] + local[2]]
    return shard_local(lambda k_: k_.index_select(2, mine), out_pl,
                       (in_pl,), k)


def out_proj(p, ctx, cfg=None):
    """ctx: (B,S,Hp,Dh) -> (B,S,d), one product over the flattened (h, e)
    dim, the heads major (an einsum may flatten them in the other order,
    which some torch versions refuse over sharded DTensor heads)."""
    y = torch.matmul(ctx.flatten(2), _pinned(p["wo"].flatten(0, 1)))
    if cfg is None:
        return y
    return constrain(y, cfg, residual_dims(cfg, y.shape[1]))


def _mask(Sq: int, Sk: int, *, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def full_attention(q, k, v, *, causal: bool, window: int = 0,
                   q_offset: int = 0) -> torch.Tensor:
    """Dense-scores attention; q,k,v: (B,S,H,Dh) (kv pre-expanded). The
    scores round through the input dtype before the float32 softmax, and p
    is cast back to it before PV, as ``repro`` (hazard H11); a fully masked
    row is NaN, as ``repro`` (H12)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bshd->bhqs", q, k).to(torch.float32) * scale
    mask = _mask(q.shape[1], k.shape[1], causal=causal, window=window,
                 q_offset=q_offset, device=q.device)
    s = s.masked_fill(~mask, -math.inf)
    p_attn = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p_attn, v)


def _flash_block(q_blk, k_blk, v_blk, carry, q_lo, k_lo, causal, window,
                 scale, k_valid):
    """One online-softmax block update (``repro``'s ``_flash_block``)."""
    m, l, acc = carry
    s = torch.einsum("bqhd,bshd->bhqs", q_blk, k_blk).to(torch.float32) * scale
    mask = _mask(q_blk.shape[1], k_blk.shape[1], causal=causal,
                 window=window, q_offset=q_lo - k_lo, device=q_blk.device)
    if k_valid is not None:
        kpos = k_lo + torch.arange(k_blk.shape[1], device=q_blk.device)
        mask &= (kpos < k_valid)[None, :]  # padded keys
    s = s.masked_fill(~mask, -math.inf)
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - m_safe[..., None]).masked_fill(~mask, 0.0)
    corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe),
                       torch.zeros_like(m))
    l_new = l * corr + p.sum(dim=-1)
    acc_new = acc * corr[..., None] + torch.einsum(
        "bhqs,bshd->bhqd", p.to(v_blk.dtype), v_blk).to(torch.float32)
    return m_new, l_new, acc_new


def chunked_attention(q, k, v, *, causal: bool, window: int = 0,
                      q_chunk: int = 1024, k_chunk: int = 1024,
                      q_offset: int = 0) -> torch.Tensor:
    """Flash-style attention over KV chunks with causal block skipping
    (forward only: ``repro``'s ``unroll=True`` form, with static skipping)."""
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    q_chunk, k_chunk = min(q_chunk, Sq), min(k_chunk, Sk)
    Sq_pad = -(-Sq // q_chunk) * q_chunk
    Sk_pad = -(-Sk // k_chunk) * k_chunk
    # padded keys sit at positions >= Sk (masked); padded query rows are
    # sliced off at the end
    q = F.pad(q, (0, 0, 0, 0, 0, Sq_pad - Sq))
    k = F.pad(k, (0, 0, 0, 0, 0, Sk_pad - Sk))
    v = F.pad(v, (0, 0, 0, 0, 0, Sk_pad - Sk))
    nk = Sk_pad // k_chunk
    scale = 1.0 / math.sqrt(Dh)
    k_valid = None if Sk_pad == Sk else Sk
    outs = []
    for qi in range(Sq_pad // q_chunk):
        q_blk = q[:, qi * q_chunk:(qi + 1) * q_chunk]
        q_lo = qi * q_chunk + q_offset
        hi = min((q_lo + q_chunk + k_chunk - 1) // k_chunk, nk) if causal else nk
        lo = max((q_lo - window + 1) // k_chunk, 0) if window else 0
        carry = (torch.full((B, H, q_chunk), -math.inf, device=q.device),
                 torch.zeros((B, H, q_chunk), device=q.device),
                 torch.zeros((B, H, q_chunk, Dh), device=q.device))
        for j in range(lo, hi):
            sl = slice(j * k_chunk, (j + 1) * k_chunk)
            carry = _flash_block(q_blk, k[:, sl], v[:, sl], carry, q_lo,
                                 j * k_chunk, causal, window, scale, k_valid)
        _, l, acc = carry
        outs.append((acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype))
    out = torch.cat(outs, dim=2)[:, :, :Sq]  # (B,H,Sq,Dh)
    return out.permute(0, 2, 1, 3)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """Single-token attention. q: (B,1,H,Dh); caches (B,S,H,Dh) expanded;
    pos: (B,). Entries at positions > pos are masked."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bshd->bhqs", q, k_cache).to(torch.float32) * scale
    S = k_cache.shape[1]
    mask = torch.arange(S, device=q.device)[None, :] <= pos[:, None]  # (B,S)
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p_attn = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bhqs,bshd->bqhd", p_attn, v_cache)


def flash_route(device_type: str, dtype: torch.dtype, head_dim: int) -> bool:
    """``auto``'s choice of the flash kernel pair (forward and backward):
    a CUDA bf16 q with a head dim the backward kernel takes, with or
    without a gradient. Everything else (the CPU, float32, Dh 256) stays on
    the plain routes."""
    return (device_type == "cuda" and dtype == torch.bfloat16
            and head_dim in BACKWARD_HEAD_DIMS)


def attention_any(q, k, v, *, causal: bool, window: int = 0,
                  impl: str = "auto", q_offset: int = 0,
                  chunk: int = 1024) -> torch.Tensor:
    if is_dtensor(q):
        # each (batch, head) shard attends on its own: the route runs on
        # the local shards, k and v placed as q is
        pl = tuple(q.placements)
        return shard_local(
            lambda q_, k_, v_: attention_any(
                q_, k_, v_, causal=causal, window=window, impl=impl,
                q_offset=q_offset, chunk=chunk),
            pl, (pl, pl, pl), q, k, v)
    if impl == "auto":
        if flash_route(q.device.type, q.dtype, q.shape[-1]):
            impl = "pallas"
        else:
            impl = "chunked" if max(q.shape[1], k.shape[1]) > 2048 else "full"
    if impl == "pallas":
        from repro_torch.kernels import ops as KOPS
        return KOPS.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset)
    if impl == "full":
        return full_attention(q, k, v, causal=causal, window=window,
                              q_offset=q_offset)
    if impl == "chunked":
        return chunked_attention(q, k, v, causal=causal, window=window,
                                 q_chunk=chunk, k_chunk=chunk,
                                 q_offset=q_offset)
    raise ValueError(f"unknown attn_impl {impl!r}: use auto, full, chunked "
                     f"or pallas")


# --------------------------------------------------------------------------
# The recurrent blocks' pieces (``repro``'s ssm and rglru modules each keep
# their own copy)
# --------------------------------------------------------------------------
def causal_conv(x, w, b):
    """Depthwise causal conv over time plus bias: x (B,S,C), w (K,C), summed
    tap by tap from the oldest, as ``repro``. A DTensor x is convolved on
    each rank's (batch, channel) shard, its whole sequence gathered first
    (a DTensor ``pad`` has no plan in some torch versions)."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        pl = tuple(Replicate() if p == Shard(1) else p for p in x.placements)
        chan = (Shard(2),)
        wpl = tuple(Shard(1) if p in chan else Replicate() for p in pl)
        bpl = tuple(Shard(0) if p in chan else Replicate() for p in pl)
        return shard_local(causal_conv, pl, (pl, wpl, bpl), x, w, b)
    K, S = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, K - 1, 0))
    out = 0
    for i in range(K):
        out = out + pad[:, i:i + S, :] * w[i]
    return out + b


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros_like(x))


# --------------------------------------------------------------------------
# MLPs
# --------------------------------------------------------------------------
def init_mlp(gen: Draws, d_model: int, d_ff: int, act: str, dtype):
    if act in ("silu", "geglu"):  # gated: gate + up + down
        return {"wg": dense_init(gen, d_model, (d_ff,), dtype),
                "wu": dense_init(gen, d_model, (d_ff,), dtype),
                "wd": dense_init(gen, d_ff, (d_model,), dtype)}
    return {"w1": dense_init(gen, d_model, (d_ff,), dtype),
            "w2": dense_init(gen, d_ff, (d_model,), dtype)}


def _gelu(x):
    return F.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def apply_mlp(p, x, act: str, cfg=None):
    x = constrain(x, cfg, ("batch", None, None))  # sequence-parallel gather
    if act in ("silu", "geglu"):
        g = torch.einsum("bsd,df->bsf", x, p["wg"])
        u = torch.einsum("bsd,df->bsf", x, p["wu"])
        g = constrain(g, cfg, ("batch", None, "tp"))
        u = constrain(u, cfg, ("batch", None, "tp"))
        g = F.silu(g) if act == "silu" else _gelu(g)
        y = torch.einsum("bsf,fd->bsd", g * u, p["wd"])
    else:
        h = _gelu(torch.einsum("bsd,df->bsf", x, p["w1"]))
        h = constrain(h, cfg, ("batch", None, "tp"))
        y = torch.einsum("bsf,fd->bsd", h, p["w2"])
    if cfg is None:
        return y
    return constrain(y, cfg, residual_dims(cfg, y.shape[1]))


# --------------------------------------------------------------------------
# Embedding / unembedding
# --------------------------------------------------------------------------
def init_embedding(gen: Draws, vocab: int, d_model: int, dtype,
                   tie: bool):
    # GPT-style 0.02 std keeps tied-unembed logits O(1) at init
    p = {"embed": normal(gen, (vocab, d_model), 0.02, dtype)}
    if not tie:
        p["unembed"] = dense_init(gen, d_model, (vocab,), dtype)
    return p


def embed(p, tokens, scale_by_dim: bool = False):
    table = fsdp_gather(p["embed"])
    # a DTensor lookup takes ``embedding``, whose vocab-sharded rule every
    # torch version has (an index op's does not)
    x = F.embedding(tokens, table) if is_dtensor(table) else table[tokens]
    if scale_by_dim:  # sqrt(d) rounded to x's dtype first, as ``repro``
        x = x * torch.tensor(np.sqrt(x.shape[-1]), dtype=x.dtype).item()
    return x


def unembed(p, x, true_vocab: Optional[int] = None, cfg=None):
    if is_dtensor(x):  # the whole sequence against the vocab shards
        x = constrain(x, cfg, ("batch", None, None))
        if x.shape[1] != 1:  # one position reads the weights in place
            p = {k: fsdp_gather(w) for k, w in p.items()}
    if "unembed" in p:
        logits = torch.einsum("bsd,dv->bsv", x, p["unembed"])
    else:
        logits = torch.einsum("bsd,vd->bsv", x, p["embed"])
    logits = constrain(logits, cfg, ("batch", None, "tp"))
    if true_vocab is not None and logits.shape[-1] != true_vocab:
        # the pad columns masked by ``where`` (no DTensor rule writes a
        # vocab-sharded slice)
        V = logits.shape[-1]
        pad = torch.arange(V, device=logits.device) >= true_vocab
        logits = torch.where(pad, torch.full((), -1e9, dtype=logits.dtype,
                                             device=logits.device), logits)
    return logits


def _vocab_ids(logits):
    """``arange(V)`` as a DTensor placed as the last dim of ``logits`` (a
    DTensor): each rank makes its own vocabulary slice, no collective."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    V = logits.shape[-1]
    pl = tuple(Shard(0) if p == Shard(logits.dim() - 1) else Replicate()
               for p in logits.placements)
    return distribute_tensor(torch.arange(V, device=logits.device),
                             logits.device_mesh, pl, src_data_rank=None)


def cross_entropy(logits, labels, cfg=None):
    """Mean of logsumexp − the label's logit, in float32. The label's logit
    is a ``gather``; on a DTensor it is ``repro``'s select-and-sum, the hit
    mask constrained like the logits, so a vocab-sharded row stays on its
    shard (a ``gather`` has no DTensor rule over a sharded vocab). The
    select-and-sum makes a (B, S, V) float32 temporary, which the plain
    path does not."""
    lf = logits.to(torch.float32)
    if not is_dtensor(logits):
        lse = torch.logsumexp(lf, dim=-1)
        label_logit = lf.gather(-1, labels[..., None].to(torch.int64))[..., 0]
        return (lse - label_logit).mean()
    # logsumexp as max, exp-sum and log, each reducible over the vocab
    # shards (DTensor's logsumexp gathers the whole vocabulary first); each
    # (B, S, V) tensor pinned to the logits' layout, gradients included
    dims = ("batch", None, "tp")
    lf = constrain(lf, cfg, dims)
    m = lf.detach().amax(dim=-1, keepdim=True)
    e = constrain(torch.exp(lf - m), cfg, dims)
    lse = (m + torch.log(e.sum(dim=-1, keepdim=True)))[..., 0]
    hit = constrain(labels.unsqueeze(-1) == _vocab_ids(lf), cfg, dims)
    picked = constrain(torch.where(hit, lf, torch.zeros((), device=lf.device)),
                       cfg, dims)
    label_logit = picked.sum(dim=-1)
    # the mean's gradient arrives replicated: pin it to the batch shards
    return constrain(lse - label_logit, cfg, ("batch", None)).mean()
