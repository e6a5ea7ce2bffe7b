"""Mixture-of-Experts FFN: the counterpart of ``repro.models.moe``.

Tokens are routed top-k and packed into per-expert capacity slots, so the
expert computation is a dense (E, B, cap, d) batch; FLOPs scale with the
active experts (cap ≈ top_k·S/E·cf). A (token, k) pair that overflows its
expert's capacity is dropped from the MoE path (it keeps the residual, and
arctic's parallel dense FFN).

``repro`` dispatches and combines with (B, S, E, cap) one-hot einsums; the
port picks the same rows with an index scatter into the slots and a gather
back out of them (each kept slot holds exactly one token, so the two are
the same function). Which pairs are kept follows ``repro`` bit for bit:

  * the router's top-k is a stable descending sort, so a tie puts the
    lower expert index first, as ``jax.lax.top_k`` does (hazard H2);
  * a pair's slot is the running count of earlier pairs routed to its
    expert over the flattened (S·K) axis, k inner, and it is kept while
    that count is below ``cap``.

The scatter never makes an out-of-range index: a dropped pair lands in a
scratch slot past the last one, which is sliced off (hazards H21, H24).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _gelu, apply_mlp, init_mlp
from repro_torch.models.module import Draws, dense_init, normal


def _stacked(gen: Draws, n: int, in_dim: int, out_dim: int, dtype):
    """(n, in_dim, out_dim) fan-in scaled weights, one expert drawn at a time
    (so the float32 draw of a whole stack never sits on the device; on the
    meta device, which holds nothing, in one draw)."""
    if gen.device.type == "meta":
        return normal(gen, (n, in_dim, out_dim), 1.0 / math.sqrt(in_dim),
                      dtype)
    w = torch.empty((n, in_dim, out_dim), dtype=dtype, device=gen.device)
    for e in range(n):
        w[e] = dense_init(gen, in_dim, (out_dim,), dtype)
    return w


def init_moe(gen: Draws, d_model: int, d_ff: int, n_experts: int,
             act: str, dtype, dense_residual: bool):
    p = {"router": dense_init(gen, d_model, (n_experts,), torch.float32),
         # per-expert weights stacked on a leading E axis, as ``repro``
         "wg": _stacked(gen, n_experts, d_model, d_ff, dtype),
         "wu": _stacked(gen, n_experts, d_model, d_ff, dtype),
         "wd": _stacked(gen, n_experts, d_ff, d_model, dtype)}
    if dense_residual:
        p["dense"] = init_mlp(gen, d_model, d_ff, act, dtype)
    return p


def moe_capacity(seq: int, n_experts: int, top_k: int, cf: float) -> int:
    cap = math.ceil(seq * top_k / n_experts * cf)
    return max(8, math.ceil(cap / 8) * 8)  # ``repro``'s lane-alignment pad


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """Router logits (B, S, E) float32, the renormalised top-k gates and
    their experts (B, S, K), lower expert first on a tie."""
    logits = torch.einsum("bsd,de->bse", x.to(torch.float32), router)
    gates = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(gates, dim=-1, descending=True, stable=True)
    topv, topi = vals[..., :top_k], idx[..., :top_k]
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return logits, topv, topi


def expert_slots(topi: torch.Tensor, n_experts: int, cap: int):
    """Each (token, k) pair's slot in its expert (B, S, K) int64, and
    whether it is kept (slot < cap)."""
    B, S, K = topi.shape
    onehot = F.one_hot(topi, n_experts).reshape(B, S * K, n_experts)
    pos = (torch.cumsum(onehot, dim=1) - onehot).reshape(B, S, K, n_experts)
    slot = pos.gather(-1, topi[..., None])[..., 0]
    return slot, slot < cap


def apply_moe(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d)."""
    E, K, act = cfg.n_experts, cfg.top_k, cfg.act
    B, S, d = x.shape
    cap = moe_capacity(S, E, K, cfg.capacity_factor)
    _, topv, topi = route(x, p["router"], K)
    slot, kept = expert_slots(topi, E, cap)
    c_idx = torch.where(kept, slot, cap)  # dropped pairs: the scratch slot
    b_idx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
    src = x[:, :, None, :].expand(B, S, K, d)
    xin = x.new_zeros((E, B, cap + 1, d)).index_put(
        (topi, b_idx, c_idx), src, accumulate=True)[:, :, :cap]  # (E,B,C,d)
    g = torch.einsum("ebcd,edf->ebcf", xin, p["wg"])
    u = torch.einsum("ebcd,edf->ebcf", xin, p["wu"])
    g = F.silu(g) if act == "silu" else _gelu(g)
    h = torch.einsum("ebcf,efd->ebcd", g * u, p["wd"])
    # combine: each kept pair's expert row, weighted by its gate in x's
    # dtype, summed over k in float32 (one rounding, as the einsum's)
    rows = h[topi, b_idx, torch.clamp(slot, max=cap - 1)]  # (B,S,K,d)
    w = (topv.to(x.dtype) * kept.to(x.dtype)).to(torch.float32)
    out = (w[..., None] * rows.to(torch.float32)).sum(2).to(x.dtype)
    if "dense" in p:  # arctic's parallel dense residual FFN
        out = out + apply_mlp(p["dense"], x, act)
    return out


def aux_load_balance_loss(router_logits: torch.Tensor, topi: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean fraction · mean
    probability)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    frac = F.one_hot(topi[..., 0], n_experts).to(torch.float32).mean(dim=(0, 1))
    imp = probs.mean(dim=(0, 1))
    return n_experts * torch.sum(frac * imp)
