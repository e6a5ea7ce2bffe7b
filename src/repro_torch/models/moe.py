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

from repro_torch.models.layers import (_gelu, apply_mlp, constrain,
                                      init_mlp, is_dtensor, shard_local)
from repro_torch.models.module import Draws, dense_init, fsdp_gather, normal


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


def _dispatch(x, router, E: int, K: int, cap: int):
    """Route each token of x (B, S, d) and scatter it into its experts'
    slots: ``(xin (E, B, cap, d), topv, topi, slot, kept, b_idx)``, the
    last five (B, S, K). Each batch row is routed and packed on its own."""
    B, S, d = x.shape
    _, topv, topi = route(x, router, K)
    slot, kept = expert_slots(topi, E, cap)
    c_idx = torch.where(kept, slot, cap)  # dropped pairs: the scratch slot
    b_idx = torch.arange(B, device=x.device)[:, None, None].expand(B, S, K)
    src = x[:, :, None, :].expand(B, S, K, d)
    xin = x.new_zeros((E, B, cap + 1, d)).index_put(
        (topi, b_idx, c_idx), src, accumulate=True)[:, :, :cap]  # (E,B,C,d)
    return xin, topv, topi, slot, kept, b_idx


def _combine(h, topv, topi, slot, kept, b_idx, E: int, e_off: int,
             dtype):
    """Each kept pair's expert row of h (E_local, B, cap, d), the experts
    ``e_off ..`` of the whole E, weighted by its gate in ``dtype``, summed
    over k in float32 (one rounding, as the einsum's); on an expert shard
    (E_local < E) a pair whose expert lies outside h adds zero (the rank
    holding it adds its row)."""
    El, cap = h.shape[0], h.shape[2]
    e, mine = topi, kept
    if El != E:
        e = topi - e_off
        mine = kept & (e >= 0) & (e < El)
        e = e.clamp(0, El - 1)
    rows = h[e, b_idx, torch.clamp(slot, max=cap - 1)]
    w = (topv.to(dtype) * mine.to(dtype)).to(torch.float32)
    return (w[..., None] * rows.to(torch.float32)).sum(2).to(dtype)


def _experts(x, router, wg, wu, wd, E: int, K: int, cap: int, act: str,
             e_off: int):
    """Route x (B, S, d), run the experts ``e_off ..`` that ``wg``, ``wu``,
    ``wd`` hold (all E, or one model shard's; their ff dim whole or a
    shard's) and combine: (B, S, d), a partial sum where the experts or
    their ff dim are a shard's."""
    xin, topv, topi, slot, kept, b_idx = _dispatch(x, router, E, K, cap)
    if wg.shape[0] != E:
        xin = xin[e_off:e_off + wg.shape[0]]
    g = torch.einsum("ebcd,edf->ebcf", xin, wg)
    u = torch.einsum("ebcd,edf->ebcf", xin, wu)
    g = F.silu(g) if act == "silu" else _gelu(g)
    h = torch.einsum("ebcf,efd->ebcd", g * u, wd)
    return _combine(h, topv, topi, slot, kept, b_idx, E, e_off, x.dtype)


def apply_moe(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """x: (B, S, d) -> (B, S, d). On DTensors the whole layer runs on each
    rank's shards (``layers.shard_local``: no DTensor rule covers an
    accumulating ``index_put``, hazard H24): its batch rows, every token's
    routing, and the experts as the weights are placed over the model axis
    (E over it where it divides E, else the ff dim, ``repro``'s rules), so
    each rank's output is a partial sum over that axis, which the output's
    constraint reduces."""
    E, K, act = cfg.n_experts, cfg.top_k, cfg.act
    B, S, d = x.shape
    cap = moe_capacity(S, E, K, cfg.capacity_factor)
    xs = constrain(x, cfg, ("batch", None, None))  # each row's whole sequence
    # the local products need whole d_model rows: gathered over the FSDP
    # axes (a no-op where the period already gathered them; a decode step
    # gathers them here)
    ws = tuple(fsdp_gather(p[k]) for k in ("wg", "wu", "wd"))
    out_pl = in_pl = None
    e_off = 0
    if is_dtensor(xs):
        from torch.distributed.tensor import Partial, Replicate, Shard
        from torch.distributed.tensor._utils import \
            compute_local_shape_and_global_offset
        rows = tuple(xs.placements)
        wpl = [tuple(w.placements) for w in ws]
        out_pl = tuple(
            Shard(0) if r == Shard(0) else
            Partial() if isinstance(wpl[0][i], Shard) else Replicate()
            for i, r in enumerate(rows))
        in_pl = (rows, (Replicate(),) * len(rows)) + tuple(wpl)
        e_off = compute_local_shape_and_global_offset(
            ws[0].shape, ws[0].device_mesh, wpl[0])[1][0]
    out = shard_local(
        lambda x_, r_, g_, u_, d_: _experts(x_, r_, g_, u_, d_, E, K, cap,
                                            act, e_off),
        out_pl, in_pl, xs, p["router"], *ws)
    out = constrain(out, cfg, ("batch", "sp", None))
    if "dense" in p:  # arctic's parallel dense residual FFN
        out = out + apply_mlp(p["dense"], x, act, cfg)
    return out


def aux_load_balance_loss(router_logits: torch.Tensor, topi: torch.Tensor,
                          n_experts: int) -> torch.Tensor:
    """Switch-style load-balancing auxiliary loss (mean fraction · mean
    probability)."""
    probs = torch.softmax(router_logits.to(torch.float32), dim=-1)
    frac = F.one_hot(topi[..., 0], n_experts).to(torch.float32).mean(dim=(0, 1))
    imp = probs.mean(dim=(0, 1))
    return n_experts * torch.sum(frac * imp)
