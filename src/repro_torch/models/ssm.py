"""Mamba-2 SSD (state-space duality) block [arXiv:2405.21060]: the
counterpart of ``repro.models.ssm``.

Training and prefill use the chunked dual form: quadratic attention-like
work inside chunks of ``ssm_chunk`` tokens plus a linear recurrence over
the chunk states (``repro``'s ``lax.scan``, a Python loop over the chunks
here). Decode carries the (B, H, P, N) state and the causal conv buffer:
O(1) per token.

Projections are separate matrices (wz/wx/wB/wC/wdt), as ``repro``'s. The
float32 casts sit where ``repro`` has them, and ``softplus`` is
``jax.nn.softplus``'s ``logaddexp(x, 0)``.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.models.layers import (causal_conv, constrain, is_dtensor,
                                      model_axis, residual_dims, shard_local,
                                      softplus)
from repro_torch.models.module import Draws, dense_init, normal


def ssm_dims(cfg) -> Dict[str, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return dict(
        d_inner=d_inner,
        nheads=d_inner // cfg.ssm_headdim,
        headdim=cfg.ssm_headdim,
        dstate=cfg.ssm_state,
        ngroups=cfg.ssm_groups,
        conv_dim=d_inner + 2 * cfg.ssm_groups * cfg.ssm_state,
        kernel=cfg.conv_kernel,
    )


def init_ssm_block(gen: Draws, cfg, dtype):
    dm = ssm_dims(cfg)
    d, di, H, N, G = (cfg.d_model, dm["d_inner"], dm["nheads"], dm["dstate"],
                      dm["ngroups"])
    dev = gen.device
    return {
        "wz": dense_init(gen, d, (di,), dtype),
        "wx": dense_init(gen, d, (di,), dtype),
        "wB": dense_init(gen, d, (G * N,), dtype),
        "wC": dense_init(gen, d, (G * N,), dtype),
        "wdt": dense_init(gen, d, (H,), dtype),
        "conv_w": normal(gen, (dm["kernel"], dm["conv_dim"]), 0.2, dtype),
        "conv_b": torch.zeros((dm["conv_dim"],), dtype=dtype, device=dev),
        "A_log": torch.from_numpy(np.log(np.linspace(1.0, 16.0, H))
                                  .astype(np.float32)).to(dev),
        "dt_bias": torch.zeros((H,), dtype=torch.float32, device=dev),
        "D": torch.ones((H,), dtype=torch.float32, device=dev),
        "norm_scale": torch.ones((di,), dtype=dtype, device=dev),
        "wo": dense_init(gen, di, (d,), dtype),
    }


def _causal_conv_train(xBC, w, b):
    """Depthwise causal conv over time, then SiLU. xBC: (B,S,C), w: (K,C)."""
    return F.silu(causal_conv(xBC, w, b))


def _gated_norm(y, z, scale, eps: float = 1e-6):
    h = (y * F.silu(z)).to(torch.float32)
    h = h * torch.rsqrt((h * h).mean(dim=-1, keepdim=True) + eps)
    return (h * scale.to(torch.float32)).to(y.dtype)


def _project(p, x, cfg):
    dm = ssm_dims(cfg)
    # the whole sequence (a sequence-parallel gather; some torch versions
    # refuse to flatten a sharded sequence into the product's rows)
    x = constrain(x, cfg, ("batch", None, None))
    z = constrain(torch.einsum("bsd,di->bsi", x, p["wz"]), cfg,
                  ("batch", None, "tp"))
    xi = constrain(torch.einsum("bsd,di->bsi", x, p["wx"]), cfg,
                   ("batch", None, "tp"))
    Bp = torch.einsum("bsd,dn->bsn", x, p["wB"])
    Cp = torch.einsum("bsd,dn->bsn", x, p["wC"])
    dt_raw = torch.einsum("bsd,dh->bsh", x, p["wdt"]).to(torch.float32)
    dt = softplus(dt_raw + p["dt_bias"])
    return z, xi, Bp, Cp, dt, dm


def _split(xBC, dm):
    """(x, B, C) channels of a conv input or output (``jnp.split`` takes
    indices, ``torch.split`` sizes)."""
    gn = dm["ngroups"] * dm["dstate"]
    return torch.split(xBC, [dm["d_inner"], gn, gn], dim=-1)


def _ssd(p, x, cfg):
    """x: (B,S,d) -> (out (B,S,d), the final SSD state (B,H,P,N), the last
    K-1 conv inputs). Chunked SSD with the inter-chunk recurrence; the
    padding steps are identities, so the recurrence ends at the state after
    token S (``repro``'s ``_ssm_prefill`` recomputes it in one more pass)."""
    B, S, _ = x.shape
    z, xi, Bp, Cp, dt, dm = _project(p, x, cfg)
    H, P, N = dm["nheads"], dm["headdim"], dm["dstate"]
    conv_in = torch.cat([xi, Bp, Cp], dim=-1)
    xi, Bp, Cp = _split(_causal_conv_train(conv_in, p["conv_w"], p["conv_b"]),
                        dm)

    Q = min(cfg.ssm_chunk, S)
    S_pad = math.ceil(S / Q) * Q
    if S_pad != S:
        # identity steps: dt = 0 gives decay exp(0) = 1 and no contribution
        pad = (0, 0, 0, S_pad - S)
        xi, Bp, Cp, dt = (F.pad(t, pad) for t in (xi, Bp, Cp, dt))
    NC = S_pad // Q
    A = -torch.exp(p["A_log"])  # (H,) negative
    # d_inner splits into (H, P) shard-aligned only over whole heads: else
    # gathered first (some torch versions refuse a strided split)
    xi = constrain(xi, cfg, ("batch", None, _head_split(cfg, H)))
    xh = constrain(xi.reshape(B, NC, Q, H, P), cfg,
                   ("batch", None, None, None, "tp")).to(torch.float32)
    Bh = Bp.reshape(B, NC, Q, N).to(torch.float32)  # G = 1
    Ch = Cp.reshape(B, NC, Q, N).to(torch.float32)
    dth = dt.reshape(B, NC, Q, H)
    with tracing.span("model.ssd"):
        Y, h = shard_local(_ssd_core, *_core_placements(xh), xh, Bh, Ch, dth,
                           A, p["D"])
    # heads whole-channelled before (H, P) flattens into d_inner: the heads
    # over the model axis where they divide it, else replicated
    Y = constrain(Y, cfg, ("batch", None, None, "tp", None))
    # and its gradient placed so before the reshape's backward splits it
    y = constrain(Y.reshape(B, S_pad, dm["d_inner"]), cfg,
                  ("batch", None, _head_split(cfg, H)))[:, :S].to(x.dtype)
    y = _gated_norm(y, z, p["norm_scale"])
    y_out = torch.einsum("bsi,id->bsd", y, p["wo"])
    return (constrain(y_out, cfg, residual_dims(cfg, y_out.shape[1])), h,
            conv_in[:, -(cfg.conv_kernel - 1):, :])


def _head_split(cfg, n_heads: int):
    """The label of d_inner before it splits into (heads, headdim): "tp"
    where the model axis divides the heads, else whole."""
    return "tp" if n_heads % model_axis(cfg) == 0 else None


def _ssd_core(xh, Bh, Ch, dth, A, D):
    """The chunked SSD over float32 chunks: xh (B, NC, Q, H, P), Bh and Ch
    (B, NC, Q, N), dth (B, NC, Q, H), A and D (H,) -> (Y (B, NC, Q, H, P),
    the state after the last chunk (B, H, P, N)). Each batch row, head and
    head channel on its own, so it runs on a DTensor's local shards."""
    B, NC, Q, H, P = xh.shape
    N = Bh.shape[-1]
    cum = torch.cumsum(dth * A, dim=2)  # inclusive log-decay

    # ---- intra-chunk (quadratic in Q) ----
    # L[i,j] = exp(cum_i - cum_j) for j <= i. Mask BEFORE the exp: the j > i
    # entries are positive and would overflow, poisoning gradients via 0·inf
    Lmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]  # (B,NC,Qi,Qj,H)
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                   device=xh.device))[None, None, :, :, None]
    Ldec = torch.exp(torch.where(causal, Lmat, torch.full_like(Lmat, -1e30)))
    Smat = torch.einsum("bcin,bcjn->bcij", Ch, Bh)  # (B,NC,Q,Q)
    xdt = xh * dth[..., None]  # (B,NC,Q,H,P)
    # ``repro``'s three-operand einsum, as two (no (…, Q, Q, H, P) product)
    Y = torch.einsum("bcijh,bcjhp->bcihp", Smat[..., None] * Ldec, xdt)

    # ---- chunk states + inter-chunk recurrence ----
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)  # (B,NC,Q,H)
    states = torch.einsum("bcjh,bcjn,bcjhp->bchpn", decay_to_end * dth, Bh, xh)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (B,NC,H)
    h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    h_prev = []
    for c in range(NC):  # the state *entering* each chunk
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_prev = torch.stack(h_prev, dim=1)  # (B,NC,H,P,N)

    Y_off = torch.einsum("bcin,bchpn->bcihp", Ch, h_prev) \
        * torch.exp(cum)[..., None]
    Y = Y + Y_off + D[None, None, None, :, None] * xh
    return Y, h


def _core_placements(xh):
    """``(out, in)`` placements of :func:`_ssd_core` from those of ``xh``
    (batch, head or head-channel shards); ``(None, None)`` for a plain
    tensor."""
    if not is_dtensor(xh):
        return None, None
    from torch.distributed.tensor import Replicate, Shard
    to = {"y": {0: 0, 3: 3, 4: 4}, "h": {0: 0, 3: 1, 4: 2},
          "bc": {0: 0}, "dt": {0: 0, 3: 3}, "hd": {3: 0}}

    def pl(kind):
        return tuple(Shard(to[kind][q.dim]) if isinstance(q, Shard)
                     and q.dim in to[kind] else Replicate()
                     for q in xh.placements)

    return ((pl("y"), pl("h")),
            (pl("y"), pl("bc"), pl("bc"), pl("dt"), pl("hd"), pl("hd")))


def apply_ssm_train(p, x, cfg) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d). Chunked SSD with the inter-chunk recurrence."""
    return _ssd(p, x, cfg)[0]


def ssm_prefill(p, h, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The train forward, plus the decode cache: the last K-1 conv inputs
    and the final SSD state (``repro``'s ``transformer._ssm_prefill``), from
    the one chunked pass."""
    y, state, conv_tail = _ssd(p, h, cfg)
    return y, {"conv": conv_tail, "state": state}


# ---------------------------------------------------------------------------
# Decode: O(1) state update per token
# ---------------------------------------------------------------------------
def init_ssm_cache(cfg, batch: int, dtype, *, device) -> Dict[str, torch.Tensor]:
    dm = ssm_dims(cfg)
    return {
        "conv": torch.zeros((batch, dm["kernel"] - 1, dm["conv_dim"]),
                            dtype=dtype, device=device),
        "state": torch.zeros((batch, dm["nheads"], dm["headdim"],
                              dm["dstate"]), dtype=torch.float32,
                             device=device),
    }


def apply_ssm_decode(p, x, cache, cfg):
    """x: (B,1,d); cache: conv (B,K-1,C), state (B,H,P,N). Returns ``(out,
    new cache)`` (fresh tensors; the old cache is left as it was)."""
    B = x.shape[0]
    z, xi, Bp, Cp, dt, dm = _project(p, x, cfg)
    H, P = dm["nheads"], dm["headdim"]
    window = torch.cat([cache["conv"], torch.cat([xi, Bp, Cp], dim=-1)], dim=1)
    conv_out = torch.einsum("bkc,kc->bc", window, p["conv_w"]) + p["conv_b"]
    xi, Bp, Cp = _split(F.silu(conv_out)[:, None, :], dm)
    A = -torch.exp(p["A_log"])
    dt1 = dt[:, 0]  # (B,H)
    # the headdim shard pinned through the reshape, as ``repro``'s
    xi = constrain(xi, cfg, ("batch", None, _head_split(cfg, H)))
    xh = constrain(xi.reshape(B, H, P), cfg, ("batch", None, "tp")
                   ).to(torch.float32)
    Bv, Cv = Bp[:, 0].to(torch.float32), Cp[:, 0].to(torch.float32)
    y, state = shard_local(_decode_core, *_decode_placements(xh), xh, Bv, Cv,
                           dt1, A, p["D"], cache["state"])
    y = constrain(y, cfg, ("batch", "tp", None))  # as Y in :func:`_ssd`
    y = _gated_norm(y.reshape(B, 1, dm["d_inner"]).to(x.dtype), z,
                    p["norm_scale"])
    out = torch.einsum("bsi,id->bsd", y, p["wo"])
    out = constrain(out, cfg, residual_dims(cfg, out.shape[1]))
    return out, {"conv": window[:, 1:, :], "state": state}


def _decode_core(xh, Bv, Cv, dt1, A, D, state):
    """One SSD step: xh (B, H, P), Bv and Cv (B, N), dt1 (B, H), A and D
    (H,), state (B, H, P, N) -> (y (B, H, P), the new state). Each batch
    row, head and head channel on its own."""
    decay = torch.exp(dt1 * A)
    state = state * decay[:, :, None, None] + torch.einsum(
        "bh,bhp,bn->bhpn", dt1, xh, Bv)
    y = torch.einsum("bn,bhpn->bhp", Cv, state) + D[None, :, None] * xh
    return y, state


def _decode_placements(xh):
    """``(out, in)`` placements of :func:`_decode_core` from those of xh
    (B, H, P); ``(None, None)`` for a plain tensor."""
    if not is_dtensor(xh):
        return None, None
    from torch.distributed.tensor import Replicate, Shard
    to = {"y": {0: 0, 1: 1, 2: 2}, "bn": {0: 0}, "dt": {0: 0, 1: 1},
          "hd": {1: 0}}

    def pl(kind):
        return tuple(Shard(to[kind][q.dim]) if isinstance(q, Shard)
                     and q.dim in to[kind] else Replicate()
                     for q in xh.placements)

    y = pl("y")
    return ((y, y), (y, pl("bn"), pl("bn"), pl("dt"), pl("hd"), pl("hd"), y))


# ---------------------------------------------------------------------------
# Sequential oracle (for tests): the straight recurrence over time
# ---------------------------------------------------------------------------
def ssm_sequential_reference(p, x, cfg) -> torch.Tensor:
    B, S, _ = x.shape
    z, xi, Bp, Cp, dt, dm = _project(p, x, cfg)
    xi, Bp, Cp = _split(_causal_conv_train(torch.cat([xi, Bp, Cp], dim=-1),
                                           p["conv_w"], p["conv_b"]), dm)
    H, P, N = dm["nheads"], dm["headdim"], dm["dstate"]
    A = -torch.exp(p["A_log"])
    state = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xh = xi[:, t].reshape(B, H, P).to(torch.float32)
        dt_t = dt[:, t]
        state = state * torch.exp(dt_t * A)[:, :, None, None] + torch.einsum(
            "bh,bhp,bn->bhpn", dt_t, xh, Bp[:, t].to(torch.float32))
        y = torch.einsum("bn,bhpn->bhp", Cp[:, t].to(torch.float32), state)
        ys.append((y + p["D"][None, :, None] * xh).reshape(B, dm["d_inner"]))
    y = _gated_norm(torch.stack(ys, dim=1).to(x.dtype), z, p["norm_scale"])
    return torch.einsum("bsi,id->bsd", y, p["wo"])
