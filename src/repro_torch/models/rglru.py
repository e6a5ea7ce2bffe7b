"""RG-LRU recurrent block (RecurrentGemma / Griffin) [arXiv:2402.19427]: the
counterpart of ``repro.models.rglru``.

Two branches from the input, a GeLU gate branch and a (causal conv1d ->
RG-LRU) branch, merged multiplicatively and projected out. Per channel:

    r_t = sigmoid(W_a x_t)            # recurrence gate
    i_t = sigmoid(W_x x_t)            # input gate
    a_t = exp(-c · softplus(Λ) · r_t) # c = 8
    h_t = a_t ⊙ h_{t-1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ x_t)

``repro`` runs the recurrence with ``lax.associative_scan``; the port with
:func:`linear_scan`, a Hillis-Steele scan over the same ``(a, b)`` combine:
log2(S) rounds of a few whole-tensor operations, where a loop over time
would cost S launches per layer. The two trees sum in another order, so
they agree to float32 rounding (``tests/test_torch_families.py`` holds the
state to ``repro``'s within 1e-5). Decode is one O(1) step.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.models.layers import (_gelu, causal_conv, constrain,
                                      residual_dims, softplus)
from repro_torch.models.module import Draws, dense_init, normal

_C = 8.0


def lru_width_of(cfg) -> int:
    return cfg.lru_width or cfg.d_model


def init_rglru_block(gen: Draws, cfg, dtype):
    d, w, dev = cfg.d_model, lru_width_of(cfg), gen.device
    # Λ so that a ∈ (0.9, 0.999) at r = 1 (griffin init), drawn as ``repro``
    # draws it, from numpy's generator seeded 0
    lam = np.log(np.expm1(-np.log(np.random.default_rng(0).uniform(
        0.9, 0.999, size=w)) / _C))
    return {
        "w_gate_branch": dense_init(gen, d, (w,), dtype),
        "w_rec_branch": dense_init(gen, d, (w,), dtype),
        "conv_w": normal(gen, (cfg.conv_kernel, w), 0.2, dtype),
        "conv_b": torch.zeros((w,), dtype=dtype, device=dev),
        "w_a": dense_init(gen, w, (w,), dtype),
        "w_x": dense_init(gen, w, (w,), dtype),
        "lam": torch.from_numpy(lam.astype(np.float32)).to(dev),
        "wo": dense_init(gen, w, (d,), dtype),
    }


def _gates(p, xw):
    r = torch.sigmoid(torch.einsum("...i,ij->...j", xw, p["w_a"])
                      .to(torch.float32))
    i = torch.sigmoid(torch.einsum("...i,ij->...j", xw, p["w_x"])
                      .to(torch.float32))
    a = torch.exp(-_C * softplus(p["lam"]) * r)
    gated_x = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * i \
        * xw.to(torch.float32)
    return a, gated_x


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t·h_{t-1} + b_t over axis 1 from h_{-1} = 0: Hillis-Steele
    over the combine ``(a1, b1), (a2, b2) -> (a1·a2, a2·b1 + b2)``."""
    S, d = a.shape[1], 1
    while d < S:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def rglru_prefill(p, x, cfg) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B,S,d) -> (B,S,d), and the decode cache: the final state and the
    last K-1 conv inputs (``repro``'s ``transformer._rglru_prefill``, which
    runs the same scan twice; once here)."""
    x = constrain(x, cfg, ("batch", None, None))  # the whole sequence
    gate = _gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate_branch"]))
    gate = constrain(gate, cfg, ("batch", None, "tp"))
    xw_in = torch.einsum("bsd,dw->bsw", x, p["w_rec_branch"])
    xw = constrain(causal_conv(xw_in, p["conv_w"], p["conv_b"]), cfg,
                   ("batch", None, "tp"))
    a, gx = _gates(p, xw)
    h = linear_scan(a, gx)
    y = torch.einsum("bsw,wd->bsd", h.to(x.dtype) * gate, p["wo"])
    y = constrain(y, cfg, residual_dims(cfg, y.shape[1]))
    return y, {"h": h[:, -1], "conv": xw_in[:, -(cfg.conv_kernel - 1):, :]}


def apply_rglru_train(p, x, cfg) -> torch.Tensor:
    """x: (B,S,d) -> (B,S,d)."""
    return rglru_prefill(p, x, cfg)[0]


def init_rglru_cache(cfg, batch: int, dtype, *, device) -> Dict[str, torch.Tensor]:
    w = lru_width_of(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, w), dtype=dtype,
                                device=device)}


def apply_rglru_decode(p, x, cache, cfg):
    """x: (B,1,d), one token. Returns ``(out, new cache)`` (fresh tensors)."""
    gate = _gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate_branch"]))
    xw = torch.einsum("bsd,dw->bsw", x, p["w_rec_branch"])
    window = torch.cat([cache["conv"], xw], dim=1)  # (B,K,w)
    xw = (torch.einsum("bkw,kw->bw", window, p["conv_w"]) + p["conv_b"])[:, None]
    a, gx = _gates(p, xw)
    h = a[:, 0] * cache["h"] + gx[:, 0]
    out = torch.einsum("bsw,wd->bsd", h[:, None, :].to(x.dtype) * gate, p["wo"])
    out = constrain(out, cfg, residual_dims(cfg, out.shape[1]))
    return out, {"h": h, "conv": window[:, 1:, :]}


def rglru_sequential_reference(p, x, cfg) -> torch.Tensor:
    """Step-by-step oracle for the scan train path (``repro``'s): the
    recurrence h_t = a_t·h_{t-1} + b_t as a loop over time."""
    B, S, _ = x.shape
    gate = _gelu(torch.einsum("bsd,dw->bsw", x, p["w_gate_branch"]))
    xw = causal_conv(torch.einsum("bsd,dw->bsw", x, p["w_rec_branch"]),
                     p["conv_w"], p["conv_b"])
    a, gx = _gates(p, xw)
    h = torch.zeros((B, a.shape[-1]), dtype=torch.float32, device=x.device)
    hs = []
    for t in range(S):
        h = a[:, t] * h + gx[:, t]
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype) * gate
    return torch.einsum("bsw,wd->bsd", y, p["wo"])
