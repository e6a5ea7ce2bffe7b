"""Plain float32 references of the benchmark's language models.

A Llama-style decoder (SmolLM) and a Mamba-2 (SSD) stack, written from the
published descriptions in plain PyTorch: no kernel, no cache, no fused
op, nothing imported from the program under test. Each model is a table of
parameters (:func:`param_table`: path, shape, dtype, how it is drawn) and a
loss over one block of rows (:func:`loss`). The parameter paths and shapes
are the ones the program takes, layers stacked on a leading axis, so the
harness draws one set of weights from the seed and hands the same tensors
to both sides.

Every matrix product goes through a ``mm`` callable: :func:`mm_f32` (plain
float32, TF32 off; the reference) or :func:`mm_fp8` (both operands, and
the incoming gradient in the backward, rounded to float8 e4m3 with a
per-tensor scale; the control that a lower precision must fail).

A configuration that names a reference module of its own
(``"reference"``, :mod:`perfbench.reference.models`) has its table and
loss from that module: :func:`param_table` and :func:`loss` hand the call
on, and everything built on them (:func:`draw_params`, :func:`n_params`,
:func:`loss_and_grads`) serves that model unchanged.

Departures from the published models, kept because the program under test
runs them so: RMSNorm's epsilon is 1e-6 (the published configs state
1e-5); the Mamba-2 residual stream is not kept in float32; weights are
drawn fan-in scaled, the embedding at std 0.02.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, List, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from perfbench.reference.models import model_of

RMS_EPS = 1e-6
E4M3_MAX = 448.0


# --------------------------------------------------------------------------
# Matrix products: float32, or float8 with a per-tensor scale
# --------------------------------------------------------------------------
def mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


def _fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 after scaling its largest magnitude to
    the format's largest finite value, and scaled back (float32)."""
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = E4M3_MAX / amax
    return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale


def _sum_to(g: torch.Tensor, shape) -> torch.Tensor:
    while g.dim() > len(shape):
        g = g.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


class _Fp8Matmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        qa, qb = _fp8(a), _fp8(b)
        ctx.save_for_backward(qa, qb)
        ctx.shapes = (a.shape, b.shape)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = _fp8(g)
        sa, sb = ctx.shapes
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        gb = torch.matmul(qa.transpose(-1, -2), qg)
        return _sum_to(ga, sa), _sum_to(gb, sb)


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


MM = {"float32": mm_f32, "fp8": mm_fp8}


# --------------------------------------------------------------------------
# Parameter tables
# --------------------------------------------------------------------------
class Param(NamedTuple):
    path: str  # "/"-joined keys of the program's tree
    shape: Tuple[int, ...]
    dtype: str  # "model" (the configuration's dtype) or "float32"
    init: Tuple  # ("normal", std) | ("ones",) | ("zeros",) | ("alog",)


def _dense(path, shape, fan_in, L=None):
    full = (L,) + tuple(shape) if L else tuple(shape)
    return Param(path, full, "model", ("normal", 1.0 / math.sqrt(fan_in)))


def param_table(cfg: dict) -> List[Param]:
    """Every parameter of the model in ``cfg`` (a configuration file's
    dict), layers stacked on a leading axis of ``num_hidden_layers``; the
    configuration's own reference module's where it names one."""
    model = model_of(cfg)
    if model is not None:
        return model.param_table(cfg)
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    out = [Param("embedding/embed", (V, d), "model", ("normal", 0.02)),
           Param("final_norm/scale", (d,), "model", ("ones",))]
    pre = "layers/sub_0/"
    if cfg["family"] == "dense":
        H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
        Dh, Fd = d // H, cfg["intermediate_size"]
        out += [
            Param(pre + "ln1/scale", (L, d), "model", ("ones",)),
            Param(pre + "ln2/scale", (L, d), "model", ("ones",)),
            _dense(pre + "attn/wq", (d, H, Dh), d, L),
            _dense(pre + "attn/wk", (d, KV, Dh), d, L),
            _dense(pre + "attn/wv", (d, KV, Dh), d, L),
            _dense(pre + "attn/wo", (H, Dh, d), H * Dh, L),
            _dense(pre + "mlp/wg", (d, Fd), d, L),
            _dense(pre + "mlp/wu", (d, Fd), d, L),
            _dense(pre + "mlp/wd", (Fd, d), Fd, L),
        ]
    elif cfg["family"] == "ssm":
        di = cfg["expand"] * d
        H, N, K = di // cfg["headdim"], cfg["state_size"], cfg["conv_kernel"]
        conv = di + 2 * N
        out += [
            Param(pre + "ln1/scale", (L, d), "model", ("ones",)),
            _dense(pre + "ssm/wz", (d, di), d, L),
            _dense(pre + "ssm/wx", (d, di), d, L),
            _dense(pre + "ssm/wB", (d, N), d, L),
            _dense(pre + "ssm/wC", (d, N), d, L),
            _dense(pre + "ssm/wdt", (d, H), d, L),
            Param(pre + "ssm/conv_w", (L, K, conv), "model", ("normal", 0.2)),
            Param(pre + "ssm/conv_b", (L, conv), "model", ("zeros",)),
            Param(pre + "ssm/A_log", (L, H), "float32", ("alog",)),
            Param(pre + "ssm/dt_bias", (L, H), "float32", ("zeros",)),
            Param(pre + "ssm/D", (L, H), "float32", ("ones",)),
            Param(pre + "ssm/norm_scale", (L, di), "model", ("ones",)),
            _dense(pre + "ssm/wo", (di, d), di, L),
        ]
    else:
        raise ValueError(f"no reference for family {cfg['family']!r}")
    return sorted(out, key=lambda p: p.path.split("/"))


def n_params(cfg: dict) -> int:
    return sum(math.prod(p.shape) for p in param_table(cfg))


def draw_params(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of ``cfg`` from ``seed``, on ``device``: every normal
    leaf is a slice of one float32 draw of a ``torch.Generator`` on that
    device, scaled and cast to its dtype; the rest are constants."""
    table = param_table(cfg)
    model_dt = getattr(torch, cfg["dtype"])
    normals = [p for p in table if p.init[0] == "normal"]
    gen = torch.Generator(device=device).manual_seed(seed)
    total = sum(math.prod(p.shape) for p in normals)
    flat = torch.randn(total, generator=gen, dtype=torch.float32,
                       device=device)
    out, off = {}, 0
    for p in table:
        dt = model_dt if p.dtype == "model" else torch.float32
        kind = p.init[0]
        if kind == "normal":
            n = math.prod(p.shape)
            out[p.path] = (flat[off:off + n].view(p.shape) * p.init[1]).to(dt)
            off += n
        elif kind == "ones":
            out[p.path] = torch.ones(p.shape, dtype=dt, device=device)
        elif kind == "zeros":
            out[p.path] = torch.zeros(p.shape, dtype=dt, device=device)
        elif kind == "alog":  # A = -(1 .. 16) spread over the heads
            a = torch.log(torch.linspace(1.0, 16.0, p.shape[-1],
                                         dtype=torch.float64))
            out[p.path] = a.to(torch.float32).to(device).expand(
                p.shape).contiguous()
        else:
            raise ValueError(kind)
    del flat
    return out


def nest(flat: Dict[str, torch.Tensor]) -> dict:
    """``{"a/b": t}`` as ``{"a": {"b": t}}``: the tree the program takes."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *keys, last = path.split("/")
        for k in keys:
            node = node.setdefault(k, {})
        node[last] = t
    return tree


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------
def rms(x, scale, eps=RMS_EPS):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, theta: float):
    """Rotary embedding, halves rotated (x: (B, S, H, Dh))."""
    S, Dh = x.shape[1], x.shape[-1]
    half = Dh // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float64,
                                        device=x.device) * 2.0 / Dh))
    ang = torch.arange(S, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).to(x.dtype)[None, :, None, :]
    sin = torch.sin(ang).to(x.dtype)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(q, k, v, mm):
    """Causal softmax attention; q (B, S, H, Dh), k and v (B, S, KV, Dh),
    each key/value head shared by H // KV consecutive query heads."""
    B, S, H, Dh = q.shape
    rep = H // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(Dh)
    causal = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~causal, -math.inf), dim=-1)
    return mm(p, v.transpose(1, 2)).transpose(1, 2).reshape(B, S, H * Dh)


def dense_layer(P, i, x, cfg, mm):
    pre = "layers/sub_0/"
    B, S, d = x.shape
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh = d // H
    h = rms(x, P[pre + "ln1/scale"][i])
    q = mm(h, P[pre + "attn/wq"][i].reshape(d, H * Dh)).view(B, S, H, Dh)
    k = mm(h, P[pre + "attn/wk"][i].reshape(d, KV * Dh)).view(B, S, KV, Dh)
    v = mm(h, P[pre + "attn/wv"][i].reshape(d, KV * Dh)).view(B, S, KV, Dh)
    theta = cfg["rope_theta"]
    ctx = attention(rope(q, theta), rope(k, theta), v, mm)
    x = x + mm(ctx, P[pre + "attn/wo"][i].reshape(H * Dh, d))
    h = rms(x, P[pre + "ln2/scale"][i])
    g = F.silu(mm(h, P[pre + "mlp/wg"][i])) * mm(h, P[pre + "mlp/wu"][i])
    return x + mm(g, P[pre + "mlp/wd"][i])


def ssd(x, Bm, Cm, dt, A, chunk: int):
    """The SSD recurrence h_t = exp(dt_t·A) h_{t-1} + dt_t x_t B_tᵀ,
    y_t = h_t C_t, chunk by chunk: within a chunk as a masked product,
    across chunks through the carried state. x (B, S, H, P), Bm and Cm
    (B, S, N), dt (B, S, H), A (H,) -> y (B, S, H, P)."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    h = x.new_zeros(Bsz, H, P, N)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        xs, Bs, Cs, dts = x[:, sl], Bm[:, sl], Cm[:, sl], dt[:, sl]
        Q = xs.shape[1]
        cum = torch.cumsum(dts * A, dim=1)  # (B, Q, H)
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B, t, s, H)
        low = torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
        decay = torch.exp(diff.masked_fill(~low[None, :, :, None], -math.inf))
        w = torch.einsum("btn,bsn->bts", Cs, Bs)[..., None] * decay
        xdt = xs * dts[..., None]
        y = torch.einsum("btsh,bshp->bthp", w, xdt)
        y = y + torch.einsum("btn,bhpn->bthp", Cs, h) * torch.exp(cum)[..., None]
        to_end = torch.exp(cum[:, -1:, :] - cum)  # (B, Q, H)
        h = (h * torch.exp(cum[:, -1, :])[:, :, None, None]
             + torch.einsum("bsh,bsn,bshp->bhpn", to_end, Bs, xdt))
        ys.append(y)
    return torch.cat(ys, dim=1)


def ssm_layer(P, i, x, cfg, mm):
    pre = "layers/sub_0/ssm/"
    B, S, d = x.shape
    di = cfg["expand"] * d
    Pd, N = cfg["headdim"], cfg["state_size"]
    H = di // Pd
    h = rms(x, P["layers/sub_0/ln1/scale"][i])
    z = mm(h, P[pre + "wz"][i])
    xi = mm(h, P[pre + "wx"][i])
    Bp = mm(h, P[pre + "wB"][i])
    Cp = mm(h, P[pre + "wC"][i])
    dt = F.softplus(mm(h, P[pre + "wdt"][i]) + P[pre + "dt_bias"][i])
    conv_in = torch.cat([xi, Bp, Cp], dim=-1).transpose(1, 2)  # (B, C, S)
    w = P[pre + "conv_w"][i]  # (K, C)
    K, C = w.shape
    conv = F.conv1d(F.pad(conv_in, (K - 1, 0)), w.t().unsqueeze(1),
                    P[pre + "conv_b"][i], groups=C)
    xi, Bp, Cp = torch.split(F.silu(conv).transpose(1, 2), [di, N, N], -1)
    A = -torch.exp(P[pre + "A_log"][i])
    xh = xi.reshape(B, S, H, Pd)
    y = ssd(xh, Bp, Cp, dt, A, cfg["chunk_size"])
    y = (y + P[pre + "D"][i][:, None] * xh).reshape(B, S, di)
    g = rms(y * F.silu(z), P[pre + "norm_scale"][i])
    return x + mm(g, P[pre + "wo"][i])


def loss(P: Dict[str, torch.Tensor], tokens, labels, cfg: dict,
         mm: Callable = mm_f32) -> torch.Tensor:
    """Mean next-token cross entropy of one block of rows (float32)."""
    model = model_of(cfg)
    if model is not None:
        return model.loss(P, tokens, labels, cfg, mm)
    layer = dense_layer if cfg["family"] == "dense" else ssm_layer
    E = P["embedding/embed"]
    x = E[tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        x = layer(P, i, x, cfg, mm)
    x = rms(x, P["final_norm/scale"])
    logits = mm(x, E.t())
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1).long())


def loss_and_grads(params: Dict[str, torch.Tensor], tokens, labels,
                   cfg: dict, *, block_rows: int, mm: Callable = mm_f32
                   ) -> Tuple[float, Dict[str, torch.Tensor]]:
    """The loss over all rows of ``tokens`` and its float32 gradient for
    every parameter, from float32 copies of ``params``, ``block_rows``
    rows at a time (each block's share of the mean accumulated)."""
    P = {k: v.detach().to(torch.float32).requires_grad_(True)
         for k, v in params.items()}
    n = tokens.shape[0]
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    for r0 in range(0, n, block_rows):
        rows = slice(r0, min(r0 + block_rows, n))
        share = (rows.stop - rows.start) / n
        lb = loss(P, tokens[rows], labels[rows], cfg, mm) * share
        lb.backward()
        total += lb.detach().double()
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in P.items()}
    return float(total), grads
