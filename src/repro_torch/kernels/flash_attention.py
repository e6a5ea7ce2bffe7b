"""Flash attention (causal, sliding window, query offset) on the card.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_pallas`` as a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``; the source says why it has two routes): bf16
operands run on the tensor cores (``wgmma`` on tiles that TMA brings into
an ``mbarrier``-guarded ring in shared memory, one producer and two
consumer warpgroups), float32 operands on the CUDA cores (the tensor cores
take float32 only as TF32). :func:`flash_attention_cuda` launches it on
CUDA tensors and counts its launches; :func:`flash_attention_plain` is its
plain PyTorch version (``repro.kernels.ref.flash_attention_ref``'s
function), which the CPU path and the on-card comparison use.

Both take q, k and v in one of two layouts, bf16 or float32, and return
the output in q's layout and dtype, accumulated in float32:

* the model's (B, S, H, Dh), k/v with the same B and H as q (already
  expanded to q's heads), read in place through their strides;
* the folded (BH, S, Dh), which is the case H = 1.

Key j is live for query i when ``j <= i + q_offset`` (causal) and
``j > i + q_offset - window`` (window > 0); a row with no live key gives 0
(ROADMAP hazard H12). No length has to divide a tile (H13). The bf16 route
rounds the softmax weights to bf16 before the product with V (H15).

The gradient: :class:`FlashAttention` is the ``torch.autograd.Function`` of
the pair. Its forward asks the kernel for each row's log-sum-exp too (the
serving path does not), and its backward recomputes the softmax weights
from it: :func:`flash_attention_backward_cuda` on the card (bf16, Dh 64 or
128: a pre-pass, then a dK/dV and a dQ kernel, no atomics), and
:func:`flash_attention_backward_plain`, the same arithmetic in PyTorch, on
the CPU. ``repro`` has no such kernel: its Pallas flash kernel is
forward-only and it trains through XLA's dense attention.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (64, 128, 256)
#: The head dims the backward kernel takes (bf16 only).
BACKWARD_HEAD_DIMS = (64, 128)
_PAD_ROWS = 128  # the backward's per-row scratch: Sq rounded up to this
_GRID_Y = 65535  # the most blocks along a launch's y axis (B·H here)


class _Args(ctypes.Structure):
    """``struct FlashArgs`` of ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "H", "Sq", "Sk", "Dh", "causal", "window", "q_offset", "bf16")]
        + [("scale", ctypes.c_float)]
        + [(f"{t}_{s}", ctypes.c_longlong) for t in "qkvo"
           for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_void_p) for n in ("q", "k", "v", "out", "lse")])


_BWD_TENSORS = ("q", "k", "v", "o", "dout", "dq", "dk", "dv")


class _BwdArgs(ctypes.Structure):
    """``struct FlashBwdArgs`` of ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "H", "Sq", "Sk", "Dh", "causal", "window", "q_offset", "sq_pad")]
        + [("scale", ctypes.c_float)]
        + [(f"{t}_{s}", ctypes.c_longlong) for t in _BWD_TENSORS
           for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "o", "dout", "lse", "dq", "dk", "dv", "lse2",
            "delta")])


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
    lib.flash_attention_bwd_launch.argtypes = [ctypes.POINTER(_BwdArgs),
                                               ctypes.c_void_p]
    lib.flash_attention_bwd_launch.restype = ctypes.c_int
    lib.flash_attention_error_string.argtypes = [ctypes.c_int]
    lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _model_layout(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, Dh) as it is, (BH, S, Dh) as the view (BH, S, 1, Dh)."""
    return x if x.dim() == 4 else x.unsqueeze(2)


def _check(q, k, v, window: int, q_offset: int) -> None:
    if q.dim() not in (3, 4) or k.dim() != q.dim() or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (BH, Sq, Dh) with k/v (BH, Sk, "
                         f"Dh), or q (B, Sq, H, Dh) with k/v (B, Sk, H, Dh) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    q4, k4 = _model_layout(q), _model_layout(k)
    if (q4.shape[0], q4.shape[2], q4.shape[3]) != (k4.shape[0], k4.shape[2],
                                                   k4.shape[3]):
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in BH or Dh (batch, heads or "
                         f"head dim)")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window ({window}) and q_offset "
                         f"({q_offset}) must be >= 0")


def _readable(x4: torch.Tensor) -> bool:
    """Whether the kernels read ``x4`` (B, S, H, Dh) in place: unit stride
    on Dh, every other stride and the start a multiple of 16 bytes. A
    dimension of size 1 is never stepped, so its stride is not checked."""
    align = 16 // x4.element_size()
    st = [s if n > 1 else x4.shape[3]
          for n, s in zip(x4.shape[:3], x4.stride()[:3])]
    return ((x4.stride(3) == 1 or x4.shape[3] <= 1)
            and all(s % align == 0 and s > 0 for s in st)
            and x4.data_ptr() % 16 == 0)


def _strides(name: str, x4: torch.Tensor):
    """(sb, ss, sh) of a (B, S, H, Dh) operand in elements, checked by
    :func:`_readable`."""
    if not _readable(x4):
        raise ValueError(f"flash_attention: {name} needs unit stride on Dh, "
                         f"positive strides that are multiples of 16 bytes and "
                         f"a 16-byte aligned start (shape {tuple(x4.shape)}, "
                         f"strides {x4.stride()})")
    Dh = x4.shape[3]
    return tuple(s if n > 1 else Dh
                 for n, s in zip(x4.shape[:3], x4.stride()[:3]))


def _check_operands(op: str, dev: torch.device, q, *others) -> None:
    """One CUDA device and q's dtype for every operand."""
    if dev.type != "cuda":
        raise ValueError(f"{op} needs CUDA tensors, got {dev}")
    for name, t in others:
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                             f"{dev}: operands on more than one device")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q {q.dtype}")


def _lse_shape(q: torch.Tensor, B: int, H: int, Sq: int):
    """(B, H, Sq) for the model's layout, (BH, Sq) for the folded one."""
    return (B, H, Sq) if q.dim() == 4 else (B, Sq)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0, return_lse: bool = False):
    """Launch the CUDA kernel: q, k, v in the (B, S, H, Dh) or (BH, S, Dh)
    layout (read in place through their strides), one dtype (bf16 or
    float32), Dh in {64, 128, 256}, on one CUDA device. Returns a new
    contiguous tensor of q's shape; with ``return_lse`` (bf16 only) also
    each row's float32 log-sum-exp, (B, H, Sq) or (BH, Sq), −inf on a row
    with no live key. Raises on anything else and on a failed launch."""
    _check(q, k, v, window, q_offset)
    dev = q.device
    _check_operands("flash_attention_cuda", dev, q, ("k", k), ("v", v))
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(bf16 or float32)")
    if return_lse and q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention: the log-sum-exp comes from the bf16 "
                        f"kernel only, got {q.dtype}")
    q4, k4, v4 = _model_layout(q), _model_layout(k), _model_layout(v)
    B, Sq, H, Dh = q4.shape
    Sk = k4.shape[1]
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh} not supported "
                         f"({SUPPORTED_HEAD_DIMS})")
    if B * H > _GRID_Y:
        raise ValueError(f"flash_attention: B·H={B * H} is over the grid's "
                         f"{_GRID_Y}")
    strides = {n: _strides(n, t) for n, t in (("q", q4), ("k", k4), ("v", v4))}
    out = torch.empty(q.shape, dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H, Sq), dtype=torch.float32, device=dev)
           if return_lse else None)
    if Sk == 0:  # no key at all: every row is fully masked (H12)
        out.zero_()
        if lse is not None:
            lse.fill_(-math.inf)
    elif B * H and Sq:
        strides["o"] = _strides("out", _model_layout(out))
        args = _Args(B=B, H=H, Sq=Sq, Sk=Sk, Dh=Dh, causal=int(bool(causal)),
                     window=int(window), q_offset=int(q_offset),
                     bf16=int(q.dtype == torch.bfloat16),
                     scale=1.0 / math.sqrt(Dh),
                     q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                     out=out.data_ptr(),
                     lse=None if lse is None else lse.data_ptr(),
                     **{f"{t}_{n}": s for t, st in strides.items()
                        for n, s in zip(("sb", "ss", "sh"), st)})
        _launch("flash_attention", _lib().flash_attention_launch, args, dev)
        flash_attention_cuda.launches += 1
    if lse is None:
        return out
    return out, lse.reshape(_lse_shape(q, B, H, Sq))


#: Launches of the CUDA kernel since the count was last set to 0.
flash_attention_cuda.launches = 0


def _launch(what: str, fn, args, dev: torch.device) -> None:
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: error {rc} "
                           f"({_lib().flash_attention_error_string(rc).decode()})")


def _check_backward(q: torch.Tensor) -> None:
    """Raise for operands the backward kernel does not take."""
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_attention backward: bf16 only on the card, "
                        f"got {q.dtype}")
    if q.shape[-1] not in BACKWARD_HEAD_DIMS:
        raise ValueError(f"flash_attention backward: head dim {q.shape[-1]} "
                         f"not supported ({BACKWARD_HEAD_DIMS})")


def flash_attention_backward_cuda(q, k, v, out, lse, dout, *,
                                  causal: bool = True, window: int = 0,
                                  q_offset: int = 0):
    """The backward kernels: ``(dq, dk, dv)`` of :func:`flash_attention_cuda`
    at q, k, v given its ``out``, its ``lse`` and the output's gradient
    ``dout``; bf16, Dh 64 or 128, either layout, read in place where the
    strides allow (``dout`` and ``out`` are copied otherwise). Three launches
    on the current stream, no atomics: the same inputs give the same bits.
    Returns new contiguous tensors of q's, k's and v's shapes."""
    _check(q, k, v, window, q_offset)
    dev = q.device
    _check_operands("flash_attention_backward_cuda", dev, q, ("k", k),
                    ("v", v), ("out", out), ("dout", dout))
    _check_backward(q)
    if out.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"flash_attention backward: out {tuple(out.shape)} and "
                         f"dout {tuple(dout.shape)} must be q's shape "
                         f"{tuple(q.shape)}")
    q4, k4, v4 = _model_layout(q), _model_layout(k), _model_layout(v)
    B, Sq, H, Dh = q4.shape
    Sk = k4.shape[1]
    if tuple(lse.shape) != _lse_shape(q, B, H, Sq) or lse.device != dev:
        raise ValueError(f"flash_attention backward: lse {tuple(lse.shape)} on "
                         f"{lse.device}, want {_lse_shape(q, B, H, Sq)} on {dev}")
    if B * H > _GRID_Y:
        raise ValueError(f"flash_attention: B·H={B * H} is over the grid's "
                         f"{_GRID_Y}")
    dq = torch.empty(q.shape, dtype=q.dtype, device=dev)
    dk = torch.empty(k.shape, dtype=k.dtype, device=dev)
    dv = torch.empty(v.shape, dtype=v.dtype, device=dev)
    if B * H == 0 or Sq == 0 or Sk == 0:  # nothing attends: every gradient 0
        return dq.zero_(), dk.zero_(), dv.zero_()
    o4 = _model_layout(out)
    g4 = _model_layout(dout)
    o4 = o4 if _readable(o4) else o4.contiguous()
    g4 = g4 if _readable(g4) else g4.contiguous()
    operands = dict(q=q4, k=k4, v=v4, o=o4, dout=g4, dq=_model_layout(dq),
                    dk=_model_layout(dk), dv=_model_layout(dv))
    strides = {n: _strides(n, t) for n, t in operands.items()}
    sq_pad = -(-Sq // _PAD_ROWS) * _PAD_ROWS
    lse = lse.to(torch.float32).contiguous()
    lse2 = torch.empty((B * H, sq_pad), dtype=torch.float32, device=dev)
    delta = torch.empty((B * H, sq_pad), dtype=torch.float32, device=dev)
    args = _BwdArgs(B=B, H=H, Sq=Sq, Sk=Sk, Dh=Dh, causal=int(bool(causal)),
                    window=int(window), q_offset=int(q_offset), sq_pad=sq_pad,
                    scale=1.0 / math.sqrt(Dh), lse=lse.data_ptr(),
                    lse2=lse2.data_ptr(), delta=delta.data_ptr(),
                    **{n: t.data_ptr() for n, t in operands.items()},
                    **{f"{t}_{n}": s for t, st in strides.items()
                       for n, s in zip(("sb", "ss", "sh"), st)})
    _launch("flash_attention backward", _lib().flash_attention_bwd_launch,
            args, dev)
    flash_attention_backward_cuda.launches += 1
    return dq, dk, dv


#: Calls of the backward (three launches each) since the count was set to 0.
flash_attention_backward_cuda.launches = 0


def _live(Sq: int, Sk: int, causal: bool, window: int, q_offset: int,
          device) -> torch.Tensor:
    """(Sq, Sk) bool: key j is live for query i."""
    qpos = torch.arange(Sq, device=device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    return mask


def _scores(q4, k4, causal, window, q_offset):
    """float32 scaled scores (B, H, Sq, Sk) and the live mask (Sq, Sk)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q4.to(torch.float32),
                     k4.to(torch.float32)) / math.sqrt(q4.shape[-1])
    return s, _live(q4.shape[1], k4.shape[1], causal, window, q_offset,
                    q4.device)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          q_offset: int = 0, return_lse: bool = False):
    """Plain PyTorch version of :func:`flash_attention_cuda`, on any device
    and in either layout: a dense masked softmax in float32, fully masked
    rows 0 (their log-sum-exp −inf)."""
    _check(q, k, v, window, q_offset)
    q4, k4, v4 = _model_layout(q), _model_layout(k), _model_layout(v)
    s, mask = _scores(q4, k4, causal, window, q_offset)
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v4.to(torch.float32)).to(q.dtype)
    out = out if q.dim() == 4 else out.squeeze(2)
    if not return_lse:
        return out
    B, Sq, H = q4.shape[:3]
    return out, torch.logsumexp(s, dim=-1).reshape(_lse_shape(q, B, H, Sq))


def flash_attention_backward_plain(q, k, v, out, lse, dout, *,
                                   causal: bool = True, window: int = 0,
                                   q_offset: int = 0):
    """Plain PyTorch version of :func:`flash_attention_backward_cuda`, on any
    device and in either layout, with the kernels' arithmetic: float32
    scores, P = exp(S − lse) on live keys, dV = Pᵀ·dO with P rounded to q's
    dtype, dS = P∘(dO·Vᵀ − Σ_d dO∘O), dQ = dS·K·scale and dK = dSᵀ·Q·scale
    with dS rounded to q's dtype, sums in float32."""
    _check(q, k, v, window, q_offset)
    q4, k4, v4 = _model_layout(q), _model_layout(k), _model_layout(v)
    o4, g4 = _model_layout(out), _model_layout(dout)
    B, Sq, H, Dh = q4.shape
    f32 = torch.float32
    s, mask = _scores(q4, k4, causal, window, q_offset)
    lse4 = lse.to(f32).reshape(B, H, Sq, 1)
    p = torch.where(mask, torch.exp(s - lse4), torch.zeros_like(s))
    g = g4.to(f32)
    delta = (g * o4.to(f32)).sum(-1).permute(0, 2, 1)[..., None]  # (B, H, Sq, 1)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).to(f32), g)
    dp = torch.einsum("bqhd,bkhd->bhqk", g, v4.to(f32))
    ds = (p * (dp - delta)).to(q.dtype).to(f32)
    scale = 1.0 / math.sqrt(Dh)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, k4.to(f32)) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q4.to(f32)) * scale
    grads = (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))
    return grads if q.dim() == 4 else tuple(x.squeeze(2) for x in grads)


class FlashAttention(torch.autograd.Function):
    """The kernel pair under autograd: the forward keeps q, k, v, the output
    and its log-sum-exp (under non-reentrant checkpointing only the
    recompute keeps them), the backward recomputes P from them. CUDA
    tensors launch the kernels (or raise), CPU tensors take the plain
    versions; no fallback from one to the other."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset):
        if q.device.type == "cuda":
            _check_backward(q)
            fwd = flash_attention_cuda
        elif q.device.type == "cpu":
            fwd = flash_attention_plain
        else:
            raise ValueError(f"flash_attention: no kernel for device {q.device}")
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        out, lse = fwd(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.kw = kw
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = (flash_attention_backward_cuda if q.device.type == "cuda"
               else flash_attention_backward_plain)
        dq, dk, dv = bwd(q, k, v, out, lse, dout, **ctx.kw)
        return dq, dk, dv, None, None, None
