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
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (64, 128, 256)
_GRID_Y = 65535  # the most blocks along a launch's y axis (B·H here)


class _Args(ctypes.Structure):
    """``struct FlashArgs`` of ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "H", "Sq", "Sk", "Dh", "causal", "window", "q_offset", "bf16")]
        + [("scale", ctypes.c_float)]
        + [(f"{t}_{s}", ctypes.c_longlong) for t in "qkvo"
           for s in ("sb", "ss", "sh")]
        + [(n, ctypes.c_void_p) for n in ("q", "k", "v", "out")])


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("flash_attention")
    lib.flash_attention_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.flash_attention_launch.restype = ctypes.c_int
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


def _strides(name: str, x4: torch.Tensor):
    """(sb, ss, sh) of a (B, S, H, Dh) operand in elements, checked for
    what the kernel's loads take: unit stride on Dh, 16-byte aligned rows.
    A dimension of size 1 is never stepped, so its stride is not checked."""
    align = 16 // x4.element_size()
    Dh = x4.shape[3]
    st = [s if n > 1 else Dh for n, s in zip(x4.shape[:3], x4.stride()[:3])]
    if ((x4.stride(3) != 1 and Dh > 1) or any(s % align or s <= 0 for s in st)
            or x4.data_ptr() % 16):
        raise ValueError(f"flash_attention: {name} needs unit stride on Dh, "
                         f"positive strides that are multiples of 16 bytes and "
                         f"a 16-byte aligned start (shape {tuple(x4.shape)}, "
                         f"strides {x4.stride()})")
    return st[0], st[1], st[2]


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: q, k, v in the (B, S, H, Dh) or (BH, S, Dh)
    layout (read in place through their strides), one dtype (bf16 or
    float32), Dh in {64, 128, 256}, on one CUDA device. Returns a new
    contiguous tensor of q's shape; raises on anything else and on a
    failed launch."""
    _check(q, k, v, window, q_offset)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k", k), ("v", v)):
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q on "
                             f"{dev}: operands on more than one device")
        if t.dtype != q.dtype:
            raise TypeError(f"flash_attention: {name} is {t.dtype}, q {q.dtype}")
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported "
                        f"(bf16 or float32)")
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
    if B * H == 0 or Sq == 0:
        return out
    if Sk == 0:  # no key at all: every row is fully masked (H12)
        return out.zero_()
    strides["o"] = _strides("out", _model_layout(out))
    args = _Args(B=B, H=H, Sq=Sq, Sk=Sk, Dh=Dh, causal=int(bool(causal)),
                 window=int(window), q_offset=int(q_offset),
                 bf16=int(q.dtype == torch.bfloat16), scale=1.0 / math.sqrt(Dh),
                 q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                 out=out.data_ptr(),
                 **{f"{t}_{n}": s for t, st in strides.items()
                    for n, s in zip(("sb", "ss", "sh"), st)})
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.flash_attention_launch(
            ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: error "
                           f"{rc} ({lib.flash_attention_error_string(rc).decode()})")
    flash_attention_cuda.launches += 1
    return out


#: Launches of the CUDA kernel since the count was last set to 0.
flash_attention_cuda.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_cuda`, on any device
    and in either layout: a dense masked softmax in float32, fully masked
    rows 0."""
    _check(q, k, v, window, q_offset)
    q4, k4, v4 = _model_layout(q), _model_layout(k), _model_layout(v)
    Sq, Sk = q4.shape[1], k4.shape[1]
    s = torch.einsum("bqhd,bkhd->bhqk", q4.to(torch.float32),
                     k4.to(torch.float32)) / math.sqrt(q4.shape[-1])
    qpos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window:
        mask &= kpos > qpos - window
    s = s.masked_fill(~mask, -math.inf)
    p = torch.softmax(s, dim=-1)
    p = torch.where(mask.any(dim=-1, keepdim=True), p, torch.zeros_like(p))
    out = torch.einsum("bhqk,bkhd->bqhd", p, v4.to(torch.float32)).to(q.dtype)
    return out if q.dim() == 4 else out.squeeze(2)
