"""Flash attention (causal, sliding window, query offset) on the card.

Port of the Pallas TPU kernel ``repro/kernels/flash_attention.py::
flash_attention_pallas`` as a hand-written CUDA kernel for Hopper
(``csrc/flash_attention.cu``: one block per 64-row q tile, K/V tiles staged
in shared memory, the running max, sum and accumulators per row in float32;
the source says why). :func:`flash_attention_cuda` launches it on CUDA
tensors and counts its launches; :func:`flash_attention_plain` is its plain
PyTorch version (``repro.kernels.ref.flash_attention_ref``'s function),
which the CPU path and the on-card comparison use.

Both take q (BH, Sq, Dh) and k/v (BH, Sk, Dh) in bf16 or float32, compute
in float32 and return (BH, Sq, Dh) in q's dtype. Key j is live for query i
when ``j <= i + q_offset`` (causal) and ``j > i + q_offset - window``
(window > 0); a row with no live key gives 0 (ROADMAP hazard H12). No
length has to divide a tile (H13).
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)
SUPPORTED_HEAD_DIMS = (64, 128, 256)


class _Args(ctypes.Structure):
    """``struct FlashArgs`` of ``csrc/flash_attention.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "BH", "Sq", "Sk", "Dh", "causal", "window", "q_offset", "bf16")]
        + [("scale", ctypes.c_float)]
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


def _check(q, k, v, window: int, q_offset: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q (BH, Sq, Dh), k/v (BH, Sk, Dh) "
                         f"expected, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} differ in BH or Dh")
    if window < 0 or q_offset < 0:
        raise ValueError(f"flash_attention: window ({window}) and q_offset "
                         f"({q_offset}) must be >= 0")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True, window: int = 0,
                         q_offset: int = 0) -> torch.Tensor:
    """Launch the CUDA kernel: q (BH, Sq, Dh), k/v (BH, Sk, Dh), one dtype
    (bf16 or float32), Dh in {64, 128, 256}, contiguous, on one CUDA
    device. Returns a new (BH, Sq, Dh) tensor; raises on anything else and
    on a failed launch."""
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
    BH, Sq, Dh = q.shape
    Sk = k.shape[1]
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {Dh} not supported "
                         f"({SUPPORTED_HEAD_DIMS})")
    if BH > 65535:
        raise ValueError(f"flash_attention: BH={BH} is over the grid's 65535")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} must be contiguous and "
                             f"16-byte aligned")
    out = torch.empty_like(q)
    if BH == 0 or Sq == 0:
        return out
    args = _Args(BH=BH, Sq=Sq, Sk=Sk, Dh=Dh, causal=int(bool(causal)),
                 window=int(window), q_offset=int(q_offset),
                 bf16=int(q.dtype == torch.bfloat16), scale=1.0 / math.sqrt(Dh),
                 q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(),
                 out=out.data_ptr())
    lib = _lib()
    with torch.cuda.device(dev):
        rc = lib.flash_attention_launch(
            ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{rc} ({lib.flash_attention_error_string(rc).decode()})")
    flash_attention_cuda.launches += 1
    return out


#: Launches of the CUDA kernel since the count was last set to 0.
flash_attention_cuda.launches = 0


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                          causal: bool = True, window: int = 0,
                          q_offset: int = 0) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention_cuda`, on any device:
    a dense masked softmax in float32, fully masked rows 0."""
    _check(q, k, v, window, q_offset)
    Sq, Sk = q.shape[1], k.shape[1]
    s = torch.einsum("bqd,bkd->bqk", q.to(torch.float32),
                     k.to(torch.float32)) / math.sqrt(q.shape[-1])
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
    return torch.einsum("bqk,bkd->bqd", p, v.to(torch.float32)).to(q.dtype)
