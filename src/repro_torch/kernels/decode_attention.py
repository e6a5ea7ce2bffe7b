"""Single-token GQA decode attention against a KV cache, on the card.

Port of the Pallas TPU kernel ``repro/kernels/decode_attention.py::
decode_attention_pallas`` as a hand-written CUDA kernel for Hopper
(``csrc/decode_attention.cu``: flash-decoding in one launch; each block
stages its chunk of the cache, read in place and only up to ``pos[b]``,
through shared memory with coalesced asynchronous copies, and the last
block of each (b, kv) group merges the group's chunks in chunk order;
bf16 at Dh 64 scores and accumulates on the tensor cores; the source says
why). :func:`decode_attention_cuda` launches it on CUDA tensors and
counts its launches (one per call); :func:`decode_attention_plain` is its
plain PyTorch version (``repro.kernels.ref.decode_attention_ref``'s
function), which the CPU path and the on-card comparison use.

Both take q (B, KV, rep, Dh), k/v caches (B, S, KV, Dh) and pos (B,)
int32, compute in float32 and return (B, KV, rep, Dh) in q's dtype; cache
positions > ``pos[b]`` are masked. S need not divide a block (ROADMAP
hazard H13). The bf16 tensor-core route rounds the softmax weights to
bf16 before the product with V (H15).
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (SUPPORTED_DTYPES,
                                                 SUPPORTED_HEAD_DIMS)

_SMEM_LIMIT = 232448  # dynamic shared memory a Hopper block can opt into
_SMS = 132  # streaming multiprocessors of an H100
_FILL_BLOCKS = 6 * _SMS  # two waves of three blocks on each SM
_GRID_Y = 65535  # the most blocks along a launch's y axis (the chunks here)


class _Args(ctypes.Structure):
    """``struct DecodeArgs`` of ``csrc/decode_attention.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in (
        "B", "S", "KV", "rep", "Dh", "chunk", "nsplit", "warps", "bf16")]
        + [("scale", ctypes.c_float)]
        + [(n, ctypes.c_longlong) for n in ("sb", "ss", "skv")]
        + [(n, ctypes.c_void_p) for n in (
            "q", "k", "v", "pos", "part_m", "part_l", "part_acc", "tickets",
            "out")])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("decode_attention")
    lib.decode_attention_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.decode_attention_launch.restype = ctypes.c_int
    lib.decode_attention_error_string.argtypes = [ctypes.c_int]
    lib.decode_attention_error_string.restype = ctypes.c_char_p
    lib.decode_attention_smem.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_smem.restype = ctypes.c_size_t
    lib.decode_attention_max_weights.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_rep_max.restype = ctypes.c_int
    lib.decode_attention_max_weights.restype = ctypes.c_size_t
    return lib


def _check(q, k_cache, v_cache, pos) -> None:
    if q.dim() != 4 or k_cache.dim() != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q (B, KV, rep, Dh), caches (B, S, "
                         f"KV, Dh) expected, got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    B, KV, _, Dh = q.shape
    if (k_cache.shape[0], k_cache.shape[2], k_cache.shape[3]) != (B, KV, Dh):
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} differ in B, KV or Dh")
    if tuple(pos.shape) != (B,):
        raise ValueError(f"decode_attention: pos must be ({B},), got "
                         f"{tuple(pos.shape)}")


def chunk_for(B: int, KV: int, S: int) -> int:
    """Cache positions per block: the largest power of two from 1024 down
    to 64 that still gives two waves of three blocks per SM (a longer chunk
    streams longer between a block's fixed costs and leaves fewer chunks to
    merge); 32 where even chunks of 64 leave SMs without a block."""
    chunk = 1024
    while chunk > 64 and B * KV * -(-S // chunk) < _FILL_BLOCKS:
        chunk //= 2
    if B * KV * -(-S // chunk) < _SMS:
        chunk = 32
    return chunk


@dataclasses.dataclass(frozen=True)
class DecodePlan:
    """How one call is cut: ``grid`` = (B·KV, nsplit) blocks of ``chunk``
    positions each, ``warps`` warps per block; one int32 ticket per (b, kv)
    group."""

    chunk: int
    nsplit: int
    warps: int
    grid: Tuple[int, int]
    tickets: int


@functools.lru_cache(maxsize=256)
def decode_plan(B: int, KV: int, S: int) -> DecodePlan:
    """The launch plan of :func:`decode_attention_cuda` (pure Python; the
    kernel takes chunk and nsplit from it)."""
    chunk = chunk_for(B, KV, S)
    nsplit = max(1, -(-S // chunk))
    # eight warps split a block's chunk finer: where the grid is under two
    # blocks per SM, and on long chunks (more loads in flight per SM)
    warps = 8 if B * KV * nsplit < 2 * _SMS or chunk >= 1024 else 4
    return DecodePlan(chunk=chunk, nsplit=nsplit, warps=warps,
                      grid=(B * KV, nsplit), tickets=B * KV)


@functools.lru_cache(maxsize=256)
def _check_plan(plan: DecodePlan, rep: int, Dh: int, S: int) -> None:
    """Raise if the kernel cannot take the plan: too much shared memory, or
    more chunks than its merge holds (once per shape)."""
    lib = _lib()
    smem = lib.decode_attention_smem(rep, Dh, plan.warps)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"decode_attention: rep={rep}, Dh={Dh} needs {smem} B "
                         f"of shared memory per block, over {_SMEM_LIMIT}")
    most = min(_GRID_Y, lib.decode_attention_max_weights(rep, Dh, plan.warps)
               // rep)
    if plan.nsplit > most:
        raise ValueError(f"decode_attention: a cache of {S} positions is "
                         f"{plan.nsplit} chunks of {plan.chunk}; the kernel "
                         f"merges at most {most} for rep={rep}")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, pos: torch.Tensor
                          ) -> torch.Tensor:
    """Launch the CUDA kernel: q (B, KV, rep, Dh) contiguous; caches (B, S,
    KV, Dh) with equal strides, unit stride on Dh and 16-byte aligned rows
    (read in place, not copied); pos (B,) int32; one dtype (bf16 or
    float32), Dh in {64, 128, 256}, all on one CUDA device. Returns a new
    (B, KV, rep, Dh) tensor; raises on anything else and on a failed
    launch."""
    _check(q, k_cache, v_cache, pos)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"decode_attention_cuda needs CUDA tensors, got {dev}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache), ("pos", pos)):
        if t.device != dev:
            raise ValueError(f"decode_attention: {name} is on {t.device}, q on "
                             f"{dev}: operands on more than one device")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.dtype != q.dtype:
            raise TypeError(f"decode_attention: {name} is {t.dtype}, q {q.dtype}")
    if q.dtype not in SUPPORTED_DTYPES:
        raise TypeError(f"decode_attention: dtype {q.dtype} not supported "
                        f"(bf16 or float32)")
    if pos.dtype != torch.int32 or not pos.is_contiguous():
        raise TypeError("decode_attention: pos must be contiguous int32")
    B, KV, rep, Dh = q.shape
    S = k_cache.shape[1]
    lib = _lib()
    if Dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode_attention: head dim {Dh} not supported "
                         f"({SUPPORTED_HEAD_DIMS})")
    if not 1 <= rep <= lib.decode_attention_rep_max():
        raise ValueError(f"decode_attention: {rep} query heads per kv head; "
                         f"the kernel takes 1..{lib.decode_attention_rep_max()}")
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("decode_attention: q must be contiguous and 16-byte "
                         "aligned")
    align = 16 // q.element_size()
    if (k_cache.stride() != v_cache.stride() or k_cache.stride(3) != 1
            or any(st % align for st in k_cache.stride()[:3])
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError(f"decode_attention: the caches need equal strides, "
                         f"unit stride on Dh and 16-byte aligned rows (strides "
                         f"{k_cache.stride()}, {v_cache.stride()})")
    plan = decode_plan(B, KV, S)
    _check_plan(plan, rep, Dh, S)
    out = torch.empty_like(q)
    if B == 0 or KV == 0 or S == 0:
        return out.zero_()
    nsplit = plan.nsplit
    part_m = torch.empty((B * KV, nsplit, rep), dtype=torch.float32, device=dev)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((B * KV, nsplit, rep, Dh), dtype=torch.float32,
                           device=dev)
    tickets = _build.tickets(dev, plan.tickets)
    sb, ss, skv, _ = k_cache.stride()
    args = _Args(B=B, S=S, KV=KV, rep=rep, Dh=Dh, chunk=plan.chunk,
                 nsplit=nsplit, warps=plan.warps,
                 bf16=int(q.dtype == torch.bfloat16), scale=1.0 / math.sqrt(Dh),
                 sb=sb, ss=ss, skv=skv, q=q.data_ptr(), k=k_cache.data_ptr(),
                 v=v_cache.data_ptr(), pos=pos.data_ptr(),
                 part_m=part_m.data_ptr(), part_l=part_l.data_ptr(),
                 part_acc=part_acc.data_ptr(), tickets=tickets.data_ptr(),
                 out=out.data_ptr())
    with torch.cuda.device(dev):
        rc = lib.decode_attention_launch(
            ctypes.byref(args), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA error "
                           f"{rc} ({lib.decode_attention_error_string(rc).decode()})")
    decode_attention_cuda.launches += 1
    return out


#: Launches of the CUDA kernel (one per call) since the count was last set
#: to 0.
decode_attention_cuda.launches = 0


def decode_attention_plain(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor
                           ) -> torch.Tensor:
    """Plain PyTorch version of :func:`decode_attention_cuda`, on any
    device: a dense masked softmax over the cache in float32."""
    _check(q, k_cache, v_cache, pos)
    s = torch.einsum("bkrd,bskd->bkrs", q.to(torch.float32),
                     k_cache.to(torch.float32)) / math.sqrt(q.shape[-1])
    S = k_cache.shape[1]
    mask = torch.arange(S, device=q.device)[None, :] <= pos[:, None]
    s = s.masked_fill(~mask[:, None, None, :], -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkrs,bskd->bkrd", p, v_cache.to(torch.float32))
    return out.to(q.dtype)
