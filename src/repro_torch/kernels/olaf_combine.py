"""The OLAF burst combine (running-mean segment sum) on the card.

Port of the Pallas TPU kernel ``repro/kernels/olaf_combine.py::
olaf_combine_pallas`` as a hand-written CUDA kernel for Hopper
(``csrc/olaf_combine.cu``: one launch, a column per thread, a per-block CSR
of the contributing updates; the source says why).
:func:`olaf_combine_cuda` launches it on CUDA tensors and counts its
launches; :func:`olaf_combine_plain` is its plain PyTorch version, which
the CPU path and the on-card comparison use.

Both compute, for each of S queues (a leading S axis is optional),

    new[q] = (slot[q]·count[q] + Σ_{u: cluster[u]=q} gate[u]·upd[u])
             / max(count[q] + hits[q], 1),   hits[q] = Σ_{u: cluster[u]=q} gate[u]

and return fresh ``(new_slots, new_counts)`` tensors; the inputs are left
as they are. A row with ``gate == 0`` or a cluster id outside ``[0, Q)``
is skipped: unlike ``repro``'s one-hot product, a non-finite element of one
update reaches only the slot it names.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block gets by default


class _Args(ctypes.Structure):
    """``struct OlafCombineArgs`` of ``csrc/olaf_combine.cu``."""

    _fields_ = ([(n, ctypes.c_int) for n in ("S", "Q", "U", "D")]
                + [(n, ctypes.c_void_p) for n in (
                    "slots", "counts", "updates", "clusters", "gate", "out",
                    "out_counts")])


@functools.cache
def _lib() -> ctypes.CDLL:
    from repro_torch.kernels import _build
    lib = _build.load("olaf_combine")
    lib.olaf_combine_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.olaf_combine_launch.restype = ctypes.c_int
    lib.olaf_combine_error_string.argtypes = [ctypes.c_int]
    lib.olaf_combine_error_string.restype = ctypes.c_char_p
    lib.olaf_combine_smem.argtypes = [ctypes.c_int] * 2
    lib.olaf_combine_smem.restype = ctypes.c_size_t
    return lib


def _batched(slots, counts, updates, clusters, gate):
    """Every operand with a leading S axis, and whether it was added."""
    if slots.dim() == 2:
        return (slots[None], counts[None], updates[None], clusters[None],
                gate[None]), True
    return (slots, counts, updates, clusters, gate), False


def _check_shapes(slots, counts, updates, clusters, gate) -> None:
    S, Q, D = slots.shape
    U = clusters.shape[-1]
    want = dict(counts=(S, Q), updates=(S, U, D), clusters=(S, U), gate=(S, U))
    for name, t in dict(counts=counts, updates=updates, clusters=clusters,
                        gate=gate).items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"olaf_combine: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")


def olaf_combine_cuda(slots: torch.Tensor, counts: torch.Tensor,
                      updates: torch.Tensor, clusters: torch.Tensor,
                      gate: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch the CUDA combine: slots (Q, D) or (S, Q, D) float32, counts
    (…, Q) int32, updates (…, U, D) float32, clusters/gate (…, U) int32 (a
    bool gate is taken as 0/1), all contiguous on one CUDA device. Returns
    new ``(slots, counts)`` tensors; raises on anything else and on a
    failed launch."""
    dev = slots.device
    for name, t in dict(counts=counts, updates=updates, clusters=clusters,
                        gate=gate).items():
        if t.device != dev:
            raise ValueError(f"olaf_combine: {name} is on {t.device}, the "
                             f"slots on {dev}: operands on more than one device")
    if dev.type != "cuda":
        raise ValueError(f"olaf_combine_cuda needs CUDA tensors, got {dev}")
    if gate.dtype == torch.bool:
        gate = gate.to(torch.int32)
    (sl, cn, up, cl, gt), squeeze = _batched(slots, counts, updates, clusters,
                                             gate)
    _check_shapes(sl, cn, up, cl, gt)
    for name, t, dt in (("slots", sl, torch.float32), ("counts", cn, torch.int32),
                        ("updates", up, torch.float32),
                        ("clusters", cl, torch.int32), ("gate", gt, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"olaf_combine: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"olaf_combine: {name} must be contiguous")
    S, Q, D = sl.shape
    U = cl.shape[-1]
    lib = _lib()
    smem = lib.olaf_combine_smem(Q, U)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"olaf_combine: Q={Q}, U={U} needs {smem} B of "
                         f"shared memory per block, over {_SMEM_LIMIT}")
    out = torch.empty_like(sl)
    out_counts = torch.empty_like(cn)
    args = _Args(S=S, Q=Q, U=U, D=D, slots=sl.data_ptr(), counts=cn.data_ptr(),
                 updates=up.data_ptr(), clusters=cl.data_ptr(),
                 gate=gt.data_ptr(), out=out.data_ptr(),
                 out_counts=out_counts.data_ptr())
    if S > 0 and Q > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.olaf_combine_launch(ctypes.byref(args), stream)
        if rc != 0:
            raise RuntimeError(
                f"olaf_combine kernel launch failed: CUDA error {rc} "
                f"({lib.olaf_combine_error_string(rc).decode()})")
        olaf_combine_cuda.launches += 1
    if squeeze:
        return out[0], out_counts[0]
    return out, out_counts


#: Launches of the CUDA kernel since the count was last set to 0.
olaf_combine_cuda.launches = 0


def olaf_combine_plain(slots: torch.Tensor, counts: torch.Tensor,
                       updates: torch.Tensor, clusters: torch.Tensor,
                       gate: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`olaf_combine_cuda`, on any device:
    one ``index_add_`` of the kept ``gate·upd`` rows in ascending u (the
    kernel's order and skip rule), then the running-mean blend."""
    (sl, cn, up, cl, gt), squeeze = _batched(slots, counts, updates, clusters,
                                             gate)
    _check_shapes(sl, cn, up, cl, gt)
    S, Q, D = sl.shape
    cl = cl.to(torch.int64)
    gt = gt.to(torch.int32)
    inside = (cl >= 0) & (cl < Q)
    keep = inside & (gt != 0)
    flat = (torch.arange(S, device=cl.device)[:, None] * Q + cl)  # (S, U)
    sums = torch.zeros((S * Q, D), dtype=torch.float32, device=sl.device)
    rows = up.to(torch.float32)[keep] * gt[keep].to(torch.float32)[:, None]
    sums.index_add_(0, flat[keep], rows)
    hits = torch.zeros(S * Q, dtype=torch.int32, device=sl.device)
    hits.index_add_(0, flat[inside], gt[inside])
    hits = hits.view(S, Q)
    cn = cn.to(torch.int32)
    acc = sl.to(torch.float32) * cn.to(torch.float32)[..., None] + sums.view(S, Q, D)
    new_counts = cn + hits
    out = acc / torch.clamp(new_counts, min=1).to(torch.float32)[..., None]
    if squeeze:
        return out[0], new_counts[0]
    return out, new_counts
