"""The OLAF burst combine (running-mean segment sum) and the forwarding
boundary around it, on the card.

Port of the Pallas TPU kernel ``repro/kernels/olaf_combine.py::
olaf_combine_pallas``, and of the rest of ``repro.kernels.ops.olaf_forward``
that ``repro`` jits into the same dispatch, as one hand-written CUDA kernel
for Hopper (``csrc/olaf_combine.cu``: one launch per call on a grid sized to
the card, per-block bit masks of the contributing updates, several columns per
thread; the source says why). :func:`olaf_combine_cuda` launches it on CUDA
tensors and counts its launches; :func:`olaf_combine_plain` is its plain
PyTorch version (the composition ``ops.olaf_forward`` ran before the
fusion), which the CPU path and the on-card comparison use.

Both compute, for each of S queues (a leading S axis is optional),

    cnt[q] = reset[q] ? 0 : count[q]
    new[q] = (slot[q]·cnt[q] + Σ_{u: cluster[u]=q} gate[u]·upd[u])
             / max(cnt[q] + hits[q], 1),   hits[q] = Σ_{u: cluster[u]=q} gate[u]

and return fresh ``(new_slots, new_counts)`` tensors; the inputs are left
as they are. A row with ``gate == 0`` or a cluster id outside ``[0, Q)``
is skipped: unlike ``repro``'s one-hot product, a non-finite element of one
update reaches only the slot it names. Given the departing ``(drain_sw,
drain_slot)`` pairs, the call is a whole forwarding boundary: it also
returns their rows, gathered from the new slots (zeros where ``drain_hop <
-1``), and clears those slots and counts; with ``U = 0`` nothing lands (a
drain-only boundary).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.kernels import _build

_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block gets by default


class _Args(ctypes.Structure):
    """``struct OlafCombineArgs`` of ``csrc/olaf_combine.cu``, field for
    field."""

    _fields_ = ([(n, ctypes.c_int) for n in ("S", "Q", "U", "D", "K", "land")]
                + [(n, ctypes.c_void_p) for n in (
                    "slots", "counts", "updates", "clusters", "gate", "reset",
                    "drain_sw", "drain_slot", "drain_hop", "out",
                    "out_counts", "drained")])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("olaf_combine")
    lib.olaf_combine_launch.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
    lib.olaf_combine_launch.restype = ctypes.c_int
    lib.olaf_combine_error_string.argtypes = [ctypes.c_int]
    lib.olaf_combine_error_string.restype = ctypes.c_char_p
    lib.olaf_combine_smem_words.argtypes = [ctypes.c_int] * 3
    lib.olaf_combine_smem_words.restype = ctypes.c_size_t
    return lib


def _batched(slots, counts, updates, clusters, gate, reset):
    """Every operand with a leading S axis, and whether it was added."""
    if slots.dim() == 2:
        return (slots[None], counts[None], updates[None], clusters[None],
                gate[None], None if reset is None else reset[None]), True
    return (slots, counts, updates, clusters, gate, reset), False


def _check_shapes(slots, counts, updates, clusters, gate, reset, drain) -> None:
    S, Q, D = slots.shape
    U = clusters.shape[-1]
    want = dict(counts=(S, Q), updates=(S, U, D), clusters=(S, U), gate=(S, U),
                reset=(S, Q))
    have = dict(counts=counts, updates=updates, clusters=clusters, gate=gate,
                reset=reset)
    K = None if drain[0] is None else tuple(drain[0].shape)
    for name, t in zip(("drain_sw", "drain_slot", "drain_hop"), drain):
        want[name], have[name] = K, t
    if (drain[0] is None) != (drain[1] is None) or (
            drain[0] is None and drain[2] is not None):
        raise ValueError("olaf_combine: drain_sw and drain_slot come "
                         "together, and drain_hop only with them")
    for name, t in have.items():
        if t is not None and (tuple(t.shape) != want[name] or (
                name.startswith("drain") and len(want[name]) != 1)):
            raise ValueError(f"olaf_combine: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")


def olaf_combine_cuda(slots: torch.Tensor, counts: torch.Tensor,
                      updates: torch.Tensor, clusters: torch.Tensor,
                      gate: torch.Tensor, *, reset: Optional[torch.Tensor] = None,
                      drain_sw: Optional[torch.Tensor] = None,
                      drain_slot: Optional[torch.Tensor] = None,
                      drain_hop: Optional[torch.Tensor] = None):
    """Launch the CUDA combine: slots (Q, D) or (S, Q, D) float32, counts
    (…, Q) int32, updates (…, U, D) float32, clusters/gate (…, U) int32 (a
    bool gate is taken as 0/1), all contiguous on one CUDA device. Returns
    new ``(slots, counts)`` tensors; raises on anything else and on a
    failed launch.

    Optional, all on the same device: ``reset`` (…, Q) bool, the slots
    whose count enters at 0; ``drain_sw``/``drain_slot`` (K,) int32, the
    departing (switch, slot) pairs of a forwarding boundary, and
    ``drain_hop`` (K,) int32 (a row with ``hop < -1`` is zeroed). With a
    drain the call returns ``(slots, counts, drained (K, D))``, and with
    U = 0 it lands nothing (a drain-only boundary, counted in
    ``drain_launches``; every other launch is one window landing, counted
    in ``launches``). Device indices are not range-checked: a negative one
    wraps, one outside the queues gives a zero row."""
    dev = slots.device
    named = dict(counts=counts, updates=updates, clusters=clusters, gate=gate,
                 reset=reset, drain_sw=drain_sw, drain_slot=drain_slot,
                 drain_hop=drain_hop)
    for name, t in named.items():
        if t is not None and t.device != dev:
            raise ValueError(f"olaf_combine: {name} is on {t.device}, the "
                             f"slots on {dev}: operands on more than one device")
    if gate.dtype == torch.bool:
        gate = gate.to(torch.int32)
    (sl, cn, up, cl, gt, rs), squeeze = _batched(slots, counts, updates,
                                                 clusters, gate, reset)
    drain = (drain_sw, drain_slot, drain_hop)
    _check_shapes(sl, cn, up, cl, gt, rs, drain)
    S, Q, D = sl.shape
    U = cl.shape[-1]
    K = 0 if drain_sw is None else drain_sw.shape[0]
    _build.check_int_sizes("olaf_combine", S=S, Q=Q, U=U, D=D, K=K)
    if dev.type != "cuda":
        raise ValueError(f"olaf_combine_cuda needs CUDA tensors, got {dev}")
    for name, t, dt in (("slots", sl, torch.float32), ("counts", cn, torch.int32),
                        ("updates", up, torch.float32),
                        ("clusters", cl, torch.int32), ("gate", gt, torch.int32),
                        ("reset", rs, torch.bool), ("drain_sw", drain_sw, torch.int32),
                        ("drain_slot", drain_slot, torch.int32),
                        ("drain_hop", drain_hop, torch.int32)):
        if t is None:
            continue
        if t.dtype != dt:
            raise TypeError(f"olaf_combine: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"olaf_combine: {name} must be contiguous")
    land = drain_sw is None or U > 0
    lib = _lib()
    smem = 4 * lib.olaf_combine_smem_words(Q, U, K)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"olaf_combine: Q={Q}, U={U}, K={K} needs {smem} B "
                         f"of shared memory per block, over {_SMEM_LIMIT}")
    out = torch.empty_like(sl)
    out_counts = torch.empty_like(cn)
    drained = torch.empty((K, D), dtype=torch.float32, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    args = _Args(S=S, Q=Q, U=U, D=D, K=K, land=int(land), slots=ptr(sl),
                 counts=ptr(cn), updates=ptr(up), clusters=ptr(cl),
                 gate=ptr(gt), reset=ptr(rs), drain_sw=ptr(drain_sw),
                 drain_slot=ptr(drain_slot), drain_hop=ptr(drain_hop),
                 out=ptr(out), out_counts=ptr(out_counts), drained=ptr(drained))
    if S > 0 and Q > 0:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.olaf_combine_launch(ctypes.byref(args), stream)
        if rc != 0:
            raise RuntimeError(
                f"olaf_combine kernel launch failed: CUDA error {rc} "
                f"({lib.olaf_combine_error_string(rc).decode()})")
        if land:
            olaf_combine_cuda.launches += 1
        else:
            olaf_combine_cuda.drain_launches += 1
    if squeeze:
        out, out_counts = out[0], out_counts[0]
    return (out, out_counts) if drain_sw is None else (out, out_counts, drained)


#: Launches of the CUDA kernel that land a window (one per combine, window
#: or forwarding boundary with U > 0) since the count was last set to 0.
olaf_combine_cuda.launches = 0
#: Launches of the CUDA kernel for a drain-only boundary (a drain, U = 0).
olaf_combine_cuda.drain_launches = 0


def olaf_combine_plain(slots: torch.Tensor, counts: torch.Tensor,
                       updates: torch.Tensor, clusters: torch.Tensor,
                       gate: torch.Tensor, *, reset: Optional[torch.Tensor] = None,
                       drain_sw: Optional[torch.Tensor] = None,
                       drain_slot: Optional[torch.Tensor] = None,
                       drain_hop: Optional[torch.Tensor] = None):
    """Plain PyTorch version of :func:`olaf_combine_cuda`, on any device:
    the reset mask by ``torch.where``, one ``index_add_`` of the kept
    ``gate·upd`` rows in ascending u (the kernel's order and skip rule),
    the running-mean blend, then the departing rows by advanced indexing
    (copies), the clear of their slots and the hop mask."""
    (sl, cn, up, cl, gt, rs), squeeze = _batched(slots, counts, updates,
                                                 clusters, gate, reset)
    _check_shapes(sl, cn, up, cl, gt, rs, (drain_sw, drain_slot, drain_hop))
    S, Q, D = sl.shape
    U = cl.shape[-1]
    if drain_sw is not None and U == 0:  # a drain-only boundary
        out, new_counts = sl.clone(), cn.clone()
    else:
        cn = cn.to(torch.int32)
        if rs is not None:
            cn = torch.where(rs, torch.zeros((), dtype=cn.dtype,
                                             device=cn.device), cn)
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
        acc = (sl.to(torch.float32) * cn.to(torch.float32)[..., None]
               + sums.view(S, Q, D))
        new_counts = cn + hits
        out = acc / torch.clamp(new_counts, min=1).to(torch.float32)[..., None]
    if drain_sw is None:
        return (out[0], new_counts[0]) if squeeze else (out, new_counts)
    sw, slot = drain_sw.to(torch.int64), drain_slot.to(torch.int64)
    drained = out[sw, slot]  # advanced indexing: a copy, (K, D)
    out[sw, slot] = 0.0
    new_counts[sw, slot] = 0
    if drain_hop is not None:
        drained = torch.where((drain_hop >= -1)[:, None], drained,
                              torch.zeros((), dtype=drained.dtype,
                                          device=drained.device))
    if squeeze:
        out, new_counts = out[0], new_counts[0]
    return out, new_counts, drained


# the window's small operands: (name, dtype) in the staging buffer's order,
# the 4-byte ones first so that every section starts 4-byte aligned
_WINDOW_OPERANDS = (("clusters", np.int32), ("gate", np.int32),
                    ("drain_sw", np.int32), ("drain_slot", np.int32),
                    ("drain_hop", np.int32), ("reset", np.bool_))


def stage_window(dev: torch.device, **operands) -> Dict[str, Optional[torch.Tensor]]:
    """The window's small operands (``clusters``, ``gate``, ``reset``,
    ``drain_sw``, ``drain_slot``, ``drain_hop``; any may be None) as
    contiguous tensors of the kernel's dtypes on ``dev``. A tensor already
    on ``dev`` is kept (cast only if its dtype differs); host data (numpy
    arrays, lists) is packed into one staging buffer, pinned on a card,
    that reaches ``dev`` in ONE copy, and each operand is a view of it. A
    tensor on another device raises."""
    out: Dict[str, Optional[torch.Tensor]] = {}
    host = {}
    for name, np_dtype in _WINDOW_OPERANDS:
        x = operands.get(name)
        tdtype = torch.bool if np_dtype is np.bool_ else torch.int32
        if x is None:
            out[name] = None
        elif isinstance(x, torch.Tensor):
            if x.device != dev:
                raise ValueError(f"{name} on {x.device}, the slots on {dev}: "
                                 f"operands on more than one device")
            out[name] = x.to(tdtype).contiguous()
        else:
            host[name] = np.ascontiguousarray(x, dtype=np_dtype)
    if not host:
        return out
    nbytes = sum(a.nbytes for a in host.values())
    buf = torch.empty(nbytes, dtype=torch.uint8,
                      pin_memory=dev.type == "cuda")
    flat = buf.numpy()
    spans, at = {}, 0
    for name, a in host.items():
        flat[at:at + a.nbytes] = a.reshape(-1).view(np.uint8)
        spans[name] = (at, a.nbytes, a.shape)
        at += a.nbytes
    staged = buf.to(dev, non_blocking=True) if dev.type == "cuda" else buf
    for name, (at, n, shape) in spans.items():
        tdtype = torch.bool if host[name].dtype == np.bool_ else torch.int32
        out[name] = staged[at:at + n].view(tdtype).view(shape)
    return out
