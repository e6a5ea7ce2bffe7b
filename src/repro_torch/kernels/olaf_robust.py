"""The PS step's robust combine on the card: the weighted mean of the drained
rows, their trimmed mean, and the choice between the two, in one kernel.

When the share of sent rows that the ingress screen flagged exceeds a
threshold, the PS applies the winsorized (trimmed) mean of the drained
block instead of its agg_count-weighted mean. ``repro`` computes both and
selects one on the device (``launch/train.py``'s ``ps_step``); the choice
is never read back to the host. :func:`olaf_robust_combine_cuda` does the
same in one launch of ``csrc/olaf_robust.cu`` (one read of the block, only
the chosen branch computed; the source says how) and counts its launches.
:func:`olaf_robust_combine_plain` is its plain PyTorch version, the
composition ``ps_step`` ran before the kernel: a matrix-vector product,
:func:`~repro_torch.core.aggregation.trimmed_combine_torch` and a
``torch.where``. The CPU path and the on-card comparison use it. Both
take

    frac = n_screen / max(n_send, 1)
    out  = frac > threshold ? trimmed_combine(rows, weights, TRIM)
                            : (weights @ rows) / max(sum(weights), 1)

with ``rows`` (K, D) float32, ``weights`` (K,) float32 (``valid ·
agg_count``) and ``n_screen``, ``n_send`` 0-dim integer tensors.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.aggregation import trimmed_combine_torch
from repro_torch.kernels import _build

#: The most rows one launch takes (the sort network lives in registers).
MAX_ROWS = 32

#: The trimmed band [TRIM, 1 - TRIM]: ``trimmed_combine_torch``'s default,
#: as ``repro``'s ``ps_step`` takes ``jax_trimmed_combine``'s.
TRIM = 0.25


class _Args(ctypes.Structure):
    """``struct OlafRobustArgs`` of ``csrc/olaf_robust.cu``, field for
    field."""

    _fields_ = ([("K", ctypes.c_int), ("D", ctypes.c_int),
                 ("ld", ctypes.c_longlong)]
                + [(n, ctypes.c_float) for n in ("threshold", "q_lo", "q_hi")]
                + [(n, ctypes.c_void_p) for n in (
                    "rows", "weights", "n_screen", "n_send", "out")])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("olaf_robust")
    lib.olaf_robust_combine_launch.argtypes = [ctypes.POINTER(_Args),
                                               ctypes.c_void_p]
    lib.olaf_robust_combine_launch.restype = ctypes.c_int
    lib.olaf_robust_error_string.argtypes = [ctypes.c_int]
    lib.olaf_robust_error_string.restype = ctypes.c_char_p
    return lib


def olaf_robust_combine_cuda(rows: torch.Tensor, weights: torch.Tensor,
                             n_screen: torch.Tensor, n_send: torch.Tensor, *,
                             threshold: float) -> torch.Tensor:
    """Launch the CUDA robust combine: ``rows`` (K, D) float32 with unit
    column stride (a row stride of its own is fine: a column slice of a
    wider block is read in place), ``weights`` (K,) float32 contiguous,
    ``n_screen`` and ``n_send`` 0-dim int32, all on one CUDA device, K at
    most :data:`MAX_ROWS`. Returns a new (D,) float32 tensor; raises on
    anything else and on a failed launch."""
    if rows.dim() != 2 or weights.shape != rows.shape[:1]:
        raise ValueError(f"olaf_robust_combine: rows (K, D) and weights (K,) "
                         f"expected, got {tuple(rows.shape)} and "
                         f"{tuple(weights.shape)}")
    K, D = rows.shape
    if K > MAX_ROWS:
        raise ValueError(f"olaf_robust_combine: K = {K} rows, over the "
                         f"kernel's {MAX_ROWS}")
    _build.check_int_sizes("olaf_robust_combine", K=K, D=D)
    for name, t in (("weights", weights), ("n_screen", n_screen),
                    ("n_send", n_send)):
        if t.device != rows.device:
            raise ValueError(f"olaf_robust_combine: {name} is on {t.device}, "
                             f"the rows on {rows.device}: operands on more "
                             f"than one device")
    if rows.device.type != "cuda":
        raise ValueError(f"olaf_robust_combine_cuda needs CUDA tensors, got "
                         f"{rows.device}")
    for name, t, dt in (("rows", rows, torch.float32),
                        ("weights", weights, torch.float32),
                        ("n_screen", n_screen, torch.int32),
                        ("n_send", n_send, torch.int32)):
        if t.dtype != dt:
            raise TypeError(f"olaf_robust_combine: {name} must be {dt}, got "
                            f"{t.dtype}")
    if n_screen.dim() or n_send.dim():
        raise ValueError("olaf_robust_combine: n_screen and n_send are 0-dim")
    if not weights.is_contiguous() or (D > 1 and rows.stride(1) != 1):
        raise ValueError("olaf_robust_combine: weights must be contiguous "
                         "and the rows' columns adjacent")
    out = torch.empty(D, dtype=torch.float32, device=rows.device)
    if D == 0:
        return out
    args = _Args(K=K, D=D, ld=rows.stride(0), threshold=threshold, q_lo=TRIM,
                 q_hi=1.0 - TRIM, rows=rows.data_ptr(),
                 weights=weights.data_ptr(), n_screen=n_screen.data_ptr(),
                 n_send=n_send.data_ptr(), out=out.data_ptr())
    lib = _lib()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = lib.olaf_robust_combine_launch(ctypes.byref(args), stream)
    if rc != 0:
        raise RuntimeError(
            f"olaf_robust_combine kernel launch failed: CUDA error {rc} "
            f"({lib.olaf_robust_error_string(rc).decode()})")
    olaf_robust_combine_cuda.launches += 1
    return out


#: Launches of the CUDA kernel since the count was last set to 0.
olaf_robust_combine_cuda.launches = 0


def olaf_robust_combine_plain(rows: torch.Tensor, weights: torch.Tensor,
                              n_screen: torch.Tensor, n_send: torch.Tensor, *,
                              threshold: float) -> torch.Tensor:
    """Plain PyTorch version of :func:`olaf_robust_combine_cuda`, on any
    device and for any K: both branches computed, one selected by
    ``torch.where`` (no value read back to the host)."""
    mean = (weights @ rows) / torch.clamp(weights.sum(), min=1.0)
    frac = n_screen.to(torch.float32) / torch.clamp(
        n_send.to(torch.float32), min=1.0)
    return torch.where(frac > threshold,
                       trimmed_combine_torch(rows, weights, TRIM), mean)
