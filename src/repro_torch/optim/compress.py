"""Gradient compression for the update path (paper §10 future work, here a
first-class feature): top-k sparsification with error feedback, and int8
linear quantization. Keeps a model update inside one network frame — the
constraint Olaf's no-fragmentation design imposes (§10).

The counterpart of ``repro.optim.compress``. Every function takes and
returns tensors on the caller's device (plain PyTorch: ``repro`` has no
Pallas kernel here); ``ErrorFeedback`` is ``repro``'s numpy code.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

_NAN_KEY = 0x7FC00000  # every NaN magnitude ranks as one value, above +inf


# ---------------------------------------------------------------------------
# top-k sparsification (+ error feedback residual)
# ---------------------------------------------------------------------------
def _magnitude_key(g: torch.Tensor) -> torch.Tensor:
    """|g| as int32 keys in ``lax.top_k``'s order: the bits of a
    non-negative float32 grow with its value, ``-0.0`` and ``0.0`` share
    key 0, and every NaN gets one key above +inf."""
    mag = g.to(torch.float32).abs()
    return torch.where(torch.isnan(mag), _NAN_KEY, mag.view(torch.int32))


def topk_compress(g: torch.Tensor, k: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat gradient -> (indices (k,) int32, values (k,)) of the
    largest-|.| entries, in ``jax.lax.top_k``'s order (H2): magnitudes
    descending, NaN first, and on equal magnitudes the lower index first.

    ``torch.topk`` orders ties as it likes, so it only finds the k-th
    magnitude here (a radix select on a card): every entry above it is
    kept, then the lowest-index entries equal to it, and only those k are
    sorted (stably, so equal keys keep their index order). O(D) passes and
    no sort of the whole gradient (D = 3.6e8 at smollm-360m's width).
    """
    if not 0 <= k <= g.numel():
        raise ValueError(f"topk_compress: k={k} outside [0, {g.numel()}]")
    key = _magnitude_key(g)
    if k == 0:
        idx = torch.zeros(0, dtype=torch.int64, device=g.device)
    else:
        kth = torch.topk(key, k, sorted=False).values.min()
        above = key > kth
        ties = key == kth
        need = k - above.sum()
        keep = above | (ties & (torch.cumsum(ties, 0, dtype=torch.int32)
                                <= need))
        idx = torch.nonzero(keep).squeeze(1)  # ascending index order
        order = torch.sort(key[idx], descending=True, stable=True).indices
        idx = idx[order]
    return idx.to(torch.int32), g[idx]


def topk_decompress(idx: torch.Tensor, vals: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """A dense ``(dim,)`` vector holding ``vals`` at ``idx``. As ``repro``'s
    ``.at[idx].set``: a negative index counts from the end, and an index
    outside ``[-dim, dim)`` is dropped."""
    idx = idx.to(torch.int64)
    idx = torch.where(idx < 0, idx + dim, idx)
    keep = (idx >= 0) & (idx < dim)
    out = torch.zeros((dim,), dtype=vals.dtype, device=vals.device)
    out[idx[keep]] = vals[keep]
    return out


def topk_compress_jit(g: torch.Tensor, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`topk_compress` under ``repro``'s name for its donating jitted
    entry point. PyTorch has no buffer donation (H5): nothing here consumes
    ``g``, which stays valid after the call."""
    return topk_compress(g, k)


class ErrorFeedback:
    """Residual accumulator: what top-k drops is carried to the next round."""

    def __init__(self, dim: int) -> None:
        self.residual = np.zeros((dim,), np.float32)

    def compress(self, g: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        corrected = g + self.residual
        idx = np.argpartition(np.abs(corrected), -k)[-k:]
        vals = corrected[idx]
        self.residual = corrected.copy()
        self.residual[idx] = 0.0
        return idx.astype(np.int32), vals.astype(np.float32)


# ---------------------------------------------------------------------------
# int8 linear quantization
# ---------------------------------------------------------------------------
def int8_quantize(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q int8, scale 0-dim)``: ``round(g / scale)`` (half to even, as
    ``jnp.round``) with ``scale = max(|g|, 1e-12) / 127`` over the finite
    entries. Non-finite coordinates would make every quantized value NaN,
    so they are pinned to the clip bounds (+inf 127, -inf -127, NaN 0)."""
    finite = torch.isfinite(g)
    g0 = torch.where(finite, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device))
    scale = torch.clamp(g0.abs().max(), min=1e-12) / 127.0
    pinned = torch.where(torch.isnan(g), 0.0,
                         torch.where(g > 0, 127.0, -127.0)).to(g.dtype)
    q_f = torch.where(finite, torch.round(g0 / scale), pinned)
    q = torch.clamp(q_f, -127, 127).to(torch.int8)
    return q, scale


def int8_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def wire_bits(dim: int, *, topk: Optional[int] = None,
              int8: bool = False) -> int:
    """Bits on the wire for one update (drives Olaf packet sizing)."""
    if topk is not None:
        per = 32 + (8 if int8 else 32)  # index + value
        return topk * per + 32
    return dim * (8 if int8 else 32) + 32
