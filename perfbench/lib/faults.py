"""Faults planted under the timed path, to show that the comparison that
decides ``correct`` catches them. Only the calibration and the tests
plant them; a benchmark run never does.

* ``unchanged``: the PS step returns the state it was given;
* ``half_batch``: each worker's gradient is taken over the first half of
  its rows, the mean over those alone (the PS engine: the PS step takes
  the first half of each burst);
* ``altered``: each worker's gradient row is altered where it is
  produced (its first eighth tripled; the PS engine: each burst row's).
"""
from __future__ import annotations

import contextlib

FAULTS = ("unchanged", "half_batch", "altered")


@contextlib.contextmanager
def planted(fault, *, engine: bool = False):
    if fault is None:
        yield
        return
    from repro_torch.launch import train as T
    name = "ps_step" if fault == "unchanged" or engine else "worker_grad"
    real = getattr(T, name)
    if engine and fault == "half_batch":
        def broken(state, burst, *, cfg):
            U = burst["payloads"].shape[0]
            half = {k: (v[: U // 2] if v.dim() and v.shape[0] == U else v)
                    for k, v in burst.items()}
            return real(state, half, cfg=cfg)
    elif engine and fault == "altered":
        def broken(state, burst, *, cfg):
            p = burst["payloads"]
            p[:, : p.shape[1] // 8].mul_(3.0)
            return real(state, burst, cfg=cfg)
    elif fault == "unchanged":
        def broken(state, burst, *, cfg):
            _, stats = real(state, burst, cfg=cfg)
            return state, stats
    elif fault == "half_batch":
        def broken(params, batch, cfg, out):
            half = {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}
            return real(params, half, cfg, out)
    elif fault == "altered":
        def broken(params, batch, cfg, out):
            loss = real(params, batch, cfg, out)
            out[: out.numel() // 8].mul_(3.0)
            return loss
    else:
        raise ValueError(f"unknown fault {fault!r}: one of {FAULTS}")
    setattr(T, name, broken)
    try:
        yield
    finally:
        setattr(T, name, real)
