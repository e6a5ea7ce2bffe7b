"""Public entry points of the port's kernels, routed by the tensors' device.

A CUDA queue state launches the hand-written kernel; a CPU state takes the
kernel's plain PyTorch version. Any other device, or operands spread over
more than one device, raises: there is no fallback from one to the other.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.core.olaf_queue import TorchQueueState, expire_inactive_drains
from repro_torch.kernels.olaf_step import olaf_step_cuda, olaf_step_plain


def _device_of(*tensors) -> torch.device:
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"olaf_step: operands on more than one device: "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


def olaf_step(state: TorchQueueState, clusters, workers, gen_times, rewards,
              payloads, reward_threshold: float = math.inf, send=None,
              capacity=None, active_workers=None, screen=None, *, k: int
              ) -> Tuple[TorchQueueState, Dict[str, torch.Tensor]]:
    """Fused full-cycle data-plane step: burst enqueue → drain-k.

    The counterpart of ``repro.kernels.ops.olaf_step``, with the same
    arguments and the same ``(new_state, out)`` result: ``out`` holds
    ``valid``, ``n_valid``, ``cluster``, ``worker``, ``gen_time``,
    ``reward``, ``agg_count`` and ``payload``, each with a leading ``k``
    axis (row 0 = oldest). One queue (``payload (Q, D)``) or S queues
    (a leading S axis on every operand). ``send`` (bool (U,), False =
    deferred), ``screen`` (bool (U,), True = rejected at ingress),
    ``capacity`` (a slot count) and ``active_workers`` (bool (W,), expires
    drained rows of crashed workers) are optional.

    On CUDA this is one :func:`~repro_torch.kernels.olaf_step.olaf_step_cuda`
    call, which updates the queue in place: treat the passed-in state as
    consumed, as ``repro``'s donating call does.
    """
    dev = _device_of(*state.fields().values(), clusters, workers, gen_times,
                     rewards, payloads, send, capacity, active_workers,
                     screen)
    if dev.type == "cuda":
        step = olaf_step_cuda
    elif dev.type == "cpu":
        step = olaf_step_plain
    else:
        raise ValueError(f"olaf_step: no kernel for device {dev}")
    state, out = step(state, clusters, workers, gen_times, rewards, payloads,
                      k, reward_threshold, send, capacity, screen)
    if active_workers is not None:
        out = expire_inactive_drains(out, active_workers)
    return state, out
