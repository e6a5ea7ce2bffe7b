"""The fused OLAF burst enqueue (Algorithm 1, no drain) on the card.

Port of the Pallas TPU kernel ``repro/kernels/olaf_combine.py::
olaf_enqueue_pallas`` (body ``_enqueue_kernel``), the enqueue-only half of
the ``olaf_step`` cycle: :func:`olaf_enqueue_cuda` runs the one launch of
``csrc/olaf_step.cu`` with no drain (K = 0) and every row sent, through
that file's ``olaf_enqueue_launch``, and counts its own launches.
:func:`olaf_enqueue_plain` is its plain PyTorch version,
``repro_torch.core.olaf_queue.enqueue_burst`` (the counterpart of
``repro``'s ``jax_enqueue_burst``, the oracle of the Pallas kernel).
"""
from __future__ import annotations

import math

import torch

from repro_torch.core import olaf_queue
from repro_torch.core.olaf_queue import TorchQueueState
from repro_torch.kernels.olaf_step import _launch_cycle


def olaf_enqueue_cuda(state: TorchQueueState, clusters, workers, gen_times,
                      rewards, payloads, reward_threshold: float = math.inf,
                      capacity=None, screen=None) -> TorchQueueState:
    """Launch the CUDA enqueue for one queue (``payload (Q, D)``) or S
    queues (a leading S axis on every operand). ``screen`` (bool, True =
    withheld at ingress, counted in ``n_screened``) and ``capacity`` (a
    slot count) are optional; there is no ``send`` gate.

    The queue is updated IN PLACE and returned: treat the argument as
    consumed. Operands are checked as ``olaf_step_cuda`` checks them; the
    wrapper raises on a CPU queue, on mixed devices and on a failed launch.
    """
    state, _ = _launch_cycle("olaf_enqueue_launch", state, clusters, workers,
                             gen_times, rewards, payloads, 0,
                             reward_threshold, None, capacity, screen)
    olaf_enqueue_cuda.launches += 1
    return state


#: Launches of the CUDA kernel since the count was last set to 0.
olaf_enqueue_cuda.launches = 0


def olaf_enqueue_plain(state: TorchQueueState, clusters, workers, gen_times,
                       rewards, payloads, reward_threshold: float = math.inf,
                       capacity=None, screen=None) -> TorchQueueState:
    """Plain PyTorch version of :func:`olaf_enqueue_cuda`, on any device:
    one ``olaf_queue.enqueue_burst`` per queue. Leaves its input state
    untouched."""
    if state.payload.dim() == 2:
        return olaf_queue.enqueue_burst(state, clusters, workers, gen_times,
                                        rewards, payloads, reward_threshold,
                                        None, capacity, screen)
    S = state.payload.shape[0]
    caps = None if capacity is None else torch.as_tensor(capacity).expand(S)
    return TorchQueueState.stack([olaf_queue.enqueue_burst(
        state.select(s), clusters[s], workers[s], gen_times[s], rewards[s],
        payloads[s], reward_threshold, None,
        None if caps is None else caps[s],
        None if screen is None else screen[s]) for s in range(S)])
