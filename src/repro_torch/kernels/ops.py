"""Public entry points of the port's kernels, routed by the tensors' device.

The counterparts of ``repro.kernels.ops``'s ``olaf_combine``,
``olaf_combine_multi``, ``olaf_combine_window``, ``olaf_forward``,
``olaf_enqueue``, ``olaf_step``, ``olaf_step_multi``, ``flash_attention`` and
``decode_attention``, without the TPU tiling arguments, and the PS step's
robust combine (``olaf_robust_combine``, which ``repro`` leaves to XLA). CUDA
operands launch the hand-written kernel; CPU operands take the kernel's
plain PyTorch version. Any other device, or operands spread over more than
one device, raises: there is no fallback from one to the other.
``olaf_burst_multi`` has no kernel (``repro`` runs it in XLA, outside any
Pallas kernel): it is plain PyTorch on either device.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from repro_torch.core.olaf_queue import (TorchQueueState, enqueue_burst_ex,
                                         expire_inactive_drains)
from repro_torch.kernels.decode_attention import (decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (FlashAttention,
                                                 flash_attention_cuda,
                                                 flash_attention_plain)
from repro_torch.kernels.olaf_combine import (olaf_combine_cuda,
                                              olaf_combine_plain,
                                              stage_window)
from repro_torch.kernels.olaf_enqueue import (olaf_enqueue_cuda,
                                              olaf_enqueue_plain)
from repro_torch.kernels.olaf_robust import (olaf_robust_combine_cuda,
                                             olaf_robust_combine_plain)
from repro_torch.kernels.olaf_step import olaf_step_cuda, olaf_step_plain


def _device_of(*tensors, op: str = "olaf_step") -> torch.device:
    devices = {t.device for t in tensors if isinstance(t, torch.Tensor)}
    if len(devices) != 1:
        raise ValueError(f"{op}: operands on more than one device: "
                         f"{sorted(map(str, devices))}")
    return devices.pop()


def _route(op: str, dev: torch.device, cuda_fn, plain_fn):
    if dev.type == "cuda":
        return cuda_fn
    if dev.type == "cpu":
        return plain_fn
    raise ValueError(f"{op}: no kernel for device {dev}")


def olaf_combine(slots, counts, updates, clusters, gate, *, reset=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Combine a burst of updates into cluster slots (running mean).

    slots (Q, D) float32, counts (Q,) int32, updates (U, D), clusters (U,)
    int32, gate (U,) int32 or bool -> new ``(slots (Q, D), counts (Q,))``.
    A leading S axis on every operand batches S independent queues in one
    launch. ``gate`` is each update's aggregation weight (0 drops it).
    ``reset`` (…, Q) bool, on the slots' device, marks slots that restart
    from this burst: their counts enter the combine at 0, in the same
    launch.
    """
    dev = _device_of(slots, counts, updates, clusters, gate, op="olaf_combine")
    fn = _route("olaf_combine", dev, olaf_combine_cuda, olaf_combine_plain)
    return fn(slots, counts, updates, clusters, gate.to(torch.int32),
              reset=reset)


def olaf_combine_multi(slots, counts, updates, clusters, gate, *, reset=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-queue combine: every operand carries a leading S (switch) axis
    — slots (S, Q, D), counts (S, Q), updates (S, U, D), clusters/gate
    (S, U), the optional ``reset`` (S, Q) — in one launch."""
    if slots.dim() != 3:
        raise ValueError(f"olaf_combine_multi: slots must be (S, Q, D), got "
                         f"{tuple(slots.shape)}")
    return olaf_combine(slots, counts, updates, clusters, gate, reset=reset)


def olaf_combine_window(slots, counts, updates, clusters, gate, reset_slots
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Window-batched combine for the hybrid replay: one whole transmission
    window — ``updates`` (S, U, D), ``clusters``/``gate`` (S, U) and
    ``reset_slots`` (S, Q) bool, the last three host (numpy) buffers or
    tensors on the slots' device — in one combine. ``gate`` carries each
    entry's weight with non-contributing entries already 0; a slot in
    ``reset_slots`` restarts from this window, so its count enters the
    combine at 0. On a card this is one kernel launch, and the host
    buffers reach the card in one copy."""
    dev = _device_of(slots, counts, updates, op="olaf_combine_window")
    fn = _route("olaf_combine_window", dev, olaf_combine_cuda,
                olaf_combine_plain)
    w = stage_window(dev, clusters=clusters, gate=gate, reset=reset_slots)
    return fn(slots, counts, updates, w["clusters"], w["gate"],
              reset=w["reset"])


def olaf_forward(slots, counts, updates, clusters, gate, reset_slots,
                 drain_sw, drain_slot, drain_hop=None):
    """Window combine and departing-row gather, one dispatch per boundary.

    Lands the pending window exactly as :func:`olaf_combine_window` (only
    when ``updates`` has U > 0; U = 0 is a drain-only boundary), then
    gathers the departing rows ``drain_sw``/``drain_slot`` (K,) from the
    post-combine buffer and clears their slots. Returns new
    ``(slots, counts, drained (K, D))``, or ``(…, drained, hops (K,))``
    when ``drain_hop`` (K,) is given (next hop: a switch index, -1 = PS,
    -2 = dropped); a row with ``hop < -1`` is zeroed. The drained rows are
    copies, never views of the slot buffer. The passed-in tensors are not
    modified. On a card the whole boundary is one kernel launch, and the
    host index arrays reach the card in one copy.
    """
    dev = _device_of(slots, counts, updates, op="olaf_forward")
    fn = _route("olaf_forward", dev, olaf_combine_cuda, olaf_combine_plain)
    w = stage_window(dev, clusters=clusters, gate=gate, reset=reset_slots,
                     drain_sw=drain_sw, drain_slot=drain_slot,
                     drain_hop=drain_hop)
    slots, counts, drained = fn(
        slots, counts, updates, w["clusters"], w["gate"], reset=w["reset"],
        drain_sw=w["drain_sw"], drain_slot=w["drain_slot"],
        drain_hop=w["drain_hop"])
    if drain_hop is None:
        return slots, counts, drained
    return slots, counts, drained, w["drain_hop"]


def olaf_enqueue(state: TorchQueueState, clusters, workers, gen_times,
                 rewards, payloads, reward_threshold: float = math.inf,
                 capacity=None, screen=None) -> TorchQueueState:
    """Fused burst enqueue (Algorithm 1 for U updates, no drain) for one
    queue: the counterpart of ``repro.kernels.ops.olaf_enqueue``.
    ``screen`` (bool (U,)) withholds rows flagged by the ingress integrity
    gate and counts them in ``n_screened``; ``capacity`` caps the logical
    slot count. On CUDA this is one
    :func:`~repro_torch.kernels.olaf_enqueue.olaf_enqueue_cuda` call, which
    updates the queue in place: treat the passed-in state as consumed."""
    dev = _device_of(*state.fields().values(), clusters, workers, gen_times,
                     rewards, payloads, capacity, screen, op="olaf_enqueue")
    fn = _route("olaf_enqueue", dev, olaf_enqueue_cuda, olaf_enqueue_plain)
    return fn(state, clusters, workers, gen_times, rewards, payloads,
              reward_threshold, capacity, screen)


def olaf_step(state: TorchQueueState, clusters, workers, gen_times, rewards,
              payloads, reward_threshold: float = math.inf, send=None,
              capacity=None, active_workers=None, screen=None, *, k: int,
              impl: str = "auto"
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

    ``impl`` is ``repro``'s: ``"auto"`` routes by the device (the kernel
    on a card, the plain version on the CPU), ``"xla"`` takes the plain
    version on any device, and ``"pallas"`` the kernel, raising off a card.
    """
    dev = _device_of(*state.fields().values(), clusters, workers, gen_times,
                     rewards, payloads, send, capacity, active_workers,
                     screen)
    if impl == "xla":
        step = olaf_step_plain
    elif impl == "pallas":
        if dev.type != "cuda":
            raise ValueError(f"olaf_step: impl='pallas' launches the CUDA "
                             f"kernel, and the operands are on {dev}")
        step = olaf_step_cuda
    elif impl == "auto":
        step = _route("olaf_step", dev, olaf_step_cuda, olaf_step_plain)
    else:
        raise ValueError(f"olaf_step: unknown impl {impl!r}: use auto, xla "
                         f"or pallas")
    state, out = step(state, clusters, workers, gen_times, rewards, payloads,
                      k, reward_threshold, send, capacity, screen)
    if active_workers is not None:
        out = expire_inactive_drains(out, active_workers)
    return state, out


def olaf_step_multi(states: TorchQueueState, clusters, workers, gen_times,
                    rewards, payloads, reward_threshold=math.inf, send=None,
                    capacity=None, screen=None, *, k: int
                    ) -> Tuple[TorchQueueState, Dict[str, torch.Tensor]]:
    """Multi-queue fused cycle: the counterpart of ``repro.kernels.ops.
    olaf_step_multi``. Every operand carries a leading S axis: ``states``
    of (S, Q), (S, Q, D) and (S,) tensors, the burst (S, U) and (S, U, D);
    ``capacity`` is a slot count or an ``(S,)`` vector, one per switch. On
    a card the S queues are one ``olaf_step`` launch (see
    :func:`repro_torch.distributed.sharding.olaf_step_sharded` for the
    split over a mesh); the queue is updated in place there."""
    if states.payload.dim() != 3:
        raise ValueError(f"olaf_step_multi: payload must be (S, Q, D), got "
                         f"{tuple(states.payload.shape)}")
    return olaf_step(states, clusters, workers, gen_times, rewards, payloads,
                     reward_threshold, send, capacity, None, screen, k=k)


def olaf_robust_combine(rows, weights, n_screen, n_send, *,
                        threshold: float) -> torch.Tensor:
    """The PS step's combine under the ingress screen: the weighted mean
    ``(weights @ rows) / max(sum(weights), 1)`` of the drained block
    ``rows`` (K, D), or its trimmed mean (``aggregation.
    trimmed_combine_torch``) where ``n_screen / max(n_send, 1) >
    threshold``; ``n_screen`` and ``n_send`` are 0-dim counts on the rows'
    device, so the choice is made there. On a card this is one
    :func:`~repro_torch.kernels.olaf_robust.olaf_robust_combine_cuda` launch,
    which takes up to ``olaf_robust.MAX_ROWS`` (32) rows and raises above
    that; on the CPU, the plain composition.
    """
    dev = _device_of(rows, weights, n_screen, n_send,
                     op="olaf_robust_combine")
    fn = _route("olaf_robust_combine", dev, olaf_robust_combine_cuda,
                olaf_robust_combine_plain)
    return fn(rows, weights, n_screen.to(torch.int32),
              n_send.to(torch.int32), threshold=threshold)


def olaf_burst_multi(states: TorchQueueState, clusters, workers, gen_times,
                     rewards, payloads, reward_threshold=math.inf, send=None,
                     capacity=None, in_counts=None, in_replaceable=None):
    """Multi-queue enqueue-only burst with per-update event reporting: the
    counterpart of ``repro.kernels.ops.olaf_burst_multi``, the entry the
    vectorized simulator (:mod:`repro_torch.core.vecsim`) routes its
    arrival bursts through.

    Every operand carries a leading S (switch) axis: ``states`` of (S, Q),
    (S, Q, D) and (S,) tensors, the burst (S, U) and (S, U, D),
    ``reward_threshold`` and ``capacity`` a number or (S,). ``send``
    (False = withheld), ``in_counts`` (a row that is already the mean of k
    updates) and ``in_replaceable`` are (S, U). Returns ``(new_states,
    slots (S, U), events (S, U))`` with the Algorithm 1 outcome codes of
    :func:`~repro_torch.core.olaf_queue.enqueue_burst_ex`, whose S-queue
    walk it is: a capacity is a slot count, as ``_burst_resolve`` has it
    (ROADMAP hazard H1). No drain. Plain PyTorch on either device; the
    passed-in state is left untouched.
    """
    dev = _device_of(*states.fields().values(), clusters, workers,
                     gen_times, rewards, payloads, send, capacity, in_counts,
                     in_replaceable, op="olaf_burst_multi")
    if clusters.dim() != 2:
        raise ValueError(f"olaf_burst_multi: the burst must be (S, U), got "
                         f"{tuple(clusters.shape)}")
    S = clusters.shape[0]
    thr = torch.as_tensor(reward_threshold, dtype=torch.float32,
                          device=dev).expand(S)
    cap = states.cluster.shape[1] if capacity is None else capacity
    cap = torch.as_tensor(cap, dtype=torch.int32, device=dev).expand(S)
    return enqueue_burst_ex(states, clusters, workers, gen_times, rewards,
                            payloads, thr, send, cap, None, in_counts,
                            in_replaceable)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    q_offset: int = 0) -> torch.Tensor:
    """Flash attention in the model's (B, S, H, Dh) layout (kv already
    expanded to H heads): the counterpart of ``repro.kernels.ops.
    flash_attention``. The kernel reads q, k and v in place through their
    strides and writes a new (B, Sq, H, Dh) tensor: no fold copy. Where
    autograd records (a gradient enabled and an operand that requires one)
    the call goes through :class:`FlashAttention`, the kernel pair with its
    backward (on a card bf16 with Dh 64 or 128, else it raises)."""
    dev = _device_of(q, k, v, op="flash_attention")
    fn = _route("flash_attention", dev, flash_attention_cuda,
                flash_attention_plain)
    if q.dim() != 4:
        raise ValueError(f"flash_attention: q (B, S, H, Dh) expected, got "
                         f"{tuple(q.shape)}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, causal, window, q_offset)
    return fn(q, k, v, causal=causal, window=window, q_offset=q_offset)


def decode_attention(q, k_cache, v_cache, pos) -> torch.Tensor:
    """GQA decode attention: q (B, KV, rep, Dh) against the unexpanded
    caches (B, S, KV, Dh), pos (B,) int32 -> (B, KV, rep, Dh). The
    counterpart of ``repro.kernels.ops.decode_attention``."""
    dev = _device_of(q, k_cache, v_cache, pos, op="decode_attention")
    fn = _route("decode_attention", dev, decode_attention_cuda,
                decode_attention_plain)
    return fn(q, k_cache, v_cache, pos)
