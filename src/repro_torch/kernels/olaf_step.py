"""The fused OLAF data-plane cycle (burst enqueue → drain-k) on the card.

Port of the Pallas TPU kernel ``repro/kernels/olaf_step.py::olaf_step_pallas``
as a hand-written CUDA kernel for Hopper (``csrc/olaf_step.cu``: one launch
per call; every block resolves its queue's burst in shared memory and then
walks column tiles of the payload, and the last block of each queue writes
the metadata back; the source says why). :func:`olaf_step_cuda` launches it
on CUDA tensors and counts its launches; :func:`olaf_step_plain` is its
plain PyTorch version (the composition in ``repro_torch.core.olaf_queue``),
which the CPU path and the on-card comparison use.
"""
from __future__ import annotations

import ctypes
import functools
import math
import numbers
from typing import Dict, Optional, Tuple

import torch

from repro_torch.core import olaf_queue
from repro_torch.core.olaf_queue import TorchQueueState
from repro_torch.kernels import _build

_SMEM_LIMIT = 48 * 1024  # dynamic shared memory a block gets by default


class _Args(ctypes.Structure):
    """``struct OlafStepArgs`` of ``csrc/olaf_step.cu``, field for field."""

    _fields_ = ([(n, ctypes.c_int) for n in ("S", "Q", "U", "D", "K", "cap")]
                + [("thr", ctypes.c_float)]
                + [(n, ctypes.c_void_p) for n in (
                    "cluster", "worker", "seq", "gen_time", "reward",
                    "agg_count", "replaceable", "payload", "next_seq",
                    "n_dropped", "n_agg", "n_repl", "n_screened", "capacity",
                    "u_cluster", "u_worker", "u_gen_time", "u_reward",
                    "u_send", "u_screen", "u_payload",
                    "d_valid", "d_cluster", "d_worker", "d_agg_count",
                    "d_gen_time", "d_reward", "d_payload", "n_valid",
                    "tickets")])


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("olaf_step")
    for fn in (lib.olaf_step_launch, lib.olaf_enqueue_launch):
        fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_void_p]
        fn.restype = ctypes.c_int
    lib.olaf_step_error_string.argtypes = [ctypes.c_int]
    lib.olaf_step_error_string.restype = ctypes.c_char_p
    lib.olaf_step_smem_words.argtypes = [ctypes.c_int] * 3
    lib.olaf_step_smem_words.restype = ctypes.c_size_t
    return lib


_STATE_DTYPES = dict(cluster=torch.int32, worker=torch.int32,
                     seq=torch.int32, gen_time=torch.float32,
                     reward=torch.float32, agg_count=torch.int32,
                     replaceable=torch.bool, payload=torch.float32,
                     next_seq=torch.int32, n_dropped=torch.int32,
                     n_agg=torch.int32, n_repl=torch.int32,
                     n_screened=torch.int32)


def _check(op: str, name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.device != device:
        raise ValueError(f"{op}: {name} is on {t.device}, the queue on {device}")
    if t.dtype != dtype:
        raise TypeError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def cycle_operands(name: str, state: TorchQueueState, clusters, workers,
                   gen_times, rewards, payloads, k: int, send, capacity,
                   screen) -> Tuple[TorchQueueState, Dict[str, Optional[torch.Tensor]],
                                    Dict[str, int]]:
    """The checked operands of one ``csrc/olaf_step.cu`` launch on the
    queue's device, which may be the CPU here: ``(state, burst, sizes)``
    with a leading S axis on every tensor (views of the caller's for one
    queue), ``burst`` the kernel's ``u_*`` operands and ``capacity``, and
    ``sizes`` its ``S, Q, U, D, K, cap``. An omitted ``send``, ``screen``
    or ``capacity``, and a Python int ``capacity``, makes no tensor: the
    kernel reads a null pointer as every row sent, none screened, and
    ``cap`` (Q, or the int) for every queue."""
    dev = state.payload.device
    operands = dict(clusters=clusters, workers=workers, gen_times=gen_times,
                    rewards=rewards, payloads=payloads, send=send,
                    capacity=capacity, screen=screen)
    for n, v in operands.items():  # before any coercion could copy them
        if isinstance(v, torch.Tensor) and v.device != dev:
            raise ValueError(f"{name}: {n} is on {v.device}, the queue "
                             f"on {dev}: operands on more than one device")
    if state.payload.dim() == 2:  # views: the in-place update reaches the caller
        state = TorchQueueState(**{n: v.unsqueeze(0)
                                   for n, v in state.fields().items()})
        clusters, workers, gen_times, rewards, payloads = (
            x.unsqueeze(0) for x in (clusters, workers, gen_times, rewards,
                                     payloads))
        send = None if send is None else send.unsqueeze(0)
        screen = None if screen is None else screen.unsqueeze(0)
    S, Q, D = state.payload.shape
    U = clusters.shape[-1]
    _build.check_int_sizes(name, S=S, Q=Q, U=U, D=D)
    for n, v in state.fields().items():
        shape = (S, Q, D) if n == "payload" else (
            (S,) if v.dim() == 1 else (S, Q))
        _check(name, n, v, _STATE_DTYPES[n], shape, dev)

    def cast(x, dtype):
        return None if x is None else torch.as_tensor(
            x, dtype=dtype, device=dev).contiguous()

    burst = dict(u_cluster=cast(clusters, torch.int32),
                 u_worker=cast(workers, torch.int32),
                 u_gen_time=cast(gen_times, torch.float32),
                 u_reward=cast(rewards, torch.float32),
                 u_send=cast(send, torch.bool),
                 u_screen=cast(screen, torch.bool),
                 u_payload=cast(payloads, torch.float32))
    for n, v in burst.items():
        if v is not None:
            _check(name, n, v, v.dtype,
                   (S, U, D) if n == "u_payload" else (S, U), dev)
    cap = Q
    if isinstance(capacity, numbers.Integral):
        cap = int(capacity)
    elif capacity is not None:
        burst["capacity"] = cast(capacity, torch.int32).expand(S).contiguous()
    burst.setdefault("capacity", None)
    return state, burst, dict(S=S, Q=Q, U=U, D=D, K=min(int(k), Q), cap=cap)


def _launch_cycle(entry: str, state: TorchQueueState, clusters, workers,
                  gen_times, rewards, payloads, k: int, reward_threshold,
                  send, capacity, screen):
    """Check and launch one ``csrc/olaf_step.cu`` entry point
    (``olaf_step_launch``, or ``olaf_enqueue_launch`` with ``k == 0`` and
    no ``send``) on the queue's CUDA device; the queue is updated in place.
    Returns ``(state, out)``, ``out`` holding the drained rows (none with
    ``k == 0``). Counts nothing: each public wrapper counts its own."""
    name = entry[:-len("_launch")]
    dev = state.payload.device
    st, burst, sz = cycle_operands(name, state, clusters, workers, gen_times,
                                   rewards, payloads, k, send, capacity,
                                   screen)
    if dev.type != "cuda":
        raise ValueError(f"{name}_cuda needs CUDA tensors, got {dev}")
    S, Q, D, K = sz["S"], sz["Q"], sz["D"], sz["K"]
    lib = _lib()
    smem = 4 * lib.olaf_step_smem_words(Q, sz["U"], K)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"{name}: Q={Q}, U={sz['U']} needs {smem} B of "
                         f"shared memory per block, over {_SMEM_LIMIT}")
    empty = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)  # noqa: E731
    drain = entry == "olaf_step_launch"
    out_t = {} if not drain else dict(
        d_valid=empty((S, K), torch.bool),
        d_cluster=empty((S, K), torch.int32),
        d_worker=empty((S, K), torch.int32),
        d_agg_count=empty((S, K), torch.int32),
        d_gen_time=empty((S, K), torch.float32),
        d_reward=empty((S, K), torch.float32),
        d_payload=empty((S, K, D), torch.float32),
        n_valid=empty((S,), torch.int32),
    )
    ptrs = {**{n: v.data_ptr() for n, v in st.fields().items()},
            **{n: None if v is None else v.data_ptr()
               for n, v in burst.items()},
            **{n: v.data_ptr() for n, v in out_t.items()}}
    args = _Args(**sz, thr=float(reward_threshold), **ptrs)
    if S > 0:
        with torch.cuda.device(dev):
            args.tickets = _build.tickets(dev, S).data_ptr()
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = getattr(lib, entry)(ctypes.byref(args), stream)
        if rc != 0:
            raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc} "
                               f"({lib.olaf_step_error_string(rc).decode()})")
    if not drain:
        return state, {}
    out = dict(valid=out_t["d_valid"], n_valid=out_t["n_valid"],
               cluster=out_t["d_cluster"], worker=out_t["d_worker"],
               gen_time=out_t["d_gen_time"], reward=out_t["d_reward"],
               agg_count=out_t["d_agg_count"], payload=out_t["d_payload"])
    if state.payload.dim() == 2:
        out = {n: v[0] for n, v in out.items()}
    return state, out


def olaf_step_cuda(state: TorchQueueState, clusters, workers, gen_times,
                   rewards, payloads, k: int,
                   reward_threshold: float = math.inf, send=None,
                   capacity=None, screen=None
                   ) -> Tuple[TorchQueueState, Dict[str, torch.Tensor]]:
    """Launch the CUDA ``olaf_step`` kernel: one full cycle for one queue
    (``payload (Q, D)``) or S queues (a leading S axis on every operand).

    The queue is updated IN PLACE: the returned state holds the passed-in
    tensors, which ``repro`` donates at this point; treat the argument as
    consumed. Every state tensor must be contiguous and of
    ``TorchQueueState``'s dtype, and every tensor operand on the queue's
    CUDA device (burst operands are cast to their dtype there, never moved;
    ``capacity`` may be a Python int); the wrapper raises on anything else
    and on a failed launch. Returns
    ``(state, out)`` with ``out`` as :func:`olaf_step_plain` gives it.
    """
    result = _launch_cycle("olaf_step_launch", state, clusters, workers,
                           gen_times, rewards, payloads, k, reward_threshold,
                           send, capacity, screen)
    olaf_step_cuda.launches += 1
    return result


#: Launches of the CUDA kernel since the count was last set to 0.
olaf_step_cuda.launches = 0


def olaf_step_plain(state: TorchQueueState, clusters, workers, gen_times,
                    rewards, payloads, k: int,
                    reward_threshold: float = math.inf, send=None,
                    capacity=None, screen=None
                    ) -> Tuple[TorchQueueState, Dict[str, torch.Tensor]]:
    """Plain PyTorch version of :func:`olaf_step_cuda`, on any device: one
    ``repro_torch.core.olaf_queue.olaf_step`` per queue. Leaves its input
    state untouched."""
    if state.payload.dim() == 2:
        return olaf_queue.olaf_step(state, clusters, workers, gen_times,
                                    rewards, payloads, k, reward_threshold,
                                    send, capacity, None, screen)
    S = state.payload.shape[0]
    caps = (None if capacity is None else
            torch.as_tensor(capacity).expand(S))
    results = [olaf_queue.olaf_step(
        state.select(s), clusters[s], workers[s], gen_times[s], rewards[s],
        payloads[s], k, reward_threshold,
        None if send is None else send[s],
        None if caps is None else caps[s], None,
        None if screen is None else screen[s]) for s in range(S)]
    new_state = TorchQueueState.stack([r[0] for r in results])
    out = {n: torch.stack([r[1][n] for r in results]) for n in results[0][1]}
    return new_state, out
