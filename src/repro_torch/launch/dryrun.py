"""Dry run: the per-device memory fit and collectives of every
(architecture × input shape) on the production meshes, against an H100.

The counterpart of ``repro.launch.dryrun``. ``repro`` lowers and compiles
each cell over 512 placeholder host devices and records XLA's memory,
cost and collective analysis. PyTorch compiles nothing here; each cell
takes two passes instead.

**The fast pass** (:func:`memory_fit`) builds the trees on the meta device
(``api.param_spec``, ``input_specs``, the step's outputs by running the
entry point on meta tensors), shards each leaf by its spec
(``distributed.sharding``: the bytes divided by the product of the sizes
of the axes the spec names) and sums:

  * ``argument_bytes``: params, AdamW ``m``/``v`` in float32 and ``step``
    (train), and the inputs (caches included for decode); of a prefill or
    decode step only the leaves it reads, as ``jax.jit`` prunes the unused
    ones (decode reads no encoder weights of encdec, no patch projection
    of vlm, no positions of ssm);
  * ``output_bytes``: the new params and optimizer state and the loss
    (train), or the logits and the caches (prefill, decode), plus 8 bytes
    per output leaf, the pointer of each leaf in the output tuple that
    XLA's ``output_size_in_bytes`` counts.

**The sharded pass** (:func:`sharded_fit`, ``build_lowering``'s
counterpart) runs the step itself, :func:`train_step` (loss and gradients
over ``cfg.microbatches`` microbatches summed in float32, then AdamW),
:func:`prefill_step` or :func:`serve_step`, on meta DTensors placed by the
specs (``sharding.to_named``) over :func:`sharding.fake_device_mesh`, one
process standing in for every rank, under ``implicit_replication()``, with
``layers.constrain`` redistributing the activations as ``repro``'s
constraints pin them. It records rank 0's view, per device:

  * ``temp_bytes``: the peak of the bytes of rank 0's live local tensors
    over the step (``MemTracker`` on the meta device, every storage once),
    less the bytes of the step's arguments live at that peak. It holds the
    activations, gradients and temporaries, and the outputs as far as they
    are alive at the peak (XLA's ``temp_size_in_bytes`` leaves the output
    buffers out), so ``argument_bytes + temp_bytes`` is the step's peak;
  * ``per_device_total``: argument + output + temp bytes, ``repro``'s sum,
    which ``fits_h100_80gb`` holds against 80 GiB; it counts the outputs
    alive at the peak twice, so it errs high (``per_device_lower_bound``,
    argument + output bytes, is kept beside it);
  * ``cost``: ``{"flops", "bytes_accessed", "transcendentals"}``,
    ``repro``'s record of XLA's cost analysis, counted op by op on rank
    0's local tensors (:class:`StepCost`): every op's operand and result
    bytes (a gather or scatter the elements it touches, :func:`op_bytes`),
    eager and unfused, so above XLA's count of the same step; the
    FLOPs of the matrix products and attention only; the transcendentals
    of the ops XLA counts as such;
  * ``collectives``: ``{"per_kind", "total_bytes"}``, the bytes of each
    collective's result on rank 0 by ``hlo_analysis.COLLECTIVE_KINDS``,
    ``repro``'s convention (:class:`StepCost`, counted at the
    functional-collective level). The plan is DTensor's, not XLA's: a
    ``Partial`` reduced over two mesh axes is two all-reduces, one per
    axis (ROADMAP hazard H32), and the reshards differ from GSPMD's.

Full depth can take tens of seconds a cell, so :func:`sharded_probes` runs
the 1- and 2-period probes (and the tail's) that ``launch.roofline``
counts FLOPs with and extrapolates linearly: collectives and ``cost``
exactly (each period issues the same ops; a train step's bytes grow as
the square of the depth, so train cells add a 3-period probe and fit the
quadratic, ROADMAP hazard H35), ``temp_bytes`` as far as the peak grows
by the same bytes per period. ``--fast`` records no ``cost``
(``cost_reason`` says why).

PyTorch emits no HLO: ``--hlo-dump`` writes the 1-period probe's local op
trace instead (:func:`write_op_trace`), one line per op with its local
operand and result specs, bytes, FLOPs and transcendentals.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k [--hlo-dump]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]

Records: ``<out>/<arch>__<shape>__<mesh>.json`` (and ``.ops.txt``),
``--out`` defaulting to ``build/dryrun_torch/`` under the working
directory.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils._pytree import tree_leaves as _operands

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.distributed import sharding as SH
from repro_torch.launch.hlo_analysis import COLLECTIVE_KINDS
from repro_torch.launch.mesh import HW, make_production_mesh, n_devices
from repro_torch.launch.train import loss_and_grads as train_loss_and_grads
from repro_torch.models import api
from repro_torch.models.api import META
from repro_torch.models.module import tree_leaves, tree_paths, tree_unflatten
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state, opt_state_pspecs)

OUT_DIR = Path("build") / "dryrun_torch"
FAST_REASON = "the fast pass: the sharded pass (sharded_fit) measures it"
#: the columns of an op trace (``--hlo-dump``, :func:`write_op_trace`)
TRACE_COLUMNS = ("op", "operands", "results", "bytes", "flops",
                 "transcendentals", "collective")
#: bytes XLA counts per leaf of an output tuple (one 64-bit pointer each)
TUPLE_ENTRY_BYTES = 8

ARCHS = [
    "smollm-360m", "gemma-2b", "chatglm3-6b", "mistral-large-123b",
    "mamba2-130m", "grok-1-314b", "arctic-480b", "whisper-small",
    "recurrentgemma-9b", "internvl2-76b",
]


def vocab_pad_for(cfg: ArchConfig, mesh) -> int:
    m = SH.axis_sizes(mesh).get("model", 1)
    return m if cfg.vocab % m else 1


def default_microbatches(cfg: ArchConfig) -> int:
    """Gradient-accumulation factor sized to the per-device activation
    budget, ``repro``'s."""
    if cfg.d_model >= 8192:
        return 8
    if cfg.d_model >= 6144 or cfg.family == "moe":
        return 4
    if cfg.d_model >= 4096:
        return 2
    return 1


def with_mesh_context(cfg: ArchConfig, mesh) -> ArchConfig:
    """Attach the distribution context (tp size, activation constraints)."""
    axes = tuple(SH.axis_sizes(mesh).items())
    tp = dict(axes).get("model", 1)
    mb = 1 if cfg.unroll_loops else default_microbatches(cfg)
    return dataclasses.replace(cfg, tp_size=tp, shard_acts=True,
                               mesh_axes=axes, microbatches=mb)


def _root(t: torch.Tensor) -> torch.Tensor:
    return t if t._base is None else t._base


class _Reads(TorchDispatchMode):
    """Records the root of every tensor an op reads or writes; a view op
    only relabels its operand and records nothing."""

    def __init__(self):
        super().__init__()
        self.roots = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not func.is_view:
            self.roots.update(id(_root(t)) for t in _operands((args, kwargs))
                              if isinstance(t, torch.Tensor))
        return func(*args, **kwargs)


def per_device_bytes(tree, spec_tree, mesh, itemsize=None, read=None) -> int:
    """Bytes of one device's shard of every leaf of ``tree`` (of those
    whose root is in ``read``, where given): each leaf's bytes (at
    ``itemsize`` bytes an element where given, else its own) over the
    product of the sizes of the axes its spec names."""
    sizes = SH.axis_sizes(mesh)
    specs = SH.tree_paths_like(spec_tree)
    total = 0
    for path, leaf in tree_paths(tree).items():
        if read is not None and id(_root(leaf)) not in read:
            continue
        names = [a for e in specs[path] if e is not None
                 for a in ((e,) if isinstance(e, str) else e)]
        n = math.prod(sizes[a] for a in names)
        nbytes = leaf.numel() * (itemsize or leaf.element_size())
        if nbytes % n:
            raise ValueError(f"{path}: {nbytes} B over {n} devices")
        total += nbytes // n
    return total


def _n_leaves(tree) -> int:
    return len(tree_paths(tree))


def _run_step(cfg: ArchConfig, shape: ShapeCfg, params, inputs):
    """The prefill or decode step on the meta device: ``((logits,
    caches), the roots of the tensors it read)``."""
    cfg = dataclasses.replace(cfg, attn_impl="full")  # one op on meta
    with torch.no_grad(), _Reads() as reads:
        if shape.kind == "prefill":
            out = api.prefill(params, inputs, cfg)
        else:
            out = api.decode_step(params, inputs["caches"], inputs, cfg)
    return out, reads.roots


def memory_fit(cfg: ArchConfig, shape: ShapeCfg, mesh,
               opt: OptConfig = OptConfig()) -> Dict[str, Any]:
    """Per-device argument and output bytes of the cell's step (see the
    module docstring); ``cfg`` before :func:`with_mesh_context`."""
    cfg = with_mesh_context(cfg, mesh)
    pspec = api.param_spec(cfg, vocab_pad_for(cfg, mesh))
    p_sh = SH.params_pspecs_cfg(pspec, mesh, cfg)
    inputs = api.input_specs(cfg, shape)
    d_sh = SH.data_pspecs(inputs, mesh, cfg)
    read = None
    if shape.kind != "train":
        (logits, caches), read = _run_step(cfg, shape, pspec, inputs)
    param_b = per_device_bytes(pspec, p_sh, mesh, read=read)
    input_b = per_device_bytes(inputs, d_sh, mesh, read=read)
    if shape.kind == "train":
        o_sh = opt_state_pspecs(p_sh, opt)
        moments = 2 if opt.kind == "adamw" else 1
        # float32 moments sharded like their params, and the int32 step
        opt_b = moments * per_device_bytes(pspec, o_sh.m, mesh, 4) + 4
        args = param_b + opt_b + input_b
        n_out = (1 + moments) * _n_leaves(pspec) + 2  # + step, + loss
        out = param_b + opt_b + 4 + TUPLE_ENTRY_BYTES * n_out
        parts = dict(params=param_b, opt_state=opt_b, inputs=input_b)
    else:
        out_tree = {"logits": logits, "caches": caches}
        out_sh = {"logits": (None,) * (logits.dim() - 1) + ("model",),
                  "caches": SH.cache_pspecs(caches, mesh, cfg)}
        out = (per_device_bytes(out_tree, out_sh, mesh)
               + TUPLE_ENTRY_BYTES * _n_leaves(out_tree))
        args = param_b + input_b
        parts = dict(params=param_b, inputs=input_b)
    return dict(argument_bytes=args, output_bytes=out, temp_bytes=None,
                temp_reason=FAST_REASON, arguments=parts,
                per_device_lower_bound=args + out,
                fits_h100_80gb=args + out <= HW["hbm_bytes"])


# ---------------------------------------------------------------------------
# The steps (plain tensors or DTensors alike)
# ---------------------------------------------------------------------------
def loss_and_grads(params, batch, cfg: ArchConfig):
    """``(loss, grads)`` of one step, grads in ``tree_leaves`` order:
    ``cfg.microbatches`` microbatches (every ``M``-th row of the batch, so a
    batch-sharded microbatch stays on its shard), each loss and gradient
    summed in float32 and divided by ``M``, as ``repro``'s scan does. One
    microbatch gives the gradients in their params' dtypes."""
    M = max(int(cfg.microbatches), 1)
    if M == 1:
        return train_loss_and_grads(params, batch, cfg)
    B = next(iter(batch.values())).shape[0]
    if B % M:
        raise ValueError(f"batch {B} over {M} microbatches")
    g_sum = [torch.zeros_like(x, dtype=torch.float32)
             for x in tree_leaves(params)]
    loss = None
    for m in range(M):
        mb = {k: v.reshape((B // M, M) + tuple(v.shape[1:]))[:, m]
              for k, v in batch.items()}
        l_m, g = train_loss_and_grads(params, mb, cfg)
        loss = l_m if loss is None else loss + l_m
        g_sum = [a + b.to(torch.float32) for a, b in zip(g_sum, g)]
        del g
    return loss / M, [g / M for g in g_sum]


def train_step(params, opt_state, batch, cfg: ArchConfig,
               opt: OptConfig = OptConfig()):
    """``repro``'s ``train_step``: :func:`loss_and_grads`, then
    ``apply_updates``. Returns ``(params, opt_state, loss)``."""
    loss, grads = loss_and_grads(params, batch, cfg)
    params, opt_state = apply_updates(
        params, tree_unflatten(params, grads), opt_state, opt)
    return params, opt_state, loss


def prefill_step(params, batch, cfg: ArchConfig):
    with torch.no_grad():
        return api.prefill(params, batch, cfg)


def serve_step(params, caches, batch, cfg: ArchConfig):
    """One decode step; the caches are updated in place and returned."""
    with torch.no_grad():
        return api.decode_step(params, caches, batch, cfg)


# ---------------------------------------------------------------------------
# The sharded pass
# ---------------------------------------------------------------------------
_COLLECTIVE_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_reduce_coalesced_": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "reduce_scatter_tensor_out": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast", "broadcast_": "broadcast",
}


def _nbytes(out) -> int:
    return sum(t.numel() * t.element_size() for t in _operands(out)
               if isinstance(t, torch.Tensor))


def _held_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` really holds: a dim of stride 0 (an
    ``expand``) counts once, not its logical size."""
    if t.numel() == 0:
        return 0
    return (math.prod(n for n, st in zip(t.shape, t.stride()) if st)
            * t.element_size())


#: ops that only relabel storage, or allocate without writing: no traffic
#: (a view, ``func.is_view``, moves none either)
_NO_TRAFFIC = frozenset({
    "_unsafe_view", "alias", "detach", "detach_", "lift_fresh",
    "as_strided_", "squeeze_", "unsqueeze_", "t_", "transpose_",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "resize_",
    "wait_tensor",  # hands back the functional collective's own result
    "_wrap_tensor_autograd",  # wraps that result for autograd
})
#: ops that write their result and read no operand: the result only
_FILLS = frozenset({
    "fill_", "zero_", "zeros", "ones", "full", "scalar_tensor",
    "zeros_like", "ones_like", "full_like", "new_zeros", "new_ones",
    "new_full",
})
#: in-place ops that overwrite their first operand without reading it
_OVERWRITES = frozenset({"copy_"})
#: ops that take part of their first operand: they read the elements they
#: take (their result's size, at most the source's), as XLA's gather
_GATHERS = frozenset({"index", "index_select", "gather", "embedding",
                      "take", "take_along_dim"})


def _indexed_numel(self: torch.Tensor, indices) -> int:
    """The elements ``self[indices]`` names (``index_put``'s region): the
    index tensors' broadcast shape times the dims they leave whole; a mask
    counts as many elements as it holds (its true ones are data)."""
    shapes, whole, dim = [], 1, 0
    for i in indices:
        if i is None:
            whole *= self.shape[dim]
            dim += 1
        elif i.dtype in (torch.bool, torch.uint8):
            shapes.append((i.numel(),))
            dim += i.dim()
        else:
            shapes.append(tuple(i.shape))
            dim += 1
    return (math.prod(torch.broadcast_shapes(*shapes)) * whole
            * math.prod(self.shape[dim:]))


def _scatter_parts(name, args, kwargs):
    """``(index bytes, value bytes read, touched elements, accumulates)``
    of an op that writes part of its first operand, or None for any other
    op."""
    a = list(args)
    if name in ("index_put", "index_put_", "_index_put_impl_"):
        acc = a[3] if len(a) > 3 else kwargs.get("accumulate", False)
        idx = sum(_held_bytes(i) for i in a[1] if i is not None)
        return idx, _held_bytes(a[2]), _indexed_numel(a[0], a[1]), bool(acc)
    if name in ("index_add", "index_add_", "index_copy", "index_copy_"):
        return (_held_bytes(a[2]), _held_bytes(a[3]), a[3].numel(),
                name.startswith("index_add"))
    if name in ("index_fill", "index_fill_"):
        n = a[2].numel() * a[0].numel() // max(a[0].shape[a[1]], 1)
        val = _held_bytes(a[3]) if isinstance(a[3], torch.Tensor) else 0
        return _held_bytes(a[2]), val, n, False
    if name in ("scatter", "scatter_", "scatter_add", "scatter_add_",
                "scatter_reduce", "scatter_reduce_"):
        n = a[2].numel()  # the src elements read are the index's
        val = n * a[3].element_size() if isinstance(a[3], torch.Tensor) \
            else 0
        acc = name not in ("scatter", "scatter_") or "reduce" in kwargs \
            or len(a) > 4
        return _held_bytes(a[2]), val, n, acc
    return None


def op_bytes(func, args, kwargs, out) -> int:
    """The bytes one op moves, at its operands' (local) shapes: each tensor
    operand read once and each result written once (an in-place op counts
    its read and its write), by :func:`_held_bytes`; 0 for a view, an op
    in ``_NO_TRAFFIC``, one that returns no tensor, or a copy from the host
    onto another device (a cached constant is copied once a process, so
    the count would depend on what ran before); a fill (``_FILLS``) its
    result only; an ``out=`` tensor only as a result.

    An op that touches part of a tensor counts what it touches. A gather
    (``_GATHERS``) reads its indices and as many elements of its source as
    it returns, and writes its result: 2·result + indices, XLA's count of
    a gather, where the result is no larger than the source; a gather that
    repeats its source (a K/V head repeat) reads each element once. A
    scatter (``index_put_``, ``index_add_``, ``scatter_``, …,
    :func:`_scatter_parts`) reads its indices and values and writes the
    region it names, and reads that region too where it accumulates (a
    region counted no larger than its target); an out-of-place one copies
    its first operand whole first (eager PyTorch clones it), and that copy
    counts too."""
    name = func._overloadpacket.__name__
    results = [t for t in _operands(out) if isinstance(t, torch.Tensor)]
    if func.is_view or name in _NO_TRAFFIC or not results:
        return 0
    reads = [] if name in _FILLS else [
        t for t in _operands((args, {k: v for k, v in kwargs.items()
                                     if k != "out"}))
        if isinstance(t, torch.Tensor)]
    if reads and results[0].device.type != "cpu" and all(
            t.device.type == "cpu" for t in reads):
        return 0  # from the host: over PCIe (XLA: a constant of the program)
    aten = func.namespace == "aten"  # c10d's scatter_, gather_ move whole
    if aten and name in _GATHERS:
        return (sum(_held_bytes(t) for t in reads[1:])
                + min(_held_bytes(reads[0]), _held_bytes(results[0]))
                + _held_bytes(results[0]))
    parts = _scatter_parts(name, args, kwargs) if aten else None
    if parts is not None:
        idx, values, n, acc = parts
        n = min(n, args[0].numel())
        copy = 0 if name.endswith("_") else (_held_bytes(args[0])
                                             + _held_bytes(results[0]))
        return copy + idx + values + (2 if acc else 1) * n * \
            args[0].element_size()
    if name in _OVERWRITES:
        reads = reads[1:]
    return sum(_held_bytes(t) for t in reads + results)


def _each(c: int):
    return lambda args, kwargs, n: c * n


def _pow(args, kwargs, n):
    """A float exponent that is not whole, or a tensor exponent; an
    integer power is multiplies (JAX's ``integer_pow``)."""
    e = args[1]
    return n if isinstance(e, torch.Tensor) or (
        isinstance(e, float) and not e.is_integer()) else 0


def _per_row(args, kwargs, n):
    """One exp per element and one log per row (a ``log_softmax``)."""
    x, dim = args[0], args[1]
    return n + (n // max(x.size(dim), 1) if x.dim() else n)


#: the transcendentals of the aten ops whose XLA counterparts XLA counts as
#: transcendental (exp, log, tanh, logistic, rsqrt, sqrt, erf, sin/cos,
#: power): ``(args, kwargs, result elements) -> count``; one per result
#: element unless a comment says otherwise. A composite counts what its
#: decomposition (``torch._decomp``) computes, so an op counts the same
#: whether it is dispatched whole or as its parts
#: (``test_transcendentals_count_the_same_whole_or_decomposed``). Every op
#: of a backward that is not fused into one of these is counted as the op
#: it is.
_TRANSCENDENTALS = {
    **{name: _each(1) for name in (
        "exp", "exp_", "exp2", "expm1", "log", "log_", "log2", "log10",
        "log1p", "tanh", "tanh_", "sigmoid", "sigmoid_", "rsqrt", "rsqrt_",
        "sqrt", "sqrt_", "erf", "erf_", "sin", "cos", "tan", "atan2")},
    "silu": _each(1), "silu_": _each(1),  # x · logistic(x)
    "silu_backward": _each(1),  # recomputes logistic(x)
    "gelu": _each(1),  # erf(x / √2), or tanh under approximate="tanh"
    # tanh's form recomputes its tanh; erf's form an erf and the pdf's exp
    "gelu_backward": lambda args, kwargs, n: n * (
        1 if kwargs.get("approximate", "none") == "tanh" else 2),
    "softplus": _each(2),  # log1p(exp(βx))
    "softplus_backward": _each(1),  # exp(βx)
    "logaddexp": _each(2),  # exp and log1p of the difference
    "_softmax": _each(1),  # one exp per element
    "_log_softmax": _per_row,
    "_log_softmax_backward_data": _each(1),  # exp of the saved output
    # an exp per element of the input, a log per element of the result
    "logsumexp": lambda args, kwargs, n: args[0].numel() + n,
    "pow": _pow, "pow_": _pow,
}


def op_flops(func, args, kwargs, out) -> int:
    """``torch.utils.flop_counter``'s count of the op (``flop_registry``:
    matrix products, convolutions and attention; 0 for any other op), as
    ``FlopCounterMode`` and ``roofline.count_flops`` take it."""
    fn = flop_registry.get(func._overloadpacket)
    return 0 if fn is None else int(fn(*args, **kwargs, out_val=out))


def op_transcendentals(func, args, kwargs, out) -> int:
    fn = _TRANSCENDENTALS.get(func._overloadpacket.__name__)
    if fn is None:
        return 0
    return int(fn(args, kwargs, sum(t.numel() for t in _operands(out)
                                    if isinstance(t, torch.Tensor))))


def _spec(t: torch.Tensor) -> str:
    """``dtype[shape]``, and the bytes it holds where an ``expand`` makes
    that less than its logical size."""
    spec = (f"{str(t.dtype).replace('torch.', '')}"
            f"[{','.join(map(str, t.shape))}]")
    held = _held_bytes(t)
    return spec if held == t.numel() * t.element_size() else \
        f"{spec}(holds {held} B)"


class StepCost(TorchDispatchMode):
    """The per-device cost of the local ops this rank issues, ``repro``'s
    ``cost`` record, and the bytes of its collectives.

    DTensor desugars first (the mode passes on DTensor arguments), so each
    op is seen once at its local shapes, backward and the remat recompute
    included; ops that DTensor's sharding propagation (:class:`_Propagation`)
    runs count nothing. Per op:

      * ``bytes_accessed``: :func:`op_bytes`;
      * ``flops``: :func:`op_flops`, matrix products and attention only,
        where XLA also counts the elementwise ops;
      * ``transcendentals``: :func:`op_transcendentals`.

    Eager and unfused: every intermediate of an elementwise chain is
    written and read again, which XLA's fusions keep in registers, so
    ``bytes_accessed`` lies above XLA's count of the same step.

    ``per_kind`` holds, per ``hlo_analysis.COLLECTIVE_KINDS`` kind, the
    bytes of the result of every functional collective over more than one
    rank (``repro``'s convention: an all-gather counts what it gathers, a
    reduce-scatter its shard); a collective's operand and result also count
    in ``bytes_accessed`` like any op's. On a CPU mesh DTensor lowers a
    shard-to-shard all-to-all to an all-gather and a chunk (gloo has no
    all-to-all); inside the mode that call is counted as the one all-to-all
    NCCL would run, its input and its result (ROADMAP hazard H31), and
    the gather and chunk count nothing. A kind outside ``COLLECTIVE_KINDS``
    (a broadcast) is counted under its own name, not dropped.

    ``trace``, a list where given, receives one line per op counted: the
    aten overload, local operand and result specs, bytes, FLOPs,
    transcendentals and, for a collective, its kind and group size
    (:func:`write_op_trace`)."""

    _PATCHED = ("placement_types", "_collective_utils", "_redistribute")

    def __init__(self, trace: list = None):
        super().__init__()
        self.per_kind = {k: 0 for k in COLLECTIVE_KINDS}
        self.bytes_accessed = self.flops = self.transcendentals = 0
        self.trace = trace
        self._inside_a2a = 0
        self._saved = []

    def add(self, kind: str, nbytes: int):
        self.per_kind[kind] = self.per_kind.get(kind, 0) + int(nbytes)

    def _count(self, name, reads, results, nbytes, flops=0, trans=0,
               collective=""):
        self.bytes_accessed += nbytes
        self.flops += flops
        self.transcendentals += trans
        if self.trace is not None:
            self.trace.append((
                name, " ".join(_spec(t) for t in reads) or "-",
                " ".join(_spec(t) for t in results) or "-", nbytes, flops,
                trans, collective or "-"))

    def __enter__(self):
        import importlib
        for name in self._PATCHED:
            mod = importlib.import_module(f"torch.distributed.tensor.{name}")
            orig = getattr(mod, "shard_dim_alltoall", None)
            if orig is None:
                continue

            def counted(*a, _orig=orig, **k):
                self._inside_a2a += 1
                try:
                    out = (_a2a_meta(*a, **k) if a[0].device.type == "meta"
                           else _orig(*a, **k))
                finally:
                    self._inside_a2a -= 1
                n = a[3].size(a[4])
                if not self._inside_a2a and n > 1:
                    self.add("all-to-all", _nbytes(out))
                    self._count("shard_dim_alltoall", [a[0]], [out],
                                _held_bytes(a[0]) + _held_bytes(out),
                                collective=f"all-to-all/{n}")
                return out

            self._saved.append((mod, orig))
            mod.shard_dim_alltoall = counted
        return super().__enter__()

    def __exit__(self, *exc):
        for mod, orig in self._saved:
            mod.shard_dim_alltoall = orig
        self._saved = []
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._inside_a2a or _Propagation.depth:
            return out
        kind = (_COLLECTIVE_OPS.get(func._overloadpacket.__name__)
                if func.namespace in ("_c10d_functional",
                                      "_c10d_functional_autograd") else None)
        n = _group_size(args, kwargs) if kind else 0
        if kind and n <= 1:  # a collective over one rank: XLA emits none
            return out
        if kind:
            self.add(kind, _nbytes(out))
        self._count(str(func), [t for t in _operands((args, kwargs))
                                if isinstance(t, torch.Tensor)],
                    [t for t in _operands(out)
                     if isinstance(t, torch.Tensor)],
                    op_bytes(func, args, kwargs, out),
                    op_flops(func, args, kwargs, out),
                    op_transcendentals(func, args, kwargs, out),
                    f"{kind}/{n}" if kind else "")
        return out

    def record(self) -> Dict[str, Any]:
        return {"per_kind": dict(self.per_kind),
                "total_bytes": sum(self.per_kind.values())}

    def cost(self) -> Dict[str, int]:
        """``repro``'s ``cost`` keys: ``flops``, ``bytes_accessed``,
        ``transcendentals``."""
        return dict(flops=self.flops, bytes_accessed=self.bytes_accessed,
                    transcendentals=self.transcendentals)


def write_op_trace(path: Path, header: Dict[str, Any], trace) -> None:
    """The op trace ``--hlo-dump`` writes: ``# key: value`` header lines,
    then one tab-separated line per op (:class:`StepCost`'s ``trace``);
    the bytes column sums to the pass's ``bytes_accessed``."""
    lines = [f"# {k}: {v}" for k, v in header.items()]
    lines.append("# " + "\t".join(TRACE_COLUMNS))
    lines += ["\t".join(map(str, row)) for row in trace]
    path.write_text("\n".join(lines) + "\n")


def _group_size(args, kwargs) -> int:
    """The size of the group a functional collective names (its last
    string argument): a collective over one rank moves nothing, and XLA
    emits none."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    names = [a for a in list(args) + list((kwargs or {}).values())
             if isinstance(a, str)]
    return _resolve_process_group(names[-1]).size() if names else 2


def _a2a_meta(x, gather_dim, shard_dim, mesh, mesh_dim):
    """The result of ``shard_dim_alltoall`` on meta: one buffer the size of
    the input, as NCCL's all-to-all writes (the CPU fallback would gather
    the whole dim first)."""
    n = mesh.size(mesh_dim)
    shape = list(x.shape)
    shape[gather_dim] *= n
    shape[shard_dim] //= n
    return x.new_empty(shape)


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


class _Propagation:
    """Marks DTensor's sharding propagation while it runs: it builds meta
    tensors of the global shapes outside any fake mode (the strategies of
    decomposed ops), which are no rank's memory and which
    :func:`_tracker` leaves out."""

    depth = 0
    _NAMES = ("propagate", "propagate_op_sharding",
              "propagate_op_sharding_non_cached")

    def __enter__(self):
        prop = _dtensor_type()._op_dispatcher.sharding_propagator
        self._saved = []
        for name in self._NAMES:
            orig = getattr(prop, name, None)
            if orig is None:
                continue

            def marked(*a, _orig=orig, **k):
                _Propagation.depth += 1
                try:
                    return _orig(*a, **k)
                finally:
                    _Propagation.depth -= 1

            had = name in vars(prop)
            self._saved.append((prop, name, had, orig))
            setattr(prop, name, marked)
        return self

    def __exit__(self, *exc):
        for prop, name, had, orig in reversed(self._saved):
            if had:
                setattr(prop, name, orig)
            else:
                delattr(prop, name)
        return False


def _tracker():
    """``MemTracker`` on rank 0's local tensors, DTensor's propagation
    (:class:`_Propagation`) left out."""
    from torch.distributed._tools.mem_tracker import MemTracker

    class LocalMemTracker(MemTracker):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if _Propagation.depth:
                return func(*args, **(kwargs or {}))
            return super().__torch_dispatch__(func, types, args, kwargs)

    return LocalMemTracker()


def _local_leaves(*trees):
    return [x.to_local() for t in trees for x in tree_leaves(t)]


def sharded_fit(cfg: ArchConfig, shape: ShapeCfg, mesh,
                opt: OptConfig = OptConfig(), trace: list = None
                ) -> Dict[str, Any]:
    """One step of ``shape.kind`` at ``cfg``'s depth on meta DTensors over a
    fake mesh of ``mesh``'s axes (see the module docstring): ``temp_bytes``,
    ``peak_bytes``, ``argument_local_bytes`` (the arguments' local shards,
    every leaf), ``cost`` and ``collectives`` (:class:`StepCost`, which
    appends its op trace to ``trace`` where given); ``cfg`` before
    :func:`with_mesh_context`. The flash kernel's
    route (``attn_impl="pallas"``) raises on meta; its cells run ``auto``'s
    plain routes, as ``launch.roofline``'s probes do."""
    from torch.distributed._tools.mem_tracker import _TOTAL_KEY, _MemRefType
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = with_mesh_context(cfg, mesh)
    if cfg.attn_impl == "pallas":
        cfg = dataclasses.replace(cfg, attn_impl="auto")
    pspec = api.param_spec(cfg, vocab_pad_for(cfg, mesh))
    p_sh = SH.params_pspecs_cfg(pspec, mesh, cfg)
    inputs = api.input_specs(cfg, shape)
    d_sh = SH.data_pspecs(inputs, mesh, cfg)
    with SH.fake_device_mesh(SH.axis_sizes(mesh)) as dm:
        params = SH.to_named(pspec, p_sh, dm)
        batch = SH.to_named(inputs, d_sh, dm)
        args = [params, batch]
        if shape.kind == "train":
            o_state = init_opt_state(pspec, opt)
            args.append(SH.to_named(o_state, opt_state_pspecs(p_sh, opt),
                                    dm))
        tracker = _tracker()
        tracker.track_external(*_local_leaves(*args))
        counter = StepCost(trace)
        with implicit_replication(), _Propagation(), counter, tracker:
            if shape.kind == "train":
                out = train_step(params, args[2], batch, cfg, opt)
            elif shape.kind == "prefill":
                out = prefill_step(params, batch, cfg)
            else:
                out = serve_step(params, batch["caches"],
                                 {"token": batch["token"],
                                  "pos": batch["pos"]}, cfg)
        del out
        peak = tracker.get_tracker_snapshot("peak").get(META, {})
    total = peak.get(_TOTAL_KEY, 0)
    held = peak.get(_MemRefType.OTH, 0)
    return dict(temp_bytes=total - held, peak_bytes=total,
                argument_local_bytes=held, cost=counter.cost(),
                collectives=counter.record())


def _extrapolate(c1: Dict[str, Any], c2: Dict[str, Any], n_full: int,
                 ct: Dict[str, Any] = None, c3: Dict[str, Any] = None
                 ) -> Dict[str, Any]:
    """The whole depth's numbers from the probe records' (nested dicts of
    ints): ``c1 + (n − 1)·d + (n − 1)(n − 2)/2·s (+ tail − c1)``, ``d`` the
    second period's ``c2 − c1`` and ``s`` the second difference
    ``c3 − 2·c2 + c1`` of a 3-period probe where one is given (else 0, a
    line: ``base + n·per_period``)."""
    out: Dict[str, Any] = {}
    for k, a in c1.items():
        if isinstance(a, dict):
            out[k] = _extrapolate(a, c2[k], n_full, ct and ct[k],
                                  c3 and c3[k])
            continue
        d = c2[k] - a
        s = c3[k] - 2 * c2[k] + a if c3 else 0
        out[k] = (a + (n_full - 1) * d + (n_full - 1) * (n_full - 2) // 2 * s
                  + (ct[k] - a if ct else 0))
    return out


def sharded_probes(cfg: ArchConfig, shape: ShapeCfg, mesh,
                   opt: OptConfig = OptConfig(), trace: list = None
                   ) -> Dict[str, Any]:
    """:func:`sharded_fit` of the whole depth from the 1- and 2-period
    probes, and the tail's (``launch.roofline``'s probes): ``temp_bytes``,
    ``peak_bytes``, ``argument_local_bytes``, ``cost`` and ``collectives``
    linear in the periods (``collectives`` and a prefill's or decode's
    ``cost`` exactly: every period issues the same ops), with the probes'
    depths under ``probes``; ``trace`` receives the 1-period probe's op
    trace.

    A train step's ``bytes_accessed`` grows as the square of the depth:
    each period takes its weights from the stacked leaves by ``select``,
    whose backward writes a zero-padded gradient of the whole stack, and
    autograd sums one such tensor per period. So train cells take a
    3-period probe too, and ``cost`` follows the quadratic through the
    three, exactly. The probe is temporary: once ``run_periods`` takes the
    periods' weights by ``unbind`` (ROADMAP, the stacked-gradient
    follow-up) the step is linear and the quadratic term goes."""
    from repro_torch.models.transformer import period_len, split_plan

    if cfg.family == "encdec":
        per, n_full, tail = 1, cfg.n_layers, []
    else:
        per = period_len(cfg)
        _, n_full, tail = split_plan(cfg)

    def at(n, trace=None):
        return sharded_fit(dataclasses.replace(
            cfg, n_layers=n, n_enc_layers=min(cfg.n_enc_layers, n)),
            shape, mesh, opt, trace)

    depths = [per, 2 * per] + ([per + len(tail)] if tail else [])
    c1, c2 = at(per, trace), at(2 * per)
    ct = at(per + len(tail)) if tail else None
    out = _extrapolate(c1, c2, n_full, ct)
    if shape.kind == "train":
        depths.append(3 * per)
        out["cost"] = _extrapolate(c1["cost"], c2["cost"], n_full,
                                   ct and ct["cost"], at(3 * per)["cost"])
    out["probes"] = depths
    return out


def mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = None, verbose: bool = False, *,
             sharded: bool = True, hlo_dump: bool = False) -> dict:
    """One cell's record (``repro``'s keys where they carry over), saved
    to ``out_dir`` when given: the fast pass, then (``sharded``) the
    sharded pass from the probes; ``hlo_dump`` writes the 1-period probe's
    op trace beside the record (``<arch>__<shape>__<mesh>.ops.txt``)."""
    if hlo_dump and (out_dir is None or not sharded):
        raise ValueError("hlo_dump needs out_dir and the sharded pass")
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    name = mesh_name(multi_pod)
    rec = {"arch": arch, "shape": shape_name, "mesh": name,
           "kind": shape.kind, "status": "skipped", "reason": None}
    if not cfg.supports(shape):
        rec["reason"] = "long_500k skipped: pure full-attention arch"
    elif (cfg.family == "encdec" and shape.kind == "decode"
          and shape_name == "long_500k"):
        rec["reason"] = "enc-dec long-context decode N/A"
    else:
        mesh = make_production_mesh(multi_pod=multi_pod)
        t0 = time.perf_counter()
        try:
            mem = memory_fit(cfg, shape, mesh)
            rec.update(status="ok", count_s=time.perf_counter() - t0,
                       memory=mem, n_devices=n_devices(mesh),
                       hardware="NVIDIA H100 SXM5 80GB (data sheet)")
            if sharded:
                t1 = time.perf_counter()
                trace = [] if hlo_dump else None
                sh = sharded_probes(cfg, shape, mesh, trace=trace)
                total = (mem["argument_bytes"] + mem["output_bytes"]
                         + sh["temp_bytes"])
                mem.update(temp_bytes=sh["temp_bytes"], per_device_total=total,
                           fits_h100_80gb=total <= HW["hbm_bytes"])
                del mem["temp_reason"]
                rec.update(cost=sh["cost"], collectives=sh["collectives"],
                           sharded=dict(
                               {k: v for k, v in sh.items()
                                if k not in ("collectives", "cost")},
                               seconds=time.perf_counter() - t1),
                           collective_plan="DTensor's (torch "
                           f"{torch.__version__}), not XLA's")
                if hlo_dump:
                    out_dir.mkdir(parents=True, exist_ok=True)
                    write_op_trace(
                        out_dir / f"{arch}__{shape_name}__{name}.ops.txt",
                        {"arch": arch, "shape": shape_name, "mesh": name,
                         "probe depth": sh["probes"][0],
                         "bytes_accessed": sum(r[3] for r in trace),
                         "torch": torch.__version__,
                         "rank": "0, local shapes; DTensor's plan"}, trace)
            else:
                rec.update(cost=None, cost_reason=FAST_REASON)
            if verbose:
                print(mem)
                cost = rec["cost"]
                print({"flops": cost["flops"],
                       "bytes accessed": cost["bytes_accessed"],
                       "transcendentals": cost["transcendentals"]}
                      if cost else rec["cost_reason"])
            if sharded:
                coll, cost = rec["collectives"], rec["cost"]
                kinds = ", ".join(f"{k} {v / 2**20:.1f}" for k, v in
                                  coll["per_kind"].items() if v)
                print(f"[ok] {arch} {shape_name} {name}: args "
                      f"{mem['argument_bytes'] / 2**30:.2f} GiB, out "
                      f"{mem['output_bytes'] / 2**30:.2f} GiB, temp "
                      f"{mem['temp_bytes'] / 2**30:.2f} GiB per device (fits "
                      f"80 GiB: {mem['fits_h100_80gb']}); collectives "
                      f"{coll['total_bytes'] / 2**30:.2f} GiB ({kinds} MiB); "
                      f"bytes accessed {cost['bytes_accessed'] / 2**30:.2f} "
                      f"GiB, {cost['flops']:.3e} FLOPs, "
                      f"{cost['transcendentals']:.3e} transcendentals")
            else:
                print(f"[ok] {arch} {shape_name} {name}: args "
                      f"{mem['argument_bytes'] / 2**30:.2f} GiB, out "
                      f"{mem['output_bytes'] / 2**30:.2f} GiB per device "
                      f"(lower bound; fits 80 GiB: {mem['fits_h100_80gb']})")
        except Exception as e:  # noqa: BLE001 — record it, keep sweeping
            rec.update(status="error", reason=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-2000:])
            print(f"[FAIL] {arch} {shape_name} {name}: {e}")
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{arch}__{shape_name}__{name}.json").write_text(
            json.dumps(rec, indent=1, default=str))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--verbose", action="store_true",
                    help="print each cell's memory record")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the JSON records")
    ap.add_argument("--fast", action="store_true",
                    help="argument and output bytes only (no sharded pass)")
    ap.add_argument("--hlo-dump", action="store_true",
                    help="write each cell's local op trace (the 1-period "
                         "probe's) beside its record, as .ops.txt")
    args = ap.parse_args(argv)
    if args.hlo_dump and args.fast:
        ap.error("--hlo-dump traces the sharded pass, which --fast skips")

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod or not args.single_pod:
        meshes.append(True)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    cells = [(a, s, mp) for a in archs for s in shapes for mp in meshes]
    ok = fail = skip = 0
    for a, s, mp in cells:
        rec = run_cell(a, s, mp, Path(args.out), verbose=args.verbose,
                       sharded=not args.fast, hlo_dump=args.hlo_dump)
        ok += rec["status"] == "ok"
        fail += rec["status"] == "error"
        skip += rec["status"] == "skipped"
    print(f"\ndry-run summary: {ok} ok, {fail} failed, {skip} skipped "
          f"of {len(cells)} cells")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
