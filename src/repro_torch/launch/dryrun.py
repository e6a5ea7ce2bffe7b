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
  * ``collectives``: ``{"per_kind", "total_bytes"}``, the bytes of each
    collective's result on rank 0 by ``hlo_analysis.COLLECTIVE_KINDS``,
    ``repro``'s convention (:class:`CollectiveBytes`, counted at the
    functional-collective level). The plan is DTensor's, not XLA's: a
    ``Partial`` reduced over two mesh axes is two all-reduces, one per
    axis (ROADMAP hazard H32), and the reshards differ from GSPMD's.

Full depth can take tens of seconds a cell, so :func:`sharded_probes` runs
the 1- and 2-period probes (and the tail's) that ``launch.roofline``
counts FLOPs with and extrapolates linearly: collectives exactly (each
period issues the same ones), ``temp_bytes`` as far as the peak grows by
the same bytes per period.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod|--single-pod]

Records: ``<out>/<arch>__<shape>__<mesh>.json``, ``--out`` defaulting to
``build/dryrun_torch/`` under the working directory.
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


class CollectiveBytes(TorchDispatchMode):
    """Counts, per ``hlo_analysis.COLLECTIVE_KINDS`` kind, the bytes of the
    result of every functional collective this rank issues (``repro``'s
    convention: an all-gather counts what it gathers, a reduce-scatter its
    shard). DTensor desugars first (the mode passes on DTensor arguments),
    so each collective is seen once at the local-tensor level, backward
    included. On a CPU mesh DTensor lowers a shard-to-shard all-to-all to
    an all-gather and a chunk (gloo has no all-to-all); inside the mode
    that call is counted as the one all-to-all NCCL would run, the bytes of
    its result (ROADMAP hazard H31). A kind outside ``COLLECTIVE_KINDS``
    (a broadcast) is counted under its own name, not dropped."""

    _PATCHED = ("placement_types", "_collective_utils", "_redistribute")

    def __init__(self):
        super().__init__()
        self.per_kind = {k: 0 for k in COLLECTIVE_KINDS}
        self._inside_a2a = 0
        self._saved = []

    def add(self, kind: str, nbytes: int):
        self.per_kind[kind] = self.per_kind.get(kind, 0) + int(nbytes)

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
                if not self._inside_a2a and a[3].size(a[4]) > 1:
                    self.add("all-to-all", _nbytes(out))
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
        out = func(*args, **(kwargs or {}))
        kind = _COLLECTIVE_OPS.get(func._overloadpacket.__name__)
        if (kind is not None and not self._inside_a2a
                and func.namespace in ("_c10d_functional",
                                       "_c10d_functional_autograd")
                and _group_size(args, kwargs) > 1):
            self.add(kind, _nbytes(out))
        return out

    def record(self) -> Dict[str, Any]:
        return {"per_kind": dict(self.per_kind),
                "total_bytes": sum(self.per_kind.values())}


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
                opt: OptConfig = OptConfig()) -> Dict[str, Any]:
    """One step of ``shape.kind`` at ``cfg``'s depth on meta DTensors over a
    fake mesh of ``mesh``'s axes (see the module docstring): ``temp_bytes``,
    ``peak_bytes``, ``argument_local_bytes`` (the arguments' local shards,
    every leaf) and ``collectives``; ``cfg`` before
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
        counter = CollectiveBytes()
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
                argument_local_bytes=held,
                collectives=counter.record())


def _extrapolate(c1: Dict[str, Any], c2: Dict[str, Any], n_full: int,
                 ct: Dict[str, Any] = None) -> Dict[str, Any]:
    """``base + n_full · per_period (+ tail − c1)`` over the numbers of two
    probe records (nested dicts of ints)."""
    out: Dict[str, Any] = {}
    for k, a in c1.items():
        if isinstance(a, dict):
            out[k] = _extrapolate(a, c2[k], n_full, ct and ct[k])
            continue
        per = c2[k] - a
        out[k] = a - per + n_full * per + (ct[k] - a if ct else 0)
    return out


def sharded_probes(cfg: ArchConfig, shape: ShapeCfg, mesh,
                   opt: OptConfig = OptConfig()) -> Dict[str, Any]:
    """:func:`sharded_fit` of the whole depth from the 1- and 2-period
    probes, and the tail's (``launch.roofline``'s probes): ``temp_bytes``,
    ``peak_bytes``, ``argument_local_bytes`` and ``collectives`` linear in
    the periods, with the probes' depths under ``probes``."""
    from repro_torch.models.transformer import period_len, split_plan

    if cfg.family == "encdec":
        per, n_full, tail = 1, cfg.n_layers, []
    else:
        per = period_len(cfg)
        _, n_full, tail = split_plan(cfg)

    def at(n):
        return sharded_fit(dataclasses.replace(
            cfg, n_layers=n, n_enc_layers=min(cfg.n_enc_layers, n)),
            shape, mesh, opt)

    depths = [per, 2 * per] + ([per + len(tail)] if tail else [])
    c1, c2 = at(per), at(2 * per)
    ct = at(per + len(tail)) if tail else None
    out = _extrapolate(c1, c2, n_full, ct)
    out["probes"] = depths
    return out


def mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = None, verbose: bool = False, *,
             sharded: bool = True) -> dict:
    """One cell's record (``repro``'s keys where they carry over), saved
    to ``out_dir`` when given: the fast pass, then (``sharded``) the
    sharded pass from the probes."""
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
                sh = sharded_probes(cfg, shape, mesh)
                total = (mem["argument_bytes"] + mem["output_bytes"]
                         + sh["temp_bytes"])
                mem.update(temp_bytes=sh["temp_bytes"], per_device_total=total,
                           fits_h100_80gb=total <= HW["hbm_bytes"])
                del mem["temp_reason"]
                rec.update(collectives=sh["collectives"],
                           sharded=dict(
                               {k: v for k, v in sh.items()
                                if k != "collectives"},
                               seconds=time.perf_counter() - t1),
                           collective_plan="DTensor's (torch "
                           f"{torch.__version__}), not XLA's")
            if verbose:
                print(mem)
            if sharded:
                coll = rec["collectives"]
                kinds = ", ".join(f"{k} {v / 2**20:.1f}" for k, v in
                                  coll["per_kind"].items() if v)
                print(f"[ok] {arch} {shape_name} {name}: args "
                      f"{mem['argument_bytes'] / 2**30:.2f} GiB, out "
                      f"{mem['output_bytes'] / 2**30:.2f} GiB, temp "
                      f"{mem['temp_bytes'] / 2**30:.2f} GiB per device (fits "
                      f"80 GiB: {mem['fits_h100_80gb']}); collectives "
                      f"{coll['total_bytes'] / 2**30:.2f} GiB ({kinds} MiB)")
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
    args = ap.parse_args(argv)

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
                       sharded=not args.fast)
        ok += rec["status"] == "ok"
        fail += rec["status"] == "error"
        skip += rec["status"] == "skipped"
    print(f"\ndry-run summary: {ok} ok, {fail} failed, {skip} skipped "
          f"of {len(cells)} cells")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
