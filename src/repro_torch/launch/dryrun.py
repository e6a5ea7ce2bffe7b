"""Dry run: the per-device memory fit of every (architecture × input shape)
on the production meshes, counted on the meta device against an H100.

The counterpart of ``repro.launch.dryrun``. ``repro`` lowers and compiles
each cell over 512 placeholder host devices and records XLA's memory and
cost analysis; PyTorch has no such compiler, so ``build_lowering`` has no
counterpart here. Instead each cell builds its trees on the meta device
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
    XLA's ``output_size_in_bytes`` counts;
  * ``temp_bytes``: ``None``, with the reason: no compiler on the meta
    device plans the activations' buffers.

``fits_h100_80gb`` holds argument + output bytes against 80 GiB: a lower
bound on what a device needs, since activations are left out.

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
from repro_torch.launch.mesh import HW, make_production_mesh, n_devices
from repro_torch.models import api
from repro_torch.models.module import tree_paths
from repro_torch.optim.optimizers import OptConfig, opt_state_pspecs

OUT_DIR = Path("build") / "dryrun_torch"
TEMP_REASON = "no compiler on the meta device"
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
                temp_reason=TEMP_REASON, arguments=parts,
                per_device_lower_bound=args + out,
                fits_h100_80gb=args + out <= HW["hbm_bytes"])


def mesh_name(multi_pod: bool) -> str:
    return "multipod_2x16x16" if multi_pod else "pod_16x16"


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = None, verbose: bool = False) -> dict:
    """One cell's record (``repro``'s keys where they carry over), saved
    to ``out_dir`` when given."""
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
            if verbose:
                print(mem)
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
        rec = run_cell(a, s, mp, Path(args.out), verbose=args.verbose)
        ok += rec["status"] == "ok"
        fail += rec["status"] == "error"
        skip += rec["status"] == "skipped"
    print(f"\ndry-run summary: {ok} ok, {fail} failed, {skip} skipped "
          f"of {len(cells)} cells")
    return 0 if fail == 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
