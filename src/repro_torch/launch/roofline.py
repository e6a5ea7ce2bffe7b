"""Roofline per (architecture × shape) on the single-pod mesh, against an
H100: the counterpart of ``repro.launch.roofline``.

``repro`` compiles unrolled cost probes of 1 and 2 layer periods with XLA
and differences their cost analyses. Here the same probes are counted on
the meta device: ``torch.utils.flop_counter.FlopCounterMode`` around the
step (``api.loss_fn`` and its backward for train, remat recompute
included; ``api.prefill``; one ``api.decode_step``), through the plain
attention route (the kernels' routes raise on the meta device), and

    per_period = C(2p) − C(1p);   base = C(1p) − per_period
    total      = base + n_periods·per_period (+ the tail's probe)

The counter sees matrix products only (mm, bmm, addmm, convolutions and
attention), not XLA's elementwise FLOPs, so ``useful_flops_ratio``
(``model_flops / counted``) is reported for its own sake and is not held
to ``repro``'s. Terms, per device of the 256-device mesh:

    compute    = counted FLOPs / 256 / 989e12    (H100 SXM, bf16 dense)
    memory     = bytes accessed per device / 3.35e12: the ``cost`` of the
                 dry run's sharded pass (``launch.dryrun.sharded_probes``,
                 the same probes), every local op's operand and result
                 bytes, a gather or scatter's by the elements it touches
                 (``dryrun.op_bytes``). The count is eager and unfused:
                 each intermediate of an elementwise chain is written and
                 read again where XLA's fusions keep it in registers, so
                 it lies above XLA's ``bytes accessed`` of the same step;
                 it is the traffic the port's op-by-op run asks of HBM,
                 before any cache. ``bytes_lower_bound`` (argument +
                 output bytes) is kept beside it.
    collective = collective bytes per device / 50e9: the result bytes of
                 every collective rank 0 issues in the same sharded pass,
                 over one GPU's InfiniBand port (``launch.mesh.HW
                 ["net_bw"]``: both axes of the 16 × 16 mesh cross nodes).
                 The plan is DTensor's, not XLA's.
    MODEL_FLOPS = 6·N·D (train) or 2·N·D, with N the active parameters.

The sharded pass also counts rank 0's own FLOPs (``cost["flops"]``, the
same registry on the local shapes); the record keeps it as
``per_device["sharded_flops"]`` beside the compute term's, which stays
``count_flops / 256``.

``--no-probes`` takes both counts from full-depth runs instead (FLOPs
counted at the whole depth, the sharded pass at the whole depth), as
``repro``'s reads them from the full-graph dry run. ``full_graph_collectives``
holds the per-kind bytes the terms came from.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.roofline --all
  PYTHONPATH=src python -m repro_torch.launch.roofline --arch gemma-2b --shape train_4k [--no-probes]
Records: ``<out>/<arch>__<shape>.json`` and ``roofline_table.md``, ``--out``
defaulting to ``build/roofline_torch/``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
from pathlib import Path
from typing import Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ArchConfig, ShapeCfg
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import HW, make_production_mesh, n_devices
from repro_torch.models import api
from repro_torch.models.module import count_params, tree_leaves, tree_unflatten
from repro_torch.models.transformer import period_len, split_plan

OUT_DIR = Path("build") / "roofline_torch"
ARCHS = dryrun.ARCHS


# ---------------------------------------------------------------------------
# FLOPs counted on the meta device
# ---------------------------------------------------------------------------
def _probe_cfg(cfg: ArchConfig, n_layers: int, shape: ShapeCfg) -> ArchConfig:
    # remat stays on for train probes: the recompute is counted, as in repro
    return dataclasses.replace(
        cfg, n_layers=n_layers,
        n_enc_layers=min(cfg.n_enc_layers, n_layers),
        attn_impl="auto" if cfg.attn_impl == "pallas" else cfg.attn_impl,
        attn_chunk=min(4096, shape.seq_len))


def count_flops(cfg: ArchConfig, shape: ShapeCfg, vocab_pad: int = 1
                ) -> float:
    """Matrix-product FLOPs of one step of ``shape.kind`` at ``cfg``, on
    meta tensors (nothing is allocated)."""
    params = api.param_spec(cfg, vocab_pad)
    inputs = api.input_specs(cfg, shape)
    with FlopCounterMode(display=False) as counter:
        if shape.kind == "train":
            leaves = [x.requires_grad_(True) for x in tree_leaves(params)]
            loss = api.loss_fn(tree_unflatten(params, leaves), inputs, cfg)
            torch.autograd.grad(loss, leaves)
        else:
            with torch.no_grad():
                if shape.kind == "prefill":
                    api.prefill(params, inputs, cfg)
                else:
                    api.decode_step(params, inputs["caches"], inputs, cfg)
    return float(counter.get_total_flops())


def probe_costs(arch: str, shape_name: str) -> Dict[str, float]:
    """Whole-step FLOPs extrapolated from 1- and 2-period probes at the
    single-pod mesh's context (padded heads and vocabulary)."""
    mesh = make_production_mesh(multi_pod=False)
    cfg = dryrun.with_mesh_context(get_config(arch), mesh)
    pad = dryrun.vocab_pad_for(cfg, mesh)
    shape = SHAPES[shape_name]
    if cfg.family == "encdec":
        per, n_full, tail = 1, cfg.n_layers, []
    else:
        per = period_len(cfg)
        _, n_full, tail = split_plan(cfg)
    c1 = count_flops(_probe_cfg(cfg, per, shape), shape, pad)
    c2 = count_flops(_probe_cfg(cfg, 2 * per, shape), shape, pad)
    per_period = c2 - c1
    base = c1 - per_period
    total = base + n_full * per_period
    if tail:
        total += count_flops(_probe_cfg(cfg, per + len(tail), shape), shape,
                             pad) - c1
    return dict(flops=total, flops_per_period=per_period, flops_base=base)


# ---------------------------------------------------------------------------
# Analytic MODEL_FLOPS
# ---------------------------------------------------------------------------
def model_flops(cfg: ArchConfig, shape: ShapeCfg) -> Tuple[float, float]:
    """(6·N(_active)·D_total, N_active). Decode: D = B tokens per step."""
    n_total = count_params(api.param_spec(cfg))
    n_active = n_total
    if cfg.family == "moe":
        # per-expert FFN params counted at top_k/E utilization
        per_expert = 3 * cfg.d_model * cfg.d_ff
        expert_total = cfg.n_layers * cfg.n_experts * per_expert
        n_active = n_total - expert_total + cfg.n_layers * cfg.top_k * per_expert
    if shape.kind == "train":
        tokens, factor = shape.global_batch * shape.seq_len, 6.0
    elif shape.kind == "prefill":
        tokens, factor = shape.global_batch * shape.seq_len, 2.0
    else:  # decode: one token per sequence per step
        tokens, factor = shape.global_batch, 2.0
    return factor * n_active * tokens, float(n_active)


# ---------------------------------------------------------------------------
# The roofline record
# ---------------------------------------------------------------------------
def analyze_cell(arch: str, shape_name: str, *, use_probes: bool = True
                 ) -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "status": "skipped"}
    if not cfg.supports(shape):
        rec["reason"] = "long_500k N/A for full-attention arch"
        return rec
    mesh = make_production_mesh(multi_pod=False)
    n_chips = n_devices(mesh)
    if use_probes:
        costs = probe_costs(arch, shape_name)
        sharded = dryrun.sharded_probes(cfg, shape, mesh)
    else:
        ctx = dryrun.with_mesh_context(cfg, mesh)
        costs = dict(flops=count_flops(
            _probe_cfg(ctx, ctx.n_layers, shape), shape,
            dryrun.vocab_pad_for(ctx, mesh)))
        sharded = dryrun.sharded_fit(cfg, shape, mesh)
    coll, cost = sharded["collectives"], sharded["cost"]
    fit = dryrun.memory_fit(cfg, shape, mesh)
    flops_dev = costs["flops"] / n_chips
    terms = {"compute_s": flops_dev / HW["peak_flops_bf16"],
             "memory_s": cost["bytes_accessed"] / HW["hbm_bw"],
             "collective_s": coll["total_bytes"] / HW["net_bw"]}
    bound = max(terms.values())
    dominant = max(terms, key=terms.get)
    mf, n_active = model_flops(cfg, shape)
    rec.update(
        status="ok",
        per_device=dict(costs, flops=flops_dev, bytes=cost["bytes_accessed"],
                        sharded_flops=cost["flops"],
                        bytes_lower_bound=fit["per_device_lower_bound"],
                        coll=coll["total_bytes"],
                        temp_bytes=sharded["temp_bytes"]),
        terms_s=terms, dominant=dominant,
        full_graph_collectives=coll["per_kind"],
        collective_plan="DTensor's, not XLA's",
        probes=sharded.get("probes"),
        model_flops_total=mf, n_active_params=n_active,
        model_flops_per_chip=mf / n_chips,
        useful_flops_ratio=mf / max(costs["flops"], 1.0),
        roofline_fraction=(mf / n_chips / HW["peak_flops_bf16"]) / bound,
        memory_fit=fit, hardware="NVIDIA H100 SXM5 80GB (data sheet)")
    return rec


def improvement_note(rec: dict) -> str:
    d = rec["dominant"]
    if d == "compute_s":
        return ("compute-bound: reduce non-useful FLOPs (attention block "
                "skipping, fused kernels) or grow per-chip batch")
    if d == "memory_s":
        return ("HBM-bound: fuse elementwise chains, shrink remat traffic, "
                "quantize caches/weights")
    return ("collective-bound: reshard to cut all-gathers (wider FSDP "
            "prefetch overlap, SP off for short seqs), compress grads")


def write_markdown(records, path: Path):
    def sec(t):
        return "n/a" if t is None else f"{t:.3e}"

    lines = ["| arch | shape | compute s | memory s | collective s | "
             "dominant | MODEL_FLOPs/counted | roofline frac | note |",
             "|---|---|---|---|---|---|---|---|---|"]
    for r in records:
        if r["status"] != "ok":
            lines.append(f"| {r['arch']} | {r['shape']} | — | — | — | — | — "
                         f"| — | {r.get('reason', 'skip')} |")
            continue
        t = r["terms_s"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {sec(t['compute_s'])} | "
            f"{sec(t['memory_s'])} | {sec(t['collective_s'])} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.2%} | "
            f"{improvement_note(r)[:60]} |")
    path.write_text("\n".join(lines))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the JSON records and the table")
    ap.add_argument("--no-probes", action="store_true",
                    help="count at full depth instead of from the 1- and "
                         "2-period probes")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    records = []
    for a in archs:
        for s in shapes:
            try:
                rec = analyze_cell(a, s, use_probes=not args.no_probes)
            except Exception as e:  # noqa: BLE001 — the cell's reason
                rec = {"arch": a, "shape": s, "status": "error",
                       "reason": f"{type(e).__name__}: {e}"}
            records.append(rec)
            (out / f"{a}__{s}.json").write_text(
                json.dumps(rec, indent=1, default=str))
            if rec["status"] == "ok":
                t = rec["terms_s"]
                print(f"[{a} {s}] comp {t['compute_s']:.2e}s mem "
                      f"{t['memory_s']:.2e}s coll {t['collective_s']:.2e}s "
                      f"-> {rec['dominant']} "
                      f"useful={rec['useful_flops_ratio']:.2f} "
                      f"roofline={rec['roofline_fraction']:.1%}")
            else:
                print(f"[{a} {s}] {rec['status']}: "
                      f"{rec.get('reason', '')[:120]}")
    write_markdown(records, out / "roofline_table.md")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
