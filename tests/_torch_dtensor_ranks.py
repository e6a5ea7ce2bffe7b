"""One rank of a (2, 2) ("data", "model") mesh of gloo processes on the CPU,
for ``tests/test_torch_dryrun_sharded.py``: run with

    PYTHONPATH=src python tests/_torch_dtensor_ranks.py RANK WORLD PORT OUT ARCH...

by every rank of ``WORLD`` (4) against ``tcp://127.0.0.1:PORT``. For each
``ARCH``'s reduced family config, cut to one layer period, it runs the dry run's three steps
(``launch.dryrun.loss_and_grads`` with ``apply_updates``,
``prefill_step``, ``serve_step``) once on plain tensors and once on
DTensors placed by the sharding rules (``sharding.to_named``), and rank 0
writes, per arch and step, the largest absolute difference of each output
(``full_tensor()``) from the plain one, and its largest magnitude, as
JSON to ``OUT``. The plain and the DTensor runs start from the same
seeded weights and inputs in every rank. The DTensor steps run as the dry
run runs them, under ``implicit_replication()`` and its cost counter
(``dryrun.StepCost``, a dispatch mode, so DTensor takes its Python
dispatch path; its C++ fast path mis-shapes some of these steps' backward
locals).
"""
import dataclasses
import json
import sys

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.module import tree_leaves, tree_map, tree_unflatten
from repro_torch.models.transformer import period_len
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state, opt_state_pspecs)

MESH = {"data": 2, "model": 2}
B, S = 8, 32


def _inputs(cfg, kind: str, gen: torch.Generator):
    shape = ShapeCfg("t", seq_len=S, global_batch=B, kind=kind)
    out = {}
    for name, leaf in api.input_specs(cfg, shape).items():
        if name == "caches":
            out[name] = tree_map(lambda c: torch.randn(
                c.shape, generator=gen, dtype=torch.float32).to(c.dtype), leaf)
        elif name == "pos":
            out[name] = torch.randint(0, S, leaf.shape, generator=gen,
                                      dtype=torch.int32)
        elif leaf.dtype == torch.int32:
            out[name] = torch.randint(0, cfg.vocab, leaf.shape, generator=gen,
                                      dtype=torch.int32)
        else:
            out[name] = torch.randn(leaf.shape, generator=gen).to(leaf.dtype)
    return out


def _diff(plain, dist_tree):
    """(max |DTensor − plain| over every leaf, max |plain|)."""
    d = m = 0.0
    for a, b in zip(tree_leaves(plain), tree_leaves(dist_tree)):
        b = b.full_tensor() if hasattr(b, "full_tensor") else b
        d = max(d, (a.to(torch.float64) - b.to(torch.float64)).abs().max().item())
        m = max(m, a.abs().max().item())
    return d, m


def _clone(tree):
    return tree_map(lambda x: x.clone(), tree)


def config(arch: str):
    """The reduced config cut to one layer period (one encoder and one
    decoder layer for encdec), in the (2, 2) mesh's context."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, n_layers=period_len(cfg),
                              n_enc_layers=min(cfg.n_enc_layers, 1))
    return dryrun.with_mesh_context(cfg, MESH)


def run_arch(arch: str, dm) -> dict:
    cfg = config(arch)
    gen = torch.Generator().manual_seed(0)
    params = api.init_model(gen, cfg, dryrun.vocab_pad_for(cfg, MESH),
                            device="cpu")
    p_sh = SH.params_pspecs_cfg(params, MESH, cfg)
    P = SH.to_named(params, p_sh, dm)
    res = {}
    opt = OptConfig(grad_clip=1.0)  # the global norm over sharded leaves

    batch = _inputs(cfg, "train", gen)
    loss, grads = dryrun.loss_and_grads(params, batch, cfg)
    state = init_opt_state(params, opt)
    new_p, new_s = apply_updates(params, tree_unflatten(params, grads), state,
                                 opt)
    with implicit_replication(), dryrun.StepCost():
        d_batch = SH.to_named(batch, SH.data_pspecs(batch, MESH, cfg), dm)
        d_loss, d_grads = dryrun.loss_and_grads(P, d_batch, cfg)
        d_state = SH.to_named(state, opt_state_pspecs(p_sh, opt), dm)
        d_new_p, d_new_s = apply_updates(P, tree_unflatten(P, d_grads),
                                         d_state, opt)
    res["train"] = {"loss": _diff([loss.detach()], [d_loss]),
                    "grads": _diff(grads, d_grads),
                    "m": _diff(new_s.m, d_new_s.m),
                    "v": _diff(new_s.v, d_new_s.v),
                    "params_finite": all(
                        bool(torch.isfinite(x.full_tensor()).all())
                        for x in tree_leaves(d_new_p))}

    batch = _inputs(cfg, "prefill", gen)
    logits, caches = dryrun.prefill_step(params, batch, cfg)
    with implicit_replication(), dryrun.StepCost():
        d_batch = SH.to_named(batch, SH.data_pspecs(batch, MESH, cfg), dm)
        d_logits, d_caches = dryrun.prefill_step(P, d_batch, cfg)
    res["prefill"] = {"logits": _diff([logits], [d_logits]),
                      "caches": _diff(caches, d_caches)}

    inp = _inputs(cfg, "decode", gen)
    caches = inp.pop("caches")
    d_caches = SH.to_named(_clone(caches), SH.cache_pspecs(caches, MESH, cfg),
                           dm)
    logits, caches = dryrun.serve_step(params, caches, inp, cfg)
    with implicit_replication(), dryrun.StepCost():
        d_inp = SH.to_named(inp, SH.data_pspecs(inp, MESH, cfg), dm)
        d_logits, d_caches = dryrun.serve_step(P, d_caches, d_inp, cfg)
    res["decode"] = {"logits": _diff([logits], [d_logits]),
                     "caches": _diff(caches, d_caches)}
    return res


def main(rank: int, world: int, port: int, out: str, archs) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        dm = init_device_mesh("cpu", tuple(MESH.values()),
                              mesh_dim_names=tuple(MESH))
        results = {arch: run_arch(arch, dm) for arch in archs}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5:])
