"""One rank of the elastic re-mesh checkpoint run, for
``tests/test_torch_ckpt_reshard.py``: run with

    PYTHONPATH=src python tests/_torch_ckpt_ranks.py RANK WORLD PORT DIR

by every rank of ``WORLD`` (4) against ``tcp://127.0.0.1:PORT``, after the
test has written a ``repro`` checkpoint to ``DIR/repro``. On a (2, 2)
("data", "model") gloo mesh, with ``tests/_torch_dtensor_ranks.py``'s
reduced smollm-360m config cut to one layer period (in the mesh's context):

  1. the ``repro`` checkpoint is restored from meta likes onto the
     placements of the sharding rules (``sharding.named_shardings``);
  2. seeded weights placed by ``sharding.to_named`` take one AdamW train
     step as DTensors (the dry run's ``loss_and_grads`` under its cost
     counter, as the sharded dry run's comparison runs it), and the state
     is saved to ``DIR/mesh`` (every rank calls ``save_checkpoint``; the
     mesh's first rank writes);
  3. the next step, uninterrupted, on the same mesh;
  4. the saved step is restored onto a (4, 1) mesh of the same ranks, with
     that mesh's config (``dryrun.with_mesh_context``, ``vocab_pad_for``).

Rank 0 writes every DTensor's ``full_tensor()`` (``torch.save``, so
bfloat16 stays bfloat16) and its placements for the test to hold to
``repro`` and to the plain step; every rank writes the checkpoints whose
arrays it wrote, and whether the saved step, restored onto its own
DTensors as likes (no shardings), came back on their placements bitwise
(``DIR/rank<r>.json``).
"""
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor.experimental import implicit_replication

import _torch_dtensor_ranks as R
from repro_torch.checkpoint import ckpt
from repro_torch.distributed import sharding as SH
from repro_torch.launch import dryrun
from repro_torch.models import api
from repro_torch.models.module import tree_leaves, tree_paths, tree_unflatten
from repro_torch.optim.optimizers import (OptConfig, apply_updates,
                                          init_opt_state, opt_state_pspecs)

MESH = R.MESH  # (2, 2)
REMESH = {"data": 4, "model": 1}
ARCH = "smollm-360m"
OPT = OptConfig(grad_clip=1.0)


def likes(cfg, mesh):
    """Meta likes of the params and AdamW state in ``mesh``'s config, and
    their shardings over the torch ``DeviceMesh`` of the same axes."""
    sizes = SH.axis_sizes(mesh)
    p_like = api.param_spec(cfg, dryrun.vocab_pad_for(cfg, sizes))
    o_like = init_opt_state(p_like, OPT)
    p_spec = SH.params_pspecs_cfg(p_like, sizes, cfg)
    return p_like, o_like, (
        SH.named_shardings(p_like, p_spec, mesh),
        SH.named_shardings(o_like, opt_state_pspecs(p_spec, OPT), mesh))


def whole(params, opt_state) -> dict:
    """Every leaf's ``full_tensor()`` and placements, by file key."""
    out = {}
    for key, x in list(tree_paths(params).items()) + [
            (i, x) for i, x in enumerate(tree_leaves(opt_state))]:
        k = f"params/{key}" if isinstance(key, str) else f"opt/{key}"
        out[k] = (x.full_tensor(), str(tuple(x.placements)))
    return out


def step(params, opt_state, batch, cfg, dm):
    with implicit_replication(), dryrun.StepCost():
        d_batch = SH.to_named(batch, SH.data_pspecs(batch, MESH, cfg), dm)
        loss, grads = dryrun.loss_and_grads(params, d_batch, cfg)
        params, opt_state = apply_updates(
            params, tree_unflatten(params, grads), opt_state, OPT)
    return loss, params, opt_state


def main(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(1)
    out = Path(out)
    writes = []
    savez = ckpt.np.savez
    ckpt.np.savez = lambda *a, **k: (writes.append(str(a[0])),
                                     savez(*a, **k))[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world)
    try:
        dm = init_device_mesh("cpu", tuple(MESH.values()),
                              mesh_dim_names=tuple(MESH))
        cfg = R.config(ARCH)
        p_like, o_like, (p_sh, o_sh) = likes(cfg, dm)

        # 1. repro's checkpoint onto the (2, 2) placements
        _, P, O = ckpt.restore_checkpoint(
            out / "repro", params_like=p_like, opt_like=o_like,
            shardings=p_sh, opt_shardings=o_sh)
        from_repro = whole(P, O)

        # 2. one step as DTensors, saved
        gen = torch.Generator().manual_seed(0)
        params = api.init_model(gen, cfg, dryrun.vocab_pad_for(cfg, MESH),
                                device="cpu")
        p_spec = SH.params_pspecs_cfg(params, MESH, cfg)
        P = SH.to_named(params, p_spec, dm)
        O = SH.to_named(init_opt_state(params, OPT),
                        opt_state_pspecs(p_spec, OPT), dm)
        batches = [R._inputs(cfg, "train", gen) for _ in range(2)]
        _, P, O = step(P, O, batches[0], cfg, dm)
        ckpt.save_checkpoint(out / "mesh", 1, P, O)
        step1 = whole(P, O)
        # DTensor likes without shardings: their own mesh and placements
        _, P1, O1 = ckpt.restore_checkpoint(out / "mesh", params_like=P,
                                            opt_like=O)
        likes_kept = all(
            a.placements == b.placements and torch.equal(
                a.to_local().reshape(-1).view(torch.uint8),
                b.to_local().reshape(-1).view(torch.uint8))
            for a, b in zip(tree_leaves((P, O)), tree_leaves((P1, O1))))

        # 3. the next step, uninterrupted
        loss, P, O = step(P, O, batches[1], cfg, dm)
        step2 = whole(P, O)
        step2["loss"] = (loss.full_tensor(), str(tuple(loss.placements)))

        # 4. the saved step onto a (4, 1) mesh of the same ranks
        dm41 = init_device_mesh("cpu", tuple(REMESH.values()),
                                mesh_dim_names=tuple(REMESH))
        cfg41 = dryrun.with_mesh_context(cfg, REMESH)
        p41, o41, (p41_sh, o41_sh) = likes(cfg41, dm41)
        _, P41, O41 = ckpt.restore_checkpoint(
            out / "mesh", params_like=p41, opt_like=o41, shardings=p41_sh,
            opt_shardings=o41_sh)
        remesh = whole(P41, O41)

        if rank == 0:
            torch.save(dict(from_repro=from_repro, step1=step1, step2=step2,
                            batch2=batches[1], remesh=remesh),
                       out / "results.pt")
        (out / f"rank{rank}.json").write_text(json.dumps(
            dict(writes=writes, dtensor_likes_kept=likes_kept)))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
