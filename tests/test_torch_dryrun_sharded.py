"""The sharded dry run (``launch.dryrun``'s sharded pass, ``layers.constrain``
on DTensors, ``sharding.to_named`` and ``fake_device_mesh``):

  * the dry run's three steps (loss and gradients with AdamW, prefill,
    one decode step) of six reduced family configs, one layer period each,
    run as DTensors on a (2, 2) mesh of four gloo processes on the CPU and
    equal the plain steps within 1e-5 (loss, gradients, AdamW moments,
    logits and caches, by ``full_tensor()``);
  * on a (4, 1) FSDP-only fake mesh, one reduced dense train step's
    collective bytes equal a count derived by hand from the weights;
  * the probes' extrapolation to 4 periods equals the direct 4-period run:
    collectives exactly, ``temp_bytes`` within 1 %;
  * ``fake_device_mesh`` leaves no process group behind, after an error
    too, and refuses to open over another group;
  * the sharded pass imports no JAX (a fresh process).
"""
import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
dist = pytest.importorskip("torch.distributed")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeCfg  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.hlo_analysis import COLLECTIVE_KINDS  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "_torch_dtensor_ranks.py"
# two meshes of four ranks at once, the archs split so the two take about
# as long
GROUPS = (["smollm-360m", "grok-1-314b", "mamba2-130m", "recurrentgemma-9b"],
          ["whisper-small", "internvl2-76b"])
ARCHS = [a for g in GROUPS for a in g]
TOL = 1e-5
NO_JAX = """
import sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCfg
from repro_torch.launch import dryrun
rec = dryrun.sharded_fit(get_config("smollm-360m").reduced(),
                         ShapeCfg("t", 16, 4, "prefill"),
                         {"data": 2, "model": 2})
assert rec["temp_bytes"] > 0
print(sum(1 for m in sys.modules if m == "jax" or m.startswith("jax.")))
"""


def _env():
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src")] + [p for p in env.get("PYTHONPATH", "").split(
            os.pathsep) if p])
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def launched(tmp_path_factory):
    """Every group's four ranks and the no-JAX process, started together
    and left running while the tests on the fake mesh run here."""
    tmp = tmp_path_factory.mktemp("ranks")
    procs, outs = [], []
    for g, archs in enumerate(GROUPS):
        port, out = _free_port(), tmp / f"group{g}.json"
        outs.append(out)
        for rank in range(4):
            procs.append(subprocess.Popen(
                [sys.executable, str(RANKS), str(rank), "4", str(port),
                 str(out)] + archs, env=_env(), cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    no_jax = subprocess.Popen([sys.executable, "-c", NO_JAX], env=_env(),
                              cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
    yield procs, outs, no_jax
    for p in procs + [no_jax]:
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def ranks(launched):
    """``(per-arch results, the no-JAX process's (rc, stdout, stderr))``."""
    procs, outs, no_jax = launched
    logs = [p.communicate(timeout=600)[0] for p in procs]
    nj_out, nj_err = no_jax.communicate(timeout=600)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = {}
    for out in outs:
        results.update(json.loads(out.read_text()))
    return results, (no_jax.returncode, nj_out, nj_err)


def test_to_placements_follow_the_spec(launched):
    from torch.distributed.tensor import Replicate, Shard

    names = ("pod", "data", "model")
    assert SH.to_placements((("pod", "data"), None, "model"), names) == (
        Shard(0), Shard(0), Shard(2))
    assert SH.to_placements(None, names) == (Replicate(),) * 3
    assert SH.to_placements(("data", None), names) == (
        Replicate(), Shard(0), Replicate())
    with pytest.raises(ValueError, match="named twice"):
        SH.to_placements(("data", "data"), names)
    # a shard over one rank is the whole tensor: replicated
    assert SH.to_placements(("data", "model"), ("data", "model"), (4, 1)) \
        == (Shard(0), Replicate())


def test_fsdp_collective_bytes_equal_a_hand_count():
    """(4, 1): batch over ``data``; every weight with a d_model dim is
    sharded over it (FSDP), the norm scales are replicated, nothing is
    split over ``model`` (size 1: a collective over one rank moves
    nothing, and is not counted). One train step of reduced smollm-360m
    (float32, two layers, tied embeddings, no remat, clipping off) then
    issues:

      * all-gather: each layer's FSDP weights once (``fsdp_gather`` before
        the period) and the embedding table twice (the lookup and the tied
        unembedding), each result the whole weight;
      * reduce-scatter: the gradient of each of those gathers back to its
        shards, a quarter of the weight each;
      * all-reduce: the replicated norm scales' gradients, whole;
      * all-to-all: none.
    """
    cfg = get_config("smollm-360m").reduced()
    mesh = make_host_mesh(4, 1)
    rec = dryrun.sharded_fit(cfg, ShapeCfg("t", 16, 8, "train"), mesh)
    ctx = dryrun.with_mesh_context(cfg, mesh)
    pspec = api.param_spec(ctx, dryrun.vocab_pad_for(ctx, mesh))
    specs = SH.tree_paths_like(SH.params_pspecs_cfg(pspec, mesh, ctx))
    w = rep = 0
    for path, leaf in tree_paths(pspec).items():
        nbytes = leaf.numel() * leaf.element_size()
        if path == "embedding/embed":
            table = nbytes
        elif "data" in specs[path]:
            w += nbytes
        elif all(e is None for e in specs[path]):
            rep += nbytes
    assert cfg.tie_embeddings and not cfg.remat and w and rep
    want = {"all-gather": w + 2 * table,
            "reduce-scatter": (w + 2 * table) // 4,
            "all-reduce": rep,
            "all-to-all": 0, "collective-permute": 0}
    got = rec["collectives"]
    assert got["per_kind"] == want
    assert got["total_bytes"] == sum(want.values())
    assert set(got["per_kind"]) == set(COLLECTIVE_KINDS)


def test_probes_extrapolate_to_a_direct_run():
    """4 periods from the 1- and 2-period probes against the 4-period run
    itself, on a (2, 2) fake mesh: the collectives equal, ``temp_bytes``
    within 1 % (the peak grows by the same bytes per period only as far
    as it sits at the same point of the step)."""
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(),
                              n_layers=4)
    mesh = make_host_mesh(2, 2)
    shape = ShapeCfg("t", 32, 8, "train")
    probed = dryrun.sharded_probes(cfg, shape, mesh)
    direct = dryrun.sharded_fit(cfg, shape, mesh)
    assert probed["probes"] == [1, 2]
    assert probed["collectives"] == direct["collectives"]
    assert probed["argument_local_bytes"] == direct["argument_local_bytes"]
    assert probed["temp_bytes"] == pytest.approx(direct["temp_bytes"],
                                                 rel=0.01)


def test_fake_device_mesh_leaves_no_group_behind():
    assert not dist.is_initialized()
    with SH.fake_device_mesh({"data": 16, "model": 16}) as dm:
        assert dist.is_initialized() and dist.get_world_size() == 256
        assert tuple(dm.mesh_dim_names) == ("data", "model")
        assert SH.axis_sizes(dm) == {"data": 16, "model": 16}
        with pytest.raises(RuntimeError, match="already initialized"):
            with SH.fake_device_mesh({"data": 2}):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="boom"):
        with SH.fake_device_mesh({"pod": 2, "data": 16, "model": 16}):
            raise ValueError("boom")
    assert not dist.is_initialized()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ARCHS)
def test_dtensor_steps_equal_the_plain_steps(ranks, arch, kind):
    rec = ranks[0][arch][kind]
    for name, got in rec.items():
        if name == "params_finite":
            assert got, (arch, kind)
            continue
        diff, scale = got
        assert scale > 0 and diff <= TOL, (arch, kind, name, diff, scale)


def test_the_sharded_pass_imports_no_jax(ranks):
    rc, out, err = ranks[1]
    assert rc == 0, err[-3000:]
    assert out.split()[-1] == "0"
