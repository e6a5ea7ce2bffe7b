"""The elastic re-mesh checkpoint: ``repro_torch.checkpoint.ckpt``'s
``restore_checkpoint(shardings=..., opt_shardings=...)`` and
``save_checkpoint`` of DTensors, held to ``repro.checkpoint.ckpt``:

  * the port's counterparts of ``repro``'s ``TestElasticRestore``: a
    restore from meta likes onto an explicit device, bitwise, bfloat16
    kept; a restore across a padding change;
  * a meta like without a sharding raises; tensor and numpy likes keep
    their device and dtype;
  * on a (2, 2) mesh of four gloo processes (``tests/_torch_ckpt_ranks.py``):
    a ``repro`` checkpoint restores onto the port's placements bitwise; a
    reduced smollm-360m train step as DTensors saves with one writer, and
    the file restores in ``repro``'s ``restore_checkpoint`` with a jax
    sharding bitwise; restored onto one plain CPU device, its next step
    equals the uninterrupted (2, 2) step within 1e-5; restored onto a (4, 1)
    mesh of the same ranks with that mesh's config, every leaf's
    ``full_tensor()`` is bitwise what ``repro`` restores from the same file
    at the same shapes.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import SingleDeviceSharding  # noqa: E402

import _torch_ckpt_ranks as CR  # noqa: E402
from repro.checkpoint import ckpt as jckpt  # noqa: E402
from repro.models.module import tree_paths as jax_tree_paths  # noqa: E402
from repro.optim.optimizers import OptState as JOptState  # noqa: E402
from repro_torch.checkpoint.ckpt import (restore_checkpoint,  # noqa: E402
                                         save_checkpoint)
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models.module import (tree_leaves, tree_map,  # noqa: E402
                                       tree_paths, tree_unflatten)
from repro_torch.optim.optimizers import (apply_updates,  # noqa: E402
                                          init_opt_state)

ROOT = Path(__file__).resolve().parents[1]
RANKS = ROOT / "tests" / "_torch_ckpt_ranks.py"
# the (2, 2) DTensor step against the plain step, as the sharded dry run's
# comparison holds it
TOL = 1e-5
CPU = torch.device("cpu")


def _meta(tree):
    return tree_unflatten(tree, [
        torch.empty(x.shape, dtype=x.dtype, device="meta")
        for x in tree_leaves(tree)])


def _on(tree, where):
    return tree_unflatten(tree, [where] * len(tree_leaves(tree)))


def _same_bits(a, b) -> bool:
    a, b = torch.as_tensor(a), torch.as_tensor(b)
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8)))


def _jax_to_torch(x) -> torch.Tensor:
    """A jax array as a tensor of the same dtype and bits (bfloat16 through
    its float32 widening, which is exact)."""
    if x.dtype == jnp.bfloat16:
        return torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(
            torch.bfloat16)
    return torch.from_numpy(np.array(x))


def _state():
    gen = torch.Generator().manual_seed(3)
    params = {"layer": {"w": torch.randn((3, 4), generator=gen),
                        "b": torch.randn((4,), generator=gen)},
              "head": torch.randn((5, 2), generator=gen).to(torch.bfloat16)}
    return params, init_opt_state(params, CR.OPT)


def test_restore_from_meta_likes_onto_an_explicit_device(tmp_path):
    """``repro``'s ``test_restore_onto_explicit_sharding``: meta likes (the
    counterpart of ``jax.eval_shape``) placed by ``torch.device`` leaves;
    every leaf bitwise, bfloat16 kept."""
    params, opt_state = _state()
    opt_state = opt_state._replace(step=torch.tensor(5, dtype=torch.int32))
    save_checkpoint(tmp_path, 2, params, opt_state)
    p_like, o_like = _meta(params), _meta(opt_state)
    step, p2, o2 = restore_checkpoint(
        tmp_path, params_like=p_like, opt_like=o_like,
        shardings=_on(p_like, CPU), opt_shardings=_on(o_like, CPU))
    assert step == 2
    assert p2["head"].dtype == torch.bfloat16
    for a, b in zip(tree_leaves((params, opt_state)), tree_leaves((p2, o2))):
        assert b.device == CPU and _same_bits(a, b)


def test_restore_across_padding_change(tmp_path):
    """``repro``'s ``test_restore_across_padding_change``: a wider like
    zero-fills the tail, a narrower one slices."""
    save_checkpoint(tmp_path, 4, {"emb": torch.ones((6, 3))})
    for rows in (8, 4):
        like = {"emb": torch.empty((rows, 3), device="meta")}
        _, p2, _ = restore_checkpoint(tmp_path, params_like=like,
                                      shardings={"emb": CPU})
        assert p2["emb"].shape == (rows, 3)
        assert torch.equal(p2["emb"][:6], torch.ones((min(rows, 6), 3)))
        assert not p2["emb"][6:].any()


@pytest.mark.parametrize("tree", ["params", "opt"])
def test_meta_like_without_sharding_raises(tmp_path, tree):
    """A meta like holds no device: without its sharding the restore
    raises ``ValueError`` naming the argument, never returning meta
    tensors; a shardings tree of another size raises too."""
    params, opt_state = _state()
    save_checkpoint(tmp_path, 1, params, opt_state)
    p_like, o_like = _meta(params), _meta(opt_state)
    kw = dict(params_like=p_like, opt_like=o_like)
    if tree == "opt":
        kw["shardings"] = _on(p_like, CPU)
    with pytest.raises(ValueError, match="shardings= .params. or "
                       "opt_shardings="):
        restore_checkpoint(tmp_path, **kw)
    if tree == "opt":
        with pytest.raises(ValueError, match="opt_shardings has 3 leaves"):
            restore_checkpoint(tmp_path, opt_shardings=[CPU] * 3, **kw)


def test_tensor_and_numpy_likes_keep_their_device(tmp_path):
    """Without shardings a tensor like gives a tensor on its device and in
    its dtype, and a numpy aux like numpy (a float64 host counter exact)."""
    params, opt_state = _state()
    counter = np.array([0.1 + 2 ** -40, np.inf], np.float64)
    save_checkpoint(tmp_path, 3, params, opt_state, aux={"t": counter})
    like = tree_map(torch.zeros_like, params)
    _, p2, o2, aux = restore_checkpoint(
        tmp_path, params_like=like, opt_like=opt_state,
        aux_like={"t": np.zeros(2)})
    assert all(_same_bits(a, b) for a, b in zip(
        tree_leaves((params, opt_state)), tree_leaves((p2, o2))))
    assert isinstance(aux["t"], np.ndarray) and aux["t"].dtype == np.float64
    np.testing.assert_array_equal(aux["t"], counter)


# ---------------------------------------------------------------------------
# the (2, 2) gloo mesh
# ---------------------------------------------------------------------------


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


def _nest(flat: dict) -> dict:
    """``{"a/b": x}`` as ``{"a": {"b": x}}``."""
    root: dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        d = root
        for k in parents:
            d = d.setdefault(k, {})
        d[last] = leaf
    return root


def _repro_checkpoint(directory: Path):
    """A ``repro`` checkpoint of the (2, 2) config's params and AdamW state,
    seeded numpy values in ``repro``'s own save; returns its arrays by
    file key."""
    rng = np.random.default_rng(0)
    p_like, o_like, _ = CR.likes(CR.R.config(CR.ARCH), CR.MESH)
    params = {k: jnp.asarray(rng.standard_normal(x.shape, np.float32))
              for k, x in tree_paths(p_like).items()}
    m = {k: jnp.asarray(rng.standard_normal(x.shape, np.float32))
         for k, x in tree_paths(o_like.m).items()}
    v = {k: jnp.asarray(rng.random(x.shape, np.float32))
         for k, x in tree_paths(o_like.v).items()}
    opt = JOptState(step=jnp.asarray(7, jnp.int32), m=_nest(m), v=_nest(v))
    jckpt.save_checkpoint(str(directory), 7, _nest(params), opt)
    return {**{f"params/{k}": x for k, x in params.items()},
            **{f"opt/{i}": x for i, x in enumerate(
                jax.tree_util.tree_leaves(opt))}}


@pytest.fixture(scope="module")
def mesh_run(tmp_path_factory):
    """The four ranks' results, the directory and the ``repro``
    checkpoint's arrays."""
    out = tmp_path_factory.mktemp("ckpt_ranks")
    repro_arrays = _repro_checkpoint(out / "repro")
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, str(RANKS), str(rank), "4", str(port), str(out)],
        env=_env(), cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for rank in range(4)]
    try:
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    return torch.load(out / "results.pt"), out, repro_arrays


def _jax_likes(whole: dict, prefix: str):
    """``jax.ShapeDtypeStruct`` likes of the ``prefix`` entries of a rank's
    ``full_tensor()`` map, as ``repro`` restores them."""
    dt = {torch.float32: jnp.float32, torch.int32: jnp.int32,
          torch.bfloat16: jnp.bfloat16}
    return {k[len(prefix):]: jax.ShapeDtypeStruct(tuple(t.shape), dt[t.dtype])
            for k, (t, _) in whole.items() if k.startswith(prefix)}


def _repro_restore(directory: Path, whole: dict) -> dict:
    """``repro``'s ``restore_checkpoint`` of ``directory`` at the shapes of
    ``whole``, onto a ``SingleDeviceSharding``; its arrays by file key."""
    sh = SingleDeviceSharding(jax.devices()[0])
    p_like = _nest(_jax_likes(whole, "params/"))
    o_flat = _jax_likes(whole, "opt/")
    o_like = [o_flat[str(i)] for i in range(len(o_flat))]
    _, params, opt = jckpt.restore_checkpoint(
        str(directory), params_like=p_like, opt_like=o_like,
        shardings=jax.tree_util.tree_map(lambda _: sh, p_like),
        opt_shardings=[sh] * len(o_like))
    got = {f"params/{k}": x for k, x in jax_tree_paths(params).items()}
    got.update({f"opt/{i}": x for i, x in enumerate(opt)})
    assert all(x.sharding == sh for x in got.values())
    return got


def _expected_placements(cfg, mesh) -> dict:
    """The placements the sharding rules give each file key on ``mesh``."""
    p_like, o_like, _ = CR.likes(cfg, mesh)
    names, sizes = tuple(mesh), tuple(mesh.values())
    p_spec = SH.tree_paths_like(SH.params_pspecs_cfg(p_like, mesh, cfg))
    out = {f"params/{k}": str(SH.to_placements(s, names, sizes))
           for k, s in p_spec.items()}
    # the state's leaves: step, then m and v by sorted path (H17)
    o_spec = [()] + [p_spec[k] for k in sorted(tree_paths(o_like.m))] * 2
    out.update({f"opt/{i}": str(SH.to_placements(s, names, sizes))
                for i, s in enumerate(o_spec)})
    return out


def test_repro_checkpoint_restores_onto_port_placements(mesh_run):
    results, _, repro_arrays = mesh_run
    got = results["from_repro"]
    want = _expected_placements(CR.R.config(CR.ARCH), CR.MESH)
    assert set(got) == set(repro_arrays) == set(want)
    assert any("Shard" in p for p in want.values())
    for key, (t, placements) in got.items():
        assert placements == want[key], key
        assert _same_bits(t, _jax_to_torch(repro_arrays[key])), key


def test_one_rank_writes_the_mesh_checkpoint(mesh_run):
    """Every rank called ``save_checkpoint``; only the mesh's first rank
    wrote the arrays, once, and the directory holds one finished step.
    Restored onto the saved DTensors as likes, with no shardings, every
    rank's leaves come back on their own placements, bitwise."""
    _, out, _ = mesh_run
    ranks = [json.loads((out / f"rank{r}.json").read_text())
             for r in range(4)]
    writes = [r["writes"] for r in ranks]
    assert len(writes[0]) == 1 and writes[1:] == [[], [], []]
    assert all(r["dtensor_likes_kept"] for r in ranks)
    assert sorted(p.name for p in (out / "mesh").iterdir()) == [
        "LATEST", "ckpt_00000001.json", "ckpt_00000001.npz"]


def test_mesh_checkpoint_restores_in_repro(mesh_run):
    """The (2, 2) DTensors' checkpoint restores in ``repro`` onto a jax
    sharding, bitwise the saved state's ``full_tensor()``."""
    results, out, _ = mesh_run
    step1 = results["step1"]
    got = _repro_restore(out / "mesh", step1)
    assert set(got) == set(step1)
    for key, (t, _) in step1.items():
        assert _same_bits(t, _jax_to_torch(got[key])), key


def test_mesh_step_resumes_on_one_device(mesh_run):
    """The (2, 2) checkpoint restored from meta likes onto one plain CPU
    device with the same config: its next step (the dry run's
    ``loss_and_grads`` and AdamW) equals the uninterrupted (2, 2) step
    within 1e-5: loss, params, m and v."""
    results, out, _ = mesh_run
    cfg = CR.R.config(CR.ARCH)
    p_like, o_like, _ = CR.likes(cfg, CR.MESH)
    _, params, opt_state = restore_checkpoint(
        out / "mesh", params_like=p_like, opt_like=o_like,
        shardings=_on(p_like, CPU), opt_shardings=_on(o_like, CPU))
    loss, grads = dryrun.loss_and_grads(params, results["batch2"], cfg)
    params, opt_state = apply_updates(
        params, tree_unflatten(params, grads), opt_state, CR.OPT)
    plain = {f"params/{k}": x for k, x in tree_paths(params).items()}
    plain.update({f"opt/{i}": x for i, x in enumerate(
        tree_leaves(opt_state))})
    plain["loss"] = loss.detach()
    step2 = results["step2"]
    assert set(plain) == set(step2)
    for key, (t, _) in step2.items():
        a = plain[key]
        assert a.dtype == t.dtype and a.shape == t.shape, key
        diff = (a.double() - t.double()).abs().max().item()
        assert diff <= TOL, (key, diff)


def test_remesh_to_4x1_is_bitwise_repros(mesh_run):
    """The (2, 2) checkpoint restored onto a (4, 1) mesh of the same ranks
    with that mesh's config: each leaf on the (4, 1) rules' placements and
    its ``full_tensor()`` bitwise ``repro``'s restore of the same file at
    the same shapes."""
    results, out, _ = mesh_run
    remesh = results["remesh"]
    got = _repro_restore(out / "mesh", remesh)
    want = _expected_placements(
        dryrun.with_mesh_context(CR.R.config(CR.ARCH), CR.REMESH), CR.REMESH)
    assert set(got) == set(remesh) == set(want)
    assert any("Shard" in p for p in want.values())
    for key, (t, placements) in remesh.items():
        assert placements == want[key], key
        assert _same_bits(t, _jax_to_torch(got[key])), key
