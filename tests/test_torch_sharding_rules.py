"""The port's sharding rules against ``repro``'s, spec for spec, on the
production meshes (16, 16) and (2, 16, 16): params (every arch in its mesh
context, which covers the head, padded and replicated attention modes),
inputs, decode caches, optimizer state, and the activation labels of
``layers.constrain``. ``repro``'s rules read only ``mesh.axis_names`` and
``mesh.devices.shape``, so a stand-in mesh serves (no 512 host devices).
A ``repro`` spec is compared padded with ``None`` to its tensor's rank,
the port's form."""
import dataclasses
import importlib
import itertools
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.distributed import sharding as JSH  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models.module import tree_paths as jax_tree_paths  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.distributed import sharding as SH  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402

MESHES = {"pod_16x16": False, "multipod_2x16x16": True}
ARCHS = sorted(list_configs())


def repro_launch(name):
    """``repro.launch.<name>``, imported with ``XLA_FLAGS`` kept as it was:
    ``repro``'s dry-run and roofline modules set a 512-host-device flag on
    import, which would reach every later jax start in this process."""
    saved = os.environ.get("XLA_FLAGS")
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved


def jax_mesh(multi_pod):
    sizes = make_production_mesh(multi_pod=multi_pod)
    return SimpleNamespace(axis_names=tuple(sizes),
                           devices=np.empty(tuple(sizes.values()), object))


def padded(spec, ndim):
    return tuple(spec) + (None,) * (ndim - len(spec))


def assert_same_specs(got, want, shapes, what):
    """``got`` (the port's spec tree) equals ``want`` (``repro``'s
    PartitionSpec tree) path for path; ``shapes`` gives each rank."""
    g = SH.tree_paths_like(got)
    w = jax_tree_paths(want)
    assert sorted(g) == sorted(w), what
    for path, spec in g.items():
        assert spec == padded(w[path], len(shapes[path].shape)), (what, path)


def _ctx(arch, multi_pod):
    mesh, jm = make_production_mesh(multi_pod=multi_pod), jax_mesh(multi_pod)
    cfg = dryrun.with_mesh_context(get_config(arch), mesh)
    jcfg = repro_launch("dryrun").with_mesh_context(jax_get_config(arch), jm)
    return mesh, jm, cfg, jcfg


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_state_specs_match_repro(arch, mesh_name):
    mesh, jm, cfg, jcfg = _ctx(arch, MESHES[mesh_name])
    assert cfg.attn_mode == jcfg.attn_mode
    pad = dryrun.vocab_pad_for(cfg, mesh)
    assert pad == repro_launch("dryrun").vocab_pad_for(jcfg, jm)
    pspec, jspec = api.param_spec(cfg, pad), jax_api.param_spec(jcfg, pad)
    got = SH.params_pspecs_cfg(pspec, mesh, cfg)
    want = JSH.params_pspecs_cfg(jspec, jm, jcfg)
    shapes = tree_paths(pspec)
    assert_same_specs(got, want, shapes, f"{arch} params")
    for kind in ("adamw", "sgd"):
        o = optimizers.opt_state_pspecs(got, optimizers.OptConfig(kind=kind))
        jo = jax_opt.opt_state_pspecs(want, jax_opt.OptConfig(kind=kind))
        assert o.step == tuple(jo.step) == ()
        assert_same_specs(o.m, jo.m, shapes, f"{arch} {kind} m")
        assert (o.v is None) == (jo.v is None)
        if o.v is not None:
            assert_same_specs(o.v, jo.v, shapes, f"{arch} {kind} v")


def test_the_three_attention_modes_are_covered():
    modes = {_ctx(a, False)[2].attn_mode for a in ARCHS}
    assert {"head", "padded", "replicated"} <= modes


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_data_and_cache_specs_match_repro(arch, mesh_name):
    mesh, jm, cfg, jcfg = _ctx(arch, MESHES[mesh_name])
    for name, shape in SHAPES.items():
        if not cfg.supports(shape):
            continue
        ins = api.input_specs(cfg, shape)
        jins = jax_api.input_specs(jcfg, JSHAPES[name])
        shapes = tree_paths(ins)
        assert_same_specs(SH.data_pspecs(ins, mesh, cfg),
                          JSH.data_pspecs(jins, jm, jcfg), shapes,
                          f"{arch} {name} inputs")
        if shape.kind == "decode":
            assert_same_specs(
                SH.cache_pspecs(ins["caches"], mesh, cfg),
                JSH.cache_pspecs(jins["caches"], jm, jcfg),
                tree_paths(ins["caches"]), f"{arch} {name} caches")
    # a batch too small for the batch axes falls back, as in repro
    small = api.cache_spec(cfg, 3, 40)
    assert_same_specs(SH.cache_pspecs(small, mesh, cfg),
                      JSH.cache_pspecs(jax_api.cache_spec(jcfg, 3, 40), jm,
                                       jcfg),
                      tree_paths(small), f"{arch} small caches")


def test_batch_axes_and_out_pspecs_for():
    for mp in (False, True):
        assert SH.batch_axes(make_production_mesh(multi_pod=mp)) \
            == JSH.batch_axes(jax_mesh(mp))
    with pytest.raises(NotImplementedError):
        SH.out_pspecs_for("train", make_production_mesh(), None, None, None)


LABELS = [None, "batch", "tp", "fsdp", "sp"]


@pytest.mark.parametrize("mesh_name", MESHES)
@pytest.mark.parametrize("seq_shard", [True, False])
def test_constrain_labels_match_repro(monkeypatch, mesh_name, seq_shard):
    """``repro``'s ``constrain`` spec, captured at its
    ``with_sharding_constraint``, for every label triple over shapes that
    do and do not divide the axes."""
    monkeypatch.setattr(jax.lax, "with_sharding_constraint",
                        lambda x, spec: spec)
    _, _, cfg, jcfg = _ctx("smollm-360m", MESHES[mesh_name])
    cfg = dataclasses.replace(cfg, seq_shard_acts=seq_shard)
    jcfg = dataclasses.replace(jcfg, seq_shard_acts=seq_shard)
    n = 0
    for dims in itertools.product(LABELS, repeat=3):
        for shape in ((32, 16, 48), (8, 1, 7), (64, 256, 16), (1, 2, 3)):
            want = JL.constrain(np.empty(shape, np.int8), jcfg, dims)
            assert L.constrain_spec(shape, cfg, dims) \
                == padded(want, 3), (dims, shape)
            n += 1
    assert n == 500
    # no mesh context: no constraint, and the tensor comes back as it was
    plain = get_config("smollm-360m")
    assert L.constrain_spec((4, 4), plain, ("batch", "tp")) is None
    x = torch.ones(2)
    assert L.constrain(x, cfg, ("batch",)) is x


@pytest.mark.parametrize("arch", ["mistral-large-123b", "smollm-360m",
                                  "gemma-2b"])
def test_head_label_and_residual_dims_match_repro(arch):
    _, _, cfg, jcfg = _ctx(arch, False)
    assert L.head_label(cfg) == JL.head_label(jcfg)
    for seq in (1, 4096):
        assert L.residual_dims(cfg, seq) == JL.residual_dims(jcfg, seq)
