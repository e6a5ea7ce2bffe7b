"""The port's dry-run stand-ins against ``repro``'s: ``api.param_spec``,
``input_specs`` and ``cache_spec`` on the meta device, held key for key,
in shape and dtype, to ``repro``'s ``ShapeDtypeStruct`` trees for every
arch in ``configs/`` and every entry of ``SHAPES`` it supports, at full
width (neither side allocates). The counterpart of
``tests/test_launch.py::test_input_specs_shapes``, with the vocabulary
padded to 16 and the distribution context of the (16, 16) mesh (tp 16,
padded heads)."""
import dataclasses
import importlib
import os
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro.models.module import tree_paths as jax_tree_paths  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import api, transformer as TF  # noqa: E402
from repro_torch.models.module import tree_paths  # noqa: E402

ARCHS = sorted(list_configs())
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if get_config(a).supports(SHAPES[s])]
JAX_MESH = SimpleNamespace(axis_names=("data", "model"),
                           devices=np.empty((16, 16), object))


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


def assert_same_tree(got, want, what):
    """Same paths (``jax.eval_shape`` returns dicts in sorted key order),
    and per path the same shape and dtype; every port leaf on the meta
    device."""
    g, w = tree_paths(got), jax_tree_paths(want)
    assert sorted(g) == sorted(w), what
    for path, x in g.items():
        assert x.device.type == "meta", (what, path)
        assert tuple(x.shape) == tuple(w[path].shape), (what, path)
        assert str(x.dtype).removeprefix("torch.") \
            == np.dtype(w[path].dtype).name, (what, path)


def test_the_configs_are_repros():
    assert tuple(ARCHS) == tuple(sorted(dryrun.ARCHS))
    for a in ARCHS:
        assert dataclasses.asdict(get_config(a)) \
            == dataclasses.asdict(jax_get_config(a))
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in JSHAPES.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_matches_repro(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert TF.period_len(cfg) == JTF.period_len(jcfg)
    for pad in (1, 16):
        assert TF.padded_vocab(cfg, pad) == JTF.padded_vocab(jcfg, pad)
        assert_same_tree(api.param_spec(cfg, pad),
                         jax_api.param_spec(jcfg, pad), f"{arch} pad {pad}")
    # the (16, 16) mesh's context: tp 16 (padded heads) and its vocab pad
    mesh = make_production_mesh()
    pcfg, jpcfg = (dryrun.with_mesh_context(cfg, mesh),
                   repro_launch("dryrun").with_mesh_context(jcfg, JAX_MESH))
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(jpcfg)
    pad = dryrun.vocab_pad_for(pcfg, mesh)
    assert_same_tree(api.param_spec(pcfg, pad), jax_api.param_spec(jpcfg, pad),
                     f"{arch} in the (16, 16) context")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_repro(arch, shape):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    assert cfg.supports(SHAPES[shape]) == jcfg.supports(JSHAPES[shape])
    got = api.input_specs(cfg, SHAPES[shape])
    want = jax_api.input_specs(jcfg, JSHAPES[shape])
    assert_same_tree(got, want, f"{arch} {shape}")
    if SHAPES[shape].kind == "train":
        assert got["tokens"].dtype == got["labels"].dtype == torch.int32
    if SHAPES[shape].kind == "decode":
        assert got["token"].dtype == got["pos"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-small",
                                  "recurrentgemma-9b", "mamba2-130m"])
def test_cache_spec_matches_repro(arch):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for batch, cache_len in ((3, 40), (128, 32768 + cfg.n_patches)):
        assert_same_tree(api.cache_spec(cfg, batch, cache_len),
                         jax_api.cache_spec(jcfg, batch, cache_len),
                         f"{arch} B {batch} len {cache_len}")


def test_meta_specs_allocate_nothing_and_keep_the_generator():
    gen = torch.Generator().manual_seed(5)
    state = gen.get_state()
    params = api.init_model(gen, get_config("arctic-480b"), device="meta")
    assert torch.equal(gen.get_state(), state)
    assert all(x.device.type == "meta" for x in tree_paths(params).values())


def test_a_real_init_is_unchanged_by_the_device_argument():
    cfg = get_config("smollm-360m").reduced()
    a = api.init_model(torch.Generator().manual_seed(0), cfg)
    b = api.init_model(torch.Generator().manual_seed(0), cfg, 1,
                       device="cpu")
    for path, x in tree_paths(a).items():
        assert torch.equal(x, tree_paths(b)[path]), path
