"""The port stands alone: no module of ``repro_torch``, nor ``chip_smoke.py``,
imports ``jax`` or ``repro``; and its entry points do not fall back to the
CPU when no card is present."""
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]

_CHILD = textwrap.dedent("""
    import importlib, importlib.abc, pkgutil, sys

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            top = name.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                raise ImportError(f"blocked import of {name}")
            return None

    sys.meta_path.insert(0, Block())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                   "repro_torch.")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # noqa: F401  (its checks run only as __main__)
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not leaked, leaked
    print(" ".join(names))
""")


def test_port_imports_neither_jax_nor_repro():
    env = {**os.environ, "PYTHONPATH": f"{ROOT / 'src'}:{ROOT}"}
    proc = subprocess.run([sys.executable, "-c", _CHILD], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    names = set(proc.stdout.split())
    assert len(names) >= 68  # every module was imported
    assert {"repro_torch.core.hybrid", "repro_torch.kernels.olaf_combine",
            "repro_torch.kernels.olaf_enqueue",
            "repro_torch.launch.train", "repro_torch.models.transformer",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.decode_attention",
            "repro_torch.launch.serve", "repro_torch.optim.compress",
            "repro_torch.core.verifier",
            "repro_torch.examples.quickstart",
            "repro_torch.distributed.sharding",
            "repro_torch.launch.dryrun", "repro_torch.launch.roofline",
            "repro_torch.launch.mesh",
            "repro_torch.launch.hlo_analysis"} <= names


def test_trainer_without_a_card_raises():
    from repro_torch.device import resolve_device
    from repro_torch.rl.async_trainer import AsyncDRLTrainer, AsyncTrainConfig
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AsyncDRLTrainer(AsyncTrainConfig())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_without_a_card_raises():
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = get_config("smollm-360m").reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve(cfg, batch=1, prompt_len=4, gen=1)
