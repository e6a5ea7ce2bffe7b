"""The port's example drivers (``repro_torch.examples``) against ``repro``'s
``examples/*.py``, on the CPU.

``examples/lm_train.py`` hands ``run_sync``/``run_olaf_async`` a partial
``argparse.Namespace``; ``repro`` reads the flags it leaves out with
defaults. The exact Namespace that example builds (steps cut to 3) goes
through both packages at the same weights (``repro``'s, carried across with
``params_from_jax``): losses within ``rtol=1e-4`` (H19: AdamW turns float
noise into lr-sized steps) and every counter of the olaf-async summary
equal. The quickstart's queue and AoM lines must equal ``repro``'s
quickstart's (the port's netsim is a numpy copy). The other drivers run
end to end at a small size and finish with finite numbers; with the
default device and no card each raises.
"""
import argparse
import contextlib
import dataclasses
import importlib.util
import io
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.launch import train as jax_train  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.examples import (async_drl_train, lm_train,  # noqa: E402
                                  quickstart, serve_decode)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import api  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_example(name: str):
    """``examples/<name>.py`` of ``repro``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"repro_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a)
    return res, out.getvalue()


def _example_call(monkeypatch, olaf: bool, ckpt: str):
    """The (cfg, Namespace) ``examples/lm_train.py``'s ``main`` hands to
    ``repro.launch.train``, captured instead of run."""
    seen = {}
    name = "run_olaf_async" if olaf else "run_sync"
    monkeypatch.setattr(jax_train, name,
                        lambda cfg, ns: seen.update(cfg=cfg, ns=ns))
    monkeypatch.setattr(sys, "argv", ["lm_train.py", "--steps", "3",
                                      "--ckpt", ckpt]
                        + (["--olaf"] if olaf else []))
    _load_example("lm_train").main()
    monkeypatch.undo()
    return seen["cfg"], seen["ns"]


def _final_and_first(text):
    line = [ln for ln in text.splitlines() if ln.startswith("final loss")][-1]
    parts = line.split("; ")
    head = parts[0].replace("final loss ", "").replace("(first ", "")
    return [float(x) for x in head.rstrip(")").split()], parts[1:-1]


@pytest.mark.parametrize("olaf", [False, True], ids=["sync", "olaf_async"])
def test_lm_train_namespace_runs_as_in_repro(monkeypatch, tmp_path, olaf):
    jcfg, ns = _example_call(monkeypatch, olaf, str(tmp_path / "repro"))
    assert not hasattr(ns, "device") and not hasattr(ns, "queue_slots")
    cfg = lm_train.config()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want_params = jax_api.init_model(jax.random.key(ns.seed), jcfg)
    monkeypatch.setattr(api, "init_model", lambda gen, c: params_from_jax(
        want_params, device=gen.device))
    fn, jfn = ((train.run_olaf_async, jax_train.run_olaf_async) if olaf
               else (train.run_sync, jax_train.run_sync))
    jns = argparse.Namespace(**vars(ns))
    if olaf:
        jns.step_impl = "xla"  # repro's XLA route on the CPU
    want, text_j = _run(jfn, jcfg, jns)
    pns = argparse.Namespace(**vars(ns))  # the same partial Namespace
    if not olaf:
        pns.ckpt = str(tmp_path / "port")  # a fresh directory: no resume
    got, text_p = _run(fn, cfg, pns, "cpu")
    losses_j, counters_j = _final_and_first(text_j)
    losses_p, counters_p = _final_and_first(text_p)
    np.testing.assert_allclose(losses_p, losses_j, rtol=1e-4)
    assert counters_p == counters_j
    last = got.log_rows[-1][1] if olaf else got.losses[-1]
    np.testing.assert_allclose(last, want, rtol=1e-4)
    if not olaf:
        assert sorted(os.listdir(pns.ckpt)) == sorted(os.listdir(ns.ckpt))


def test_quickstart_lines_equal_repros():
    ref = _load_example("quickstart")
    want = _run(lambda: (ref.demo_queue(), ref.demo_aom()))[1]
    got = _run(lambda: (quickstart.demo_queue(), quickstart.demo_aom()))[1]
    assert got == want
    assert "olaf:" in got and "fifo:" in got


def test_quickstart_main_on_cpu():
    res, text = _run(quickstart.main, ["--device", "cpu"])
    assert res["equal"] and res["counts_equal"] and res["max_abs_err"] == 0.0
    assert res["counts"] == [2, 2, 2, 2]
    assert text.rstrip().endswith("quickstart OK")


def test_lm_train_main_on_cpu(tmp_path):
    sync, _ = _run(lm_train.main, ["--steps", "2", "--ckpt",
                                   str(tmp_path / "ck"), "--device", "cpu"])
    assert len(sync.losses) == 2 and all(map(math.isfinite, sync.losses))
    olaf, text = _run(lm_train.main, ["--olaf", "--steps", "2", "--device",
                                      "cpu"])
    assert len(olaf.log_rows) == 2
    assert all(math.isfinite(l) for _, l, _ in olaf.log_rows)
    assert "final loss" in text


def test_async_drl_train_main_on_cpu():
    res, text = _run(async_drl_train.main, ["--updates", "2", "--device",
                                            "cpu"])
    assert set(res) == {"fifo", "olaf"}
    for r in res.values():
        assert r["applied"] > 0
        assert all(math.isfinite(r[k]) for k in ("loss_pct", "avg_aom",
                                                 "eval_return"))
    assert text.count("eval return") == 2


def test_serve_decode_main_on_cpu():
    res, text = _run(serve_decode.main, ["--arch", "mamba2-130m",
                                         "--device", "cpu"])
    assert list(res) == ["mamba2-130m"]
    assert res["mamba2-130m"].tokens.shape == (2, 13)
    assert "=== mamba2-130m (reduced) ===" in text


@pytest.mark.parametrize("module", [quickstart, async_drl_train, lm_train,
                                    serve_decode],
                         ids=lambda m: m.__name__.rsplit(".", 1)[1])
def test_examples_without_a_card_raise(module):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        module.main([])


def test_quickstart_runs_as_a_module():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.examples.quickstart", "--device",
         "cpu"], cwd=ROOT, env=env, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.rstrip().endswith("quickstart OK")
