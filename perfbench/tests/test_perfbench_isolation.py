"""What the benchmark runs loads neither JAX nor the JAX package
(``repro``), compared by whole top-level name; the reference loads
nothing of the program; and a run without a card, or without the
program, fails before it prints a result."""
import ast
import json
import os
import shutil
import subprocess
import sys

from perfbench_testkit import ROOT

BENCH = ROOT / "perfbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_file_of_the_benchmark_imports_jax_or_repro():
    for path in BENCH.rglob("*.py"):
        assert not set(imported_tops(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        assert "repro_torch" not in set(imported_tops(path)), path


RUN_BLOCKED = r"""
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {"jax", "jaxlib", "flax", "repro"}:
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
sys.path.insert(0, %r)
import torch
torch.set_num_threads(2)
from perfbench_testkit import run_reduced, R
line = run_reduced("smollm-360m.train-long", traced=True)
print(R.forbidden_modules(), line["correct"])
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_a_run_loads_no_forbidden_module():
    out = subprocess.run([sys.executable, "-c",
                          RUN_BLOCKED % str(BENCH / "tests")],
                         capture_output=True, text=True, env=_env(),
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def _no_result(out):
    lines = out.stdout.strip().splitlines()
    return not lines or not lines[-1].startswith("{")


def test_a_run_without_a_card_fails_without_a_result():
    out = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "smollm-360m.train-long", "--seed", "5", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, env=_env(),
        cwd=ROOT, timeout=300)
    assert out.returncode != 0 and _no_result(out)


def test_a_checkout_of_the_benchmark_alone_fails_without_a_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    cmd = json.loads((ROOT / "BENCHMARK.json").read_text())["command"]
    out = subprocess.run(
        [sys.executable if cmd[0] == "python3" else cmd[0], *cmd[1:],
         "--workload", "smollm-360m.train-long", "--seed", "5",
         "--seconds", "1", "--trace", "0"], capture_output=True, text=True,
        env=_env(), cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and _no_result(out)
