"""A cell and a per-layer metric added as files, in a copy of the
benchmark, are taken with no edit of its code; and the reduction of a
profiled stretch."""
import json
import shutil

import pytest

from perfbench_testkit import ROOT, R, reduced_plan, run_reduced
from perfbench.lib import trace

READER = '''
def read(ctx):
    n = ctx.get("iters")
    return float(n) if n else None
'''


@pytest.fixture
def copy_with_new_files(tmp_path):
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    first = spec["workloads"][0]
    new = dict(first, name=first["config"] + ".train-copy",
               traffic="train-copy")
    spec["workloads"].append(new)
    spec["per_layer"].append({
        "name": "iters_in_window.train", "unit": "iterations",
        "better": "higher", "source": "program_counter",
        "layer": "trainer", "moves": "train_tokens_per_s",
        "workloads": [new["name"]]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    wl = tmp_path / "perfbench" / "workloads"
    shutil.copy(wl / f"{first['name']}.json", wl / f"{new['name']}.json")
    (tmp_path / "perfbench" / "metrics" / "iters_in_window.train.py") \
        .write_text(READER)
    return tmp_path, new["name"]


def test_an_added_cell_and_metric_are_found(copy_with_new_files):
    root, cell = copy_with_new_files
    pl = R.plan(cell, root)
    names = {m["name"] for m in pl["per_layer"]}
    assert "iters_in_window.train" in names
    assert pl["driver"] == root / "perfbench" / "drivers" / "trainer.py"
    line = run_reduced(cell, traced=True, pl=reduced_plan(cell, root))
    assert line["metrics"]["iters_in_window.train"]["value"] >= 1
    # the cells already there do not report it
    old = R.plan(json.loads((root / "BENCHMARK.json").read_text())
                 ["workloads"][0]["name"], root)
    assert "iters_in_window.train" not in {m["name"]
                                           for m in old["per_layer"]}


def test_a_profiled_stretch_reduces_to_busy_time_and_named_gaps():
    host = [(0.0, 100.0, trace.WINDOW), (0.0, 40.0, "perfbench.ps_step"),
            (50.0, 100.0, "perfbench.worker_grad")]
    device = [(10.0, 20.0, "k1"), (15.0, 30.0, "k2"), (60.0, 90.0, "k1")]
    p = trace.reduce(device, host, iters=2, wall_s=1e-4)
    assert p.window_s == pytest.approx(1e-4)
    assert p.busy_s == pytest.approx(50e-6)
    assert p.device_events == 3
    assert p.ops["k1"] == (2, pytest.approx(40e-6))
    # gaps [0, 10) and [30, 60) begin inside ps_step, [90, 100) inside
    # worker_grad
    assert p.gaps["perfbench.ps_step"] == pytest.approx(40e-6)
    assert p.gaps["perfbench.worker_grad"] == pytest.approx(10e-6)
    b = p.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"} and b["device_ops"][0][0] \
        == "k1"


@pytest.mark.parametrize("name, short", [
    ("void at::native::(anonymous namespace)::cunn_SoftMaxForward<4, float, "
     "float, float, at::native::(anonymous namespace)::SoftMaxForwardEpilogue>"
     "(float*, float const*, int)", "cunn_SoftMaxForward"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::"
     "AUnaryFunctor<float, float, float, at::native::binary_internal::"
     "MulFunctor<float> >, std::array<char*, 2ul> >(int, at::native::"
     "AUnaryFunctor<float, float, float>)", "vectorized_elementwise_kernel<MulFunctor>"),
    ("void olaf_step_kernel<16, 2>(OlafStepArgs)",
     "void olaf_step_kernel<16, 2>(OlafStepArgs)"),
])
def test_a_device_operation_keeps_a_name_that_tells_it_apart(name, short):
    assert trace.short_name(name) == short

