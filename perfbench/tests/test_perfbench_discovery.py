"""A cell, a per-layer metric, a configuration with a reference model of
its own and a new architecture, each added as files in a copy of the
benchmark, are taken with no edit of its code; the reduction of a
profiled stretch; and what a reader takes from the port's own spans."""
import dataclasses
import json
import shutil

import pytest

from perfbench_testkit import (ROOT, R, check_the_ports_spans, reduced_plan,
                               run_reduced)
from perfbench.lib import program, trace
from perfbench.reference import flops, lm, models

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



#: A Llama-style decoder as a reference module of its own: the parameter
#: table written out, the loss a loop over ``lm``'s dense layer, and 6·N
#: FLOPs a token (the default counts attention besides).
REFERENCE = '''
from perfbench.reference import lm

CALLS = []


def param_table(cfg):
    CALLS.append("param_table")
    d, L, V = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["vocab_size"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    Dh, Fd, pre = d // H, cfg["intermediate_size"], "layers/sub_0/"
    rows = [lm.Param("embedding/embed", (V, d), "model", ("normal", 0.02)),
            lm.Param("final_norm/scale", (d,), "model", ("ones",)),
            lm.Param(pre + "ln1/scale", (L, d), "model", ("ones",)),
            lm.Param(pre + "ln2/scale", (L, d), "model", ("ones",)),
            lm._dense(pre + "attn/wq", (d, H, Dh), d, L),
            lm._dense(pre + "attn/wk", (d, KV, Dh), d, L),
            lm._dense(pre + "attn/wv", (d, KV, Dh), d, L),
            lm._dense(pre + "attn/wo", (H, Dh, d), H * Dh, L),
            lm._dense(pre + "mlp/wg", (d, Fd), d, L),
            lm._dense(pre + "mlp/wu", (d, Fd), d, L),
            lm._dense(pre + "mlp/wd", (Fd, d), Fd, L)]
    return sorted(rows, key=lambda p: p.path.split("/"))


def loss(P, tokens, labels, cfg, mm):
    CALLS.append("loss")
    E = P["embedding/embed"]
    x = E[tokens.long()]
    for i in range(cfg["num_hidden_layers"]):
        x = lm.dense_layer(P, i, x, cfg, mm)
    logits = mm(lm.rms(x, P["final_norm/scale"]), E.t())
    return lm.F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                              labels.reshape(-1).long())


def train_flops_per_token(cfg, seq):
    return 6.0 * lm.n_params(cfg)
'''


#: The two configurations added as files: ``llama-plain`` is the program's
#: smollm-360m under a reference module of its own; ``mqa-decoder`` is an
#: architecture no other test names, with its own registry name,
#: ``cpu_sizes`` and ``family`` besides. ``port`` is the registry entry
#: that the PR adding such a model puts under ``src/``, stood in for by one
#: the test registers for its duration: a decoder of one layer with one
#: key-value head, whose reduced sizes are no other configuration's.
ADDED = [
    pytest.param(dict(name="llama-plain", port=None, sizes={}, config={},
                      fault="altered"), id="reference-model"),
    pytest.param(dict(name="mqa-decoder",
                      port=dict(n_layers=1, n_kv_heads=1),
                      sizes=dict(num_hidden_layers=1, num_key_value_heads=1),
                      config=dict(family="decoder-mqa", parameters=None),
                      fault="half_batch"), id="new-architecture"),
]


@pytest.fixture(params=ADDED)
def copy_with_a_configuration(request, tmp_path, monkeypatch):
    """A copy of the benchmark with the configuration ``request.param``
    names, its reference module and its cell: all new files beside
    ``BENCHMARK.json`` entries appended to its lists."""
    case = request.param
    name, module = case["name"], case["name"].replace("-", "_")
    config = json.loads((ROOT / "perfbench" / "configs" / "smollm-360m.json")
                        .read_text())
    if case["port"]:
        from repro_torch.configs import base, get_config
        monkeypatch.setitem(base._REGISTRY, name, dataclasses.replace(
            get_config(config["registry"]), name=name, **case["port"]))
        config["registry"] = name
    config.update(case["config"], **case["sizes"], reference=module)
    config["cpu_sizes"] = dict(config["cpu_sizes"], **case["sizes"])
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = tmp_path / "perfbench"
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    like, cell = "smollm-360m.train-long", f"{name}.train-long"
    conf = next(c for c in spec["configs"] if c["name"] == "smollm-360m")
    spec["configs"].append(dict(conf, name=name,
                                file=f"perfbench/configs/{name}.json"))
    spec["workloads"].append({"name": cell, "config": name,
                              "traffic": "train-long", "chips": 1,
                              "why": "a configuration added as files"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if like in m.get("workloads", ()):
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    (bench / "configs" / f"{name}.json").write_text(json.dumps(config))
    wl = json.loads((bench / "workloads" / f"{like}.json").read_text())
    (bench / "workloads" / f"{cell}.json").write_text(
        json.dumps(dict(wl, config=name)))
    (bench / "reference" / f"{module}.py").write_text(REFERENCE)
    return tmp_path, cell, case


def test_a_configuration_added_as_files_is_run_and_checked(
        copy_with_a_configuration):
    root, cell, case = copy_with_a_configuration
    name, module = case["name"], case["name"].replace("-", "_")
    added = {f"configs/{name}.json", f"workloads/{cell}.json",
             f"reference/{module}.py"}
    for path in (root / "perfbench").rglob("*"):
        rel = path.relative_to(root / "perfbench").as_posix()
        if path.is_file() and rel not in added:
            assert path.read_bytes() == (ROOT / "perfbench" / rel) \
                .read_bytes(), rel
    pl = reduced_plan(cell, root, check_steps=2)
    # the sizes are the file's own, and are the program's reduced model's
    for k, v in case["sizes"].items():
        assert pl["config"][k] == v, k
    model = models.model_of(pl["config"])
    assert model.__file__ == str(root / "perfbench" / "reference"
                                 / f"{module}.py")
    # the module's count, not the default's (which adds attention)
    assert flops.train_flops_per_token(pl["config"], 16) \
        == 6.0 * lm.n_params(pl["config"])
    del model.CALLS[:]
    line = run_reduced(cell, pl=pl)
    assert line["correct"], line["compared"]
    assert {"param_table", "loss"} <= set(model.CALLS)
    assert not run_reduced(cell, pl=pl, fault=case["fault"])["correct"]
    check_the_ports_spans(reduced_plan(cell, root))


class Rec:
    def __init__(self, name, id, parent, device_ms):
        self.name, self.id, self.parent = name, id, parent
        self.device_ms = device_ms


def test_a_reader_takes_span_time_per_iteration_or_per_parent():
    recs = [Rec("worker.grad", 1, None, 10.0),
            Rec("worker.forward", 2, 1, 4.0),
            Rec("model.period", 3, 2, 3.0), Rec("model.ssd", 4, 3, 2.0),
            Rec("worker.backward", 5, 1, 6.0),
            Rec("model.period", 6, 5, 3.0), Rec("model.ssd", 7, 6, 2.5),
            Rec("worker.grad", 8, None, 10.0),
            Rec("worker.forward", 9, 8, 4.0), Rec("model.ssd", 10, 9, 1.0)]
    ctx = {"program_spans": recs, "program_iters": 1}
    assert program.span_ms(ctx, "model.ssd") == pytest.approx(5.5)
    assert program.span_ms(ctx, "model.attention", "model.ssd",
                           under="worker.forward", per="worker.grad") \
        == pytest.approx(1.5)
    assert program.span_ms(ctx, "model.attention") is None
    assert program.span_ms(dict(ctx, program_iters=0), "model.ssd") is None
    # off a card a span has no device time
    cpu = [Rec(r.name, r.id, r.parent, None) for r in recs]
    assert program.span_ms(dict(ctx, program_spans=cpu), "model.ssd") \
        is None


class Event:
    def __init__(self, name, start, end, device_type):
        self.name, self.device_type = name, device_type
        self.time_range = type("R", (), {"start": start, "end": end})


def test_the_ports_labels_are_no_device_operation_and_name_no_gap():
    CUDA, CPU = "cuda", "cpu"
    events = [Event(trace.WINDOW, 0.0, 100.0, CPU),
              Event("perfbench.ps_step", 0.0, 90.0, CPU),
              Event("perfbench.ps_step", 1.0, 80.0, CUDA),
              Event("olaf.ps.combine", 10.0, 60.0, CPU),
              Event("olaf.ps.combine", 12.0, 60.0, CUDA),
              Event("k1", 20.0, 30.0, CUDA)]
    device, host = trace.split(events, CUDA)
    assert device == [(20.0, 30.0, "k1")]
    assert [n for *_, n in host] == [trace.WINDOW, "perfbench.ps_step"]
    p = trace.reduce(device, host, iters=1, wall_s=1e-4)
    assert p.device_events == 1 and p.busy_s == pytest.approx(10e-6)
    # the gap from 30 begins inside ``olaf.ps.combine`` too: the harness's
    # label names it
    assert set(p.gaps) == {"perfbench.ps_step"}
