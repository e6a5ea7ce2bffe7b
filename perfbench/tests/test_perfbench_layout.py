"""BENCHMARK.json and the files it names: every cell's workload,
configuration, driver and metric readers exist and agree with the
program's own configuration."""
import json
import re

import pytest

from perfbench_testkit import ROOT, R, cells

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_shape():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"][:2] == ["python3", "perfbench/run.py"]
    assert SPEC["paths"] == ["perfbench"]
    assert isinstance(SPEC["run_seconds"], int) \
        and 1 <= SPEC["run_seconds"] <= 51
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert any(w["config"] == c["name"] for w in SPEC["workloads"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 0 < len(w["why"]) <= 200
    names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in names
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0 < m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and NAME.match(m["name"])
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in names and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


@pytest.mark.parametrize("cell", cells())
def test_each_cell_finds_its_files(cell):
    pl = R.plan(cell)
    assert pl["driver"].exists()
    assert pl["config"]["registry"]
    assert {m["name"] for m in pl["end_to_end"]} >= {"setup_s"}
    assert pl["per_layer"], "every cell reports a per-layer metric"
    for m in pl["per_layer"]:
        assert m["reader"].exists()
    # every number the check compares has a limit
    limits = pl["workload"]["limits"]
    assert set(limits) <= {"loss_gap", "grad_gap", "change_gap",
                           "count_diffs"}
    assert limits["count_diffs"] == 0 and {"grad_gap", "change_gap"} \
        & set(limits)


@pytest.mark.parametrize("config", sorted(
    (ROOT / "perfbench" / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_each_configuration_is_the_programs(config):
    from repro_torch.models import api
    from repro_torch.models.module import count_params
    cfg_file = json.loads(config.read_text())
    from perfbench.lib import olaf
    cfg = olaf.program_config(cfg_file)
    olaf.check_layout(cfg_file, cfg)
    assert count_params(api.param_spec(cfg)) == cfg_file["parameters"]
    assert cfg.n_layers == cfg_file["num_hidden_layers"]
    assert cfg.d_model == cfg_file["hidden_size"]
    assert cfg.vocab == cfg_file["vocab_size"]
    assert cfg.dtype == cfg_file["dtype"]
    # the CPU tests' sizes are the program's ``reduced()`` model
    small = dict(cfg_file, **cfg_file["cpu_sizes"], registry_reduced=True)
    red = olaf.program_config(small)
    olaf.check_layout(small, red)
    assert red.dtype == small["dtype"] == "float32"


@pytest.mark.parametrize("reader", sorted(
    (ROOT / "perfbench" / "metrics").glob("*.py")), ids=lambda p: p.stem)
def test_a_reader_with_nothing_to_read_returns_nothing(reader):
    assert R.load_module(reader).read({}) is None


#: What the parent of the reference-module lookup gave for each
#: configuration: parameters, training FLOPs a token at the cell's
#: sequence, and at the reduced size (seed ``SEED``) the SHA-256 of the
#: drawn weights and the reference's loss on one worker's first batch.
FROZEN = {
    "smollm-360m": (361_821_120, 2548414080.0, "b43c12012ec056d9d5213cfce"
                    "75bed0aa2c829fe89c4259a5494ff92ed2d2b32",
                    5.592703104019165),
    "mamba2-130m": (128_983_488, 773900928.0, "7a98fcd001c17be3e1165e229"
                    "bebc88c3492007daf89ea64396d4eeec42b5126",
                    5.54120659828186),
}


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_the_default_reference_model_is_unchanged(name):
    import hashlib

    import torch

    from perfbench.reference import data, flops, lm
    from perfbench_testkit import SEED, few_threads
    n, train_flops, digest, loss = FROZEN[name]
    cfg = json.loads((ROOT / "perfbench" / "configs" / f"{name}.json")
                     .read_text())
    assert "reference" not in cfg
    seq = json.loads((ROOT / "perfbench" / "workloads"
                      / f"{name}.train-long.json").read_text())["job"]["seq"]
    assert lm.n_params(cfg) == n == cfg["parameters"]
    assert flops.train_flops_per_token(cfg, seq) == train_flops
    red = dict(cfg, **cfg["cpu_sizes"])
    P = lm.draw_params(red, SEED, torch.device("cpu"))
    h = hashlib.sha256()
    for k in sorted(P):
        h.update(k.encode())
        h.update(P[k].contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest() == digest
    b = data.token_batch(red["vocab_size"], 16, 8, 4, 1, SEED, 0)
    with few_threads(1):
        got, _ = lm.loss_and_grads(P, torch.from_numpy(b["tokens"]),
                                   torch.from_numpy(b["labels"]), red,
                                   block_rows=1)
    assert got == pytest.approx(loss, rel=1e-6)
