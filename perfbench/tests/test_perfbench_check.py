"""The reference agrees with the port at the reduced size over two
trainer iterations or PS cycles, under each cell's own limits, and the
result line has the keys the driver reads."""
import pytest

from perfbench_testkit import R, cells, run_reduced

KEYS = ["correct", "attempted", "failed", "metrics", "device", "compared"]


@pytest.mark.parametrize("cell", cells())
def test_the_reference_agrees_with_the_port(cell):
    line = run_reduced(cell, check_steps=2)
    assert line["correct"], line["compared"]
    assert line["compared"]["count_diffs"]["value"] == 0
    assert list(line) == KEYS  # ``compared`` last
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert set(line["compared"]) == set(R.plan(cell)["workload"]["limits"])
    assert set(line["metrics"]) == {m["name"] for m in
                                    R.plan(cell)["end_to_end"]}
    assert line["device"]["platform"] == "cpu"


@pytest.mark.parametrize("cell", cells())
def test_a_traced_line_reports_per_layer_metrics_only(cell):
    line = run_reduced(cell, traced=True)
    assert line["correct"]
    # no card here: nothing is profiled, so no breakdown and no device
    # time; only what needs no card may be read
    assert [k for k in line if k != "breakdown"] == KEYS
    assert not {m["name"] for m in R.plan(cell)["end_to_end"]} \
        & set(line["metrics"])


@pytest.mark.parametrize("cell", cells())
def test_a_traced_run_hands_the_readers_the_ports_spans(cell):
    import time

    import torch

    from perfbench_testkit import few_threads, reduced_plan
    pl = reduced_plan(cell)
    wl, cfg = pl["workload"], pl["config"]
    with few_threads():
        ctx = R.load_module(pl["driver"]).run(
            wl, cfg, 5, 0.3, True, torch.device("cpu"),
            time.perf_counter())["ctx"]
    assert ctx["program_iters"] == wl["profile_iters"]
    recs = ctx["program_spans"]
    by_id = {r.id: r for r in recs}

    def parents(name):
        got = [by_id[r.parent].name for r in recs if r.name == name]
        assert got, f"no {name} span"
        return set(got)

    assert parents("ps.combine") == {"ps.step"}
    assert sum(r.name == "ps.step" for r in recs) == wl["profile_iters"]
    if wl["driver"] == "trainer":
        assert parents("worker.forward") == {"worker.grad"}
        assert sum(r.name == "worker.grad" for r in recs) \
            == wl["profile_iters"] * wl["job"]["burst_size"]
        mixer = {"dense": "model.attention", "ssm": "model.ssd"}
        assert parents(mixer[cfg["family"]]) == {"model.period"}
        assert "worker.forward" in parents("model.period")
    else:
        stats = ctx["program_stats"]
        assert len(stats) == wl["profile_iters"]
        assert {"loss", "combined", "screened"} <= set(stats[0])
    # no device time off a card: the readers find nothing
    assert all(r.device_ms is None for r in recs)
