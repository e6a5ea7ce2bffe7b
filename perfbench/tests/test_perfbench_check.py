"""The reference agrees with the port at the reduced size over two
trainer iterations or PS cycles, under each cell's own limits, and the
result line has the keys the driver reads."""
import pytest

from perfbench_testkit import (R, cells, check_the_ports_spans, reduced_plan,
                               run_reduced)

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
    check_the_ports_spans(reduced_plan(cell))
