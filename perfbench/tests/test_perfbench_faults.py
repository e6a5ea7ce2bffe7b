"""A run with the timed path broken underneath comes out not correct, for
each fault a training cell can have (the harness's look for a card
skipped; the program on the CPU at the reduced size)."""
import pytest

from perfbench_testkit import cells, run_reduced
from perfbench.lib.faults import FAULTS


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", cells())
def test_a_planted_fault_is_not_correct(cell, fault):
    line = run_reduced(cell, fault=fault)
    assert not line["correct"], line["compared"]
