"""The control: the reference computed in the precision below the stated
one (training cells: float8 e4m3 products with a per-tensor scale, below
the models' bfloat16; the PS engine: its queue and combine in bfloat16,
below their float32) in the program's place fails the cell's check, on
three seeds."""
import pytest
import torch

from perfbench_testkit import R, cells, few_threads, reduced_plan
from perfbench.reference import compare as C

SEEDS = (11, 2_222_222_222, 3_000_000_019)


@pytest.mark.parametrize("cell", cells())
def test_the_float8_control_is_not_correct(cell):
    pl = reduced_plan(cell, control_size=True)
    drv = R.load_module(pl["driver"])
    cpu = torch.device("cpu")
    for seed in SEEDS:
        with few_threads():
            ref = drv.reference(pl["workload"], pl["config"], seed, cpu)
            ctl = drv.reference(pl["workload"], pl["config"], seed, cpu,
                                precision=drv.CONTROL)
        numbers = C.compare(ctl, ref)
        assert not C.verdict(numbers, pl["workload"]["limits"]), numbers
