"""Shared set-up of the benchmark's CPU tests: every cell at a reduced
size (the program's ``ArchConfig.reduced()`` sizes, float32, remat off,
two rows of 16 tokens a worker), run through the driver on the CPU."""
import contextlib
import copy
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import run as R  # noqa: E402

#: The reduced sizes of each configuration, as ``ArchConfig.reduced()``
#: sets them.
REDUCED = {
    "smollm-360m": dict(num_hidden_layers=2, hidden_size=64,
                        num_attention_heads=4, num_key_value_heads=2,
                        head_dim=16, intermediate_size=128, vocab_size=256,
                        dtype="float32"),
    "mamba2-130m": dict(num_hidden_layers=2, hidden_size=64, state_size=16,
                        headdim=16, chunk_size=8, vocab_size=256,
                        dtype="float32"),
}
#: A larger size for the control (reference against reference, no
#: program) where the one at ``REDUCED`` is too small for the lower
#: precision to show: (the configuration's sizes, the job's sequence).
CONTROL_SIZES = {
    "mamba2-130m": (dict(hidden_size=256, state_size=64, headdim=64,
                         num_hidden_layers=6, chunk_size=32), 128),
}
SEED = 3_000_000_019  # above 2**31, as the driver's are


def cells(root: Path = ROOT):
    import json
    return [w["name"] for w in
            json.loads((root / "BENCHMARK.json").read_text())["workloads"]]


def reduced_plan(cell: str, root: Path = ROOT, *, control_size=False,
                 **workload) -> dict:
    pl = copy.deepcopy(R.plan(cell, root))
    name = pl["config"]["registry"]
    pl["config"].update(REDUCED[name], registry_reduced=True)
    job = pl["workload"]["job"]
    job.update(batch=2 * job["workers"], seq=16)
    if control_size and name in CONTROL_SIZES:
        sizes, seq = CONTROL_SIZES[name]
        pl["config"].update(sizes)
        job.update(seq=seq)
    pl["workload"].update(workload)
    return pl


@contextlib.contextmanager
def few_threads(n: int = 2):
    """At most ``n`` CPU threads for torch while the block runs (the test
    workers share the machine's cores), restored after it."""
    import torch
    was = torch.get_num_threads()
    torch.set_num_threads(min(n, was))
    try:
        yield
    finally:
        torch.set_num_threads(was)


def run_reduced(cell: str, *, fault=None, traced=False, seconds=0.3,
                seed=SEED, pl=None, **workload) -> dict:
    import torch
    pl = pl or reduced_plan(cell, **workload)
    with few_threads():
        return R.execute(pl, seed, seconds, traced, torch.device("cpu"),
                         time.perf_counter(), fault=fault)
