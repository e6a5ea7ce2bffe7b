"""Shared set-up of the benchmark's CPU tests: every cell at a reduced
size (its configuration file's ``cpu_sizes``, the program's
``ArchConfig.reduced()`` sizes in float32 with remat off; two rows of 16
tokens a worker), run through the driver on the CPU."""
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

SEED = 3_000_000_019  # above 2**31, as the driver's are


def cells(root: Path = ROOT):
    import json
    return [w["name"] for w in
            json.loads((root / "BENCHMARK.json").read_text())["workloads"]]


def reduced_plan(cell: str, root: Path = ROOT, *, control_size=False,
                 **workload) -> dict:
    """The cell's plan at its configuration's ``cpu_sizes``; with
    ``control_size``, at its ``cpu_control`` sizes and sequence on top of
    them where the file has them (a size at which the lower precision of
    the control shows)."""
    pl = copy.deepcopy(R.plan(cell, root))
    cfg = pl["config"]
    cfg.update(cfg["cpu_sizes"], registry_reduced=True)
    job = pl["workload"]["job"]
    job.update(batch=2 * job["workers"], seq=16)
    if control_size and "cpu_control" in cfg:
        cfg.update(cfg["cpu_control"]["sizes"])
        job.update(seq=cfg["cpu_control"]["seq"])
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


def check_the_ports_spans(pl: dict) -> None:
    """A traced run of the plan's cell hands the readers the port's spans
    in the stretch after the window, nested as the readers expect. The
    model's spans are held by their place alone, whatever the model: a
    mixer under ``model.period``, every ``model.*`` span below a
    ``model.period``, which the forward opens."""
    import torch
    wl = pl["workload"]
    with few_threads():
        ctx = R.load_module(pl["driver"]).run(
            wl, pl["config"], 5, 0.3, True, torch.device("cpu"),
            time.perf_counter())["ctx"]
    assert ctx["program_iters"] == wl["profile_iters"]
    recs = ctx["program_spans"]
    by_id = {r.id: r for r in recs}

    def parents(name):
        got = [by_id[r.parent].name for r in recs if r.name == name]
        assert got, f"no {name} span"
        return set(got)

    def ancestors(r):
        while r.parent is not None:
            r = by_id[r.parent]
            yield r.name

    assert parents("ps.combine") == {"ps.step"}
    assert sum(r.name == "ps.step" for r in recs) == wl["profile_iters"]
    if wl["driver"] == "trainer":
        assert parents("worker.forward") == {"worker.grad"}
        assert sum(r.name == "worker.grad" for r in recs) \
            == wl["profile_iters"] * wl["job"]["burst_size"]
        model = [r for r in recs if r.name.startswith("model.")
                 and r.name != "model.period"]
        assert any(by_id[r.parent].name == "model.period" for r in model), \
            "no model span under model.period"
        for r in model:
            assert "model.period" in ancestors(r), r.name
        assert "worker.forward" in parents("model.period")
    else:
        stats = ctx["program_stats"]
        assert len(stats) == wl["profile_iters"]
        assert {"loss", "combined", "screened"} <= set(stats[0])
    # no device time off a card: the readers find nothing
    assert all(r.device_ms is None for r in recs)
