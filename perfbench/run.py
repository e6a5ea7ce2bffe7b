#!/usr/bin/env python3
"""One run of one benchmark cell of the port (``repro_torch``):

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Everything is found by name:
``BENCHMARK.json`` names the cell's configuration and metrics,
``perfbench/workloads/<cell>.json`` holds its traffic (the driver, the
job's parameters, the limits of its check),
``perfbench/configs/<config>.json`` the model (and, where it names one,
``perfbench/reference/<module>.py`` its plain reference),
``perfbench/drivers/<driver>.py`` runs the cell and
``perfbench/metrics/<metric>.py`` reads one per-layer metric from what
the traced run recorded. A new cell, configuration, reference model or
metric is a new file, and no code changes.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``,
``breakdown`` (traced runs) and ``compared``, each number of the check
beside its limit; the same numbers end standard error. The run fails, and
prints no result, without as many CUDA cards as the cell asks for, or if
``jax``, ``jaxlib``, ``flax`` or ``repro`` was imported in this process.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _paths(root: Path) -> None:
    for p in (str(root / "src"), str(root)):
        if p not in sys.path:
            sys.path.insert(0, p)


def load_module(path: Path):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def plan(cell: str, root: Path = ROOT) -> dict:
    """Everything a run of ``cell`` needs, found by name under ``root``:
    the cell's entry in ``BENCHMARK.json``, its workload, configuration
    and driver files, and its end-to-end and per-layer metrics (each
    per-layer one with its reader)."""
    bench_dir = root / "perfbench"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    entry = next((w for w in spec["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"no cell {cell!r} in BENCHMARK.json")
    workload = json.loads((bench_dir / "workloads" / f"{cell}.json")
                          .read_text())
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])
    config = json.loads((root / conf["file"]).read_text())
    if "reference" in config:  # its plain model lies in this checkout
        config["reference_dir"] = str(bench_dir / "reference")
    e2e = [m for m in spec["end_to_end"] if _applies(m, cell)]
    e2e_names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in e2e_names)]
    for m in layer:
        m["reader"] = bench_dir / "metrics" / f"{m['name']}.py"
        if not m["reader"].exists():
            raise SystemExit(f"no reader {m['reader']} for {m['name']}")
    driver = bench_dir / "drivers" / f"{workload['driver']}.py"
    if not driver.exists():
        raise SystemExit(f"no driver {driver}")
    return {"cell": cell, "chips": entry["chips"], "workload": workload,
            "config": config, "driver": driver, "end_to_end": e2e,
            "per_layer": layer}


def forbidden_modules() -> list:
    """Top-level names of the loaded modules that the benchmark may not
    load, compared whole (``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def execute(pl: dict, seed: int, seconds: float, traced: bool, device,
            t0: float, *, fault=None, notes=None) -> dict:
    """Run the cell through its driver and assemble the result line;
    ``notes`` (a list) takes the driver's lines about its phases."""
    import torch
    from perfbench.lib import peaks
    driver = load_module(pl["driver"])
    out = driver.run(pl["workload"], pl["config"], seed, seconds, traced,
                     device, t0, fault=fault)
    if notes is not None:
        notes.extend(out.get("notes", []))
    on_card = device.type == "cuda"
    name = torch.cuda.get_device_name(device) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": pl["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    metrics = {}
    if traced:
        ctx = dict(out["ctx"], peaks=peaks.peaks_of(name))
        for m in pl["per_layer"]:
            value = load_module(m["reader"]).read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        prof = out["ctx"].get("profile")
        if prof is not None:
            dev["busy_s"], dev["window_s"] = prof.busy_s, prof.window_s
    else:
        for m in pl["end_to_end"]:
            if m["name"] not in out["e2e"]:
                raise RuntimeError(f"the driver measured no {m['name']}")
            metrics[m["name"]] = {"value": float(out["e2e"][m["name"]]),
                                  "unit": m["unit"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics, "device": dev}
    if traced and out["ctx"].get("profile") is not None:
        line["breakdown"] = out["ctx"]["profile"].breakdown()
    line["compared"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in out["compared"].items()}
    return line


def _json_number(x):
    return x if isinstance(x, (int, str)) or x is None or math.isfinite(x) \
        else str(x)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 perfbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _paths(ROOT)
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"perfbench: the program is not in this checkout ({e})",
              file=sys.stderr)
        return 2
    pl = plan(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < pl["chips"]:
        print(f"perfbench: {args.workload} needs {pl['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    from perfbench.lib import peaks
    notes = []
    line = execute(pl, args.seed, args.seconds, bool(args.trace),
                   torch.device("cuda", 0), T0, notes=notes)
    found = forbidden_modules()
    if found:
        print(f"perfbench: this process loaded {found}", file=sys.stderr)
        return 3
    for note in notes:
        print(f"perfbench: {note}", file=sys.stderr)
    card = peaks.power_limit()
    line["device"]["power_limit"] = card
    for k, m in line["metrics"].items():
        print(f"{k} {m['value']!r} {m['unit']} (card: {card})",
              file=sys.stderr)
    for k, c in line["compared"].items():
        print(f"compared {k} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    line["compared"] = {k: {kk: _json_number(vv) for kk, vv in c.items()}
                        for k, c in line["compared"].items()}
    sys.stdout.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
