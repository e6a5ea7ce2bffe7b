"""Time the one-device vectorized simulator of several checkouts on one
card, one process per checkout, in the order given.

    python3 tools/vecsim_ab.py ROOT [ROOT ...] [--steps N] [--profiled N]

Each ROOT is a checkout of this repository. For each, a fresh process
loads that checkout's ``chip_smoke.py`` (which puts the checkout's own
``src`` first on the path) and steps the first ``--steps`` boundaries of
``repro``'s k=8 ``vecsim_scale`` configuration (80 switches, 1,024
workers, D = 941, dt = 2^-11) on one device through its
``vecsim_segment``: a short warm-up, then the timed segment twice, then the
first ``--profiled`` boundaries unprofiled and again under
``torch.profiler``, whose device events give the events per boundary and
the card's idle share. Prints the card's name and power limit, then one
JSON line per checkout. To compare two versions within one call, give
them as A B B A.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys
import time


def measure(root: pathlib.Path, steps: int, profiled: int) -> dict:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", root / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = sm  # its dataclasses look their module up
    spec.loader.exec_module(sm)
    torch = sm.torch
    if not torch.cuda.is_available():
        raise SystemExit("vecsim_ab: no CUDA device")
    dev = torch.device("cuda")
    cfg = sm.vecsim_scale_cfg()
    rows = sm.vecsim_rows(cfg)

    def segment(n):
        runner, carry, ts = sm.vecsim_segment(cfg, rows, dev, n)
        torch.cuda.synchronize()
        return runner, carry, ts

    runner, carry, ts = segment(8)  # warm-up
    runner.run(carry, ts)
    walls, out = [], None
    for _ in range(2):
        runner, carry, ts = segment(steps)
        t0 = time.perf_counter()
        out = runner.run(carry, ts)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    pwalls, prof = [], None
    for with_prof in (False, True):
        runner, carry, ts = segment(profiled)
        t0 = time.perf_counter()
        if with_prof:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                runner.run(carry, ts)
                torch.cuda.synchronize()
        else:
            runner.run(carry, ts)
            torch.cuda.synchronize()
        pwalls.append(time.perf_counter() - t0)
    kernels = sm.device_kernels(prof)
    busy = sum(us for _, us in kernels.values()) / 1e6
    events = sum(n for n, _ in kernels.values())
    return dict(
        root=str(root), steps=steps, walls_s=walls,
        boundaries_per_s=[steps / w for w in walls],
        sent=int(out["sent"]), forwarded=int(out["forwarded"]),
        delivered=int(out["dlv"]["n"]), profiled_steps=profiled,
        profiled_walls_s=pwalls, device_events=events,
        events_per_boundary=events / profiled if events else None,
        device_busy_s=busy,
        idle_share=100 * (1 - busy / pwalls[0]) if events else None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=pathlib.Path)
    ap.add_argument("--steps", type=int, default=128)
    ap.add_argument("--profiled", type=int, default=32)
    ap.add_argument("--one", action="store_true",
                    help="measure the one ROOT in this process")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.roots[0].resolve(), args.steps,
                                 args.profiled)), flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: not available", flush=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for root in args.roots:
        root = root.resolve()
        done = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), str(root),
             "--one", "--steps", str(args.steps), "--profiled",
             str(args.profiled)], cwd=root, env=env, capture_output=True,
            text=True)
        sys.stderr.write(done.stderr[-4000:])
        if done.returncode:
            print(f"vecsim_ab: {root} exited {done.returncode}", flush=True)
            return done.returncode
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
