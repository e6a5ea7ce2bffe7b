#!/usr/bin/env python3
"""The readings a cell's limits are set from (never run by a benchmark run):

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--faults half_batch,altered]

For each seed, the program's first steps (set-up only, no window) against
the reference's: the sound reading. For each control seed, the reference
itself computed in the precision below the stated one (the driver's
``CONTROL``) in the program's place: the control, which has to fail. For each fault
(``lib/faults.py``), the program with that fault planted, on the control
seeds. One JSON line per reading on standard output; the same numbers the
cell's check compares.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def readings(pl, seeds, control_seeds, fault_names, device):
    import torch
    from perfbench import run as R
    from perfbench.reference import compare as C
    drv = R.load_module(pl["driver"])
    cell, config = pl["workload"], pl["config"]

    def free():
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()

    for seed in seeds:
        t = time.perf_counter()
        ref = drv.reference(cell, config, seed, device)
        free()
        t_ref = time.perf_counter() - t
        runs = [("sound", None)]
        if seed in control_seeds:
            runs += [("control", drv.CONTROL)] + [(f, f) for f in fault_names]
        for kind, arg in runs:
            t = time.perf_counter()
            if kind == "control":
                got = drv.reference(cell, config, seed, device, precision=arg)
            else:
                got = drv.program_trajectory(cell, config, seed, device,
                                             fault=None if kind == "sound"
                                             else arg)
            free()
            worst = {}
            for what, keep in (("grad", lambda k: True),
                               ("change", C.moved(ref).__contains__)):
                g = C.leaf_gaps(getattr(got, what + "_norms"),
                                getattr(ref, what + "_norms"), keep)
                worst[what] = sorted(g.items(), key=lambda kv: -kv[1])[:3]
            yield {"seed": seed, "kind": kind,
                   "numbers": C.compare(got, ref), "worst": worst,
                   "counts": got.counts, "ref_counts": ref.counts,
                   "losses": got.losses, "ref_losses": ref.losses,
                   "seconds": time.perf_counter() - t,
                   "reference_seconds": t_ref}


def main(argv=None) -> int:
    import torch
    from perfbench import run as R
    ap = argparse.ArgumentParser(prog="python3 perfbench/calibrate.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--faults", default="")
    args = ap.parse_args(argv)
    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    pl = R.plan(args.workload)
    dev = torch.device("cuda", 0)
    for row in readings(pl, ints(args.seeds), set(ints(args.control_seeds)),
                        [f for f in args.faults.split(",") if f], dev):
        print(json.dumps(row), flush=True)
    print(json.dumps({"peak": torch.cuda.max_memory_allocated(dev),
                      "card": torch.cuda.get_device_name(dev),
                      "wall_s": time.perf_counter() - T0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
