"""Serve the LM families of several checkouts on one card, one process per
checkout, in the order given, and count their device events.

    python3 tools/families_ab.py ROOT [ROOT ...] [--arch NAME ...]

Each ROOT is a checkout of this repository. For each, a fresh process
loads that checkout's ``chip_smoke.py`` (which puts the checkout's own
``src`` first on the path), builds its kernels, and serves each arch as
the smoke run's ``[families]`` phase does (``FAMILIES``: the published
widths at the phase's depth, bf16, seeded random weights, greedy,
``attn_impl="pallas"``): a warm-up, the served run timed with the launch
counts from 0, then the prefill and 4 decode steps under
``torch.profiler``, whose device events give the events per step. Prints
the card's name and power limit, then one JSON line per checkout. To
compare two versions within one call, give them as A B B A.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import pathlib
import subprocess
import sys


def measure(root: pathlib.Path, archs) -> dict:
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_ab", root / "chip_smoke.py")
    sm = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = sm  # its dataclasses look their module up
    spec.loader.exec_module(sm)
    torch = sm.torch
    if not torch.cuda.is_available():
        raise SystemExit("families_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    sm._build.build_all()
    rows = {}
    for arch in archs or list(sm.FAMILIES):
        depth, B, P = sm.FAMILIES[arch]
        cfg = sm.family_cfg(arch, attn_impl="pallas")
        torch.cuda.empty_cache()
        params = sm.lm_api.init_model(torch.Generator(dev).manual_seed(0),
                                      cfg)
        sm.launch_serve.serve(cfg, batch=B, prompt_len=P, gen=2,
                              temperature=0.0, device=dev, params=params)
        sm.reset_counts()
        served = sm.launch_serve.serve(cfg, batch=B, prompt_len=P,
                                       gen=sm.FAMILY_GEN, temperature=0.0,
                                       device=dev, params=params)
        counts = sm.read_counts()
        prof = sm.profiled_family(params, cfg, dev, B, P)
        rows[arch] = dict(
            layers=depth, B=B, P=P, gen=sm.FAMILY_GEN,
            prefill_ms=served.prefill_s * 1e3,
            decode_ms_per_token=served.decode_s / sm.FAMILY_GEN * 1e3,
            prefill_events=prof["prefill"]["events"],
            decode_events_per_step=prof["decode"]["events_per_step"],
            launches={k: v for k, v in counts.items() if v},
            tokens0=served.tokens[0][:8].tolist())
        del params
    return dict(root=str(root), rows=rows)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+", type=pathlib.Path)
    ap.add_argument("--arch", action="append", default=[],
                    help="an arch of FAMILIES (repeatable; default all)")
    ap.add_argument("--one", action="store_true",
                    help="measure the one ROOT in this process")
    args = ap.parse_args(argv)
    if args.one:
        print(json.dumps(measure(args.roots[0].resolve(), args.arch)),
              flush=True)
        return 0
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip() or "nvidia-smi: not available", flush=True)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    extra = [a for arch in args.arch for a in ("--arch", arch)]
    for root in args.roots:
        root = root.resolve()
        done = subprocess.run(
            [sys.executable, str(pathlib.Path(__file__).resolve()), str(root),
             "--one", *extra], cwd=root, env=env, capture_output=True,
            text=True)
        sys.stderr.write(done.stderr[-4000:])
        if done.returncode:
            print(f"families_ab: {root} exited {done.returncode}", flush=True)
            return done.returncode
        print(done.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
