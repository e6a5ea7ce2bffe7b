"""Command-line entry point of the port: ``python -m repro_torch.launch.train``.

Only ``--mode scenario`` is ported: it replays a network topology scenario
through the hybrid multi-switch data plane
(:func:`repro_torch.core.hybrid.run_hybrid_multihop`) with the event or the
window backend, on ``--device`` (default ``cuda``), and prints the summary
line of ``repro.launch.train``. The LM trainer modes (``sync``,
``olaf-async``) and the vectorized backend come with later slices of the
port and exit with an error that says so.

    PYTHONPATH=src python -m repro_torch.launch.train --mode scenario \\
        --topology fattree --fattree-k 4 --sim-dim 941 --sim-impl window
"""
from __future__ import annotations

import argparse
import time

from repro_torch.core.hybrid import run_hybrid_multihop
from repro_torch.core.topology import fattree_cfg, multirack_cfg


def run_scenario(args):
    """Replay a topology scenario through the hybrid data plane with the
    selected backend (``event``: one event per call; ``window``: batched
    per transmission window) and print one summary line."""
    if args.topology == "fattree":
        sim_cfg = fattree_cfg(args.fattree_k, seed=args.seed,
                              spec_kw=dict(spines=args.fattree_spines))
    elif args.topology == "multirack":
        sim_cfg = multirack_cfg(seed=args.seed)
    else:
        sim_cfg = None  # §8.3 SW1/SW2/SW3 multihop default
    t0 = time.time()
    hyb, _cfg = run_hybrid_multihop(args.sim_dim, seed=args.seed,
                                    sim_cfg=sim_cfg, sim_impl=args.sim_impl,
                                    device=args.device)
    wall = time.time() - t0
    enq = sum(qs["enqueued"] for qs in hyb.queue_stats.values())
    agg = sum(qs["aggregations"] for qs in hyb.queue_stats.values())
    drp = sum(qs["dropped"] for qs in hyb.queue_stats.values())
    impl = args.sim_impl or "window"
    print(f"scenario {args.topology} [{impl}]: "
          f"{len(hyb.delivered)} delivered, {hyb.forwarded} forwarded, "
          f"{enq} enqueued / {agg} aggregated / {drp} dropped; "
          f"{hyb.launches} combine launches, "
          f"{hyb.h2d_transfers} h2d transfers; {wall:.2f}s wall")
    return hyb


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--mode", default="scenario",
                    choices=["sync", "olaf-async", "scenario"],
                    help="only 'scenario' is ported; the LM trainer modes "
                         "come with the LM-substrate slice")
    ap.add_argument("--sim-impl", default=None,
                    choices=["event", "window", "vectorized"],
                    help="hybrid replay backend: per-event or per-window "
                         "('vectorized' is not ported yet)")
    ap.add_argument("--topology", default="multihop",
                    choices=["multihop", "fattree", "multirack"])
    ap.add_argument("--fattree-k", type=int, default=2,
                    help="fat-tree arity for --topology fattree")
    ap.add_argument("--fattree-spines", type=int, default=1,
                    help="core switches for --topology fattree")
    ap.add_argument("--sim-dim", type=int, default=64,
                    help="payload row width")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mode != "scenario":
        ap.error(f"--mode {args.mode} is not ported yet: the LM trainer "
                 f"modes come with the LM-substrate slice's training on "
                 f"lm_loss (ROADMAP queue 1 item 7c); use --mode scenario")
    if args.sim_impl == "vectorized":
        ap.error("--sim-impl vectorized is not ported yet: it comes with the "
                 "vecsim slice (ROADMAP queue 1 item 4); use event or window")
    return run_scenario(args)


if __name__ == "__main__":
    main()
