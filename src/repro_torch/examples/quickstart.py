"""Quickstart: the OLAF core in 60 seconds.

1. Opportunistic aggregation in the OlafQueue (Algorithm 1);
2. the Age-of-Model metric on a FIFO-vs-Olaf microbenchmark;
3. the Z3 verifier accepting an AoM-fairness objective;
4. the ``olaf_combine`` kernel against its plain PyTorch version.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

On a card step 4 launches the CUDA kernel once; with ``--device cpu`` the
entry point takes the plain version, so the check compares it with itself.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core import PyOlafQueue, Update
from repro_torch.core.netsim import NetworkSimulator, microbench_cfg
from repro_torch.core.verifier import (VerifierConfig, uniform_schedule,
                                       verify_aom_fairness)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.olaf_combine import olaf_combine_plain


def demo_queue():
    print("== OlafQueue: opportunistic aggregation ==")
    q = PyOlafQueue(capacity=4)
    q.enqueue(Update(cluster_id=0, worker_id=0, gen_time=0.0, reward=1.0,
                     payload=np.array([1.0, 1.0])))
    q.enqueue(Update(cluster_id=0, worker_id=1, gen_time=0.1, reward=1.1,
                     payload=np.array([3.0, 3.0])))  # same cluster -> merge
    q.enqueue(Update(cluster_id=1, worker_id=9, gen_time=0.2, reward=0.5,
                     payload=np.array([7.0, 7.0])))
    out = q.dequeue()
    print(f"  first departure: cluster {out.cluster_id}, "
          f"payload {out.payload} (mean of 2 updates), "
          f"agg_count={out.agg_count}")
    assert np.allclose(out.payload, [2.0, 2.0])


def demo_aom():
    print("== FIFO vs Olaf under congestion (microbench, 20 Gbps out) ==")
    for queue in ("fifo", "olaf"):
        res = NetworkSimulator(microbench_cfg(queue, 20.0, n_updates=300)).run()
        print(f"  {queue:>4}: loss {res.loss_pct:5.1f}%  "
              f"avg AoM {res.avg_aom()*1e6:7.2f} us  "
              f"delivered {res.received_at_ps}")


def demo_verifier():
    print("== Z3 AoM-fairness verification (paper Sec. 6) ==")
    try:
        import z3  # noqa: F401
    except ImportError:
        print("  (skipped: z3-solver not installed — "
              "pip install -r requirements-dev.txt)")
        return
    res = verify_aom_fairness(
        [uniform_schedule(0.1, 6), uniform_schedule(0.1, 6)],
        VerifierConfig(p_over_c=0.002, epsilon=0.25))
    print(f"  two 100ms clusters, eps=0.25: {res.status} "
          f"in {res.solve_time_s:.2f}s")


def demo_kernel(device) -> Dict[str, object]:
    """``ops.olaf_combine`` of 8 updates into 4 slots of 256 on ``device``
    (one CUDA ``olaf_combine`` launch on a card) against
    ``olaf_combine_plain`` on the same inputs."""
    dev = torch.device(device)
    print(f"== olaf_combine kernel on {dev.type} against its plain version ==")
    slots = torch.zeros((4, 256), device=dev)
    counts = torch.zeros((4,), dtype=torch.int32, device=dev)
    upd = torch.ones((8, 256), device=dev)
    clusters = torch.arange(8, dtype=torch.int32, device=dev) % 4
    gate = torch.ones((8,), dtype=torch.int32, device=dev)
    got, cnt = ops.olaf_combine(slots, counts, upd, clusters, gate)
    want, want_cnt = olaf_combine_plain(slots, counts, upd, clusters, gate)
    result = dict(equal=bool(torch.allclose(got, want)),
                  counts_equal=bool(torch.equal(cnt, want_cnt)),
                  max_abs_err=float((got - want).abs().max()),
                  counts=cnt.cpu().tolist())
    print(f"  kernel == plain: {result['equal']} and "
          f"{result['counts_equal']}; slot counts {result['counts']}")
    return result


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    dev = resolve_device(ap.parse_args(argv).device)
    demo_queue()
    demo_aom()
    demo_verifier()
    result = demo_kernel(dev)
    print("quickstart OK")
    return result


if __name__ == "__main__":
    main()
