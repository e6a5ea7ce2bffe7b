"""Train a small LM end-to-end with the full substrate: deterministic data
pipeline, AdamW, checkpointing, and (optionally) the OLAF-async mode where
data-parallel workers stream gradients through the device-resident
OlafQueue (one ``olaf_step`` call per PS step, the CUDA kernel on a card).

The config is a ~7M-param smollm-family model, as ``examples/lm_train.py``
sizes it; ``repro_torch.launch.train``, which this example wraps, trains
the full configs.

Run:  PYTHONPATH=src python -m repro_torch.examples.lm_train \\
          [--steps 60] [--olaf] [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.launch import train as T


def config():
    """The example's reduced smollm-360m, a bit beefier than the smoke
    config so the loss curve is interesting."""
    cfg = get_config("smollm-360m").reduced()
    return dataclasses.replace(cfg, d_model=128, n_layers=4, d_ff=512,
                               vocab=2048)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--olaf", action="store_true",
                    help="OLAF-async data parallelism instead of sync")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"),
                    help="sync mode's checkpoint directory (it resumes "
                         "from one it finds there)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    # examples/lm_train.py's partial Namespace, plus device: the flags it
    # leaves out take repro's defaults in launch.train
    ns = argparse.Namespace(
        arch="smollm-360m", reduced=True, mode="olaf-async" if args.olaf
        else "sync", steps=args.steps, batch=8, seq=128, lr=3e-3,
        workers=4, seed=0, ckpt=None if args.olaf else args.ckpt,
        ckpt_every=20, log_every=10, burst_size=2, drain_k=4,
        device=str(dev))
    if args.olaf:
        return T.run_olaf_async(config(), ns)
    return T.run_sync(config(), ns)


if __name__ == "__main__":
    main()
