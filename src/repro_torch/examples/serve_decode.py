"""Batched-request serving example: prefill a batch of prompts, then decode
with KV caches through ``repro_torch.launch.serve``.

Runs three families to show the cache variety: dense (smollm KV cache),
SSM (mamba2 constant-size state), and hybrid (recurrentgemma ring-buffer
local attention + RG-LRU state), each reduced.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \\
          [--arch smollm-360m] [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.device import resolve_device
from repro_torch.launch import serve

ARCHS = ("smollm-360m", "mamba2-130m", "recurrentgemma-9b")


def main(argv=None) -> Dict[str, serve.ServeResult]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCHS, action="append",
                    help="serve only this arch (repeatable; default: all "
                         "three)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (default; raises without a card) or 'cpu'")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    for arch in args.arch or ARCHS:
        print(f"=== {arch} (reduced) ===")
        out[arch] = serve.main(["--arch", arch, "--reduced", "--batch", "2",
                                "--prompt-len", "12", "--gen", "12",
                                "--device", str(dev)])
    return out


if __name__ == "__main__":
    main()
