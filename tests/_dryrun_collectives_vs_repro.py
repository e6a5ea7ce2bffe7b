"""Collective bytes of one reduced dense train step on a (4, 1) FSDP-only
mesh: the port's sharded dry run (DTensor's plan, counted on a fake process
group) beside ``repro``'s ``analyze_collectives`` of the same cell compiled
by XLA over 4 forced host devices. Not a test: the two plans differ, and
the numbers are printed side by side, not held equal. On the CPU:

    PYTHONPATH=src python tests/_dryrun_collectives_vs_repro.py

``repro`` runs in a subprocess (the forced device count must be set before
JAX starts); the port's side imports no JAX.
"""
import json
import os
import subprocess
import sys

B, S = 8, 16
REPRO = f"""
import json
from repro.configs import get_config
from repro.configs.base import ShapeCfg
from repro.launch.dryrun import build_lowering
from repro.launch.hlo_analysis import analyze_collectives
from repro.launch.mesh import make_host_mesh
cfg = get_config("smollm-360m").reduced()
text = build_lowering(cfg, ShapeCfg("t", {S}, {B}, "train"),
                      make_host_mesh(4, 1)).compile().as_text()
print(json.dumps(analyze_collectives(text)))
"""


def port() -> dict:
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCfg
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    rec = dryrun.sharded_fit(get_config("smollm-360m").reduced(),
                             ShapeCfg("t", S, B, "train"),
                             make_host_mesh(4, 1))
    return rec["collectives"]


def repro() -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    out = subprocess.run([sys.executable, "-c", REPRO], env=env, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def main() -> None:
    mine, xla = port(), repro()
    print(f"smollm-360m reduced, train B {B} S {S}, mesh (data 4, model 1); "
          f"result bytes per device")
    print(f"{'kind':<20}{'port (DTensor)':>16}{'repro (XLA)':>14}")
    for kind in mine["per_kind"]:
        print(f"{kind:<20}{mine['per_kind'][kind]:>16}"
              f"{xla['per_kind'].get(kind, 0):>14}")
    print(f"{'total':<20}{mine['total_bytes']:>16}{xla['total_bytes']:>14}")


if __name__ == "__main__":
    main()
