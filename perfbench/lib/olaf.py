"""The program's OLAF-async trainer, built from a workload's ``job`` on
weights the benchmark draws from the seed: the object both the training
and the PS-engine cells time."""
from __future__ import annotations

from perfbench.reference import lm

FLAGS = {"workers": "--workers", "burst_size": "--burst-size",
         "drain_k": "--drain-k", "queue_slots": "--queue-slots",
         "batch": "--batch", "seq": "--seq", "lr": "--lr",
         "txctl_threshold": "--txctl-threshold",
         "txctl_mode": "--txctl-mode"}
SWITCHES = {"ingress_screen": "--ingress-screen"}


def program_config(config: dict):
    """The port's ``ArchConfig`` of a configuration file."""
    from repro_torch.configs import get_config
    cfg = get_config(config["registry"])
    return cfg.reduced() if config.get("registry_reduced") else cfg


def check_layout(config: dict, cfg) -> None:
    """The reference's parameter table against the program's own (shapes
    and dtypes, on the meta device): the two must describe one model."""
    import torch
    from repro_torch.models import api
    from repro_torch.models.module import tree_paths
    theirs = {k: (tuple(v.shape), v.dtype)
              for k, v in tree_paths(api.param_spec(cfg)).items()}
    model_dt = getattr(torch, config["dtype"])
    ours = {p.path: (tuple(p.shape),
                     model_dt if p.dtype == "model" else torch.float32)
            for p in lm.param_table(config)}
    if theirs != ours:
        diff = sorted(set(theirs.items()) ^ set(ours.items()))
        raise RuntimeError(f"the reference's parameters are not the "
                           f"program's: {diff[:6]}")


def trainer_argv(config: dict, job: dict, seed: int, device) -> list:
    argv = ["--arch", config["registry"], "--mode", "olaf-async",
            "--seed", str(seed), "--steps", str(10 ** 9), "--log-every", "0",
            "--device", device.type]
    for key, flag in FLAGS.items():
        argv += [flag, str(job[key])]
    argv += [flag for key, flag in SWITCHES.items() if job[key]]
    return argv


def build(config: dict, job: dict, seed: int, device):
    """The trainer on weights drawn from ``seed`` on ``device``; returns
    ``(trainer, the initial weights by path)``."""
    from repro_torch.launch import train as T
    cfg = program_config(config)
    check_layout(config, cfg)
    args = T.build_parser().parse_args(trainer_argv(config, job, seed,
                                                    device))
    flat = lm.draw_params(config, seed, device)
    tree = lm.nest(dict(flat))
    real = T.init_params
    T.init_params = lambda *_a, **_k: tree
    try:
        tr = T.OlafAsyncTrainer(cfg, args, device=device)
    finally:
        T.init_params = real
    if tr.dim != lm.n_params(config):
        raise RuntimeError(f"the trainer's D = {tr.dim}, the reference's "
                           f"{lm.n_params(config)}")
    return tr, flat
