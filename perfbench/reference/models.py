"""The reference model a configuration names.

A configuration file may carry ``"reference": "<module>"``: the plain
model of ``perfbench/reference/<module>.py``, which provides

* ``param_table(cfg)``: every parameter as :class:`lm.Param` rows (path,
  shape, dtype, init kind), the program's paths and shapes;
* ``loss(P, tokens, labels, cfg, mm)``: the mean next-token cross entropy
  of one block of rows, in float32, every matrix product through ``mm``;
* ``train_flops_per_token(cfg, seq)``: the model FLOPs of a training step
  per token.

:mod:`perfbench.reference.lm` and :mod:`perfbench.reference.flops` hand
their calls to that module; without the key the model is one of ``lm``'s
own families. So a new architecture enters the benchmark as a file here
and its configuration, with no edit of the harness.

``run.plan`` puts the reference directory of the checkout it planned from
into the configuration's dict as ``reference_dir``; a configuration read
without it finds the module beside this file.
"""
from __future__ import annotations

import functools
import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Optional

HERE = Path(__file__).resolve().parent


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ModuleType:
    p = Path(path)
    if not p.is_file():
        raise ValueError(f"no reference model {p}")
    spec = importlib.util.spec_from_file_location(
        "perfbench_reference_" + p.stem.replace(".", "_").replace("-", "_"),
        p)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def model_of(cfg: dict) -> Optional[ModuleType]:
    """The reference module that ``cfg`` names, loaded once a process per
    file; ``None`` where it names none."""
    name = cfg.get("reference")
    if name is None:
        return None
    return _load(str(Path(cfg.get("reference_dir", HERE)) / f"{name}.py"))
