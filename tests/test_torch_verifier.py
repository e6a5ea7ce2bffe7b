"""``repro_torch.core.verifier`` (a copy) against ``repro.core.verifier``.

The schedule helpers and the result types are compared here; so is the
error both raise at use when z3 is missing (simulated by setting each
module's ``z3`` to None, so it runs with or without z3). The solver cases of
``tests/test_verifier.py`` compare status and verdict, and skip where
z3-solver is not installed.
"""
import dataclasses

import pytest

from repro.core import verifier as jax_verifier
from repro_torch.core import verifier


@pytest.mark.parametrize("interval,n,start", [(0.1, 6, 0.0), (0.3, 2, 0.0),
                                              (0.002, 5, 1.5), (1.0, 0, 0.0)])
def test_uniform_schedule_matches_repro(interval, n, start):
    assert verifier.uniform_schedule(interval, n, start) == \
        jax_verifier.uniform_schedule(interval, n, start)


@pytest.mark.parametrize("name", ["VerifierConfig", "VerifyResult"])
def test_types_match_repro(name):
    def fields(cls):
        return [(f.name, f.default, f.default_factory)
                for f in dataclasses.fields(cls)]
    assert fields(getattr(verifier, name)) == fields(getattr(jax_verifier,
                                                             name))


@pytest.mark.parametrize("call", ["verify_aom_fairness",
                                  "admissible_thresholds"])
def test_missing_z3_raises_at_use(monkeypatch, call):
    sched = [verifier.uniform_schedule(0.1, 3)] * 2
    args = (sched,) if call == "verify_aom_fairness" else (sched, [1.0])
    for mod in (verifier, jax_verifier):
        monkeypatch.setattr(mod, "z3", None)
        with pytest.raises(ImportError, match="needs z3-solver"):
            getattr(mod, call)(*args)


CASES = {  # tests/test_verifier.py's schedules and configurations
    "symmetric": ([(0.1, 6), (0.1, 6)], dict(epsilon=0.1)),
    "asymmetric": ([(0.1, 6), (0.3, 2)], dict(epsilon=0.25)),
    "tiny_eps": ([(0.1, 5), (0.5, 2)], dict(epsilon=1e-6)),
    "tight": ([(0.1, 4), (0.1, 4)], dict(epsilon=0.001)),
    "jitter": ([(0.1, 4), (0.1, 4)], dict(epsilon=0.001, jitter=0.05)),
    "rate": ([(0.1, 4), (0.1, 4)], dict(epsilon=0.5, send_rate=1.0)),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_solver_verdicts_match_repro(name):
    pytest.importorskip("z3", reason="z3-solver not installed "
                        "(pip install -r requirements-dev.txt)")
    scheds, kw = CASES[name]
    out = []
    for mod in (jax_verifier, verifier):
        sched = [mod.uniform_schedule(i, n) for i, n in scheds]
        cfg = mod.VerifierConfig(p_over_c=0.002, timeout_ms=60_000, **kw)
        res = mod.verify_aom_fairness(sched, cfg)
        out.append((res.status, res.fair, res.counterexample is None))
    assert out[0] == out[1]
