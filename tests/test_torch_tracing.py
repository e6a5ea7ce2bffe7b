"""The port's spans (``repro_torch.tracing``) on the CPU: off by default and
free there, where each one fires inside the PS step and a worker gradient
(remat ``full``: each period again in the backward's recompute), the
step's results bit for bit the same with tracing on, and each span's host
stamps on the clock of its own profiler label. The card's side (device
times, CUDA graph capture) is in ``tests/test_torch_cuda.py``.
"""
import collections
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models.module import tree_leaves  # noqa: E402

PS_PHASES = ("ps.gate", "ps.screen", "ps.olaf_step", "ps.combine",
             "ps.apply", "ps.feedback")
MIXER = {"smollm-360m": "model.attention", "mamba2-130m": "model.ssd"}
TRAIN_ARGV = ["--arch", "smollm-360m", "--reduced", "--mode", "olaf-async",
              "--workers", "4", "--batch", "8", "--seq", "16", "--steps", "8",
              "--burst-size", "2", "--drain-k", "4", "--ingress-screen",
              "--staleness-bound", "0.6", "--log-every", "0",
              "--device", "cpu"]


@pytest.fixture(autouse=True)
def tracing_off():
    """Every test starts and ends with tracing off and no span kept."""
    tracing.disable()
    tracing.take()
    yield
    tracing.disable()
    tracing.take()


def _trainer(seed=0):
    args = train.build_parser().parse_args(TRAIN_ARGV + ["--seed", str(seed)])
    return train.OlafAsyncTrainer(get_config("smollm-360m").reduced(), args)


def _remat_full(arch):
    return dataclasses.replace(get_config(arch).reduced(), remat=True,
                               remat_policy="full")


def _batch(cfg, seed=0, B=2, S=16):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randint(0, cfg.vocab, (B, S), generator=g)
            for k in ("tokens", "labels")}


def _traced(fn, *a, **kw):
    tracing.enable()
    try:
        out = fn(*a, **kw)
    finally:
        tracing.disable()
    return out, tracing.take()


def _under(records):
    """``(name, parent's name)`` of every record, counted."""
    by_id = {r.id: r for r in records}
    return collections.Counter(
        (r.name, by_id[r.parent].name if r.parent else None)
        for r in records)


def test_off_by_default_no_label_event_or_record(monkeypatch):
    entered, events = [], []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: entered.append(a))
    # as if on a card: a span that is on would make events now
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event",
                        lambda *a, **k: events.append(a))
    assert tracing.span("ps.step") is tracing.span("worker.grad")
    tr = _trainer()
    tr.step()
    cfg = _remat_full("mamba2-130m")
    params = train.init_params(cfg, 0, torch.device("cpu"))
    row = torch.empty(sum(x.numel() for x in tree_leaves(params)))
    train.worker_grad(params, _batch(cfg), cfg, row)
    assert entered == [] and events == []
    assert tracing.take() == []


def test_ps_step_spans_tile_the_step():
    tr = _trainer()
    tr.step()  # the first step builds what later steps reuse
    burst = tr.next_burst()
    _, recs = _traced(train.ps_step, tr.state, burst, cfg=tr.ps_cfg)
    under = _under(recs)
    want = {("ps.step", None): 1}
    want.update({(p, "ps.step"): 1 for p in PS_PHASES})
    assert under == want
    if not torch.cuda.is_initialized():  # no CUDA event without CUDA
        assert all(r.device_ms is None for r in recs)
    # the phases follow one another inside the step
    step = next(r for r in recs if r.name == "ps.step")
    phases = [r for r in recs if r.parent == step.id]
    assert [r.name for r in phases] == list(PS_PHASES)
    assert step.start_ns <= phases[0].start_ns
    assert all(a.end_ns <= b.start_ns for a, b in zip(phases, phases[1:]))
    assert phases[-1].end_ns <= step.end_ns


def test_trainer_step_is_the_root_of_its_gradients_and_ps_step():
    tr = _trainer()
    _, recs = _traced(tr.step)
    under = _under(recs)
    assert under[("trainer.step", None)] == 1
    assert under[("worker.grad", "trainer.step")] == tr.burst_size
    assert under[("ps.step", "trainer.step")] == 1


@pytest.mark.parametrize("arch", sorted(MIXER))
def test_worker_grad_periods_fire_again_in_the_recompute(arch):
    cfg = _remat_full(arch)
    n = cfg.n_layers
    params = train.init_params(cfg, 0, torch.device("cpu"))
    row = torch.empty(sum(x.numel() for x in tree_leaves(params)))
    _, recs = _traced(train.worker_grad, params, _batch(cfg), cfg, row)
    assert _under(recs) == {
        ("worker.grad", None): 1, ("worker.forward", "worker.grad"): 1,
        ("worker.backward", "worker.grad"): 1,
        ("model.period", "worker.forward"): n,
        ("model.period", "worker.backward"): n,
        (MIXER[arch], "model.period"): 2 * n}
    periods = {r.id for r in recs if r.name == "model.period"}
    mixers = [r for r in recs if r.name == MIXER[arch]]
    assert len({r.parent for r in mixers}) == 2 * n  # one under each
    assert {r.parent for r in mixers} == periods


def _same(a, b, what):
    if isinstance(a, torch.Generator):
        assert torch.equal(a.get_state(), b.get_state()), what
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and torch.equal(a, b), what
    else:
        assert a == b, what


def test_results_are_bitwise_the_same_with_tracing_on():
    off, on = _trainer(seed=5), _trainer(seed=5)
    for _ in range(4):  # the trimmed branch included: the screen is on
        off.step()
        _traced(on.step)
    for i, (a, b) in enumerate(zip(tree_leaves(off.state),
                                   tree_leaves(on.state))):
        _same(a, b, f"state leaf {i}")
    assert len(off.pending) == len(on.pending) == 4
    for s_off, s_on in zip(off.pending, on.pending):
        for k in train.STAT_KEYS:
            _same(s_off[k], s_on[k], k)
    cfg = _remat_full("smollm-360m")
    params = train.init_params(cfg, 1, torch.device("cpu"))
    D = sum(x.numel() for x in tree_leaves(params))
    rows = torch.empty(2, D)
    loss_off = train.worker_grad(params, _batch(cfg, 3), cfg, rows[0])
    loss_on, _ = _traced(train.worker_grad, params, _batch(cfg, 3), cfg,
                         rows[1])
    assert torch.equal(loss_off, loss_on)
    assert torch.equal(rows[0], rows[1])


def test_host_stamps_sit_on_the_profiler_clock():
    """Each span's ``time_ns`` stamps lie within 1 ms of its own
    ``olaf.*`` label in a CPU trace (``trace_start_ns()`` plus the event's
    ``time_range`` in µs); spans and labels of one name pair in order.
    One torch thread and a first label that is not a span: a trace's
    first label sets the profiler up after its own clock read, and
    threads that outnumber the cores delay a label's entry by tens of ms
    (the machine's scheduler, not the span)."""
    from torch.profiler import ProfilerActivity, profile, record_function
    tr = _trainer()
    tr.step()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("first"):
                pass
            _, recs = _traced(tr.step)
    finally:
        torch.set_num_threads(threads)
    base = prof.profiler.kineto_results.trace_start_ns()
    labels = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith(tracing.PREFIX):
            labels[e.name[len(tracing.PREFIX):]].append(
                (base + round(e.time_range.start * 1e3),
                 base + round(e.time_range.end * 1e3)))
    spans = collections.defaultdict(list)
    for r in recs:
        spans[r.name].append((r.start_ns, r.end_ns))
    assert {k: len(v) for k, v in labels.items()} \
        == {k: len(v) for k, v in spans.items()}
    for name, got in spans.items():
        for (s0, s1), (l0, l1) in zip(sorted(got), sorted(labels[name])):
            assert abs(s0 - l0) < 1_000_000, (name, (l0 - s0) / 1e6)
            assert abs(s1 - l1) < 1_000_000, (name, (s1 - l1) / 1e6)
