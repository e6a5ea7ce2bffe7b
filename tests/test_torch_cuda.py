"""The port's CUDA kernels against their plain PyTorch versions, on a card,
and the paths around them that need a card (the PS step of LM training).

Imports torch, numpy and ``repro_torch`` only, so it runs on a machine
without JAX: ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
Without a card every test skips with its reason (a CUDA kernel has no CPU
mode).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.hybrid import run_hybrid_multihop  # noqa: E402
from repro_torch.core.olaf_queue import TorchQueueState, queue_init  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (decode_attention_cuda,  # noqa: E402
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    flash_attention_backward_cuda, flash_attention_backward_plain,
    flash_attention_cuda, flash_attention_plain)
from repro_torch.kernels.olaf_combine import (olaf_combine_cuda,  # noqa: E402
                                              olaf_combine_plain)
from repro_torch.kernels.olaf_enqueue import (olaf_enqueue_cuda,  # noqa: E402
                                              olaf_enqueue_plain)
from repro_torch.kernels.olaf_robust import (olaf_robust_combine_cuda,  # noqa: E402
                                             olaf_robust_combine_plain)
from repro_torch.kernels.olaf_step import olaf_step_cuda, olaf_step_plain  # noqa: E402
from _trim_cases import trim_cases  # noqa: E402

META_FIELDS = ("cluster", "worker", "seq", "agg_count", "replaceable",
               "gen_time", "reward", "next_seq", "n_dropped", "n_agg",
               "n_repl", "n_screened")
OUT_EXACT = ("valid", "n_valid", "cluster", "worker", "agg_count",
             "gen_time", "reward")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda")


def _burst(rng, S, U, D, n_clusters, t0, dev):
    arrays = (rng.integers(0, n_clusters, (S, U)).astype(np.int32),
              rng.integers(0, 6, (S, U)).astype(np.int32),
              (t0 + rng.random((S, U))).astype(np.float32),
              rng.normal(size=(S, U)).astype(np.float32),
              rng.normal(size=(S, U, D)).astype(np.float32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.cuda
@pytest.mark.parametrize("S,Q,U,k,cap", [(1, 8, 8, 2, 8), (3, 64, 96, 16, 48),
                                         (2, 8, 0, 4, 8), (1, 4, 12, 9, 4),
                                         (2, 96, 130, 8, 70)])
def test_kernel_matches_plain(cuda_device, S, Q, U, k, cap):
    """Exact on metadata and drain fields, payloads within rtol=1e-5,
    atol=1e-6 (the kernel sums the telescoped mean in another order)."""
    rng = np.random.default_rng(S * 1000 + Q + U)
    D = 1031  # ragged against the 256-column blocks
    st = TorchQueueState.stack([queue_init(Q, D, device=cuda_device)] * S)
    for trial in range(4):
        args = _burst(rng, S, U, D, 2 * Q, float(trial), cuda_device)
        send = torch.from_numpy(rng.random((S, U)) < 0.9).to(cuda_device)
        screen = torch.from_numpy(rng.random((S, U)) < 0.1).to(cuda_device)
        want = olaf_step_plain(st, *args, k, 0.5, send, cap, screen)
        got = olaf_step_cuda(st.clone(), *args, k, 0.5, send, cap, screen)
        torch.cuda.synchronize()
        for f in META_FIELDS:
            assert torch.equal(getattr(want[0], f), getattr(got[0], f)), f
        for f in OUT_EXACT:
            assert torch.equal(want[1][f], got[1][f]), f
        torch.testing.assert_close(got[0].payload, want[0].payload,
                                   rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(got[1]["payload"], want[1]["payload"],
                                   rtol=1e-5, atol=1e-6)
        st = want[0]


@pytest.mark.cuda
def test_ops_launches_the_kernel_in_place(cuda_device):
    """``ops.olaf_step`` on a CUDA state is one kernel launch, for an empty
    burst too, and it updates the passed-in state's tensors."""
    rng = np.random.default_rng(1)
    st = queue_init(4, 64, device=cuda_device)
    payload_ptr = st.payload.data_ptr()
    before = olaf_step_cuda.launches
    args = tuple(a[0] for a in _burst(rng, 1, 5, 64, 6, 0.0, cuda_device))
    st2, out = ops.olaf_step(st, *args, k=2)
    empty = tuple(a[0] for a in _burst(rng, 1, 0, 64, 6, 1.0, cuda_device))
    st3, out = ops.olaf_step(st2, *empty, k=2)
    torch.cuda.synchronize()
    assert olaf_step_cuda.launches == before + 2
    assert st3.payload.data_ptr() == payload_ptr
    assert out["valid"].shape == (2,) and out["payload"].shape == (2, 64)


@pytest.mark.cuda
@pytest.mark.parametrize("S,Q,U,D", [(3, 4, 16, 941), (21, 8, 64, 4099)])
def test_combine_kernel_matches_plain(cuda_device, S, Q, U, D):
    """Counts exact, slots within rtol=1e-5, atol=1e-6; out-of-range
    cluster ids and zero gates are skipped; the kernel is deterministic."""
    rng = np.random.default_rng(S + Q + U)
    arrays = (rng.normal(size=(S, Q, D)).astype(np.float32),
              rng.integers(0, 6, (S, Q)).astype(np.int32),
              rng.normal(size=(S, U, D)).astype(np.float32),
              rng.integers(-1, Q + 1, (S, U)).astype(np.int32),
              rng.integers(0, 5, (S, U)).astype(np.int32))
    args = tuple(torch.from_numpy(a).to(cuda_device) for a in arrays)
    before = olaf_combine_cuda.launches
    got = olaf_combine_cuda(*args)
    again = ops.olaf_combine(*args)
    want = olaf_combine_plain(*args)
    torch.cuda.synchronize()
    assert olaf_combine_cuda.launches == before + 2
    assert torch.equal(got[1], want[1])
    torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=1e-6)
    assert torch.equal(got[0], again[0]) and torch.equal(got[1], again[1])


def _robust_counts(dev, selected):
    """(n_screen, n_send) on the card: 2 of 7 sent rows screened selects
    the trimmed combine at the threshold 0.25, 1 of 7 the mean."""
    return (torch.tensor(2 if selected else 1, dtype=torch.int32, device=dev),
            torch.tensor(7, dtype=torch.int32, device=dev))


def _check_robust(rows, w, selected):
    """The kernel against the plain composition on the same card: NaN and
    ±inf at the same places, the rest within atol 1e-6 and rtol 1e-6 on
    either branch (the kernel sums the rows in order, cuBLAS in its own:
    the atol for a column whose sum nearly cancels, the rtol for one whose
    clipped outlier is large). One launch."""
    counts = _robust_counts(rows.device, selected)
    before = olaf_robust_combine_cuda.launches
    got = ops.olaf_robust_combine(rows, w, *counts, threshold=0.25)
    want = olaf_robust_combine_plain(rows, w, *counts, threshold=0.25)
    torch.cuda.synchronize()
    assert olaf_robust_combine_cuda.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    for pick in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(pick(got), pick(want)), pick.__name__
    fin = torch.isfinite(want)
    torch.testing.assert_close(got[fin], want[fin], atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("selected", [False, True])
@pytest.mark.parametrize("case", list(trim_cases()))
def test_robust_combine_kernel_matches_plain(cuda_device, case, selected):
    rows, w = trim_cases()[case]
    _check_robust(torch.from_numpy(rows).to(cuda_device),
                  torch.from_numpy(w).to(cuda_device), selected)


@pytest.mark.cuda
@pytest.mark.parametrize("selected", [False, True])
@pytest.mark.parametrize("layout", ["contiguous", "column_view",
                                    "aligned_view"])
@pytest.mark.parametrize("K", [1, 2, 4, 7, 12, 32])
def test_robust_combine_kernel_at_width(cuda_device, K, layout, selected):
    """D = 2**20 + 3 with ties, outliers and non-finite entries, at a K of
    each of the kernel's sort networks (2, 4, 8, 16 and 32 rows):
    contiguous rows (an odd row stride: scalar loads), a column view one
    float past a 16-byte boundary with a row stride of a multiple of 4
    (16-byte loads between a masked head and tail, scalar stores), and a
    view at the boundary (16-byte loads and stores, a tail of 3)."""
    rng = np.random.default_rng(31 + K)
    D = 2**20 + 3
    pad = dict(contiguous=0, column_view=5, aligned_view=1)[layout]
    block = rng.normal(size=(K, D + pad)).astype(np.float32)
    block[:, ::7] = np.round(block[:, ::7])  # ties
    block[1 % K, ::97] *= 1e3  # outliers
    for value, row, every in ((np.nan, 0, 1009), (np.inf, 2, 2003),
                              (-np.inf, 3, 3001), (np.inf, 1, 4001)):
        block[row % K, rng.integers(0, D + pad, (D + pad) // every)] = value
    base = torch.from_numpy(block).to(cuda_device)
    rows = base[:, 1:1 + D] if layout == "column_view" else base[:, :D]
    assert rows.stride(0) % 4 == (3 if layout == "contiguous" else 0)
    assert (rows.data_ptr() % 16 == 0) == (layout != "column_view")
    # agg counts 1, 2, 3, 0 (a row left out), 1, ...
    w = torch.from_numpy(((np.arange(K) + 1) % 4).astype(np.float32)
                         ).to(cuda_device)
    _check_robust(rows, w, selected)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [32, 33])
def test_robust_combine_refuses_more_than_32_rows_on_the_card(cuda_device,
                                                              K):
    """Up to 32 rows (the widest sort network) the route launches the
    kernel; at 33 it raises with no launch, and so does building a trainer
    whose screen would drain 33 rows a step: the card has no plain
    route."""
    rng = np.random.default_rng(K)
    rows = torch.from_numpy(rng.normal(size=(K, 4099)).astype(np.float32)
                            ).to(cuda_device)
    w = torch.from_numpy(rng.integers(0, 3, K).astype(np.float32)
                         ).to(cuda_device)
    for selected in (False, True):
        counts = _robust_counts(cuda_device, selected)
        before = olaf_robust_combine_cuda.launches
        if K > 32:
            with pytest.raises(ValueError, match="over the kernel's 32"):
                ops.olaf_robust_combine(rows, w, *counts, threshold=0.25)
            assert olaf_robust_combine_cuda.launches == before
            continue
        got = ops.olaf_robust_combine(rows, w, *counts, threshold=0.25)
        want = olaf_robust_combine_plain(rows, w, *counts, threshold=0.25)
        torch.cuda.synchronize()
        assert olaf_robust_combine_cuda.launches == before + 1
        torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
    if K > 32:
        from repro_torch.launch import train
        args = train.build_parser().parse_args(
            TRAIN_ARGV + ["--device", "cuda", "--workers", "64",
                          "--batch", "64", "--drain-k", str(K)])
        with pytest.raises(ValueError, match="at most 32 drained rows"):
            train.OlafAsyncTrainer(get_config("smollm-360m").reduced(), args)


@pytest.mark.cuda
def test_enqueue_kernel_matches_plain(cuda_device):
    rng = np.random.default_rng(5)
    Q, U, D = 16, 24, 1031
    st = queue_init(Q, D, device=cuda_device)
    before = olaf_enqueue_cuda.launches
    for trial in range(4):
        args = tuple(a[0] for a in _burst(rng, 1, U, D, 2 * Q, float(trial),
                                          cuda_device))
        screen = torch.from_numpy(rng.random(U) < 0.2).to(cuda_device)
        want = olaf_enqueue_plain(st, *args, 0.5, 12, screen)
        got = olaf_enqueue_cuda(st.clone(), *args, 0.5, 12, screen)
        torch.cuda.synchronize()
        for f in META_FIELDS:
            assert torch.equal(getattr(want, f), getattr(got, f)), f
        torch.testing.assert_close(got.payload, want.payload, rtol=1e-5,
                                   atol=1e-6)
        st = want
    assert olaf_enqueue_cuda.launches == before + 4
    assert int(st.n_screened) > 0 and int(st.n_agg) > 0


@pytest.mark.cuda
def test_hybrid_backends_bitwise_on_the_card(cuda_device):
    """The event and window replays land the same blocks in the same
    launches, and the kernel sums without atomics: the same bits."""
    kw = dict(seed=3, n_clusters_per_group=2, workers_per_cluster=2,
              horizon=0.25, interval_s1=0.02, interval_s2=0.025,
              x1_gbps=0.5e-3, x2_gbps=0.5e-3, sw3_gbps=0.8e-3,
              size_bits=8192, sw12_slots=4, sw3_slots=4)
    before = olaf_combine_cuda.launches
    event, _ = run_hybrid_multihop(941, sim_impl="event", device=cuda_device,
                                   **kw)
    window, _ = run_hybrid_multihop(941, sim_impl="window",
                                    device=cuda_device, **kw)
    assert olaf_combine_cuda.launches - before == event.launches + window.launches
    assert len(event.delivered) == len(window.delivered) > 0
    for (t0, u0, p0), (t1, u1, p1) in zip(event.delivered, window.delivered):
        assert t0 == t1 and u0.agg_count == u1.agg_count
        assert p0.device.type == "cuda" and torch.equal(p0, p1)
    np.testing.assert_array_equal(event.final_counts, window.final_counts)


def _device_ops_per_call(call, setup, calls=4, markers=4):
    """(kernels named ``olaf``, memory copies, other device operations) per
    call of ``call(setup())``, as ``torch.profiler`` traces ``calls``
    calls after one outside the trace. Spin kernels fence the calls, and a
    trace that lost one of them is taken again."""
    for _ in range(4):
        inputs = [setup() for _ in range(calls + 1)]
        call(inputs[0])
        torch.cuda.synchronize()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(markers):
                torch.cuda._sleep(1000)
            for x in inputs[1:]:
                call(x)
            for _ in range(markers):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if sum("spin_kernel" in n for n in names) == 2 * markers:
            break
    else:
        pytest.fail("the profiler lost a marker kernel in every trace")
    mine = sum("olaf" in n for n in names)
    copies = sum("Memcpy" in n for n in names)
    other = len(names) - mine - copies - 2 * markers
    return mine / calls, copies / calls, other / calls


def _forward_operands(rng, dev, S=21, Q=8, U=16, D=941, host=False):
    """A forwarding boundary: device slots, counts and updates; the window's
    small arrays on the device, or as numpy (the hybrid's host buffers)."""
    small = dict(clusters=rng.integers(-1, Q + 1, (S, U)).astype(np.int32),
                 gate=rng.integers(0, 4, (S, U)).astype(np.int32),
                 reset_slots=rng.random((S, Q)) < 0.3,
                 drain_sw=np.array([3, 0], np.int32),
                 drain_slot=np.array([5, 1], np.int32),
                 drain_hop=np.array([-1, -2], np.int32))
    if not host:
        small = {n: torch.from_numpy(a).to(dev) for n, a in small.items()}
    big = (torch.from_numpy(rng.normal(size=(S, Q, D)).astype(np.float32)),
           torch.from_numpy(rng.integers(0, 6, (S, Q)).astype(np.int32)),
           torch.from_numpy(rng.normal(size=(S, U, D)).astype(np.float32)))
    return tuple(t.to(dev) for t in big), small


@pytest.mark.cuda
@pytest.mark.parametrize("wrapper", ["olaf_step", "olaf_enqueue",
                                     "olaf_combine", "olaf_forward",
                                     "olaf_forward_host",
                                     "olaf_robust_combine"])
def test_olaf_wrappers_are_one_kernel_per_call(cuda_device, wrapper):
    """One kernel and no other device operation per call: the trainer's
    drain (``send``, ``screen`` and ``capacity`` left out), the enqueue,
    the combine, a whole forwarding boundary and the PS step's robust
    combine (either branch). From numpy index arrays the boundary adds
    exactly one copy (one pinned staging buffer)."""
    rng = np.random.default_rng(17)
    if wrapper in ("olaf_step", "olaf_enqueue"):
        Q, U, D = 8, 8, 941
        st = queue_init(Q, D, device=cuda_device)
        burst = tuple(a[0] for a in _burst(rng, 1, U, D, 2 * Q, 0.0,
                                           cuda_device))
        if wrapper == "olaf_step":
            def call(x):
                olaf_step_cuda(x, *burst, 2)
        else:
            def call(x):
                olaf_enqueue_cuda(x, *burst)
        mine, copies, other = _device_ops_per_call(call, st.clone)
    elif wrapper == "olaf_robust_combine":
        rows = torch.from_numpy(rng.normal(size=(4, 2**16 + 3)).astype(
            np.float32)).to(cuda_device)
        w = torch.tensor([1.0, 0.0, 2.0, 1.0], device=cuda_device)
        for selected in (False, True):
            counts = _robust_counts(cuda_device, selected)
            assert _device_ops_per_call(
                lambda _: ops.olaf_robust_combine(rows, w, *counts,
                                                  threshold=0.25),
                lambda: None) == (1, 0, 0), selected
        return
    elif wrapper == "olaf_combine":
        (sl, cn, up), small = _forward_operands(rng, cuda_device)
        mine, copies, other = _device_ops_per_call(
            lambda _: olaf_combine_cuda(sl, cn, up, small["clusters"],
                                        small["gate"]), lambda: None)
    else:
        host = wrapper == "olaf_forward_host"
        (sl, cn, up), small = _forward_operands(rng, cuda_device, host=host)
        mine, copies, other = _device_ops_per_call(
            lambda _: ops.olaf_forward(sl, cn, up, **small), lambda: None)
        assert copies == (1 if host else 0)
        copies = 0
    assert (mine, copies, other) == (1, 0, 0)


@pytest.mark.cuda
def test_olaf_step_calls_are_bitwise_equal(cuda_device):
    """Many blocks per queue (a ticket per queue, reset by the last block):
    the same cycle run again and again gives the same bits, and equals the
    plain version."""
    rng = np.random.default_rng(21)
    S, Q, U, D, k = 3, 16, 40, 2**16 + 3, 5
    st = TorchQueueState.stack([queue_init(Q, D, device=cuda_device)] * S)
    for trial in range(2):  # a second burst lands on a filled queue
        args = _burst(rng, S, U, D, 2 * Q, float(trial), cuda_device)
        want = olaf_step_plain(st, *args, k, 0.5)
        runs = [olaf_step_cuda(st.clone(), *args, k, 0.5) for _ in range(3)]
        torch.cuda.synchronize()
        for got in runs:
            for f in META_FIELDS:
                assert torch.equal(getattr(want[0], f), getattr(got[0], f)), f
            for f in OUT_EXACT:
                assert torch.equal(want[1][f], got[1][f]), f
            torch.testing.assert_close(got[0].payload, want[0].payload,
                                       rtol=1e-5, atol=1e-6)
            assert torch.equal(got[0].payload, runs[0][0].payload)
            assert torch.equal(got[1]["payload"], runs[0][1]["payload"])
        st = want[0]


@pytest.mark.cuda
def test_reset_slot_does_not_read_its_old_row_h16(cuda_device):
    """H16: a slot that a reset in the burst restarts is not read. A NaN
    in its old row reaches the plain version (old·0 + row) and not the
    kernels, which give the contributing rows' mean; every other field and
    row is the same, and the drained row carries the kernel's value."""
    D = 1031
    gen = torch.Generator(cuda_device).manual_seed(16)

    def update(cluster, worker, t):
        def col(x, dt):
            return torch.tensor([x], dtype=dt, device=cuda_device)
        return (col(cluster, torch.int32), col(worker, torch.int32),
                col(t, torch.float32), col(0.5, torch.float32),
                torch.randn((1, D), generator=gen, device=cuda_device))

    st = olaf_enqueue_plain(queue_init(4, D, device=cuda_device),
                            *update(3, 1, 0.0))
    st = olaf_enqueue_plain(st, *update(5, 2, 0.5))
    slot = int(torch.nonzero(st.cluster == 3)[0])
    st.payload[slot] = float("nan")
    burst = update(3, 1, 1.0)  # the same worker again: a replace, a reset
    want = olaf_enqueue_plain(st, *burst)
    got = olaf_enqueue_cuda(st.clone(), *burst)
    step_want = olaf_step_plain(st, *burst, 1)
    step_got = olaf_step_cuda(st.clone(), *burst, 1)
    torch.cuda.synchronize()
    assert int(want.n_repl) == 1 and bool(torch.isnan(want.payload[slot]).all())
    for w, g in ((want, got), (step_want[0], step_got[0])):
        for f in META_FIELDS:
            assert torch.equal(getattr(w, f), getattr(g, f)), f
        others = torch.arange(4, device=cuda_device) != slot
        assert torch.equal(w.payload[others], g.payload[others])
    assert torch.equal(got.payload[slot], burst[4][0])
    assert bool(step_got[1]["valid"][0]) and bool(torch.isnan(
        step_want[1]["payload"][0]).all())
    assert torch.equal(step_got[1]["payload"][0], burst[4][0])


@pytest.mark.cuda
def test_olaf_step_on_two_streams_at_once(cuda_device):
    """Cycles in flight on two streams of one card at once: each stream
    has its own tickets, so every queue's metadata is written back once,
    by its own call, and every result equals the same call run alone."""
    rng = np.random.default_rng(22)
    S, Q, U, D, k = 2, 8, 24, 2**15 + 1, 3
    base = TorchQueueState.stack([queue_init(Q, D, device=cuda_device)] * S)
    bursts = [_burst(rng, S, U, D, 2 * Q, 0.0, cuda_device) for _ in range(2)]
    alone = [olaf_step_cuda(base.clone(), *b, k) for b in bursts]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in bursts]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    outs = [[], []]
    for _ in range(10):
        for i, (s, b) in enumerate(zip(streams, bursts)):
            with torch.cuda.stream(s):
                st = base.clone()
                outs[i].append(olaf_step_cuda(st, *b, k))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        for st, out in got:
            for f in META_FIELDS + ("payload",):
                assert torch.equal(getattr(want[0], f), getattr(st, f)), f
            for f in OUT_EXACT + ("payload",):
                assert torch.equal(want[1][f], out[f]), f


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["drained_slot_reset", "drain_only",
                                  "hop_minus_two", "all_gates_zero",
                                  "wide"])
def test_forward_kernel_matches_plain(cuda_device, case):
    """The fused boundary against its plain version: counts, clears and
    hops exact, rows within rtol=1e-5, atol=1e-6; deterministic."""
    rng = np.random.default_rng(30 + len(case))
    S, Q, U, D = (21, 8, 64, 2**17 + 3) if case == "wide" else (3, 4, 8, 941)
    U = 0 if case == "drain_only" else U
    (sl, cn, up), small = _forward_operands(rng, cuda_device, S, Q, U, D)
    small["drain_sw"] = torch.tensor([1, 0, 2, 1], dtype=torch.int32,
                                     device=cuda_device)
    small["drain_slot"] = torch.tensor([2, 0, 3, 2], dtype=torch.int32,
                                       device=cuda_device)
    small["drain_hop"] = torch.tensor(
        [0, -1, -2 if case == "hop_minus_two" else 1, 3], dtype=torch.int32,
        device=cuda_device)
    small["reset_slots"][1, 2] = case == "drained_slot_reset"
    if case == "all_gates_zero":
        small["gate"].zero_()
    kw = dict(reset=small["reset_slots"], drain_sw=small["drain_sw"],
              drain_slot=small["drain_slot"], drain_hop=small["drain_hop"])
    before = (olaf_combine_cuda.launches, olaf_combine_cuda.drain_launches)
    got = olaf_combine_cuda(sl, cn, up, small["clusters"], small["gate"], **kw)
    again = ops.olaf_forward(sl, cn, up, **small)
    want = olaf_combine_plain(sl, cn, up, small["clusters"], small["gate"], **kw)
    torch.cuda.synchronize()
    landed = 0 if case == "drain_only" else 2
    assert (olaf_combine_cuda.launches - before[0],
            olaf_combine_cuda.drain_launches - before[1]) == (landed, 2 - landed)
    assert torch.equal(got[1], want[1])
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    for g, a in zip(got, again[:3]):
        assert torch.equal(g, a)
    assert torch.equal(again[3], small["drain_hop"])


ATTN_TOL = {torch.float32: 1e-5, torch.bfloat16: 1e-2}  # bf16: ~2 ulps


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(cuda_device, dtype):
    """Ragged lengths, every head dim, causal, window and q offset; a row
    whose keys all lie before the window gives 0."""
    gen = torch.Generator(cuda_device).manual_seed(11)
    cases = [(6, 130, 130, 64, True, 0, 0), (4, 77, 200, 128, True, 0, 123),
             (3, 100, 100, 256, True, 17, 0), (2, 70, 70, 64, False, 0, 0),
             (2, 8, 40, 64, True, 4, 60)]
    before = flash_attention_cuda.launches
    for BH, Sq, Sk, Dh, causal, window, q_offset in cases:
        q, k, v = (torch.randn((BH, S, Dh), generator=gen, device=cuda_device)
                   .to(dtype) for S in (Sq, Sk, Sk))
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = flash_attention_cuda(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, flash_attention_plain(q, k, v, **kw),
                                   rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    assert torch.equal(got, torch.zeros_like(got))  # the last case: all masked
    # the model layout (B, S, H, Dh) through ops, one batch row
    x = torch.randn((1, 33, 3, 64), generator=gen, device=cuda_device).to(dtype)
    got = ops.flash_attention(x, x, x, causal=True)
    want = flash_attention_plain(*(x.transpose(1, 2).reshape(3, 33, 64),) * 3)
    torch.testing.assert_close(got, want.reshape(1, 3, 33, 64).transpose(1, 2),
                               rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    assert flash_attention_cuda.launches == before + len(cases) + 1
    with pytest.raises(ValueError, match="head dim"):
        flash_attention_cuda(q[..., :32], k[..., :32], v[..., :32])
    with pytest.raises(TypeError, match="not supported"):
        flash_attention_cuda(q.half(), k.half(), v.half())


# (B, Sq, Sk, H, Dh, causal, window, q_offset); H None: the folded layout
FLASH_BACKWARD_CASES = [(2, 256, 256, 3, 64, True, 0, 0),
                        (1, 200, 77, 2, 64, False, 0, 0),
                        (2, 300, 300, 2, 128, True, 0, 0),
                        (2, 333, 333, 2, 64, True, 100, 0),
                        (1, 100, 300, 2, 128, True, 0, 200),
                        (2, 64, 64, 2, 64, True, 16, 60),
                        (3, 190, 190, None, 128, False, 50, 0),
                        (2, 700, 700, 2, 64, True, 40, 0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_BACKWARD_CASES)
def test_flash_backward_kernel_matches_plain(cuda_device, case):
    """The backward kernels against the plain backward from the kernel's own
    output and log-sum-exp, bf16, a strided dout: every gradient within
    1e-2 of its largest element (the two round P and dS to bf16 at sums
    taken in other orders, so an element may round one ulp apart); the
    same bits on a second call (no atomics); one count per call."""
    B, Sq, Sk, H, Dh, causal, window, q_offset = case
    gen = torch.Generator(cuda_device).manual_seed(sum(x or 0 for x in case[:5]))
    shape = (lambda S: (B, S, Dh)) if H is None else (lambda S: (B, S, H, Dh))
    q, k, v = (torch.randn(shape(S), generator=gen, device=cuda_device)
               .to(torch.bfloat16) for S in (Sq, Sk, Sk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    out, lse = flash_attention_cuda(q, k, v, return_lse=True, **kw)
    assert torch.equal(out, flash_attention_cuda(q, k, v, **kw))
    want_out, want_lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    live = torch.isfinite(want_lse)
    assert torch.equal(torch.isfinite(lse), live)
    torch.testing.assert_close(lse[live], want_lse[live], rtol=0, atol=1e-5)
    g = torch.randn(out.shape, generator=gen, device=cuda_device).to(torch.bfloat16)
    if H is not None:
        g = g.transpose(1, 2).contiguous().transpose(1, 2)
    before = flash_attention_backward_cuda.launches
    got = flash_attention_backward_cuda(q, k, v, out, lse, g, **kw)
    again = flash_attention_backward_cuda(q, k, v, out, lse, g, **kw)
    torch.cuda.synchronize()
    assert flash_attention_backward_cuda.launches == before + 2
    want = flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
    for n, a, b, c in zip("qkv", got, want, again):
        assert a.shape == b.shape and a.dtype == torch.bfloat16, n
        assert torch.equal(a, c), f"d{n} differs between two calls"
        scale = float(b.float().abs().max())
        torch.testing.assert_close(a.float() / scale, b.float() / scale,
                                   rtol=0, atol=1e-2, msg=f"d{n} {case}")
    with pytest.raises(ValueError, match="head dim"):
        x = q[..., :32].contiguous()
        flash_attention_backward_cuda(x, x, x, x, lse, x)


@pytest.mark.cuda
def test_training_attention_takes_the_kernel_pair(cuda_device):
    """A bf16 model with Dh 64 under ``auto`` on the card runs the flash
    pair: each gradient launches the forward kernel once per layer (twice
    under remat ``full``: forward and recompute) and the backward once per
    layer; its loss and gradient stay near the ``full`` route's on the
    same card (bf16 rounding: the kernels keep S in float32)."""
    from repro_torch.launch import train as launch_train
    base = dataclasses.replace(get_config("smollm-360m").reduced(),
                               dtype="bfloat16", d_model=256, n_heads=4,
                               n_kv_heads=2, n_layers=3)
    assert base.hd == 64
    gen = torch.Generator().manual_seed(0)
    toks = torch.randint(0, base.vocab, (2, 257), generator=gen)
    batch = {"tokens": toks[:, :-1].to(cuda_device),
             "labels": toks[:, 1:].to(cuda_device)}
    params = launch_train.init_params(base, 1, cuda_device)
    got = {}
    for name, cfg in (("auto", base), ("auto+remat", dataclasses.replace(
            base, remat=True, remat_policy="full")),
            ("full", dataclasses.replace(base, attn_impl="full"))):
        f0 = flash_attention_cuda.launches
        b0 = flash_attention_backward_cuda.launches
        loss, grads = launch_train.loss_and_grads(params, batch, cfg)
        torch.cuda.synchronize()
        got[name] = (float(loss), torch.cat([x.float().ravel() for x in grads]))
        got[name + " launches"] = (flash_attention_cuda.launches - f0,
                                   flash_attention_backward_cuda.launches - b0)
    assert got["auto launches"] == (3, 3)
    assert got["auto+remat launches"] == (6, 3)
    assert got["full launches"] == (0, 0)
    assert got["auto"][0] == got["auto+remat"][0]
    assert torch.equal(got["auto"][1], got["auto+remat"][1])
    np.testing.assert_allclose(got["auto"][0], got["full"][0], rtol=1e-2)
    g, r = got["auto"][1], got["full"][1]
    assert float((g - r).norm() / r.norm()) < 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_reads_the_model_layout_in_place(cuda_device,
                                                                dtype):
    """q, k, v as strided (B, S, H, Dh) views into fused projections, at
    every head dim, ragged lengths, a window and a q offset: bf16 through
    the tensor-core kernel, float32 through the CUDA-core one, each equal
    to the plain version and to the folded (BH, S, Dh) call."""
    gen = torch.Generator(cuda_device).manual_seed(13)
    cases = [(2, 130, 130, 3, 64, True, 0, 0), (1, 77, 200, 2, 128, True, 0, 123),
             (2, 100, 100, 2, 256, True, 17, 0), (3, 70, 70, 4, 64, False, 0, 0),
             (1, 129, 300, 5, 128, True, 64, 171)]
    before = flash_attention_cuda.launches
    for B, Sq, Sk, H, Dh, causal, window, q_offset in cases:
        xq, xkv = (torch.randn((B, S, 3, H, Dh), generator=gen, device=cuda_device)
                   .to(dtype) for S in (Sq, Sk))
        q, k, v = xq[:, :, 0], xkv[:, :, 1], xkv[:, :, 2]
        kw = dict(causal=causal, window=window, q_offset=q_offset)
        got = ops.flash_attention(q, k, v, **kw)
        torch.cuda.synchronize()
        assert got.shape == (B, Sq, H, Dh) and got.is_contiguous()
        torch.testing.assert_close(got, flash_attention_plain(q, k, v, **kw),
                                   rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])

        def fold(x):
            return x.transpose(1, 2).reshape(B * H, x.shape[1], Dh)

        folded = flash_attention_cuda(fold(q), fold(k), fold(v), **kw)
        torch.testing.assert_close(
            folded.reshape(B, H, Sq, Dh).transpose(1, 2), got,
            rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    assert flash_attention_cuda.launches == before + 2 * len(cases)
    odd = torch.zeros((1, 8, 2, 72), dtype=dtype, device=cuda_device)[..., 2:66]
    with pytest.raises(ValueError, match="16-byte aligned start"):
        flash_attention_cuda(odd, odd, odd)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_matches_plain(cuda_device, dtype):
    """Per-row positions over ragged caches, read in place from a stacked
    (L, B, S, KV, Dh) cache; positions past pos hold junk that must not
    weigh in."""
    gen = torch.Generator(cuda_device).manual_seed(12)
    before = decode_attention_cuda.launches
    cases = [(8, 5, 3, 552, 64), (4, 1, 8, 1000, 256), (3, 2, 16, 77, 128)]
    for B, KV, rep, S, Dh in cases:
        q = torch.randn((B, KV, rep, Dh), generator=gen, device=cuda_device).to(dtype)
        stacked = torch.randn((2, 2, B, S, KV, Dh), generator=gen,
                              device=cuda_device).to(dtype)
        kc, vc = stacked[0, 1], stacked[1, 1]
        pos = torch.randint(0, S, (B,), generator=gen, device=cuda_device,
                            dtype=torch.int32)
        pos[0] = S - 1
        got = ops.decode_attention(q, kc, vc, pos)
        torch.cuda.synchronize()
        want = decode_attention_plain(q, kc, vc, pos)
        torch.testing.assert_close(got, want, rtol=ATTN_TOL[dtype],
                                   atol=ATTN_TOL[dtype])
        # the tickets are back at 0 after every call and the merge sums in
        # chunk order: repeated calls give the same bits
        again = [decode_attention_cuda(q, kc, vc, pos) for _ in range(2)]
        assert all(torch.equal(got, x) for x in again)
        kc[1, int(pos[1]) + 1:] = 1e4
        torch.testing.assert_close(decode_attention_cuda(q, kc, vc, pos), got)
    # one launch per call: ops, two repeats and the junk call per case
    assert decode_attention_cuda.launches == before + 4 * len(cases)
    with pytest.raises(ValueError, match="strides"):
        decode_attention_cuda(q, kc.transpose(0, 1).contiguous().transpose(0, 1),
                              vc, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_kernel_on_two_streams_at_once(cuda_device, dtype):
    """Calls in flight on two streams of one card at once: each stream has
    its own ticket counters, so every group's merge runs once, in its own
    call, and every output equals that of the same call run alone."""
    gen = torch.Generator(cuda_device).manual_seed(13)
    B, KV, rep, S, Dh = 8, 5, 3, 4096, 64
    inputs = []
    for _ in range(2):
        q = torch.randn((B, KV, rep, Dh), generator=gen, device=cuda_device).to(dtype)
        kc, vc = (torch.randn((B, S, KV, Dh), generator=gen,
                              device=cuda_device).to(dtype) for _ in range(2))
        pos = torch.randint(0, S, (B,), generator=gen, device=cuda_device,
                            dtype=torch.int32)
        inputs.append((q, kc, vc, pos))
    alone = [decode_attention_cuda(*x) for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda_device) for _ in inputs]
    for s in streams:
        s.wait_stream(torch.cuda.current_stream(cuda_device))
    outs = [[], []]
    for _ in range(20):
        for i, (s, x) in enumerate(zip(streams, inputs)):
            with torch.cuda.stream(s):
                outs[i].append(decode_attention_cuda(*x))
    torch.cuda.synchronize()
    for want, got in zip(alone, outs):
        assert all(torch.equal(want, g) for g in got)


# --------------------------------------------------------------------------
# LM training with the OLAF-async PS step (launch/train.py)
# --------------------------------------------------------------------------
TRAIN_ARGV = ["--arch", "smollm-360m", "--reduced", "--mode", "olaf-async",
              "--workers", "4", "--batch", "8", "--seq", "16", "--steps", "8",
              "--burst-size", "2", "--drain-k", "4", "--ingress-screen",
              "--staleness-bound", "0.6", "--crash-workers", "1",
              "--crash-at", "2", "--restart-at", "5", "--log-every", "0"]


@pytest.mark.cuda
def test_reduced_olaf_async_on_the_card_equals_the_cpu(cuda_device):
    """The same run (one seed: the weights are drawn on the CPU for every
    device) on the card and on the CPU: every counter exact, the losses
    and AoM within rtol 1e-4 (cuBLAS and the CPU sum in other orders; six
    AdamW steps amplify it), one ``olaf_step`` launch per PS step."""
    from repro_torch.launch import train
    olaf_step_cuda.launches = 0
    card = train.main(TRAIN_ARGV + ["--device", "cuda"])
    torch.cuda.synchronize()
    assert olaf_step_cuda.launches == 8
    host = train.main(TRAIN_ARGV + ["--device", "cpu"])
    assert card.state.queue.payload.device.type == "cuda"
    for f in ("deferred_total", "stale_total", "screened_total"):
        assert getattr(card, f) == getattr(host, f), f
    assert [c for _, _, c in card.log_rows] == [c for _, _, c in host.log_rows]
    for f in ("cluster", "worker", "seq", "agg_count", "next_seq", "n_agg",
              "n_repl", "n_dropped", "n_screened"):
        assert torch.equal(getattr(card.state.queue, f).cpu(),
                           getattr(host.state.queue, f)), f
    np.testing.assert_allclose([l for _, l, _ in card.log_rows],
                               [l for _, l, _ in host.log_rows], rtol=1e-4)
    np.testing.assert_allclose(card.avg_aom(), host.avg_aom(), rtol=1e-4)


@pytest.mark.cuda
def test_step_impl_xla_launches_no_kernel_on_the_card(cuda_device):
    """``--step-impl xla`` takes the plain ``olaf_step`` on the card: no
    launch, and every counter and queue field equal to the kernel run's
    (``pallas``, one launch per PS step); losses within rtol 1e-4."""
    from repro_torch.launch import train
    olaf_step_cuda.launches = 0
    kernel = train.main(TRAIN_ARGV + ["--step-impl", "pallas"])
    torch.cuda.synchronize()
    assert olaf_step_cuda.launches == 8
    olaf_step_cuda.launches = 0
    plain = train.main(TRAIN_ARGV + ["--step-impl", "xla"])
    torch.cuda.synchronize()
    assert olaf_step_cuda.launches == 0
    for f in ("deferred_total", "stale_total", "screened_total"):
        assert getattr(kernel, f) == getattr(plain, f), f
    assert [c for _, _, c in kernel.log_rows] \
        == [c for _, _, c in plain.log_rows]
    for f in ("cluster", "worker", "seq", "agg_count", "next_seq", "n_agg",
              "n_repl", "n_dropped", "n_screened"):
        assert torch.equal(getattr(kernel.state.queue, f),
                           getattr(plain.state.queue, f)), f
    np.testing.assert_allclose([l for _, l, _ in kernel.log_rows],
                               [l for _, l, _ in plain.log_rows], rtol=1e-4)


@pytest.mark.cuda
def test_ps_step_makes_no_host_sync(cuda_device):
    """``ps_step`` on the card (screen, staleness bound, churn mask, the
    trimmed branch) runs under ``set_sync_debug_mode("error")``: no call in
    it waits for the card. One ``olaf_step`` launch and one
    ``olaf_robust_combine`` launch (step 5) per step."""
    from repro_torch.launch import train
    args = train.build_parser().parse_args(TRAIN_ARGV + ["--device", "cuda"])
    tr = train.OlafAsyncTrainer(get_config("smollm-360m").reduced(), args)
    tr.step()  # builds and loads the kernel outside the checked span
    tr._churn_events(args.crash_at)
    bursts = [tr.next_burst() for _ in range(3)]
    torch.cuda.synchronize()
    olaf_step_cuda.launches = olaf_robust_combine_cuda.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        for b in bursts:
            tr.state, stats = train.ps_step(tr.state, b, cfg=tr.ps_cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert olaf_step_cuda.launches == olaf_robust_combine_cuda.launches == 3
    assert all(v.device.type == "cuda" and v.dim() == 0
               for v in stats.values())


@pytest.mark.cuda
def test_spans_on_the_card(cuda_device):
    """``repro_torch.tracing`` on the card: a trainer step under remat
    ``full`` gives every span a positive device time, and each gradient
    2 × n_layers ``model.period`` spans, half under ``worker.backward``
    (autograd's device thread runs the recompute); a span inside CUDA
    graph capture records no event, and the capture and its replay
    succeed."""
    from repro_torch import tracing
    from repro_torch.launch import train
    args = train.build_parser().parse_args(TRAIN_ARGV + ["--device", "cuda"])
    cfg = dataclasses.replace(get_config("smollm-360m").reduced(), remat=True,
                              remat_policy="full")
    tr = train.OlafAsyncTrainer(cfg, args)
    tr.step()  # builds and loads the kernel outside the traced step
    x = torch.arange(1024, dtype=torch.float32, device=cuda_device)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        y = x * 2  # warm up before capture, as torch.cuda.graph asks
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    tracing.enable()
    try:
        tr.step()
        recs = tracing.take()
        with torch.cuda.graph(graph):
            with tracing.span("model.period"):
                y = x * 2
        graph.replay()
        captured = tracing.take()
    finally:
        tracing.disable()
        tracing.take()
    assert all(r.device_ms is not None and r.device_ms > 0 for r in recs), \
        [(r.name, r.device_ms) for r in recs if not r.device_ms]
    by_id = {r.id: r for r in recs}
    grads = [r for r in recs if r.name == "worker.grad"]
    assert len(grads) == tr.burst_size
    periods = [r for r in recs if r.name == "model.period"]
    assert len(periods) == 2 * cfg.n_layers * len(grads)
    assert sum(by_id[r.parent].name == "worker.backward"
               for r in periods) == cfg.n_layers * len(grads)
    assert [(r.name, r.device_ms) for r in captured] \
        == [("model.period", None)]
    torch.cuda.synchronize()
    assert torch.equal(y, x * 2)


def _dyadic_fattree_cfg(route="static", faults=None):
    """``tests/test_vecsim.py``'s dyadic fat-tree k=2, from the port's
    topology (every event time exact in float32 and float64)."""
    from repro_torch.core.topology import build_sim_cfg, fattree_spec
    spec = fattree_spec(2, edge_gbps=2 ** 19 / 1e9, agg_gbps=2 ** 20 / 1e9,
                        core_gbps=2 ** 21 / 1e9, prop_delay=2.0 ** -12,
                        route_policy=route)
    return build_sim_cfg(spec, gen_interval=3 * 2.0 ** -7, gen_jitter=0.0,
                         size_bits=8192, horizon=0.25, seed=0, faults=faults)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["static", "hash", "adaptive"])
def test_vecsim_on_the_card_equals_the_cpu(cuda_device, route):
    """``run_vecsim`` on the card against the same run on the CPU, on a
    small fat-tree with lossy links: every counter, delivery field and time
    equal, payloads within 1e-6, the results on the card."""
    from repro_torch.core import vecsim
    from repro_torch.core.netsim import FaultSpec, LinkFault
    cfg0 = _dyadic_fattree_cfg(route)
    cfg = _dyadic_fattree_cfg(route, faults=FaultSpec(
        links=[LinkFault(switch=s.name, drop_prob=0.05)
               for s in cfg0.switches], seed=11))
    grid, _ = vecsim.oracle_event_times(cfg)
    rows = np.random.default_rng(1).normal(size=(512, 33)).astype(np.float32)
    kw = dict(grid=grid, dim=33, payload_rows=rows)
    card = vecsim.run_vecsim(cfg, device=cuda_device, **kw)
    host = vecsim.run_vecsim(cfg, device="cpu", **kw)
    assert card.delivered_payloads.device.type == "cuda"
    assert len(card.delivery_times) > 0
    for f in ("queue_stats", "sent", "deferred", "received_at_ps",
              "link_dropped", "raw_link_dropped", "reroutes",
              "drops_by_switch", "deliveries", "agg_counts",
              "unrecovered_drops"):
        assert getattr(card.sim, f) == getattr(host.sim, f), f
    assert [dataclasses.astuple(u) for u in card.sim.delivered_updates] == \
        [dataclasses.astuple(u) for u in host.sim.delivered_updates]
    for f in ("aom", "n_steps", "forwarded", "residual", "h2d_transfers",
              "width", "passes"):
        assert getattr(card, f) == getattr(host, f), f
    np.testing.assert_array_equal(card.delivery_times, host.delivery_times)
    np.testing.assert_array_equal(card.final_counts, host.final_counts)
    assert float((card.delivered_payloads.cpu()
                  - host.delivered_payloads).abs().max()) <= 1e-6


@pytest.mark.cuda
def test_vecsim_step_loop_makes_no_host_sync(cuda_device):
    """Every boundary of a run with transmission control, lossy links and
    the ``hash`` route, stepped under ``set_sync_debug_mode("error")``: the
    step never waits for the card."""
    from repro_torch.core import vecsim
    from repro_torch.core.netsim import FaultSpec, LinkFault
    from repro_torch.core.txctl import TxControlConfig
    cfg0 = _dyadic_fattree_cfg("hash")
    cfg = dataclasses.replace(
        cfg0, tx_control=TxControlConfig(delta_threshold=0.5),
        faults=FaultSpec(links=[LinkFault(switch=s.name, drop_prob=0.1)
                                for s in cfg0.switches], seed=3))
    comp = vecsim.compile_scenario(cfg, dim=8)
    assert comp.static.has_tx and comp.static.route == "hash"
    grid = vecsim.uniform_grid(cfg, 2.0 ** -9, allow_coarse=True)
    arrs = vecsim._stage(comp.arrays, cuda_device)
    runner = vecsim._Runner(comp.static, arrs, 8,
                            float(comp.arrays["horizon"]))
    carry = runner.init_carry()
    ts = torch.from_numpy(grid).to(cuda_device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = runner.run(carry, ts)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(carry["sent"]) > 0 and int(carry["dlv"]["n"]) > 0
    assert carry["dlv"]["pay"].device.type == "cuda"


@pytest.mark.cuda
def test_vectorized_hybrid_rows_live_on_the_card(cuda_device):
    """``run_hybrid_multihop(sim_impl="vectorized")`` on the card: the
    delivered rows are card tensors, equal to the CPU run's within 1e-6."""
    kw = dict(dim=16, seed=3, horizon=0.1, sim_impl="vectorized")
    card, _ = run_hybrid_multihop(device=cuda_device, **kw)
    host, _ = run_hybrid_multihop(device="cpu", **kw)
    assert len(card.delivered) == len(host.delivered) > 0
    for (tc, uc, pc), (th, uh, ph) in zip(card.delivered, host.delivered):
        assert pc.device.type == "cuda"
        assert tc == th and dataclasses.astuple(uc) == dataclasses.astuple(uh)
        assert float((pc.cpu() - ph).abs().max()) <= 1e-6
    assert card.queue_stats == host.queue_stats
    assert card.launches == host.launches > 1


@pytest.mark.cuda
def test_sharded_kernels_launch_once_per_shard(cuda_device):
    """``olaf_combine_sharded`` and ``olaf_step_sharded`` over three entries
    of the card: three kernel launches each, equal to the one-launch call
    (combine bit for bit, with and without a reset mask; step metadata
    exact, payload within rtol 1e-5, atol 1e-6), heterogeneous capacities
    included."""
    from repro_torch.distributed import sharding
    rng = np.random.default_rng(17)
    S, Q, U, D = 6, 4, 8, 941
    args = (torch.from_numpy(rng.normal(size=(S, Q, D)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, 3, (S, Q)).astype(np.int32)),
            torch.from_numpy(rng.normal(size=(S, U, D)).astype(np.float32)),
            torch.from_numpy(rng.integers(0, Q, (S, U)).astype(np.int32)),
            torch.from_numpy(rng.integers(0, 3, (S, U)).astype(np.int32)))
    args = tuple(a.to(cuda_device) for a in args)
    mesh = sharding.switch_mesh(S, devices=[cuda_device] * 3)
    olaf_combine_cuda.launches = 0
    one = ops.olaf_combine_multi(*args)
    assert olaf_combine_cuda.launches == 1
    split = sharding.olaf_combine_sharded(*args, mesh=mesh)
    assert olaf_combine_cuda.launches == 4
    assert all(torch.equal(a, b) for a, b in zip(one, split))
    # each shard's slice of a reset mask rides its own launch
    reset = torch.from_numpy(rng.random((S, Q)) < 0.4).to(cuda_device)
    one = ops.olaf_combine_multi(*args, reset=reset)
    split = sharding.olaf_combine_sharded(*args, reset=reset, mesh=mesh)
    assert olaf_combine_cuda.launches == 8
    assert all(torch.equal(a, b) for a, b in zip(one, split))

    S, Q, U, k = 3, 64, 96, 16
    caps = torch.tensor([48, 64, 17], dtype=torch.int32, device=cuda_device)
    states = TorchQueueState.stack([queue_init(Q, 4099, device=cuda_device)
                                    for _ in range(S)])
    burst = _burst(rng, S, U, 4099, 24, 1.0, cuda_device)
    olaf_step_cuda.launches = 0
    st1, out1 = ops.olaf_step_multi(states.clone(), *burst, capacity=caps,
                                    k=k)
    st3, out3 = sharding.olaf_step_sharded(
        states.clone(), *burst, capacities=caps, k=k,
        mesh=sharding.switch_mesh(S, devices=[cuda_device] * 3))
    assert olaf_step_cuda.launches == 4
    for f in META_FIELDS:
        assert torch.equal(getattr(st1, f), getattr(st3, f)), f
    for f in OUT_EXACT:
        assert torch.equal(out1[f], out3[f]), f
    torch.testing.assert_close(st3.payload, st1.payload, rtol=1e-5,
                               atol=1e-6)
    torch.testing.assert_close(out3["payload"], out1["payload"], rtol=1e-5,
                               atol=1e-6)


@pytest.mark.cuda
def test_sharded_vecsim_on_the_card_equals_one_device(cuda_device):
    """A (2,1) mesh on one card against the one-device card run, bit for
    bit (transmission control, lossy links, the ``hash`` route), and a
    sharded segment stepped under ``set_sync_debug_mode("error")``."""
    from repro_torch.core import vecsim
    from repro_torch.core.netsim import FaultSpec, LinkFault
    from repro_torch.core.txctl import TxControlConfig
    cfg0 = _dyadic_fattree_cfg("hash")
    cfg = dataclasses.replace(
        cfg0, tx_control=TxControlConfig(delta_threshold=0.5),
        faults=FaultSpec(links=[LinkFault(switch=s.name, drop_prob=0.1)
                                for s in cfg0.switches], seed=3))
    kw = dict(dt=2.0 ** -9, allow_coarse=True, dim=33)
    one = vecsim.run_vecsim(cfg, device=cuda_device, **kw)
    split = vecsim.run_vecsim(cfg, mesh=(2, 1), device=[cuda_device] * 2,
                              **kw)
    assert split.delivered_payloads.device.type == "cuda"
    assert len(one.delivery_times) > 0
    assert [dataclasses.astuple(u) for u in one.sim.delivered_updates] == \
        [dataclasses.astuple(u) for u in split.sim.delivered_updates]
    for f in ("queue_stats", "sent", "deferred", "link_dropped",
              "raw_link_dropped", "reroutes", "drops_by_switch",
              "reroutes_by_switch"):
        assert getattr(one.sim, f) == getattr(split.sim, f), f
    for f in ("aom", "n_steps", "forwarded", "residual"):
        assert getattr(one, f) == getattr(split, f), f
    np.testing.assert_array_equal(one.delivery_times, split.delivery_times)
    np.testing.assert_array_equal(one.final_counts, split.final_counts)
    assert torch.equal(one.delivered_payloads, split.delivered_payloads)

    comp = vecsim.compile_scenario(cfg, dim=33)
    perm = vecsim._stripe_perm(comp.static.S, 2)
    arrays = dict(comp.arrays)
    for key in vecsim._SWITCH_AXIS_KEYS:
        arrays[key] = comp.arrays[key][perm]
    devs = np.empty(2, dtype=object)
    devs[:] = [torch.device("cuda", torch.cuda.current_device())] * 2
    runner = vecsim._ShardedRunner(
        comp.static, vecsim._stage(arrays, devs[0]), devs.reshape(2, 1), 8,
        float(comp.arrays["horizon"]), comp.static.Rt)
    carry = runner.init_carry()
    ts = torch.from_numpy(vecsim.uniform_grid(cfg, 2.0 ** -9,
                                              allow_coarse=True)).to(devs[0])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        carry = runner.run(carry, ts[:64])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(carry["rep"]["sent"]) > 0


# --------------------------------------------------------------------------
# the moe, ssm, hybrid, vlm and encdec families
# --------------------------------------------------------------------------
FAMILY_ARCHS = ["grok-1-314b", "arctic-480b", "mamba2-130m",
                "recurrentgemma-9b", "internvl2-76b", "whisper-small"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_attention_kernels_at_the_families_shapes(cuda_device, dtype):
    """The shapes the families give the kernels: whisper's non-causal
    encoder (48 rows of 1500 frames, Dh 64); the prefills of grok-1, arctic
    and internvl2 (Dh 128, k/v expanded from 8 heads) and recurrentgemma's
    (2,304 tokens, window 2048, Dh 256, k/v from 1 head); and decode at rep
    1 (whisper), 6 (grok-1), 7 (arctic) and 8 (internvl2)."""
    gen = torch.Generator(cuda_device).manual_seed(21)
    q, k, v = (torch.randn((48, 1500, 64), generator=gen, device=cuda_device)
               .to(dtype) for _ in range(3))
    torch.testing.assert_close(
        flash_attention_cuda(q, k, v, causal=False),
        flash_attention_plain(q, k, v, causal=False), rtol=ATTN_TOL[dtype],
        atol=ATTN_TOL[dtype])
    # (B, S, H, KV, Dh, window): grok-1, arctic, internvl2 (256 patches +
    # 512 tokens), recurrentgemma past its window
    for B, S, H, KV, Dh, window in [(4, 512, 48, 8, 128, 0),
                                    (4, 512, 56, 8, 128, 0),
                                    (4, 768, 64, 8, 128, 0),
                                    (2, 2304, 16, 1, 256, 2048)]:
        q = torch.randn((B, S, H, Dh), generator=gen, device=cuda_device).to(dtype)
        kv = torch.randn((2, B, S, KV, Dh), generator=gen,
                         device=cuda_device).to(dtype)
        heads = torch.arange(H, device=cuda_device) // (H // KV)
        k, v = kv[0].index_select(2, heads), kv[1].index_select(2, heads)
        kw = dict(causal=True, window=window)
        torch.testing.assert_close(ops.flash_attention(q, k, v, **kw),
                                   flash_attention_plain(q, k, v, **kw),
                                   rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])
    for B, KV, rep, S, Dh in [(4, 12, 1, 88, 64), (4, 8, 6, 536, 128),
                              (4, 8, 7, 536, 128), (4, 8, 8, 792, 128)]:
        q = torch.randn((B, KV, rep, Dh), generator=gen, device=cuda_device).to(dtype)
        kc, vc = (torch.randn((B, S, KV, Dh), generator=gen,
                              device=cuda_device).to(dtype) for _ in range(2))
        pos = torch.linspace(0, S - 1, B, device=cuda_device).round().to(torch.int32)
        torch.testing.assert_close(ops.decode_attention(q, kc, vc, pos),
                                   decode_attention_plain(q, kc, vc, pos),
                                   rtol=ATTN_TOL[dtype], atol=ATTN_TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_reduced_family_on_the_card_equals_the_cpu(cuda_device, arch):
    """The reduced config at head dim 64 (the kernels take no 16) in float32
    under ``attn_impl="pallas"``, weights drawn on the CPU: prefill logits
    and 4 decode steps' logits on the card within 1e-4 of the CPU's (the
    kernels against their plain versions, cuBLAS against the CPU's sums),
    with the prefill through the flash kernel."""
    from repro_torch.launch import serve
    from repro_torch.models import api
    from repro_torch.models.module import tree_map
    cfg = dataclasses.replace(get_config(arch).reduced(), head_dim=64,
                              attn_impl="pallas")
    host = api.init_model(torch.Generator().manual_seed(0), cfg)
    out = {}
    for dev in (cuda_device, torch.device("cpu")):
        params = tree_map(lambda x: x.to(dev), host)
        inputs = serve.prompt_inputs(cfg, 2, 20, 0, dev)
        offset = serve.position_offset(cfg)
        before = flash_attention_cuda.launches
        with torch.inference_mode():
            logits, caches = api.prefill(params, inputs, cfg)
            if dev.type == "cuda":
                assert flash_attention_cuda.launches > before or cfg.family == "ssm"
            caches = tree_map(serve._grow, api.make_caches(
                cfg, 2, offset + 20 + 12, device=dev), caches)
            rows = [logits[:, -1]]
            for i in range(4):
                tok = torch.tensor([3 + i, 7 * i], dtype=torch.int32, device=dev)
                pos = torch.full((2,), offset + 20 + i, dtype=torch.int32,
                                 device=dev)
                logits, caches = api.decode_step(
                    params, caches, {"token": tok, "pos": pos}, cfg)
                rows.append(logits)
        out[dev.type] = torch.stack(rows).cpu()
    torch.testing.assert_close(out["cuda"], out["cpu"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_reduced_family_olaf_async_on_the_card_equals_the_cpu(cuda_device,
                                                              arch):
    """moe, ssm and hybrid training: the reduced olaf-async run on the card
    and on the CPU, combined counts exact, losses within rtol 1e-4, one
    ``olaf_step`` launch per PS step."""
    from repro_torch.launch import train
    argv = ["--arch", arch, "--reduced", "--mode", "olaf-async", "--workers",
            "4", "--batch", "8", "--seq", "16", "--steps", "4",
            "--burst-size", "2", "--drain-k", "4", "--log-every", "0"]
    olaf_step_cuda.launches = 0
    card = train.main(argv + ["--device", "cuda"])
    torch.cuda.synchronize()
    assert olaf_step_cuda.launches == 4
    host = train.main(argv + ["--device", "cpu"])
    assert [c for _, _, c in card.log_rows] == [c for _, _, c in host.log_rows]
    np.testing.assert_allclose([l for _, l, _ in card.log_rows],
                               [l for _, l, _ in host.log_rows], rtol=1e-4)


def _chip_smoke():
    """``chip_smoke.py`` as a module: its ``[recovery]`` phase's trainer
    configuration, run and snapshot comparison are the ones used here."""
    import importlib.util
    import pathlib
    import sys
    if "chip_smoke" not in sys.modules:
        path = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
        spec = importlib.util.spec_from_file_location("chip_smoke", path)
        module = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = module  # its dataclasses look it up
        spec.loader.exec_module(module)
    return sys.modules["chip_smoke"]


@pytest.mark.cuda
def test_recovery_on_the_card_equals_the_cpu(cuda_device, tmp_path):
    """Checkpointed PS recovery under ``tests/test_node_faults.py``'s churn
    and PS bounce, a snapshot every 3 deliveries: the card's run restores
    from the same snapshot as the CPU's, every drain (those after the
    restore too) is one ``olaf_step`` launch, the restored queue lives on
    the card, and every snapshot equals the CPU's (ints exact, floats
    within rtol 1e-5, atol 1e-6; the CUDA kernel updates the queue in
    place, so a snapshot that kept a reference would show the later
    drains)."""
    smoke = _chip_smoke()
    (tmp_path / "card").mkdir()
    (tmp_path / "cpu").mkdir()
    card, res, rec = smoke.recovery_run(cuda_device, str(tmp_path / "card"))
    torch.cuda.synchronize()
    host, hres, _ = smoke.recovery_run("cpu", str(tmp_path / "cpu"))
    assert rec["per_drain"] and set(rec["per_drain"]) == {1}
    assert rec["restored_at"] and rec["restored_at"][0] < len(rec["per_drain"])
    assert card.recovered_from and card.recovered_from == host.recovered_from
    assert all(v.device.type == "cuda"
               for v in card._ps_queue.fields().values())
    for f in dataclasses.fields(res.sim_result):
        if f.name != "delivered_updates":
            assert getattr(res.sim_result, f.name) == \
                getattr(hres.sim_result, f.name), f.name
    assert (res.ps.applied, res.ps.rejected) == (hres.ps.applied,
                                                 hres.ps.rejected)
    np.testing.assert_allclose(res.ps.w, hres.ps.w, rtol=1e-6, atol=0)
    assert (smoke.RECOVERY_RTOL, smoke.RECOVERY_ATOL) == (1e-5, 1e-6)
    smoke.compare_snapshots(tmp_path / "card", tmp_path / "cpu")
    assert list((tmp_path / "card").glob("*.npz"))


@pytest.mark.cuda
def test_topk_compress_ties_on_the_card(cuda_device):
    """``topk_compress`` at D = 2**20 + 3 with the k-th magnitude tied
    about 260,000 times, signed zeros, NaN and ±inf: the card's indices and
    value bits equal the CPU's (``lax.top_k``'s order, H2)."""
    from repro_torch.optim.compress import int8_quantize, topk_compress
    rng = np.random.default_rng(19)
    D = 2**20 + 3
    g = rng.choice(np.float32([0.0, 0.25, 0.5, 4.0]), D) \
        * rng.choice(np.float32([-1.0, 1.0]), D)
    g[rng.choice(D, 64)] = np.nan
    g[rng.choice(D, 64)] = np.inf
    g[rng.choice(D, 64)] = -np.inf
    host = torch.from_numpy(g)
    k = int((np.abs(g) >= 4.0).sum()) + 1000
    for kk in (1, k, D):
        want = topk_compress(host, kk)
        got = topk_compress(host.to(cuda_device), kk)
        assert torch.equal(got[0].cpu(), want[0])
        assert torch.equal(got[1].cpu().view(torch.int32),
                           want[1].view(torch.int32))
    q, s = int8_quantize(host.to(cuda_device))
    wq, ws = int8_quantize(host)
    assert torch.equal(q.cpu(), wq) and s.item() == ws.item()
