"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports torch, numpy and ``repro_torch`` only, so it runs on a machine
without JAX: ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
Without a card every test skips with its reason (a CUDA kernel has no CPU
mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.hybrid import run_hybrid_multihop  # noqa: E402
from repro_torch.core.olaf_queue import TorchQueueState, queue_init  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.olaf_combine import (olaf_combine_cuda,  # noqa: E402
                                              olaf_combine_plain)
from repro_torch.kernels.olaf_enqueue import (olaf_enqueue_cuda,  # noqa: E402
                                              olaf_enqueue_plain)
from repro_torch.kernels.olaf_step import olaf_step_cuda, olaf_step_plain  # noqa: E402

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
                                         (2, 8, 0, 4, 8), (1, 4, 12, 9, 4)])
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
