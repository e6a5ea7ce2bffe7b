"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports torch, numpy and ``repro_torch`` only, so it runs on a machine
without JAX: ``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``.
Without a card every test skips with its reason (a CUDA kernel has no CPU
mode).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.olaf_queue import TorchQueueState, queue_init  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
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
