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
from repro_torch.kernels.decode_attention import (decode_attention_cuda,  # noqa: E402
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,  # noqa: E402
                                                 flash_attention_plain)
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
