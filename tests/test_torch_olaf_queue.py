"""Parity of the port's queue and ``olaf_step`` with ``repro``'s.

The same bursts, made with numpy from a seed, go through
``repro.core.olaf_queue.jax_olaf_step`` and through
``repro_torch.kernels.ops.olaf_step`` on the CPU (the kernel's plain
PyTorch version). Metadata, counters and drain fields must match exactly;
payloads within ``rtol=1e-4, atol=1e-5`` (float association of the
telescoped mean, the tolerance of ``tests/test_olaf_step.py``). The CUDA
kernel itself is held to the plain version in ``test_torch_cuda.py``.
"""
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import olaf_queue as jq  # noqa: E402
from repro.core.olaf_queue import JaxQueueState, jax_queue_init  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro_torch.core.olaf_queue import (EMPTY_SEQ, TorchQueueState,  # noqa: E402
                                         queue_init, queue_state_from_numpy,
                                         queue_state_to_numpy)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.olaf_step import olaf_step_cuda, olaf_step_plain  # noqa: E402

D = 16
META_FIELDS = ("cluster", "worker", "seq", "agg_count", "replaceable",
               "gen_time", "reward", "next_seq", "n_dropped", "n_agg",
               "n_repl", "n_screened")
OUT_EXACT = ("valid", "n_valid", "cluster", "worker", "agg_count",
             "gen_time", "reward")

# name, Q, U, k, n_clusters, n_workers, reward_threshold — the scenarios of
# tests/test_olaf_step.py, 10 bursts each here
SCENARIOS = [
    ("general", 8, 24, 4, 12, 8, np.inf),
    ("full_queue", 4, 32, 2, 16, 8, np.inf),
    ("drain_all", 8, 6, 8, 20, 8, np.inf),  # k == Q pops past occupancy
    ("reward_gated", 6, 16, 3, 8, 4, 0.75),
]
N_BURSTS = 10

# repro's composition, jitted once per shape (k is static)
jax_olaf_step = jax.jit(jq.jax_olaf_step, static_argnums=(6,))


def _rand_burst(rng, U, n_clusters, n_workers, t0, dim=D):
    return (rng.integers(0, n_clusters, U).astype(np.int32),
            rng.integers(0, n_workers, U).astype(np.int32),
            (t0 + rng.random(U)).astype(np.float32),
            rng.normal(size=U).astype(np.float32),
            rng.normal(size=(U, dim)).astype(np.float32))


def _jax(burst):
    return tuple(jnp.asarray(a) for a in burst)


def _torch(burst):
    return tuple(torch.from_numpy(np.array(a)) for a in burst)


def _assert_match(want, got, name):
    """``want`` = (JaxQueueState, out) from repro, ``got`` from the port."""
    st_w, out_w = want
    st_g, out_g = got
    for f in META_FIELDS:
        g = getattr(st_g, f)
        if f not in ("replaceable", "gen_time", "reward"):  # H4: int32
            assert g.dtype == torch.int32, f"{name}: state {f} is {g.dtype}"
        np.testing.assert_array_equal(np.asarray(getattr(st_w, f)),
                                      g.numpy(), err_msg=f"{name}: state {f}")
    np.testing.assert_allclose(np.asarray(st_w.payload), st_g.payload.numpy(),
                               rtol=1e-4, atol=1e-5,
                               err_msg=f"{name}: state payload")
    for f in OUT_EXACT:
        np.testing.assert_array_equal(np.asarray(out_w[f]), out_g[f].numpy(),
                                      err_msg=f"{name}: out {f}")
    np.testing.assert_allclose(np.asarray(out_w["payload"]),
                               out_g["payload"].numpy(), rtol=1e-4, atol=1e-5,
                               err_msg=f"{name}: out payload")


def _cpu_state(jax_state):
    return queue_state_from_numpy(jax_state, device="cpu")


@pytest.mark.parametrize("name,Q,U,k,n_clusters,n_workers,thr", SCENARIOS,
                         ids=[s[0] for s in SCENARIOS])
def test_olaf_step_matches_jax(name, Q, U, k, n_clusters, n_workers, thr):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    st_j = jax_queue_init(Q, D)
    st_t = queue_init(Q, D, device="cpu")
    for trial in range(N_BURSTS):
        burst = _rand_burst(rng, U, n_clusters, n_workers, float(trial))
        want = jax_olaf_step(st_j, *_jax(burst), k, thr)
        got = ops.olaf_step(st_t, *_torch(burst), thr, k=k)
        _assert_match(want, got, f"{name}[{trial}]")
        st_j, st_t = want[0], got[0]
    if name == "full_queue":
        assert int(st_t.n_dropped) > 0
    if name == "reward_gated":
        assert int(st_t.n_dropped) > 0 and int(st_t.n_repl) > 0
    assert int(st_t.n_agg) > 0


def test_send_screen_masks_and_threshold():
    """Deferred (send=False) and screened rows never touch the queue; a
    screened sent row counts in n_screened. With a finite threshold."""
    rng = np.random.default_rng(3)
    Q, U, k, thr = 8, 16, 3, 0.5
    st_j, st_t = jax_queue_init(Q, D), queue_init(Q, D, device="cpu")
    for trial in range(8):
        burst = _rand_burst(rng, U, 10, 5, float(trial))
        send = rng.integers(0, 2, U).astype(bool)
        screen = rng.random(U) < 0.3
        want = jax_olaf_step(st_j, *_jax(burst), k, thr, jnp.asarray(send),
                             None, None, jnp.asarray(screen))
        got = ops.olaf_step(st_t, *_torch(burst), thr,
                            send=torch.from_numpy(send),
                            screen=torch.from_numpy(screen), k=k)
        _assert_match(want, got, f"masks[{trial}]")
        st_j, st_t = want[0], got[0]
    assert int(st_t.n_screened) > 0 and int(st_t.n_dropped) > 0


def test_drain_only_burst_and_k_above_queue():
    """U = 0 (the trainer's final flush) and k > Q (clamped to Q) after a
    few bursts that leave residue in the queue."""
    rng = np.random.default_rng(5)
    Q = 6
    st_j, st_t = jax_queue_init(Q, D), queue_init(Q, D, device="cpu")
    for trial in range(3):
        burst = _rand_burst(rng, 12, 9, 4, float(trial))
        want = jax_olaf_step(st_j, *_jax(burst), 1)
        got = ops.olaf_step(st_t, *_torch(burst), k=1)
        _assert_match(want, got, f"fill[{trial}]")
        st_j, st_t = want[0], got[0]
    empty = _rand_burst(rng, 0, 9, 4, 9.0)
    for k in (2, Q + 3):
        want = jax_olaf_step(st_j, *_jax(empty), k)
        got = ops.olaf_step(st_t, *_torch(empty), k=k)
        _assert_match(want, got, f"drain-only k={k}")
        assert got[1]["valid"].shape == (min(k, Q),)
        st_j, st_t = want[0], got[0]
    assert int(st_t.n_agg) > 0
    assert not bool((st_t.cluster >= 0).any())  # the k > Q drain emptied it


def test_capacity_hole_follows_burst_resolve():
    """H1: with an occupied slot at index >= capacity, the queue is full by
    COUNT and an append takes the first empty slot at any index — the rule
    of ``_burst_resolve``, which ``alg1_resolve``'s slot-region test does
    not follow."""
    Q, cap = 6, 3
    st = jax_queue_init(Q, D)
    cluster = np.array([-1, 7, -1, -1, 9, -1], np.int32)
    occupied = cluster >= 0
    st = JaxQueueState(
        cluster=jnp.asarray(cluster),
        worker=jnp.asarray(np.where(occupied, 1, -1).astype(np.int32)),
        seq=jnp.asarray(np.where(occupied, [0, 0, 0, 0, 1, 0], EMPTY_SEQ)
                        .astype(np.int32)),
        gen_time=st.gen_time,
        reward=jnp.asarray(np.where(occupied, 0.0, -np.inf).astype(np.float32)),
        agg_count=jnp.asarray(occupied.astype(np.int32)),
        replaceable=jnp.asarray(occupied),
        payload=jnp.asarray(np.random.default_rng(0).normal(size=(Q, D))
                            .astype(np.float32) * occupied[:, None]),
        next_seq=jnp.asarray(2, jnp.int32), n_dropped=st.n_dropped,
        n_agg=st.n_agg, n_repl=st.n_repl, n_screened=st.n_screened)
    # clusters 1, 2, 3 arrive: 1 appends at slot 0 (count 2 -> 3), then the
    # queue is full by count and 2, 3 drop; cluster 9 aggregates at slot 4
    burst = (np.array([1, 2, 3, 9], np.int32), np.array([2, 2, 2, 2], np.int32),
             np.full(4, 0.5, np.float32), np.zeros(4, np.float32),
             np.random.default_rng(1).normal(size=(4, D)).astype(np.float32))
    want = jax_olaf_step(st, *_jax(burst), 2, np.inf, None, cap)
    got = ops.olaf_step(_cpu_state(st), *_torch(burst), capacity=cap, k=2)
    _assert_match(want, got, "capacity hole")
    assert int(got[0].n_dropped) == 2 and int(got[0].n_agg) == 1


def test_active_workers_expire_drained_rows():
    rng = np.random.default_rng(9)
    Q, U, k = 8, 12, 4
    burst = _rand_burst(rng, U, 10, 6, 0.0)
    active = np.array([True, False, True, True, False, True])
    want = jax_olaf_step(jax_queue_init(Q, D), *_jax(burst), k,
                         active_workers=jnp.asarray(active))
    got = ops.olaf_step(queue_init(Q, D, device="cpu"), *_torch(burst),
                        active_workers=torch.from_numpy(active), k=k)
    _assert_match(want, got, "active_workers")


def test_pallas_interpret_agrees_with_port():
    """One small cycle through repro's Pallas kernel in interpret mode, as
    the JAX tests run it, against the port."""
    rng = np.random.default_rng(13)
    Q, U, k = 8, 10, 3
    burst = _rand_burst(rng, U, 6, 4, 0.0)
    want = jax_ops.olaf_step(jax_queue_init(Q, D), *_jax(burst), k=k,
                             impl="pallas", tile_q=4, tile_d=D,
                             interpret=True)
    got = ops.olaf_step(queue_init(Q, D, device="cpu"), *_torch(burst), k=k)
    _assert_match(want, got, "pallas-interpret")


def test_multi_queue_plain_matches_per_queue_jax():
    """The plain version over a leading S axis equals one jax_olaf_step per
    queue (the layout the CUDA kernel takes)."""
    rng = np.random.default_rng(7)
    S, Q, U, k = 3, 8, 12, 4
    bursts = [_rand_burst(rng, U, 10, 5, 0.0) for _ in range(S)]
    stacked = tuple(torch.from_numpy(np.stack([b[i] for b in bursts]))
                    for i in range(5))
    caps = torch.tensor([8, 5, 3], dtype=torch.int32)
    st = TorchQueueState.stack([queue_init(Q, D, device="cpu")] * S)
    st_t, out_t = olaf_step_plain(st, *stacked, k, capacity=caps)
    for s in range(S):
        want = jax_olaf_step(jax_queue_init(Q, D), *_jax(bursts[s]), k,
                             np.inf, None, int(caps[s]))
        _assert_match(want, (st_t.select(s), {n: v[s] for n, v in out_t.items()}),
                      f"S[{s}]")


def test_queue_state_numpy_round_trip():
    rng = np.random.default_rng(17)
    st_j = jax_queue_init(5, D)
    st_j, _ = jax_olaf_step(st_j, *_jax(_rand_burst(rng, 9, 6, 3, 0.0)), 1)
    st_t = queue_state_from_numpy(st_j, device="cpu")
    assert st_t.seq.dtype == torch.int32 and st_t.next_seq.shape == ()
    assert st_t.replaceable.dtype == torch.bool
    back = JaxQueueState(**queue_state_to_numpy(st_t))
    for f in (*META_FIELDS, "payload"):
        a, b = np.asarray(getattr(st_j, f)), np.asarray(getattr(back, f))
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_ops_raises_instead_of_falling_back():
    """No device but CPU and CUDA has a path, and mixed devices raise."""
    rng = np.random.default_rng(0)
    burst = _torch(_rand_burst(rng, 4, 3, 2, 0.0))
    meta = queue_init(4, D, device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.olaf_step(meta, *(b.to("meta") for b in burst), k=2)
    with pytest.raises(ValueError, match="more than one device"):
        ops.olaf_step(queue_init(4, D, device="cpu"), burst[0].to("meta"),
                      *burst[1:], k=2)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        olaf_step_cuda(queue_init(4, D, device="cpu"), *burst, 2)
    # the kernel's own wrapper checks devices before it casts anything
    with pytest.raises(ValueError, match="payloads is on meta.*more than one"):
        olaf_step_cuda(queue_init(4, D, device="cpu"), *burst[:4],
                       burst[4].to("meta"), 2)
    with pytest.raises(ValueError, match="screen is on meta.*more than one"):
        olaf_step_cuda(queue_init(4, D, device="cpu"), *burst, 2,
                       screen=torch.zeros(4, dtype=torch.bool, device="meta"))


def test_nan_slot_reaches_only_its_drained_row_h9():
    """H9: repro drains with a one-hot product, which spreads a NaN in one
    queued slot (0·NaN) to every drained row; the port gathers, so only the
    row that pops that slot is NaN. Every drained row finite in repro
    equals the port's, and the port's NaN rows are a subset of repro's."""
    rng = np.random.default_rng(21)
    Q, k = 8, 4
    st_j = jax_queue_init(Q, D)
    st_j, _ = jax_olaf_step(st_j, *_jax(_rand_burst(rng, 6, 6, 3, 0.0)), 1)
    fields = {f: np.array(v) for f, v in queue_state_to_numpy(
        _cpu_state(st_j)).items()}
    occupied = np.flatnonzero(fields["cluster"] >= 0)
    assert len(occupied) >= 3
    oldest = occupied[np.argsort(fields["seq"][occupied])]
    fields["payload"][oldest[1], 3] = np.nan  # drained second of k
    st_j = JaxQueueState(**{f: jnp.asarray(v) for f, v in fields.items()})
    burst = _rand_burst(rng, 3, 12, 3, 1.0)
    want = jax_olaf_step(st_j, *_jax(burst), k)
    got = ops.olaf_step(_cpu_state(st_j), *_torch(burst), k=k)
    w_rows = np.asarray(want[1]["payload"])
    g_rows = got[1]["payload"].numpy()
    w_nan = np.isnan(w_rows).any(-1)
    g_nan = np.isnan(g_rows).any(-1)
    assert (g_nan <= w_nan).all()
    np.testing.assert_array_equal(np.flatnonzero(g_nan), [1])
    assert w_nan.sum() > 1  # repro spread it to the other drained rows
    np.testing.assert_allclose(w_rows[~w_nan], g_rows[~w_nan], rtol=1e-4,
                               atol=1e-5)
    for f in OUT_EXACT:
        np.testing.assert_array_equal(np.asarray(want[1][f]),
                                      got[1][f].numpy(), err_msg=f)
    np.testing.assert_allclose(np.asarray(want[0].payload),
                               got[0].payload.numpy(), rtol=1e-4, atol=1e-5)
