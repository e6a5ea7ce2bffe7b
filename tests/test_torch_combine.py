"""Parity of the port's combine and enqueue entry points with ``repro``'s.

The same inputs, made with numpy from a seed, go through
``repro.kernels.ops`` (the Pallas kernels in interpret mode, as the JAX
tests run them) or ``repro.kernels.ref.olaf_combine_ref``, and through
``repro_torch.kernels.ops`` on the CPU (the kernels' plain PyTorch
versions). Counts and queue metadata must match exactly; payloads within
``rtol=1e-5, atol=1e-6`` (the sums are taken in another order). The CUDA
kernels themselves are held to the plain versions in
``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core.olaf_queue import jax_queue_init  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels.ref import olaf_combine_ref  # noqa: E402
from repro_torch.core.olaf_queue import (EVENT_OF_CLASS, classify_slot_events,  # noqa: E402
                                         queue_init)
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.olaf_combine import (olaf_combine_cuda,  # noqa: E402
                                              olaf_combine_plain)
from repro_torch.kernels.olaf_enqueue import olaf_enqueue_cuda  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6
D = 32  # divides repro's tile_d
D_RAGGED = 1031  # port only: no tile constraint


def _window(rng, S, Q, U, dim, *, p_reset=0.3, gate_hi=5):
    """Seeded combine operands: slots, counts, updates, clusters in
    [-1, Q] (both ends out of range), gates 0..gate_hi-1, reset mask."""
    slots = rng.normal(size=(S, Q, dim)).astype(np.float32)
    counts = rng.integers(0, 6, (S, Q)).astype(np.int32)
    updates = rng.normal(size=(S, U, dim)).astype(np.float32)
    clusters = rng.integers(-1, Q + 1, (S, U)).astype(np.int32)
    gate = rng.integers(0, gate_hi, (S, U)).astype(np.int32)
    reset = rng.random((S, Q)) < p_reset
    return slots, counts, updates, clusters, gate, reset


def _t(*arrays):
    return tuple(torch.from_numpy(np.array(a)) for a in arrays)


def _j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def _assert_combine(want, got, what):
    w_slots, w_counts = (np.asarray(x) for x in want)
    g_slots, g_counts = (x.numpy() for x in got)
    assert g_counts.dtype == np.int32, what
    np.testing.assert_array_equal(w_counts, g_counts, err_msg=f"{what}: counts")
    np.testing.assert_allclose(w_slots, g_slots, rtol=RTOL, atol=ATOL,
                               err_msg=f"{what}: slots")


@pytest.mark.parametrize("S,Q,U", [(1, 4, 8), (3, 4, 16), (3, 8, 5)])
def test_combine_matches_pallas_and_ref(S, Q, U):
    rng = np.random.default_rng(S * 100 + Q * 10 + U)
    slots, counts, updates, clusters, gate, _ = _window(rng, S, Q, U, D)
    want = jax_ops.olaf_combine(*_j(slots, counts, updates, clusters, gate),
                                tile_q=4, interpret=True)
    got = ops.olaf_combine(*_t(slots, counts, updates, clusters, gate))
    _assert_combine(want, got, "pallas")
    _assert_combine(olaf_combine_ref(*_j(slots, counts, updates, clusters,
                                         gate)), got, "ref")
    if S == 1:  # one queue, no leading axis
        one = ops.olaf_combine(*_t(slots[0], counts[0], updates[0],
                                   clusters[0], gate[0]))
        _assert_combine(olaf_combine_ref(*_j(slots[0], counts[0], updates[0],
                                             clusters[0], gate[0])), one,
                        "rank-2")
    multi = ops.olaf_combine_multi(*_t(slots, counts, updates, clusters, gate))
    _assert_combine(want, multi, "multi")


def test_combine_ragged_d_and_bool_gate():
    """Any D (the Pallas kernel asserted D % tile_d == 0) and a bool gate."""
    rng = np.random.default_rng(4)
    slots, counts, updates, clusters, gate, _ = _window(rng, 3, 8, 12,
                                                        D_RAGGED)
    gate = gate > 1
    got = ops.olaf_combine(*_t(slots, counts, updates, clusters, gate))
    _assert_combine(olaf_combine_ref(*_j(slots, counts, updates, clusters,
                                         gate.astype(np.int32))), got, "ragged")
    # the plain version leaves its inputs alone and returns fresh tensors
    ts = _t(slots, counts, updates, clusters, gate.astype(np.int32))
    out, _ = olaf_combine_plain(*ts)
    assert out.data_ptr() != ts[0].data_ptr()
    np.testing.assert_array_equal(ts[0].numpy(), slots)


def test_combine_all_gates_zero_rewrites_every_slot():
    """No update contributes: counts unchanged, every slot x·c/max(c,1)."""
    rng = np.random.default_rng(8)
    slots, counts, updates, clusters, _, _ = _window(rng, 2, 4, 8, D)
    gate = np.zeros_like(clusters)
    got = ops.olaf_combine(*_t(slots, counts, updates, clusters, gate))
    np.testing.assert_array_equal(got[1].numpy(), counts)
    c = counts.astype(np.float32)[..., None]
    np.testing.assert_array_equal(got[0].numpy(),
                                  (slots * c) / np.maximum(c, np.float32(1)))


@pytest.mark.parametrize("S", [1, 3])
def test_combine_window_resets(S):
    rng = np.random.default_rng(20 + S)
    slots, counts, updates, clusters, gate, reset = _window(rng, S, 4, 8, D)
    want = jax_ops.olaf_combine_window(*_j(slots, counts, updates), clusters,
                                       gate, reset, tile_q=4, interpret=True)
    # host (numpy) window buffers, as the hybrid replay passes them
    got = ops.olaf_combine_window(*_t(slots, counts, updates), clusters, gate,
                                  reset)
    _assert_combine(want, got, "window")
    # a reset slot's old NaN survives as NaN·0, as in repro
    slots[0, 0] = np.nan
    reset[0, 0] = True
    got = ops.olaf_combine_window(*_t(slots, counts, updates), clusters, gate,
                                  reset)
    assert np.isnan(got[0][0, 0].numpy()).all()


@pytest.mark.parametrize("U", [0, 8])
@pytest.mark.parametrize("with_hop", [False, True])
def test_forward_matches_repro(U, with_hop):
    rng = np.random.default_rng(30 + U + with_hop)
    S, Q = 3, 4
    slots, counts, updates, clusters, gate, reset = _window(rng, S, Q, U, D)
    sw = np.array([0, 2, 1], np.int32)
    slot = np.array([1, 3, 0], np.int32)
    hop = np.array([1, -1, -2], np.int32) if with_hop else None
    want = jax_ops.olaf_forward(*_j(slots, counts, updates), clusters, gate,
                                reset, sw, slot, hop, tile_q=4,
                                interpret=True)
    ins = _t(slots, counts, updates)
    got = ops.olaf_forward(*ins, clusters, gate, reset, sw, slot, hop)
    assert len(got) == len(want) == (4 if with_hop else 3)
    _assert_combine(want[:2], got[:2], "forward state")
    np.testing.assert_allclose(np.asarray(want[2]), got[2].numpy(),
                               rtol=RTOL, atol=ATOL)
    if with_hop:
        np.testing.assert_array_equal(np.asarray(want[3]), got[3].numpy())
        assert not got[2][2].any()  # hop -2: the row dies on the device
    # the drained rows are copies, and the passed-in buffers are unchanged
    np.testing.assert_array_equal(ins[0].numpy(), slots)
    np.testing.assert_array_equal(ins[1].numpy(), counts)
    got[0].zero_()
    assert got[2].abs().sum() > 0


@pytest.mark.parametrize("case", ["drained_slot_reset", "drain_only",
                                  "hop_minus_two", "all_gates_zero"])
def test_fused_forward_plain_matches_repro(case):
    """The fused forward's plain version (``olaf_combine_plain`` with a
    reset mask and a drain, what ``ops.olaf_forward`` runs on the CPU)
    against ``repro``'s ``ops.olaf_forward``: a drained slot that the same
    window resets, a drain-only boundary (U = 0, nothing lands, the reset
    mask is not applied), hop -2 (the row is zeroed) and a window whose
    gates are all zero (every slot rewritten as x·c/c, then drained)."""
    rng = np.random.default_rng(60 + len(case))
    S, Q, U = 3, 4, 0 if case == "drain_only" else 8
    slots, counts, updates, clusters, gate, reset = _window(rng, S, Q, U, D)
    if case == "all_gates_zero":
        gate[:] = 0
    sw = np.array([1, 0, 2], np.int32)
    slot = np.array([2, 0, 3], np.int32)
    hop = np.array([-1, 0, -2 if case == "hop_minus_two" else 1], np.int32)
    if case in ("drained_slot_reset", "drain_only"):
        reset[1, 2] = reset[2, 3] = True
        clusters[1, :2], gate[1, :2] = 2, 1  # the reset slot drains its window
    want = jax_ops.olaf_forward(*_j(slots, counts, updates), clusters, gate,
                                reset, sw, slot, hop, tile_q=4,
                                interpret=True)
    got = olaf_combine_plain(*_t(slots, counts, updates, clusters, gate),
                             reset=torch.from_numpy(reset),
                             drain_sw=torch.from_numpy(sw),
                             drain_slot=torch.from_numpy(slot),
                             drain_hop=torch.from_numpy(hop))
    _assert_combine(want[:2], got[:2], case)
    np.testing.assert_allclose(np.asarray(want[2]), got[2].numpy(),
                               rtol=RTOL, atol=ATOL)
    assert not got[0][sw, slot].any() and not got[1][sw, slot].any()
    if case == "hop_minus_two":
        assert not got[2][2].any()
    if case == "drain_only":  # nothing landed: the other slots as they were
        keep = np.ones((S, Q), bool)
        keep[sw, slot] = False
        np.testing.assert_array_equal(got[0].numpy()[keep], slots[keep])
        np.testing.assert_array_equal(got[1].numpy()[keep], counts[keep])


def test_nan_row_stays_in_its_slot_h9():
    """H9: repro's one-hot product spreads one NaN element to every slot
    (0·NaN); the port's segment sum keeps it in the slot the row names, and
    skips it where its gate is 0. Every row finite in repro equals the
    port's; the port's NaN rows are a subset of repro's."""
    rng = np.random.default_rng(44)
    S, Q, U = 2, 8, 8
    slots, counts, updates, clusters, gate, _ = _window(rng, S, Q, U, D)
    clusters[0, 3], gate[0, 3] = 5, 2
    updates[0, 3, 7] = np.nan
    clusters[1, 2], gate[1, 2] = 1, 0  # a dropped NaN row weighs in nowhere
    updates[1, 2, :] = np.nan
    for want in (jax_ops.olaf_combine(*_j(slots, counts, updates, clusters,
                                          gate), tile_q=4, interpret=True),
                 olaf_combine_ref(*_j(slots, counts, updates, clusters,
                                      gate))):
        w_slots = np.asarray(want[0])
        got_slots, got_counts = ops.olaf_combine(*_t(slots, counts, updates,
                                                     clusters, gate))
        got_slots = got_slots.numpy()
        np.testing.assert_array_equal(np.asarray(want[1]), got_counts.numpy())
        w_nan = np.isnan(w_slots).any(-1)
        g_nan = np.isnan(got_slots).any(-1)
        assert (g_nan <= w_nan).all()
        assert w_nan.sum() > g_nan.sum()  # repro spread it further
        np.testing.assert_array_equal(np.argwhere(g_nan), [[0, 5]])
        np.testing.assert_allclose(w_slots[~w_nan], got_slots[~w_nan],
                                   rtol=RTOL, atol=ATOL)


def _burst(rng, U, n_clusters, n_workers, t0):
    return (rng.integers(0, n_clusters, U).astype(np.int32),
            rng.integers(0, n_workers, U).astype(np.int32),
            (t0 + rng.random(U)).astype(np.float32),
            rng.normal(size=U).astype(np.float32),
            rng.normal(size=(U, D)).astype(np.float32))


def test_enqueue_matches_pallas_interpret():
    """Six bursts with ``screen``, ``capacity`` < Q and a finite threshold
    through repro's ``olaf_enqueue`` (Pallas, interpret mode) and the
    port's (plain on the CPU)."""
    rng = np.random.default_rng(12)
    Q, U, cap, thr = 8, 10, 6, 0.5
    st_j, st_t = jax_queue_init(Q, D), queue_init(Q, D, device="cpu")
    for i in range(6):
        burst = _burst(rng, U, 9, 4, float(i))
        screen = rng.random(U) < 0.2
        st_j = jax_ops.olaf_enqueue(st_j, *_j(*burst), thr, cap,
                                    jnp.asarray(screen), tile_q=4,
                                    interpret=True)
        st_t = ops.olaf_enqueue(st_t, *_t(*burst), thr, cap,
                                torch.from_numpy(screen))
        for f in ("cluster", "worker", "seq", "agg_count", "replaceable",
                  "gen_time", "reward", "next_seq", "n_dropped", "n_agg",
                  "n_repl", "n_screened"):
            np.testing.assert_array_equal(np.asarray(getattr(st_j, f)),
                                          getattr(st_t, f).numpy(),
                                          err_msg=f"burst {i}: {f}")
        np.testing.assert_allclose(np.asarray(st_j.payload),
                                   st_t.payload.numpy(), rtol=RTOL, atol=ATOL)
    assert int(st_t.n_screened) > 0 and int(st_t.n_dropped) > 0
    assert int(st_t.n_agg) > 0 and int(st_t.n_repl) > 0
    assert int((st_t.cluster >= 0).sum()) == cap


def test_kernels_raise_instead_of_falling_back():
    rng = np.random.default_rng(0)
    ts = _t(*_window(rng, 1, 4, 4, D)[:5])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        olaf_combine_cuda(*ts)
    with pytest.raises(ValueError, match="more than one device"):
        ops.olaf_combine(ts[0], ts[1], ts[2].to("meta"), ts[3], ts[4])
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.olaf_combine(*(t.to("meta") for t in ts))
    burst = _t(*_burst(rng, 4, 3, 2, 0.0))
    with pytest.raises(ValueError, match="olaf_enqueue_cuda needs CUDA"):
        olaf_enqueue_cuda(queue_init(4, D, device="cpu"), *burst)
    with pytest.raises(ValueError, match="more than one device"):
        ops.olaf_enqueue(queue_init(4, D, device="cpu"), burst[0].to("meta"),
                         *burst[1:])


def test_event_table_and_its_inverse():
    """``classify_slot_events`` inverts ``EVENT_OF_CLASS``."""
    labels = ["append", "agg", "replace", "drop", "append", "replace"]
    slots = [0, 0, 0, 0, 2, 2]
    events = [EVENT_OF_CLASS[c] for c in labels]
    assert classify_slot_events(slots, events, np.zeros(4, bool)) == labels
