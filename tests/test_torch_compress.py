"""``repro_torch.optim.compress`` against ``repro.optim.compress``.

Inputs come from ``np.random.default_rng`` seeds and hand-written edge
cases; every comparison is exact. ``topk_compress`` must give
``jax.lax.top_k``'s indices in its order (H2: magnitudes descending, NaN
above +inf, on a tie the lower index first) and the values' bits, ``-0.0``
included; ``int8_quantize`` must give the same int8 codes (half to even)
and the same float32 scale, non-finite inputs included.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.optim import compress as jax_compress  # noqa: E402
from repro_torch.optim import compress  # noqa: E402


def _bits(x) -> np.ndarray:
    """float32 bit patterns, so ``-0.0`` and NaN compare exactly."""
    return np.asarray(x, np.float32).view(np.int32)


def _same_topk(g: np.ndarray, k: int):
    want_i, want_v = jax_compress.topk_compress(jnp.asarray(g), k)
    got_i, got_v = compress.topk_compress(torch.from_numpy(g), k)
    assert got_i.dtype == torch.int32 and got_v.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))
    return got_i.numpy()


EDGE = np.asarray([1.0, np.nan, -np.inf, 2.0, np.inf, -2.0, np.nan, 0.0,
                   -0.0, 2.0, -1.0, 0.0], np.float32)


def _case(name: str) -> np.ndarray:
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "edge":
        return EDGE
    if name == "signed_zeros":
        return np.asarray([0.0, -0.0, -0.0, 0.0, 0.0, -0.0], np.float32)
    if name == "ties":  # few magnitudes: the k-th is always tied
        return rng.integers(-3, 4, size=4099).astype(np.float32)
    if name == "normal":
        return rng.normal(size=4099).astype(np.float32)
    if name == "nonfinite":
        g = rng.normal(size=1031).astype(np.float32)
        g[rng.choice(1031, 40, replace=False)] = np.nan
        g[rng.choice(1031, 20, replace=False)] = np.inf
        g[rng.choice(1031, 20, replace=False)] = -np.inf
        return g
    raise KeyError(name)


@pytest.mark.parametrize("name", ["edge", "signed_zeros", "ties", "normal",
                                  "nonfinite"])
@pytest.mark.parametrize("k", ["one", "some", "half", "all"])
def test_topk_compress_matches_lax_top_k(name, k):
    g = _case(name)
    n = {"one": 1, "some": min(7, g.size), "half": g.size // 2,
         "all": g.size}[k]
    _same_topk(g, n)


def test_topk_ties_at_the_kth_magnitude_take_the_lower_indices():
    """D = 2**16 + 3 with the k-th magnitude tied many times: the kept
    ties are the lowest-index ones, as ``lax.top_k`` keeps them."""
    rng = np.random.default_rng(5)
    g = np.where(rng.random(2**16 + 3) < 0.5, 0.5, 0.25).astype(np.float32)
    g[rng.choice(g.size, 100, replace=False)] = 4.0
    g *= np.where(rng.random(g.size) < 0.5, -1.0, 1.0).astype(np.float32)
    idx = _same_topk(g, 1000)
    tied = np.flatnonzero(np.abs(g) == 0.5)
    np.testing.assert_array_equal(np.sort(idx[100:]), tied[:900])


def test_topk_k_zero_and_out_of_range():
    g = _case("normal")
    i, v = compress.topk_compress(torch.from_numpy(g), 0)
    assert i.shape == v.shape == (0,)
    with pytest.raises(ValueError, match="outside"):
        compress.topk_compress(torch.from_numpy(g), g.size + 1)


def test_topk_compress_jit_is_the_same_and_keeps_its_input():
    g = torch.from_numpy(_case("ties"))
    before = g.clone()
    a = compress.topk_compress(g, 64)
    b = compress.topk_compress_jit(g, 64)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert torch.equal(g, before)  # no donation in PyTorch (H5)


def test_topk_decompress_matches_repro():
    rng = np.random.default_rng(3)
    g = rng.normal(size=257).astype(np.float32)
    idx, vals = compress.topk_compress(torch.from_numpy(g), 32)
    want = jax_compress.topk_decompress(jnp.asarray(idx.numpy()),
                                        jnp.asarray(vals.numpy()), 257)
    np.testing.assert_array_equal(
        compress.topk_decompress(idx, vals, 257).numpy(), np.asarray(want))
    # negative indices count from the end; outside [-dim, dim) is dropped
    idx = np.asarray([0, -1, 7, -9, 2], np.int32)
    vals = np.asarray([1.0, 2.0, 3.0, 4.0, -0.0], np.float32)
    want = jax_compress.topk_decompress(jnp.asarray(idx), jnp.asarray(vals), 5)
    got = compress.topk_decompress(torch.from_numpy(idx),
                                   torch.from_numpy(vals), 5)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_error_feedback_matches_repro_over_5_rounds():
    rng = np.random.default_rng(11)
    dim, k = 300, 17
    want, got = jax_compress.ErrorFeedback(dim), compress.ErrorFeedback(dim)
    for _ in range(5):
        g = rng.normal(size=dim).astype(np.float32)
        (wi, wv), (gi, gv) = want.compress(g.copy(), k), got.compress(g.copy(), k)
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(_bits(gv), _bits(wv))
        np.testing.assert_array_equal(_bits(got.residual),
                                      _bits(want.residual))


QUANT = {
    "zeros": np.zeros(16, np.float32),
    "nonfinite": np.asarray([1.0, -2.0, np.nan, np.inf, -np.inf, 0.5],
                            np.float32),
    # scale 1: exact half-way codes, rounded to even (0.5 -> 0, 2.5 -> 2)
    "half_way": np.asarray([127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 126.5,
                            -126.5], np.float32),
    "large": (np.random.default_rng(1).normal(size=64) * 1e3
              ).astype(np.float32),
    "tiny": np.asarray([1e-30, -3e-31, 0.0], np.float32),
    "all_nan": np.full(4, np.nan, np.float32),
}


@pytest.mark.parametrize("name", sorted(QUANT))
def test_int8_quantize_matches_repro(name):
    g = QUANT[name]
    wq, ws = jax_compress.int8_quantize(jnp.asarray(g))
    gq, gs = compress.int8_quantize(torch.from_numpy(g))
    assert gq.dtype == torch.int8 and gs.dtype == torch.float32
    assert gs.shape == ()
    np.testing.assert_array_equal(gq.numpy(), np.asarray(wq))
    assert _bits(gs.item()) == _bits(float(ws))
    np.testing.assert_array_equal(
        _bits(compress.int8_dequantize(gq, gs).numpy()),
        _bits(jax_compress.int8_dequantize(wq, ws)))


@pytest.mark.parametrize("kw", [{}, {"int8": True}, {"topk": 128},
                                {"topk": 128, "int8": True}])
def test_wire_bits_matches_repro(kw):
    for dim in (941, 1024, 1794, 361_821_120):
        assert compress.wire_bits(dim, **kw) == jax_compress.wire_bits(dim, **kw)

