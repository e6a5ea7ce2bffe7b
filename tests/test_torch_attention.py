"""Parity of the port's attention kernels' plain versions with ``repro``'s.

The same inputs, made with numpy from a seed, go through ``repro``'s
Pallas kernels in interpret mode (at lengths that divide their blocks) or
through ``repro.kernels.ref`` (at ragged lengths, which the Pallas kernels
refuse: ROADMAP hazard H13), and through the port's plain versions on the
CPU. Tolerances: float32 ``atol = rtol = 1e-5`` (float association); bf16
``1e-2``, about two bf16 ulps at these magnitudes (each side rounds its
float32 result once). The CUDA kernels themselves are held to the plain
versions in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jax_ops  # noqa: E402
from repro.kernels import ref  # noqa: E402
from repro.kernels.flash_attention import flash_attention_pallas  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.decode_attention import (chunk_for,  # noqa: E402
                                                  decode_attention_cuda,
                                                  decode_attention_plain)
from repro_torch.kernels.flash_attention import (flash_attention_cuda,  # noqa: E402
                                                 flash_attention_plain)

TOL = {"float32": 1e-5, "bfloat16": 1e-2}


def _pair(a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of ``dtype``
    (bf16 rounded once, on the jax side, and carried bit for bit)."""
    j = jnp.asarray(a, jnp.float32).astype(getattr(jnp, dtype))
    t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(getattr(torch, dtype))
    return j, t


def _close(got: torch.Tensor, want, dtype: str, what: str):
    assert got.dtype == getattr(torch, dtype), what
    np.testing.assert_allclose(got.to(torch.float32).numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)),
                               rtol=TOL[dtype], atol=TOL[dtype], err_msg=what)


# (BH, Sq, Sk, Dh, causal, window, q_offset): Sq and Sk divide the 32-row
# Pallas blocks below
DIVIDING = [(3, 64, 64, 16, True, 0, 0), (2, 64, 64, 16, False, 0, 0),
            (2, 96, 96, 8, True, 20, 0), (2, 32, 96, 16, True, 0, 64),
            (2, 64, 64, 16, False, 24, 0)]
RAGGED = [(2, 37, 37, 8, True, 0, 0), (3, 53, 71, 16, True, 11, 18),
          (2, 29, 29, 8, False, 0, 0), (1, 5, 130, 16, True, 0, 125)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", DIVIDING)
def test_flash_plain_matches_pallas_interpret(shape, dtype):
    BH, Sq, Sk, Dh, causal, window, q_offset = shape
    rng = np.random.default_rng(BH * Sq + Sk + window)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(BH, S, Dh)), dtype)
                                    for S in (Sq, Sk, Sk))
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  q_offset=q_offset, block_q=32, block_k=32,
                                  interpret=True)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                q_offset=q_offset)
    _close(got, want, dtype, f"flash {shape} {dtype}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", RAGGED)
def test_flash_plain_matches_ref_at_ragged_lengths(shape, dtype):
    BH, Sq, Sk, Dh, causal, window, q_offset = shape
    rng = np.random.default_rng(7 * BH + Sq + Sk)
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(BH, S, Dh)), dtype)
                                    for S in (Sq, Sk, Sk))
    want = ref.flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                   q_offset=q_offset)
    got = flash_attention_plain(tq, tk, tv, causal=causal, window=window,
                                q_offset=q_offset)
    _close(got, want, dtype, f"flash ragged {shape} {dtype}")


def test_flash_fully_masked_row_is_zero_h12():
    """Every key of these rows lies before the window: the kernel's −1e30
    mask and its 1e-30 floor on the sum give 0, as ``ref`` does (``repro``'s
    ``layers.full_attention`` gives NaN there)."""
    rng = np.random.default_rng(12)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 8, 16)).astype(np.float32))
               for _ in range(3))
    got = flash_attention_plain(q, k, v, causal=True, window=4, q_offset=20)
    assert torch.equal(got, torch.zeros_like(got))
    want = ref.flash_attention_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                                   causal=True, window=4, q_offset=20)
    np.testing.assert_array_equal(np.asarray(want), 0.0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ops_flash_in_model_layout_matches_repro(dtype):
    """``ops.flash_attention`` on (B, S, H, Dh) folds heads as ``repro``'s."""
    rng = np.random.default_rng(3)
    B, S, H, Dh = 2, 64, 3, 16
    (jq, tq), (jk, tk), (jv, tv) = (_pair(rng.normal(size=(B, S, H, Dh)), dtype)
                                    for _ in range(3))
    want = jax_ops.flash_attention(jq, jk, jv, causal=True, block_q=32,
                                   block_k=32, interpret=True)
    got = ops.flash_attention(tq, tk, tv, causal=True)
    assert got.shape == (B, S, H, Dh)
    _close(got, want, dtype, f"ops.flash_attention {dtype}")


def _decode_inputs(rng, B, S, KV, rep, Dh, dtype, pos):
    q = _pair(rng.normal(size=(B, KV, rep, Dh)), dtype)
    kc = _pair(rng.normal(size=(B, S, KV, Dh)), dtype)
    vc = _pair(rng.normal(size=(B, S, KV, Dh)), dtype)
    pos = np.asarray(pos, np.int32)
    return (q, kc, vc, (jnp.asarray(pos), torch.from_numpy(pos)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("KV,rep", [(2, 1), (2, 3), (1, 8)])
def test_decode_plain_matches_pallas_interpret(KV, rep, dtype):
    """Per-row positions over a partly written cache (S = 48, blocks of
    16): the positions past pos hold junk that must not weigh in."""
    rng = np.random.default_rng(KV * 10 + rep)
    B, S, Dh = 3, 48, 16
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = _decode_inputs(
        rng, B, S, KV, rep, Dh, dtype, [0, 21, 47])
    want = jax_ops.decode_attention(jq, jk, jv, jp, block_s=16, interpret=True)
    got = ops.decode_attention(tq, tk, tv, tp)
    _close(got, want, dtype, f"decode KV={KV} rep={rep} {dtype}")
    junk = tk.clone()
    junk[1, 22:] = 1e4
    junk[0, 1:] = -1e4
    torch.testing.assert_close(decode_attention_plain(tq, junk, tv, tp), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("S", [37, 552])
def test_decode_plain_matches_ref_at_ragged_lengths(S, dtype):
    rng = np.random.default_rng(S)
    B, KV, rep, Dh = 4, 2, 3, 16
    pos = rng.integers(0, S, B)
    (jq, tq), (jk, tk), (jv, tv), (jp, tp) = _decode_inputs(
        rng, B, S, KV, rep, Dh, dtype, pos)
    want = ref.decode_attention_ref(jq, jk, jv, jp)
    _close(decode_attention_plain(tq, tk, tv, tp), want, dtype,
           f"decode ragged S={S} {dtype}")


def test_ops_route_cpu_to_plain_and_refuse_other_devices():
    rng = np.random.default_rng(0)
    fl0, dec0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    q = torch.from_numpy(rng.normal(size=(1, 8, 2, 64)).astype(np.float32))
    out = ops.flash_attention(q, q, q, causal=True)
    torch.testing.assert_close(out, ops.flash_attention(q, q, q, causal=True))
    cache = torch.from_numpy(rng.normal(size=(1, 8, 2, 64)).astype(np.float32))
    pos = torch.tensor([5], dtype=torch.int32)
    dec = ops.decode_attention(cache[:, :1].reshape(1, 2, 1, 64), cache, cache,
                               pos)
    assert dec.shape == (1, 2, 1, 64)
    assert (flash_attention_cuda.launches, decode_attention_cuda.launches) == (
        fl0, dec0), "a CPU tensor launched a CUDA kernel"
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.flash_attention(meta, meta, meta)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ops.decode_attention(meta[:, :1].reshape(1, 2, 1, 64), meta, meta,
                             pos.to("meta"))
    with pytest.raises(ValueError, match="more than one device"):
        ops.flash_attention(q, meta, meta)


def test_cuda_wrappers_refuse_cpu_tensors():
    """On the CPU only the plain versions run: the CUDA wrappers raise
    before building anything."""
    q = torch.zeros((2, 8, 64))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_cuda(q, q, q)
    cache = torch.zeros((1, 8, 2, 64))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        decode_attention_cuda(torch.zeros((1, 2, 1, 64)), cache, cache,
                              torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="differ in BH or Dh"):
        flash_attention_plain(q, q[:1], q[:1])


def test_decode_chunk_fills_the_card():
    """The serve shape (8 rows x 5 kv heads, S = 552) splits into chunks of
    64 (360 blocks); the 32k cache keeps chunks of 256."""
    assert chunk_for(8, 5, 552) == 64
    assert chunk_for(8, 5, 32768) == 256
    assert chunk_for(1, 1, 10) == 64
