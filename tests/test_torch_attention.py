"""Parity of the port's attention kernels' plain versions with ``repro``'s.

The same inputs, made with numpy from a seed, go through ``repro``'s
Pallas kernels in interpret mode (at lengths that divide their blocks) or
through ``repro.kernels.ref`` (at ragged lengths, which the Pallas kernels
refuse: ROADMAP hazard H13), and through the port's plain versions on the
CPU. Tolerances: float32 ``atol = rtol = 1e-5`` (float association); bf16
``atol = rtol = 1e-2`` (an element's bound is 1e-2 + 1e-2·|want|), about
two bf16 ulps at these magnitudes (each side rounds its float32 result
once). The CUDA kernels themselves are held to the plain
versions in ``test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import math

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
                                                  decode_attention_plain,
                                                  decode_plan)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    BACKWARD_HEAD_DIMS, FlashAttention, flash_attention_backward_cuda,
    flash_attention_backward_plain, flash_attention_cuda,
    flash_attention_plain)
from repro_torch.models import layers  # noqa: E402

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
    64 (360 blocks); the 32k cache into chunks of 1024 (1,280 blocks, two
    waves of three blocks on each of the H100's 132 SMs); a grid that
    leaves SMs idle even at 64 takes chunks of 32."""
    assert chunk_for(8, 5, 552) == 64
    assert chunk_for(8, 5, 32768) == 1024
    assert chunk_for(4, 1, 1000) == 32
    assert chunk_for(1, 1, 10) == 32


@pytest.mark.parametrize("B,KV,S", [(8, 5, 552), (8, 5, 32768), (4, 1, 1000),
                                    (1, 1, 10), (64, 8, 4096)])
def test_decode_plan_grid_and_tickets(B, KV, S):
    """One launch per call: a (B·KV, nsplit) grid whose chunks cover the
    cache once, as many blocks as fill the card where the cache is long
    enough, and one ticket per (b, kv) group."""
    plan = decode_plan(B, KV, S)
    assert plan.grid == (B * KV, plan.nsplit)
    assert plan.tickets == B * KV
    assert plan.chunk == chunk_for(B, KV, S)
    assert (plan.nsplit - 1) * plan.chunk < S <= plan.nsplit * plan.chunk
    blocks = plan.grid[0] * plan.grid[1]
    if plan.chunk > 64:  # a longer chunk only while the grid still fills
        assert blocks >= 6 * 132
    assert blocks >= min(6 * 132, B * KV * -(-S // 64))
    assert plan.warps == (8 if blocks < 2 * 132 or plan.chunk >= 1024 else 4)


# ---------------------------------------------------------------------------
# the (B, S, H, Dh) model layout read through strides (no fold copy)
# ---------------------------------------------------------------------------
def _strided_qkv(rng, B, Sq, Sk, H, Dh, dtype):
    """q, k, v as views into fused (B, S, 3, H, Dh) projections, the way a
    fused qkv projection leaves them: strides (S·3·H·Dh, 3·H·Dh, Dh, 1)."""
    out = []
    for S, which in ((Sq, 0), (Sk, 1), (Sk, 2)):
        j, t = _pair(rng.normal(size=(B, S, 3, H, Dh)), dtype)
        out.append((j[:, :, which], t[:, :, which]))
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("Sq,Sk,window,q_offset", [(64, 64, 0, 0),
                                                   (32, 96, 0, 64),
                                                   (64, 64, 24, 0),
                                                   (32, 96, 40, 64)])
def test_flash_strided_model_layout_matches_folded_and_repro(Sq, Sk, window,
                                                             q_offset, dtype):
    """``flash_attention_plain`` and ``ops.flash_attention`` on strided
    (B, S, H, Dh) views equal the folded (BH, S, Dh) path and ``repro``'s
    ``ops.flash_attention`` (Pallas, interpret mode)."""
    rng = np.random.default_rng(Sq + Sk + window + q_offset)
    B, H, Dh = 2, 3, 16
    (jq, tq), (jk, tk), (jv, tv) = _strided_qkv(rng, B, Sq, Sk, H, Dh, dtype)
    assert not tq.is_contiguous() and tq.stride() == (Sq * 3 * H * Dh,
                                                      3 * H * Dh, Dh, 1)
    kw = dict(causal=True, window=window, q_offset=q_offset)
    want = jax_ops.flash_attention(jq, jk, jv, block_q=32, block_k=32,
                                   interpret=True, **kw)
    got = flash_attention_plain(tq, tk, tv, **kw)
    assert got.shape == (B, Sq, H, Dh)
    _close(got, want, dtype, f"plain strided {dtype}")
    via_ops = ops.flash_attention(tq, tk, tv, **kw)
    _close(via_ops, want, dtype, f"ops strided {dtype}")

    def fold(x):
        return x.permute(0, 2, 1, 3).reshape(B * H, x.shape[1], Dh)

    folded = flash_attention_plain(fold(tq), fold(tk), fold(tv), **kw)
    assert folded.shape == (B * H, Sq, Dh)
    torch.testing.assert_close(folded.reshape(B, H, Sq, Dh).permute(0, 2, 1, 3),
                               got, rtol=TOL[dtype], atol=TOL[dtype])


def test_ops_flash_makes_no_fold_copy():
    """``ops.flash_attention`` hands the kernel's wrapper q, k and v as they
    are (the kernel reads them through their strides)."""
    seen = []

    def spy(q, k, v, **kw):
        seen.extend(t.data_ptr() for t in (q, k, v))
        return flash_attention_plain(q, k, v, **kw)

    rng = np.random.default_rng(5)
    (_, q), (_, k), (_, v) = _strided_qkv(rng, 1, 8, 8, 2, 64, "float32")
    orig = ops.flash_attention_plain
    ops.flash_attention_plain = spy
    try:
        ops.flash_attention(q, k, v)
    finally:
        ops.flash_attention_plain = orig
    assert seen == [q.data_ptr(), k.data_ptr(), v.data_ptr()]


def test_flash_wrapper_refuses_layouts_the_kernel_cannot_read():
    """The CUDA wrapper's stride checks (what TMA and 16-byte loads take),
    run before any launch: on meta tensors they raise the layout error."""
    from repro_torch.kernels.flash_attention import _strides
    good = torch.empty((2, 8, 3, 64), dtype=torch.bfloat16, device="meta")
    assert _strides("q", good) == (8 * 3 * 64, 3 * 64, 64)
    odd = torch.empty((2, 8, 3, 68), dtype=torch.bfloat16)[..., :60]
    with pytest.raises(ValueError, match="multiples of 16 bytes"):
        _strides("q", odd)
    transposed = torch.empty((2, 64, 3, 8), dtype=torch.bfloat16).transpose(1, 3)
    with pytest.raises(ValueError, match="unit stride on Dh"):
        _strides("k", transposed)


# ---------------------------------------------------------------------------
# hazard H15: the bf16 kernel rounds P to bf16 before P·V
# ---------------------------------------------------------------------------
def _bf16_kernel_model(q, k, v, *, causal, window, q_offset, BK):
    """The bf16 tensor-core kernel's numerics in float32 on the CPU: S from
    the bf16 inputs in float32, an online softmax per BK-key tile, l from
    the float32 p, P rounded to bf16 before P·V, the output rounded once."""
    BH, Sq, Dh = q.shape
    Sk = k.shape[1]
    qf, kf, vf = (x.to(torch.float32) for x in (q, k, v))
    qpos = torch.arange(Sq)[:, None] + q_offset
    m = torch.full((BH, Sq, 1), -1e30)
    l = torch.zeros((BH, Sq, 1))
    o = torch.zeros((BH, Sq, Dh))
    for k0 in range(0, Sk, BK):
        kpos = torch.arange(k0, min(k0 + BK, Sk))[None, :]
        s = torch.einsum("bqd,bkd->bqk", qf, kf[:, k0:k0 + BK]) / math.sqrt(Dh)
        live = torch.ones((Sq, kpos.shape[1]), dtype=torch.bool)
        if causal:
            live &= kpos <= qpos
        if window:
            live &= kpos > qpos - window
        s = torch.where(live, s, torch.tensor(-1e30))
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(live, torch.exp(s - m_new), torch.tensor(0.0))
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        pb = p.to(torch.bfloat16).to(torch.float32)
        o = o * corr + torch.einsum("bqk,bkd->bqd", pb, vf[:, k0:k0 + BK])
        m = m_new
    return (o / torch.clamp(l, min=1e-30)).to(torch.bfloat16)


# the chip_smoke.py flash shapes (a)-(d), cut to a few heads (and (b) to
# one head at its full 2048 length): (BH, Sq, Sk, Dh, causal, window, q_offset)
H15_SHAPES = {"a": (2, 512, 512, 64, True, 0, 0),
              "b": (1, 2048, 2048, 64, True, 0, 0),
              "c": (2, 1000, 1000, 256, True, 128, 0),
              "d": (2, 256, 768, 128, True, 0, 512)}


@pytest.mark.parametrize("name", sorted(H15_SHAPES))
def test_bf16_p_rounding_stays_within_tolerance_h15(name):
    """Rounding P to bf16 (relative error at most 2^-9 per weight) keeps
    the output within ``allclose(rtol=1e-2, atol=1e-2)`` of the plain
    version (an element's bound is 1e-2 + 1e-2·|plain|; ``ATTN_TOL[bf16]``),
    which keeps P in float32: evidence for H15 before any card run."""
    BH, Sq, Sk, Dh, causal, window, q_offset = H15_SHAPES[name]
    gen = torch.Generator().manual_seed(15)
    q, k, v = (torch.randn((BH, S, Dh), generator=gen).to(torch.bfloat16)
               for S in (Sq, Sk, Sk))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    got = _bf16_kernel_model(q, k, v, BK=64 if Dh == 256 else 128, **kw)
    want = flash_attention_plain(q, k, v, **kw)
    torch.testing.assert_close(got.to(torch.float32), want.to(torch.float32),
                               rtol=TOL["bfloat16"], atol=TOL["bfloat16"])


def _bf16_decode_model(q, kc, vc, pos):
    """The bf16 decode kernel's numerics at Dh 64 in float32 on the CPU:
    S from the bf16 inputs, the weights p in float32 for l and rounded to
    bf16 for P·V, the output rounded once."""
    s = torch.einsum("bkrd,bskd->bkrs", q.float(), kc.float()) / math.sqrt(
        q.shape[-1])
    live = torch.arange(kc.shape[1])[None, :] <= pos[:, None]
    s = s.masked_fill(~live[:, None, None, :], -math.inf)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    pb = p.to(torch.bfloat16).float()
    out = torch.einsum("bkrs,bskd->bkrd", pb, vc.float()) / p.sum(-1, keepdim=True)
    return out.to(torch.bfloat16)


@pytest.mark.parametrize("S,rep", [(552, 3), (4096, 3), (777, 16)])
def test_bf16_decode_p_rounding_stays_within_tolerance_h15(S, rep):
    """The decode kernel's tensor-core route (bf16, Dh 64) rounds P the
    same way: within ``allclose(rtol=1e-2, atol=1e-2)`` of the plain
    version (``ATTN_TOL[bf16]``) at the serve cache length, a longer cache
    and the most heads per kv group."""
    gen = torch.Generator().manual_seed(S + rep)
    B, KV, Dh = 2, 2, 64
    q = torch.randn((B, KV, rep, Dh), generator=gen).to(torch.bfloat16)
    kc, vc = (torch.randn((B, S, KV, Dh), generator=gen).to(torch.bfloat16)
              for _ in range(2))
    pos = torch.tensor([S - 1, S // 3], dtype=torch.int32)
    got = _bf16_decode_model(q, kc, vc, pos)
    want = decode_attention_plain(q, kc, vc, pos)
    torch.testing.assert_close(got.float(), want.float(), rtol=TOL["bfloat16"],
                               atol=TOL["bfloat16"])


# --------------------------------------------------------------------------
# the backward: flash_attention_backward_plain and the autograd Function
# --------------------------------------------------------------------------
# (B, Sq, Sk, H, Dh, causal, window, q_offset); H None is the folded
# (BH, S, Dh) layout
BACKWARD = {
    "causal": (2, 37, 37, 3, 64, True, 0, 0),
    "non-causal": (2, 29, 29, 2, 64, False, 0, 0),
    "window": (1, 53, 53, 2, 128, True, 11, 0),
    "q-offset": (2, 20, 61, 2, 64, True, 0, 41),
    "ragged-sk": (1, 24, 70, 3, 128, False, 0, 0),
    "masked-rows": (2, 16, 16, 2, 64, True, 4, 12),  # rows 7.. see no key
    "window-non-causal": (1, 31, 31, 2, 64, False, 6, 0),
    "folded": (6, 45, 45, None, 128, True, 0, 0),
    "folded-window": (4, 33, 40, None, 64, True, 9, 7),
}


def _backward_inputs(case, seed):
    B, Sq, Sk, H, Dh, causal, window, q_offset = case
    gen = torch.Generator().manual_seed(seed)
    shape = (lambda S: (B, S, Dh)) if H is None else (lambda S: (B, S, H, Dh))
    q, k, v = (torch.randn(shape(S), generator=gen, dtype=torch.float64)
               .float() for S in (Sq, Sk, Sk))
    return (q, k, v), dict(causal=causal, window=window, q_offset=q_offset)


@pytest.mark.parametrize("name", sorted(BACKWARD))
def test_flash_backward_plain_and_function_match_autograd(name):
    """In float32, ``flash_attention_backward_plain`` from the saved
    log-sum-exp and the ``FlashAttention`` Function on the CPU give the
    gradients ``torch.autograd`` takes through ``flash_attention_plain``:
    the softmax backward rebuilt from P = exp(S − lse) and Σ dO∘O instead
    of Σ dP∘P, equal up to float association (``atol = rtol = 1e-5``). A
    row with no live key has lse −inf and gradient 0 on every side."""
    (q, k, v), kw = _backward_inputs(BACKWARD[name], len(name))
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = flash_attention_plain(*leaves, **kw)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(1))
    want = torch.autograd.grad(out, leaves, g)

    out2, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    torch.testing.assert_close(out2, out.detach(), rtol=0, atol=0)
    B, Sq = q.shape[0], q.shape[1]
    assert lse.shape == ((B, Sq) if q.dim() == 3 else (B, q.shape[2], Sq))
    got = flash_attention_backward_plain(q, k, v, out2, lse, g, **kw)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out3 = FlashAttention.apply(*leaves, kw["causal"], kw["window"],
                                kw["q_offset"])
    torch.testing.assert_close(out3, out.detach(), rtol=0, atol=0)
    via_fn = torch.autograd.grad(out3, leaves, g)
    for what, grads in (("plain", got), ("Function", via_fn)):
        for n, a, b in zip("qkv", grads, want):
            assert a.shape == b.shape and a.dtype == b.dtype, (what, n)
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5,
                                       msg=f"{name} {what} d{n}")
    if name == "masked-rows":  # every key lies before the window (H12)
        dead = ~torch.isfinite(lse)
        assert dead.any() and not dead.all()
        assert torch.equal(got[0][:, 7:], torch.zeros_like(got[0][:, 7:]))


def test_flash_backward_plain_rounds_p_and_ds_as_the_kernels():
    """In bf16 the plain backward rounds P before Pᵀ·dO and dS before its two
    products, as the kernels do (and as autograd of ``full_attention``
    rounds dS): within two bf16 ulps (``TOL["bfloat16"]``) of the float32
    gradients of the same bf16 inputs, and not equal to them."""
    (q, k, v), kw = _backward_inputs(BACKWARD["causal"], 3)
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    out, lse = flash_attention_plain(q, k, v, return_lse=True, **kw)
    g = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)
                    ).to(torch.bfloat16)
    got = flash_attention_backward_plain(q, k, v, out, lse, g, **kw)
    f32 = [x.float() for x in (q, k, v, out, lse, g)]
    want = flash_attention_backward_plain(*f32, **kw)
    for n, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16, n
        scale = float(b.abs().max())
        torch.testing.assert_close(a.float() / scale, b / scale,
                                   rtol=TOL["bfloat16"], atol=TOL["bfloat16"],
                                   msg=f"d{n}")
    assert not all(torch.equal(a.float(), b) for a, b in zip(got, want))


def test_flash_backward_cuda_refuses_cpu_tensors():
    """The backward kernel's wrapper raises on the CPU (the Function takes
    the plain backward there)."""
    q = torch.zeros((2, 8, 64), dtype=torch.bfloat16)
    lse = torch.zeros((2, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        flash_attention_backward_cuda(q, q, q, q, lse, q)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        m = q.to("meta").requires_grad_()
        FlashAttention.apply(m, m, m, True, 0, 0)


@pytest.mark.parametrize("device_type,dtype,head_dim,kernels", [
    ("cuda", torch.bfloat16, 64, True), ("cuda", torch.bfloat16, 128, True),
    ("cuda", torch.bfloat16, 256, False), ("cuda", torch.bfloat16, 16, False),
    ("cuda", torch.float32, 64, False), ("cuda", torch.float16, 64, False),
    ("cpu", torch.bfloat16, 64, False), ("cpu", torch.float32, 128, False),
    ("meta", torch.bfloat16, 64, False)])
def test_auto_route_takes_the_kernel_pair_only_on_cuda_bf16(device_type, dtype,
                                                            head_dim, kernels):
    """``auto`` takes the flash kernel pair for a CUDA bf16 q with a head
    dim the backward kernel takes, and nothing else: a pure function of
    device type, dtype and Dh, so no card is needed to check it."""
    assert BACKWARD_HEAD_DIMS == (64, 128)
    assert layers.flash_route(device_type, dtype, head_dim) is kernels


def test_auto_route_off_the_card_stays_plain():
    """On the CPU ``auto`` keeps its plain routes, gradient or not: no
    ``FlashAttention`` node in the graph, and the same values as ``full``."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((1, 24, 2, 64), generator=gen).to(torch.bfloat16)
               .requires_grad_() for _ in range(3))
    out = layers.attention_any(q, k, v, causal=True, impl="auto")
    assert "FlashAttention" not in type(out.grad_fn).__name__
    torch.testing.assert_close(out, layers.full_attention(q, k, v, causal=True),
                               rtol=0, atol=0)
    fl = layers.attention_any(q, k, v, causal=True, impl="pallas")
    assert "FlashAttention" in type(fl.grad_fn).__name__
