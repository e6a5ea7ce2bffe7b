"""Parity of the port's moe, ssm, hybrid, vlm and encdec families with
``repro``'s.

The six ``reduced()`` configs (grok-1, arctic, mamba2, recurrentgemma,
internvl2, whisper) in float32 on the CPU. ``repro``'s weights
(``api.init_model`` on a ``jax.random`` key) are carried across with
``params_from_jax``; tokens, patches and frames come from
``np.random.default_rng``. ``repro`` runs its XLA route (``attn_impl``
"auto"); the port runs "auto" under autograd and "pallas" (the kernels'
plain versions on the CPU) for prefill and decode. Tolerance for every
logit, loss, gradient and cache: ``atol = rtol = 1e-4`` (float32 through a
few layers, summed in another order), as ``tests/test_torch_lm.py``; the
layer pieces within ``1e-5``.
"""
import contextlib
import dataclasses
import io
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import encdec as JED  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402
from repro.models import rglru as JRG  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import api, module  # noqa: E402
from repro_torch.models import encdec as ED  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402
from repro_torch.models import rglru as RG  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

ARCHS = ["grok-1-314b", "arctic-480b", "mamba2-130m", "recurrentgemma-9b",
         "internvl2-76b", "whisper-small"]
TOL = 1e-4
PIECE_TOL = 1e-5
B = 2
CPU = torch.device("cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(got.detach().to(torch.float32).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _cfgs(arch, impl="auto", **kw):
    return (dataclasses.replace(jax_get_config(arch).reduced(),
                                attn_impl=impl, **kw),
            dataclasses.replace(get_config(arch).reduced(), attn_impl=impl,
                                **kw))


def _prompt_len(cfg):
    # past the hybrid's window of 16, so the ring buffer wraps; past the
    # ssm chunk of 8 and not a multiple of it
    return 20 if cfg.window else 12


def _inputs(cfg, seed, S):
    """``repro``'s batch dict (numpy): tokens and labels, and the stub
    patches or frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        batch["patches"] = rng.normal(
            size=(B, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


@pytest.fixture(scope="module")
def jax_weights():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = jax.jit(jax_api.init_model, static_argnums=1)(
                jax.random.key(0), jax_get_config(arch).reduced())
        return cache[arch]
    return get


def _paths(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_jax_and_init_layout(arch, jax_weights):
    """Key for key and shape for shape: the port's own ``init_model`` draws
    the tree ``repro``'s does (the MoE experts stacked on a leading E axis,
    the rec and ssm blocks, ``patch_proj``, ``enc_layers``/``dec_layers``),
    and ``params_from_jax`` carries the values. Λ and A_log are not random:
    the port draws them as ``repro`` does."""
    jp = jax_weights(arch)
    _, pc = _cfgs(arch)
    want = _paths(jp)
    got = module.tree_paths(params_from_jax(jp, device=CPU))
    own = module.tree_paths(api.init_model(torch.Generator().manual_seed(0), pc))
    assert set(got) == set(want) == set(own)
    for path, leaf in got.items():
        assert tuple(leaf.shape) == want[path].shape == tuple(own[path].shape)
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
        if path.endswith(("/lam", "/A_log")):
            np.testing.assert_allclose(own[path].numpy(), want[path],
                                       rtol=1e-6, err_msg=path)


# ---------------------------------------------------------------------------
# forward, loss and gradient
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradient_match_repro(arch, jax_weights):
    jc, pc = _cfgs(arch)
    jp = jax_weights(arch)
    batch = _inputs(jc, 1, _prompt_len(jc))
    tb = {k: _t(v) for k, v in batch.items()}
    params = params_from_jax(jp, device=CPU)

    _close(api.forward(params, tb, pc),
           jax.jit(lambda p, b: jax_api.forward(p, b, jc))(jp, batch),
           f"{arch} forward")
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jax_api.loss_fn(p, b, jc)))(jp, batch)
    leaves = module.tree_paths(params)
    for v in leaves.values():
        v.requires_grad_(True)
    loss_p = api.loss_fn(params, tb, pc)
    grads_p = torch.autograd.grad(loss_p, list(leaves.values()))
    _close(loss_p, loss_j, f"{arch} loss")
    want = _paths(grads_j)
    for path, g in zip(leaves, grads_p):
        _close(g, want[path], f"{arch} d loss / d {path}")


# ---------------------------------------------------------------------------
# prefill and decode
# ---------------------------------------------------------------------------
def _grow_jax(cfg, caches, new_len):
    full = jax_api.make_caches(cfg, B, new_len)

    def copy_prefix(z, c):
        if z.shape == c.shape:
            return c
        axis = [i for i, (a, b) in enumerate(zip(z.shape, c.shape)) if a != b][0]
        pad = [(0, z.shape[i] - c.shape[i]) if i == axis else (0, 0)
               for i in range(z.ndim)]
        return jnp.pad(c, pad)

    return jax.tree.map(copy_prefix, full, caches)


def _close_caches(got, want, what):
    want = _paths(want)
    got = module.tree_paths(got)
    assert set(got) == set(want), what
    for path, v in got.items():
        _close(v, want[path], f"{what}: cache {path}")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_repro(arch, jax_weights):
    """Prefill logits and every cache, then 4 decode steps (logits and every
    cache after each): the port under ``attn_impl="pallas"`` against
    ``repro``'s ``lm_decode_step`` / ``encdec_decode_step``."""
    jc, _ = _cfgs(arch)
    _, pc = _cfgs(arch, "pallas")
    jp = jax_weights(arch)
    P = _prompt_len(jc)
    batch = _inputs(jc, 2, P)
    del batch["labels"]
    tb = {k: _t(v) for k, v in batch.items()}
    params = params_from_jax(jp, device=CPU)
    offset = jc.n_patches if jc.family == "vlm" else 0
    total = offset + P + 4 + 8

    with torch.inference_mode():
        logits_p, caches_p = api.prefill(params, tb, pc)
    logits_j, caches_j = jax.jit(lambda p, b: jax_api.prefill(p, b, jc))(
        jp, batch)
    _close(logits_p, logits_j, f"{arch} prefill logits")
    _close_caches(caches_p, caches_j, f"{arch} prefill")

    caches_j = _grow_jax(jc, caches_j, total)
    caches_p = module.tree_map(port_serve._grow,
                               api.make_caches(pc, B, total, device=CPU),
                               caches_p)
    rng = np.random.default_rng(3)
    step_j = jax.jit(lambda p, c, b: jax_api.decode_step(p, c, b, jc))
    for i in range(4):
        tok = rng.integers(0, jc.vocab, (B,)).astype(np.int32)
        pos = np.full((B,), offset + P + i, np.int32)
        logits_j, caches_j = step_j(jp, caches_j, {"token": tok, "pos": pos})
        with torch.inference_mode():
            logits_p, caches_p = api.decode_step(
                params, caches_p, {"token": _t(tok), "pos": _t(pos)}, pc)
        _close(logits_p, logits_j, f"{arch} decode step {i} logits")
        _close_caches(caches_p, caches_j, f"{arch} decode step {i}")


# ---------------------------------------------------------------------------
# pinned hazards: MoE capacity and router ties, SSD chunking, the RG-LRU scan
# ---------------------------------------------------------------------------
def _jit(fn, cfg):
    """``repro``'s ``fn(params, x, cfg)`` under ``jax.jit`` (eager JAX
    dispatches every op of its loops one by one)."""
    return jax.jit(lambda p, x: fn(p, x, cfg))


def _moe_case(arch, S, seed, **kw):
    jc, pc = _cfgs(arch, **kw)
    jp = jax_weights_layer(arch)
    x = np.random.default_rng(seed).normal(size=(B, S, jc.d_model)).astype(
        np.float32)
    return jc, pc, jp, x


def jax_weights_layer(arch):
    jc, _ = _cfgs(arch)
    return JMOE.init_moe(jax.random.key(1), jc.d_model, jc.d_ff, jc.n_experts,
                         jc.act, jnp.float32, jc.dense_residual)


def _jax_kept(x, router, cfg, S):
    """``repro``'s kept (token, k) pairs, composed from its own steps
    (``moe.py:55-71``): top-k by ``lax.top_k``, slots by the cumulative
    count over the flattened (S·K) axis."""
    cap = JMOE.moe_capacity(S, cfg.n_experts, cfg.top_k, cfg.capacity_factor)
    gates = jax.nn.softmax(jnp.einsum("bsd,de->bse", x, router), axis=-1)
    _, topi = jax.lax.top_k(gates, cfg.top_k)
    onehot = jax.nn.one_hot(topi, cfg.n_experts, dtype=jnp.int32)
    flat = onehot.reshape(B, S * cfg.top_k, cfg.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(onehot.shape)
    within = ((pos < cap) & (onehot > 0)).any(-1)
    return np.asarray(topi), np.asarray(within)


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_overflow_keeps_repros_pairs_exactly(arch):
    """capacity_factor 0.25 over 32 tokens: 64 (token, k) pairs into 4
    experts of 8 slots, so pairs overflow. The kept set is ``repro``'s bit
    for bit, and the layer's output (arctic: with its dense residual)
    agrees."""
    S = 32
    jc, pc, jp, x = _moe_case(arch, S, 4, capacity_factor=0.25)
    p = params_from_jax(jp, device=CPU)
    topi_j, kept_j = _jax_kept(x, jp["router"], jc, S)
    _, _, topi_p = MOE.route(_t(x), p["router"], pc.top_k)
    cap = MOE.moe_capacity(S, pc.n_experts, pc.top_k, pc.capacity_factor)
    _, kept_p = MOE.expert_slots(topi_p, pc.n_experts, cap)
    np.testing.assert_array_equal(topi_p.numpy(), topi_j)
    np.testing.assert_array_equal(kept_p.numpy(), kept_j)
    assert cap == 8 and 0 < kept_j.sum() < kept_j.size  # some dropped
    _close(MOE.apply_moe(p, _t(x), pc), JMOE.apply_moe(jp, x, jc),
           f"{arch} apply_moe with overflow", PIECE_TOL)


def test_moe_router_tie_takes_lax_top_k_order_h2():
    """A zero router ties every expert: ``lax.top_k`` takes experts 0 and 1
    for every token (the lower index first), and so must the port; with
    64 pairs on two experts of 24 slots, which pairs overflow depends on
    that order."""
    S = 32
    jc, pc, jp, x = _moe_case("grok-1-314b", S, 5)
    jp = dict(jp, router=jnp.zeros_like(jp["router"]))
    p = params_from_jax(jp, device=CPU)
    topi_j, kept_j = _jax_kept(x, jp["router"], jc, S)
    _, topv_p, topi_p = MOE.route(_t(x), p["router"], pc.top_k)
    assert (topi_j == np.array([0, 1])).all()
    np.testing.assert_array_equal(topi_p.numpy(), topi_j)
    np.testing.assert_array_equal(topv_p.numpy(), 0.5)
    cap = MOE.moe_capacity(S, pc.n_experts, pc.top_k, pc.capacity_factor)
    np.testing.assert_array_equal(
        MOE.expert_slots(topi_p, pc.n_experts, cap)[1].numpy(), kept_j)
    assert not kept_j.all()
    _close(MOE.apply_moe(p, _t(x), pc), JMOE.apply_moe(jp, x, jc),
           "apply_moe on a tied router", PIECE_TOL)


def test_aux_load_balance_loss_matches_repro():
    jc, pc, jp, x = _moe_case("grok-1-314b", 16, 6)
    logits = jnp.einsum("bsd,de->bse", x, jp["router"])
    _, topi = jax.lax.top_k(jax.nn.softmax(logits, -1), jc.top_k)
    _close(MOE.aux_load_balance_loss(_t(logits), _t(topi).long(),
                                     pc.n_experts),
           JMOE.aux_load_balance_loss(logits, topi, jc.n_experts),
           "aux loss", PIECE_TOL)


def test_bf16_whisper_encoder_follows_repros_promotion_h23():
    """H23: float32 frames run a bf16 whisper's encoder in float32, as JAX's
    promotion runs ``repro``'s: the port's ``encode`` on ``repro``'s bf16
    weights gives ``repro``'s float32 states within 1e-4. ``repro``'s bf16
    decoder then raises (the float32 cross-attention turns its layer
    scan's carry float32); the port's decoder stays bf16, its caches in the
    model's dtype, its logits finite and within 0.1 of the same weights'
    float32 decoder."""
    jc, pc = _cfgs("whisper-small", dtype="bfloat16")
    jp = jax.jit(jax_api.init_model, static_argnums=1)(jax.random.key(0), jc)
    p = params_from_jax(jp, device=CPU)
    batch = _inputs(jc, 5, 6)
    want = jax.jit(JED.encode, static_argnums=2)(jp, batch["frames"], jc)
    got = ED.encode(p, _t(batch["frames"]), pc)
    assert want.dtype == jnp.float32 and got.dtype == torch.float32
    _close(got, want, "encoder states")
    with pytest.raises(TypeError, match="carry"):
        jax_api.prefill(jp, {k: batch[k] for k in ("tokens", "frames")}, jc)
    inputs = {"tokens": _t(batch["tokens"]), "frames": _t(batch["frames"])}
    with torch.inference_mode():
        logits, caches = api.prefill(p, inputs, pc)
        ref, _ = api.prefill(module.cast_tree(p, torch.float32), inputs,
                             dataclasses.replace(pc, dtype="float32"))
    assert logits.dtype == torch.bfloat16 and bool(torch.isfinite(logits).all())
    assert {c.dtype for c in caches.values()} == {torch.bfloat16}
    assert float((logits.float() - ref).abs().max()) < 0.1


@pytest.mark.parametrize("S", [5, 12, 21])
def test_ssm_chunking_matches_repro_and_the_recurrence(S):
    """The chunked SSD at S below the chunk (8), above it and not a
    multiple of it (the dt = 0 padding): against ``repro``'s
    ``apply_ssm_train``, the port's and ``repro``'s sequential oracles;
    the prefill's final state and conv tail against ``repro``'s
    ``_ssm_prefill``, and one decode step from there against the oracle
    over S + 1 tokens."""
    jc, pc = _cfgs("mamba2-130m")
    jp = JSSM.init_ssm_block(jax.random.key(2), jc, jnp.float32)
    p = params_from_jax(jp, device=CPU)
    x = np.random.default_rng(S).normal(size=(B, S + 1, jc.d_model)).astype(
        np.float32)
    xs = x[:, :S]
    got = SSM.apply_ssm_train(p, _t(xs), pc)
    _close(got, _jit(JSSM.apply_ssm_train, jc)(jp, xs), f"S={S} train",
           PIECE_TOL)
    _close(SSM.ssm_sequential_reference(p, _t(xs), pc),
           _jit(JSSM.ssm_sequential_reference, jc)(jp, xs), f"S={S} oracle",
           PIECE_TOL)
    _close(got, SSM.ssm_sequential_reference(p, _t(xs), pc).numpy(),
           f"S={S} chunked vs recurrence", PIECE_TOL)
    y, cache = SSM.ssm_prefill(p, _t(xs), pc)
    _, want = _jit(JTF._ssm_prefill, jc)(jp, xs)
    _close(cache["state"], want["state"], f"S={S} prefill state", PIECE_TOL)
    _close(cache["conv"], want["conv"], f"S={S} conv tail", PIECE_TOL)
    out, _ = SSM.apply_ssm_decode(p, _t(x[:, S:]), cache, pc)
    _close(out[:, 0], SSM.ssm_sequential_reference(p, _t(x), pc)[:, S].numpy(),
           f"S={S} decode after prefill", PIECE_TOL)


@pytest.mark.parametrize("S", [7, 33])
def test_rglru_scan_state_matches_repros_associative_scan(S):
    """The Hillis-Steele scan against ``lax.associative_scan``: the prefill's
    final state and conv tail (``repro``'s ``_rglru_prefill``) and the
    block's output within 1e-5, and the sequential oracle."""
    jc, pc = _cfgs("recurrentgemma-9b")
    jp = JRG.init_rglru_block(jax.random.key(3), jc, jnp.float32)
    p = params_from_jax(jp, device=CPU)
    x = np.random.default_rng(S).normal(size=(B, S, jc.d_model)).astype(
        np.float32)
    y, cache = RG.rglru_prefill(p, _t(x), pc)
    y_j, want = _jit(JTF._rglru_prefill, jc)(jp, x)
    _close(cache["h"], want["h"], f"S={S} state", PIECE_TOL)
    _close(cache["conv"], want["conv"], f"S={S} conv tail", PIECE_TOL)
    _close(y, y_j, f"S={S} output", PIECE_TOL)
    _close(RG.apply_rglru_train(p, _t(x), pc),
           _jit(JRG.rglru_sequential_reference, jc)(jp, x), f"S={S} vs oracle",
           PIECE_TOL)
    a = torch.rand((B, S, 3), generator=torch.Generator().manual_seed(S))
    b = torch.randn((B, S, 3), generator=torch.Generator().manual_seed(S + 1))
    h, want_h = torch.zeros((B, 3)), []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want_h.append(h)
    _close(RG.linear_scan(a, b), torch.stack(want_h, 1).numpy(),
           f"S={S} linear_scan", PIECE_TOL)


@pytest.mark.parametrize("S", [7, 33])
def test_rglru_sequential_reference_matches_repros(S):
    """The port's step-by-step oracle against ``repro``'s
    ``rglru_sequential_reference`` within 1e-5, and against the port's
    scan train path."""
    jc, pc = _cfgs("recurrentgemma-9b")
    jp = JRG.init_rglru_block(jax.random.key(5), jc, jnp.float32)
    p = params_from_jax(jp, device=CPU)
    x = np.random.default_rng(100 + S).normal(
        size=(B, S, jc.d_model)).astype(np.float32)
    got = RG.rglru_sequential_reference(p, _t(x), pc)
    assert got.shape == (B, S, jc.d_model)
    _close(got, _jit(JRG.rglru_sequential_reference, jc)(jp, x),
           f"S={S} oracle vs repro's", PIECE_TOL)
    _close(RG.apply_rglru_train(p, _t(x), pc), got.numpy(),
           f"S={S} scan vs oracle", PIECE_TOL)


# ---------------------------------------------------------------------------
# the commands
# ---------------------------------------------------------------------------
def _repro_serve_tokens(argv):
    out = io.StringIO()
    saved = sys.argv
    sys.argv = ["serve"] + argv
    try:
        with contextlib.redirect_stdout(out):
            jax_serve.main()
    finally:
        sys.argv = saved
    match = re.search(r"sample tokens\[0\]: (\[.*\])", out.getvalue())
    return eval(match.group(1))  # a printed list of ints


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-130m",
                                  "recurrentgemma-9b", "internvl2-76b",
                                  "whisper-small"])
def test_serve_greedy_tokens_match_repro(arch, jax_weights):
    """One arch of each family: ``repro_torch.launch.serve`` under ``--attn-impl pallas`` on
    ``repro``'s weights gives ``repro.launch.serve``'s greedy tokens (the
    vlm patches and encdec frames drawn after the prompt, the vlm decode
    offset, the cache length offset + P + gen + 8); no kernel launched on
    the CPU."""
    argv = ["--arch", arch, "--reduced", "--temperature", "0", "--gen", "6"]
    want = _repro_serve_tokens(argv)
    args = port_serve.build_parser().parse_args(
        argv + ["--device", "cpu", "--attn-impl", "pallas"])
    cfg = port_serve.config_from_args(args)
    fl0, dec0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    res = port_serve.serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           gen=args.gen, temperature=0.0, seed=args.seed,
                           device="cpu",
                           params=params_from_jax(jax_weights(arch), device=CPU))
    assert res.tokens.shape == (args.batch, args.gen + 1)
    assert res.tokens[0][:16].tolist() == want
    assert (flash_attention_cuda.launches,
            decode_attention_cuda.launches) == (fl0, dec0)


@pytest.mark.parametrize("arch", ["grok-1-314b", "mamba2-130m",
                                  "recurrentgemma-9b"])
def test_sync_cli_matches_repro(arch, jax_weights, monkeypatch):
    """``launch.train --reduced --mode sync`` of moe, ssm and hybrid, on
    ``repro``'s seed-0 weights: the printed losses of 3 AdamW steps."""
    monkeypatch.setattr(api, "init_model", lambda gen, cfg: params_from_jax(
        jax_weights(arch), device=gen.device))
    argv = ["--arch", arch, "--reduced", "--mode", "sync", "--steps", "3",
            "--batch", "4", "--seq", "16", "--log-every", "1", "--device",
            "cpu"]
    args = port_train.build_parser().parse_args(argv)
    with contextlib.redirect_stdout(io.StringIO()):
        got = port_train.main(argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_train.run_sync(jax_get_config(arch).reduced(), args)
    want = [float(ln.split("loss ")[1].split()[0])
            for ln in out.getvalue().splitlines() if ln.startswith("step ")]
    assert len(got.losses) == len(want) == 3
    np.testing.assert_allclose(got.losses, want, rtol=1e-4)


@pytest.mark.parametrize("arch", ["internvl2-76b", "whisper-small"])
def test_train_refuses_vlm_and_encdec_as_repro_does(arch):
    argv = ["--arch", arch, "--reduced", "--mode", "sync", "--device", "cpu"]
    with pytest.raises(SystemExit) as got:
        port_train.main(argv)
    saved = sys.argv
    sys.argv = ["train"] + argv[:-2]
    try:
        with pytest.raises(SystemExit) as want:
            jax_train.main()
    finally:
        sys.argv = saved
    assert got.value.code == want.value.code == (
        "use the family-specific example drivers for stub-frontend archs")
