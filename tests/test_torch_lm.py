"""Parity of the port's LM serving path with ``repro``'s.

Reduced float32 configs of the four dense architectures. ``repro``'s
weights (``api.init_model`` on a ``jax.random`` key) are carried across
with ``params_from_jax``; token ids come from ``np.random.default_rng``.
``repro`` runs its Pallas flash kernel in interpret mode under
``attn_impl="pallas"``. Tolerance for every logit and cache: ``atol =
rtol = 1e-4`` (float32 through a few layers, summed in another order); the
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

from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs import list_configs as jax_list_configs  # noqa: E402
from repro.launch import serve as jax_serve  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import transformer as JTF  # noqa: E402
from repro_torch.configs import SHAPES, get_config, list_configs  # noqa: E402
from repro_torch.kernels.decode_attention import decode_attention_cuda  # noqa: E402
from repro_torch.kernels.flash_attention import flash_attention_cuda  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.models import api, module  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402

DENSE = ["smollm-360m", "gemma-2b", "chatglm3-6b", "mistral-large-123b"]
TOL = 1e-4
B, S = 2, 12


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, what, tol=TOL):
    got = got.detach().to(torch.float32).numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _cfgs(arch, impl):
    jc = dataclasses.replace(jax_get_config(arch).reduced(), attn_impl=impl)
    pc = dataclasses.replace(get_config(arch).reduced(), attn_impl=impl)
    return jc, pc


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


def _grow_port(cfg, caches, new_len):
    return module.tree_map(port_serve._grow,
                           api.make_caches(cfg, B, new_len, device="cpu"),
                           caches)


# ---------------------------------------------------------------------------
# configs and weights
# ---------------------------------------------------------------------------
def test_configs_are_repros_field_for_field():
    assert list_configs() == tuple(n for n in jax_list_configs()
                                   if n != "olaf-ppo")
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()}
    for name in list_configs():
        jc, pc = jax_get_config(name), get_config(name)
        assert dataclasses.asdict(pc) == dataclasses.asdict(jc), name
        assert dataclasses.asdict(pc.reduced()) == dataclasses.asdict(jc.reduced())
        for shape in SHAPES.values():
            assert pc.supports(shape) == jc.supports(JAX_SHAPES[shape.name])
        if not jc.n_heads:
            continue  # attention-free (mamba2)
        for c, j in ((pc, jc), (dataclasses.replace(pc, tp_size=16),
                                dataclasses.replace(jc, tp_size=16))):
            assert (c.hd, c.attn_mode, c.padded_heads) == (j.hd, j.attn_mode,
                                                          j.padded_heads), name
            np.testing.assert_array_equal(c.kv_head_map(), j.kv_head_map())


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_jax_and_init_layout(arch):
    """Key for key and shape for shape: the port's own ``init_lm`` draws the
    same tree ``repro``'s does, and ``params_from_jax`` carries the values."""
    jc, pc = _cfgs(arch, "full")
    jp = jax_api.init_model(jax.random.key(0), jc)
    carried = TF.params_from_jax(jp, device="cpu")
    own = api.init_model(torch.Generator().manual_seed(0), pc)
    want = {"/".join(str(k.key) for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got, drawn = module.tree_paths(carried), module.tree_paths(own)
    assert set(got) == set(want) == set(drawn)
    for path, leaf in got.items():
        assert leaf.dtype == torch.float32 and tuple(leaf.shape) == want[path].shape
        np.testing.assert_array_equal(leaf.numpy(), want[path], err_msg=path)
        assert tuple(drawn[path].shape) == want[path].shape, path
    assert module.count_params(carried) == module.count_params(own)


def test_params_from_jax_carries_bf16_bits():
    jc = dataclasses.replace(jax_get_config("smollm-360m").reduced(),
                             dtype="bfloat16")
    jp = jax_api.init_model(jax.random.key(1), jc)
    carried = TF.params_from_jax(jp, device="cpu")
    wq = np.array(jp["layers"]["sub_0"]["attn"]["wq"])
    got = carried["layers"]["sub_0"]["attn"]["wq"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                  wq.view(np.int16))
    cast = module.cast_tree(carried, torch.float32)
    np.testing.assert_array_equal(cast["layers"]["sub_0"]["attn"]["wq"].numpy(),
                                  wq.astype(np.float32))


# ---------------------------------------------------------------------------
# layer pieces
# ---------------------------------------------------------------------------
def test_layer_pieces_match_repro():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 7, 32)).astype(np.float32)
    scale = rng.normal(size=32).astype(np.float32)
    bias = rng.normal(size=32).astype(np.float32)
    _close(L.rmsnorm({"scale": _t(scale)}, _t(x)),
           JL.rmsnorm({"scale": scale}, x), "rmsnorm", 1e-5)
    _close(L.layernorm({"scale": _t(scale), "bias": _t(bias)}, _t(x)),
           JL.layernorm({"scale": scale, "bias": bias}, x), "layernorm", 1e-5)
    h = rng.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = np.arange(7)[None, :] + np.array([[0], [40]])
    for rd in (None, 8):
        _close(L.apply_rope(_t(h), _t(pos), 1e4, rd),
               JL.apply_rope(h, pos, 1e4, rd), f"rope rd={rd}", 1e-5)
    mlp = {k: rng.normal(size=s).astype(np.float32) / 5 for k, s in
           (("wg", (32, 48)), ("wu", (32, 48)), ("wd", (48, 32)),
            ("w1", (32, 48)), ("w2", (48, 32)))}
    tm = {k: _t(v) for k, v in mlp.items()}
    for act in ("silu", "geglu", "gelu"):
        _close(L.apply_mlp(tm, _t(x), act), JL.apply_mlp(mlp, x, act),
               f"mlp {act}", 1e-5)
    emb = {"embed": rng.normal(size=(40, 32)).astype(np.float32)}
    tok = rng.integers(0, 40, (2, 7))
    _close(L.embed({"embed": _t(emb["embed"])}, _t(tok), True),
           JL.embed(emb, tok, True), "embed", 1e-5)
    _close(L.unembed({"embed": _t(emb["embed"])}, _t(x), true_vocab=33),
           JL.unembed(emb, x, true_vocab=33), "unembed", 1e-5)
    logits = rng.normal(size=(2, 7, 40)).astype(np.float32)
    _close(L.cross_entropy(_t(logits), _t(tok)),
           JL.cross_entropy(logits, tok), "cross_entropy", 1e-5)


@pytest.mark.parametrize("causal,window,q_offset", [(True, 0, 0), (True, 6, 0),
                                                    (False, 0, 0), (True, 0, 9)])
def test_attention_strategies_match_repro(causal, window, q_offset):
    rng = np.random.default_rng(window + q_offset)
    q = rng.normal(size=(2, 21, 4, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 21 + q_offset, 4, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_offset=q_offset)
    want = JL.full_attention(q, k, v, **kw)
    _close(L.full_attention(_t(q), _t(k), _t(v), **kw), want, "full", 1e-5)
    _close(L.chunked_attention(_t(q), _t(k), _t(v), q_chunk=8, k_chunk=8, **kw),
           JL.chunked_attention(q, k, v, q_chunk=8, k_chunk=8, **kw),
           "chunked", 1e-5)
    _close(L.attention_any(_t(q), _t(k), _t(v), impl="pallas", **kw), want,
           "pallas route", 1e-5)
    pos = np.array([3, 20], np.int32)
    _close(L.decode_attention(_t(q[:, :1]), _t(k), _t(v), _t(pos)),
           JL.decode_attention(q[:, :1], k, v, pos), "decode", 1e-5)


@pytest.mark.parametrize("impl", ["full", "pallas"])
def test_windowed_attention_layer_matches_repro(impl):
    """recurrentgemma's local-attention layer: the prefill ring buffer and
    the windowed decode (the whole family: tests/test_torch_families.py)."""
    jc, pc = _cfgs("recurrentgemma-9b", impl)
    p_j = JTF.init_layer(jax.random.key(4), jc, "attn")
    p_t = TF.params_from_jax(p_j, device="cpu")
    rng = np.random.default_rng(4)
    P = jc.window + 5
    x = rng.normal(size=(B, P, jc.d_model)).astype(np.float32)
    positions = np.arange(P)[None, :]
    yj, cj = JTF.apply_layer_prefill(p_j, x, jc, "attn", positions)
    yt, ct = TF.apply_layer_prefill(p_t, _t(x), pc, "attn", _t(positions))
    _close(yt, yj, "windowed prefill")
    for key in ("k", "v"):
        _close(ct[key], cj[key], f"ring buffer {key}")
    for step in range(3):
        xs = rng.normal(size=(B, 1, jc.d_model)).astype(np.float32)
        pos = np.full((B,), P + step, np.int32)
        yj, cj = JTF.apply_layer_decode(p_j, xs, cj, pos, jc, "attn")
        yt, ct = TF.apply_layer_decode(p_t, _t(xs), ct, _t(pos), pc, "attn")
        _close(yt, yj, f"windowed decode {step}")
        _close(ct["k"], cj["k"], f"windowed cache {step}")


# ---------------------------------------------------------------------------
# the model: forward, prefill, teacher-forced decode
# ---------------------------------------------------------------------------
N_DECODE = 6


@pytest.mark.parametrize("impl", ["full", "pallas"])
@pytest.mark.parametrize("arch", DENSE)
def test_lm_matches_repro(arch, impl):
    jc, pc = _cfgs(arch, impl)
    jp = jax_api.init_model(jax.random.key(2), jc)
    tp = TF.params_from_jax(jp, device="cpu")
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jc.vocab, (B, S + N_DECODE)).astype(np.int32)
    prompt = tokens[:, :S]

    _close(TF.lm_forward(tp, _t(prompt), pc),
           JTF.lm_forward(jp, jnp.asarray(prompt), jc), f"{arch} forward")
    lj, cj = JTF.lm_prefill(jp, jnp.asarray(prompt), jc)
    with torch.inference_mode():
        lt, ct = TF.lm_prefill(tp, _t(prompt), pc)
    _close(lt, lj, f"{arch} prefill logits")
    for path, leaf in module.tree_paths(ct).items():
        _close(leaf, module.tree_paths(jax.tree.map(np.asarray, cj))[path],
               f"{arch} prefill cache {path}")
    total = S + N_DECODE + 8
    cj, ct = _grow_jax(jc, cj, total), _grow_port(pc, ct, total)
    step = jax.jit(lambda p, c, t, q: JTF.lm_decode_step(p, c, t, q, jc))
    for i in range(N_DECODE):
        tok = tokens[:, S + i]
        pos = np.full((B,), S + i, np.int32)
        lj, cj = step(jp, cj, jnp.asarray(tok), jnp.asarray(pos))
        with torch.inference_mode():
            lt, ct = TF.lm_decode_step(tp, ct, _t(tok), _t(pos), pc)
        _close(lt, lj, f"{arch} decode step {i}")
    _close(ct["layers"]["sub_0"]["v"], cj["layers"]["sub_0"]["v"],
           f"{arch} caches after decode")


@pytest.mark.parametrize("impl", ["full", "pallas", "chunked"])
@pytest.mark.parametrize("arch", DENSE)
def test_prefill_decode_matches_forward(arch, impl):
    """decode(prefill(t[:-1]), t[-1]) equals forward(t) at the last step."""
    _, pc = _cfgs(arch, impl)
    params = api.init_model(torch.Generator().manual_seed(1), pc)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, pc.vocab, (B, S)).astype(np.int32))
    with torch.inference_mode():
        full = api.forward(params, {"tokens": tokens}, pc)
        _, caches = api.prefill(params, {"tokens": tokens[:, :-1]}, pc)
        caches = _grow_port(pc, caches, S + 8)
        pos = torch.full((B,), S - 1, dtype=torch.int32)
        step, _ = api.decode_step(params, caches,
                                  {"token": tokens[:, -1], "pos": pos}, pc)
    torch.testing.assert_close(step, full[:, -1], rtol=TOL, atol=TOL)


def test_pallas_decode_route_folds_heads_h14():
    """Under attn_impl="pallas" decode reads the unexpanded cache with q
    folded to (B, KV, rep, Dh); a config whose heads are padded for tensor
    parallelism (kv_head_map is then not h // rep) is refused."""
    _, pc = _cfgs("smollm-360m", "pallas")
    padded = dataclasses.replace(get_config("smollm-360m"), tp_size=16,
                                 attn_impl="pallas")
    assert padded.padded_heads != padded.n_heads
    rep = pc.n_heads // pc.n_kv_heads
    np.testing.assert_array_equal(pc.kv_head_map(),
                                  np.arange(pc.n_heads) // rep)
    q = torch.zeros((1, 1, padded.padded_heads, padded.hd))
    cache = torch.zeros((1, 4, padded.n_kv_heads, padded.hd))
    with pytest.raises(ValueError, match="padded_heads == n_heads"):
        TF._decode_kernel_route(q, cache, cache,
                                torch.zeros(1, dtype=torch.int32), padded)


# ---------------------------------------------------------------------------
# the serve command
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


def test_serve_greedy_tokens_match_repro(capsys):
    """``repro_torch.launch.serve`` with ``--attn-impl pallas`` on ``repro``'s
    weights gives ``repro.launch.serve``'s greedy tokens; the smallest gap
    between the top two logits of any greedy pick is printed, so that a
    near tie shows as such."""
    argv = ["--arch", "smollm-360m", "--reduced", "--temperature", "0"]
    want = _repro_serve_tokens(argv)
    args = port_serve.build_parser().parse_args(
        argv + ["--device", "cpu", "--attn-impl", "pallas"])
    cfg = port_serve.config_from_args(args)
    assert cfg.attn_impl == "pallas"
    params = TF.params_from_jax(jax_api.init_model(jax.random.key(args.seed),
                                                   jax_get_config("smollm-360m").reduced()),
                                device="cpu")
    fl0, dec0 = flash_attention_cuda.launches, decode_attention_cuda.launches
    res = port_serve.serve(cfg, batch=args.batch, prompt_len=args.prompt_len,
                           gen=args.gen, temperature=args.temperature,
                           seed=args.seed, device=args.device, params=params)
    assert res.tokens.shape == (args.batch, args.gen + 1)
    assert res.tokens[0][:16].tolist() == want
    assert (flash_attention_cuda.launches, decode_attention_cuda.launches) == (fl0, dec0)

    # teacher-forced replay of the greedy picks: the smallest top-2 gap
    prompt = torch.from_numpy(np.random.default_rng(args.seed).integers(
        0, cfg.vocab, (args.batch, args.prompt_len)).astype(np.int32))
    gaps = []
    with torch.inference_mode():
        logits, caches = TF.lm_prefill(params, prompt, cfg)
        logits = logits[:, -1]
        caches = module.tree_map(port_serve._grow, api.make_caches(
            cfg, args.batch, args.prompt_len + args.gen + 8, device="cpu"), caches)
        for i in range(args.gen + 1):
            top2 = torch.topk(logits[:, :cfg.vocab], 2).values
            gaps.append(float((top2[:, 0] - top2[:, 1]).min()))
            if i == args.gen:
                break
            tok = torch.from_numpy(res.tokens[:, i])
            pos = torch.full((args.batch,), args.prompt_len + i, dtype=torch.int32)
            logits, caches = TF.lm_decode_step(params, caches, tok, pos, cfg)
    with capsys.disabled():
        print(f"\nsmallest top-2 logit gap over {len(gaps)} greedy picks: "
              f"{min(gaps):.3g}")
    assert min(gaps) > 0

    # the command line itself, on its own weights
    res = port_serve.main(argv + ["--device", "cpu", "--attn-impl", "pallas",
                                  "--gen", "4"])
    assert "sample tokens[0]:" in capsys.readouterr().out
    assert res.tokens.shape == (4, 5)
