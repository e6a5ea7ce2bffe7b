"""LM training with the OLAF-async PS step: the port against ``repro``.

Reduced smollm-360m in float32 on the CPU. Inputs come from
``np.random.default_rng`` seeds; ``repro`` runs eagerly or under
``jax.jit`` with ``ops.olaf_step(impl="xla")``, and its weights are carried
across with ``params_from_jax``. ``repro``'s gate draws from
``jax.random``, which torch cannot replay (ROADMAP hazard H3): the PS-step
comparison injects the uniforms on both sides, and the end-to-end runs use
the defaults, under which every send probability is 0 or 1.

Tolerances: integers, bools and counters exact everywhere. Floats of the
device-half functions within ``rtol=1e-6`` (float32, one rounding apart
where XLA and torch evaluate an expression differently); the loss within
``1e-5`` and its gradient within ``2e-5`` (two float32 layers, summed in
another order); the 8-step PS run's queue payloads, AoM and losses within
``rtol=1e-6``, its params within ``atol=1e-6`` (AdamW moves a param by
about ``lr = 1e-3`` per step whatever the gradient's size); the end-to-end
CLI losses within ``rtol=1e-4`` (gradients of diverging params, six AdamW
steps).
"""
import argparse
import contextlib
import dataclasses
import io
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import ckpt as jax_ckpt  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import aom as jax_aom  # noqa: E402
from repro.core import txctl as jax_tx  # noqa: E402
from repro.core.aggregation import jax_trimmed_combine  # noqa: E402
from repro.core.olaf_queue import jax_queue_init, jax_screen_mask  # noqa: E402
from repro.kernels import ops as jax_ops  # noqa: E402
from repro.launch import train as jax_train  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro.models.module import tree_paths as jax_tree_paths  # noqa: E402
from repro.optim import optimizers as jax_opt  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import aom, txctl  # noqa: E402
from repro_torch.core.aggregation import (nanquantile_linear,  # noqa: E402
                                          trimmed_combine_torch)
from repro_torch.core.olaf_queue import queue_init, screen_mask  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import api, module  # noqa: E402
from repro_torch.models.transformer import (opt_state_from_jax,  # noqa: E402
                                            params_from_jax)
from repro_torch.optim import optimizers  # noqa: E402
from _trim_cases import trim_cases as _trim_cases  # noqa: E402

RTOL = 1e-6
ARCH = "smollm-360m"
CPU = torch.device("cpu")


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _same(got, want, what, rtol=RTOL, atol=0.0):
    """Exact for integer and bool arrays, within tolerance for floats (an
    infinity or NaN must sit at the same place)."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, what
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=what)


# --------------------------------------------------------------------------
# transmission control
# --------------------------------------------------------------------------
def _tx_pair(rng, W):
    fields = dict(
        last_ack=rng.random(W).astype(np.float32) * 2,
        has_fb=rng.random(W) < 0.7,
        n_active=rng.integers(0, 8, W).astype(np.float32),
        q_max=np.full(W, 3, np.float32),
        outstanding=rng.random(W) < 0.5,
        sent_gen=rng.random(W).astype(np.float32),
        deadline=(rng.random(W) * 3).astype(np.float32),
        retries=rng.integers(0, 4, W).astype(np.int32),
        active=rng.random(W) < 0.8)
    return (jax_tx.JaxTxState(**{k: jnp.asarray(v) for k, v in fields.items()}),
            txctl.TorchTxState(**{k: _t(v) for k, v in fields.items()}))


def _same_tx(got, want, what):
    for f in dataclasses.fields(want):
        w, g = getattr(want, f.name), getattr(got, f.name)
        assert (w is None) == (g is None), f"{what}.{f.name}"
        if w is not None:
            _same(g, w, f"{what}.{f.name}")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_txctl_device_half_matches_jax(seed):
    """Every function, with churn (a worker rejoining, one crashing) and
    retransmission (timeouts due, a retry budget spent)."""
    rng = np.random.default_rng(seed)
    W, thr, v = 9, 0.5, 0.5
    jst, pst = _tx_pair(rng, W)
    fresh_j = jax_tx.jax_txctl_init(W, track_active=True)
    fresh_p = txctl.txctl_init(W, device=CPU, track_active=True)
    _same_tx(fresh_p, fresh_j, "init")
    _same_tx(txctl.txctl_init(W, device=CPU), jax_tx.jax_txctl_init(W), "init")
    active = rng.random(W) < 0.6
    jst = jax_tx.jax_txctl_set_active(jst, jnp.asarray(active))
    pst = txctl.txctl_set_active(pst, _t(active))
    _same_tx(pst, jst, "set_active")
    for now in (0.3, 1.7, 4.0):
        _same(txctl.send_probability(pst, now, thr, v),
              jax_tx.jax_send_probability(jst, now, thr, v), "p")
        ids = rng.integers(0, W, 5).astype(np.int32)
        u = rng.random(5).astype(np.float32)
        send, p = txctl.txctl_gate(pst, now, thr, v, worker_ids=_t(ids),
                                   uniforms=_t(u))
        _, p_j = jax_tx.jax_txctl_gate(jst, jax.random.key(0), now, thr, v,
                                       worker_ids=jnp.asarray(ids))
        _same(p, p_j, "gate p")
        _same(send, u < _np(p_j), "gate send")
        acked = rng.random(W) < 0.5
        for gen in (None, 0.5):
            _same_tx(txctl.txctl_ack(pst, _t(acked), now, 5.0, 3.0, gen),
                     jax_tx.jax_txctl_ack(jst, jnp.asarray(acked), now, 5.0,
                                          3.0, gen), f"ack {gen}")
        jst = jax_tx.jax_txctl_ack(jst, jnp.asarray(acked), now, 5.0, 3.0)
        pst = txctl.txctl_ack(pst, _t(acked), now, 5.0, 3.0)
        sent = rng.random(W) < 0.5
        jst = jax_tx.jax_txctl_send(jst, jnp.asarray(sent), now, now - 0.1,
                                    0.4)
        pst = txctl.txctl_send(pst, _t(sent), now, now - 0.1, 0.4)
        _same_tx(pst, jst, "send")
        due_j, jst = jax_tx.jax_txctl_retransmit(jst, now + 0.5, 0.4, 2.0, 2)
        due_p, pst = txctl.txctl_retransmit(pst, now + 0.5, 0.4, 2.0, 2)
        _same(due_p, due_j, "due")
        _same_tx(pst, jst, "retransmit")
    with pytest.raises(ValueError, match="generator or the uniforms"):
        txctl.txctl_gate(pst, 0.0, thr, v)


# --------------------------------------------------------------------------
# AoM
# --------------------------------------------------------------------------
def test_aom_device_half_matches_jax():
    """A regressing timestamp (folded at last_t, no negative area) and
    invalid rows inside blocks; the average and the staleness mask."""
    blocks = [([0.5, 0.9, 0.7, 1.2], [0.1, 0.6, 0.65, 0.3], [1, 1, 1, 0]),
              ([1.1, 2.0, 2.5, 2.6], [1.0, 1.5, 0.2, 2.4], [1, 0, 1, 1]),
              ([2.4, 2.4, 3.0, 3.1], [2.0, 2.3, 2.9, 3.0], [1, 1, 0, 0])]
    sj, sp = jax_aom.jax_aom_init(0.2), aom.aom_init(0.2, device=CPU)
    for ts, gs, vs in blocks:
        ts = np.float32(ts)
        gs = np.float32(gs)
        vs = np.asarray(vs, bool)
        sj = jax_aom.jax_aom_update_block(sj, ts, gs, vs)
        sp = aom.aom_update_block(sp, _t(ts), _t(gs), _t(vs))
        for f in ("last_t", "last_gen", "integral"):
            _same(getattr(sp, f), getattr(sj, f), f)
        _same(aom.staleness_mask(_t(np.float32(ts.max())), _t(gs), 0.9),
              jax_aom.jax_staleness_mask(ts.max(), gs, 0.9), "fresh")
    assert float(sp.integral) > 0
    for horizon in (3.1, 5.0):
        _same(aom.aom_average(sp, horizon),
              jax_aom.jax_aom_average(sj, horizon), "average")


# --------------------------------------------------------------------------
# the ingress screen and the trimmed combine
# --------------------------------------------------------------------------
@pytest.mark.parametrize("med0", [0.0, 3.0])
def test_screen_mask_matches_jax(med0):
    """A NaN row, an outlier row and masked rows, judged in order."""
    rng = np.random.default_rng(7)
    U, D = 8, 40
    x = rng.normal(size=(U, D)).astype(np.float32) * 0.5
    x[2, 5] = np.nan
    x[4] *= 200.0  # an outlier
    x[6, 1] = np.inf
    x[7] *= 200.0  # an outlier, but masked out
    mask = np.ones(U, bool)
    mask[[1, 7]] = False
    for m in (None, mask):
        sj, medj = jax_screen_mask(x, jnp.float32(med0), factor=16.0,
                                   mask=None if m is None else jnp.asarray(m))
        sp, medp = screen_mask(_t(x), torch.tensor(med0), factor=16.0,
                               mask=None if m is None else _t(m))
        _same(sp, sj, "screen")
        _same(medp, medj, "med")
        assert bool(sp[2]) and bool(sp[4]) and bool(sp[6])
    assert not bool(sp[7])  # masked: never screened


@pytest.mark.parametrize("case", list(_trim_cases()))
def test_trimmed_combine_matches_jax(case):
    rows, w = _trim_cases()[case]
    want = jax_trimmed_combine(jnp.asarray(rows), jnp.asarray(w))
    got = trimmed_combine_torch(_t(rows), _t(w))
    _same(got, want, case, atol=1e-6)


@pytest.mark.parametrize("selected", [False, True])
@pytest.mark.parametrize("case", list(_trim_cases()))
def test_robust_combine_route_matches_jax(case, selected):
    """``ops.olaf_robust_combine`` on the CPU (the plain route, the
    kernel's yardstick on a card) against ``repro``'s ``ps_step`` combine:
    the weighted mean, or the trimmed combine where the screened share of
    the sent rows exceeds the threshold (2 of 7 sent, or 1 of 7, against
    0.25), picked on the device."""
    rows, w = _trim_cases()[case]
    n_screen, n_send = (2 if selected else 1), 7
    mean = (jnp.asarray(w) @ jnp.asarray(rows)) / jnp.maximum(w.sum(), 1.0)
    want = jnp.where(n_screen / max(n_send, 1) > 0.25,
                     jax_trimmed_combine(jnp.asarray(rows), jnp.asarray(w)),
                     mean)
    got = ops.olaf_robust_combine(
        _t(rows), _t(w), torch.tensor(n_screen, dtype=torch.int32),
        torch.tensor(n_send), threshold=0.25)
    _same(got, want, case, atol=1e-6)


def test_nanquantile_follows_jnp_not_torch_lerp_h18():
    """Hazard H18: a column [1, inf] at 0.75 is inf in ``jnp.nanquantile``
    (low·(1−w) + high·w) and NaN in ``torch.nanquantile`` (lerp); the
    port's quantile follows ``jnp``. An all-NaN column is NaN in both; so
    with nine all-NaN rows more."""
    x2 = np.float32([[1.0, np.nan, 2.0], [np.inf, np.nan, 2.0]])
    x11 = np.concatenate([x2, np.full((9, 3), np.nan, np.float32)])
    for x in (x2, x11):
        for q in (0.25, 0.75):
            want = np.asarray(jnp.nanquantile(jnp.asarray(x), q, axis=0))
            got = nanquantile_linear(_t(x), q).numpy()
            np.testing.assert_array_equal(got, want)
        assert np.isinf(want[0]) and np.isnan(want[1])
    assert torch.isnan(torch.nanquantile(_t(x2), 0.75, dim=0)[0])


# --------------------------------------------------------------------------
# the optimizer
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["adamw", "sgd"])
def test_apply_updates_matches_jax(kind):
    """Three steps: a clipped one, one with a non-finite gradient (skipped:
    every gradient zeroed), and a plain one; a bf16 leaf beside float32
    ones (compared within one bf16 ulp)."""
    rng = np.random.default_rng(11)

    def tree(f):
        return {"b": {"w": f((5, 3)), "s": f((3,))}, "a": f((4,))}

    p_np = tree(lambda s: rng.normal(size=s).astype(np.float32))
    pj = dict(p_np, a=jnp.asarray(p_np["a"], jnp.bfloat16))
    pp = params_from_jax(pj, device=CPU)
    cfg_j = jax_opt.OptConfig(kind=kind, lr=1e-2, grad_clip=1.0,
                              weight_decay=0.01)
    cfg_p = optimizers.OptConfig(kind=kind, lr=1e-2, grad_clip=1.0,
                                 weight_decay=0.01)
    sj, sp = jax_opt.init_opt_state(pj, cfg_j), optimizers.init_opt_state(pp, cfg_p)
    for i, scale in enumerate((10.0, 1.0, 0.1)):
        g_np = tree(lambda s: (rng.normal(size=s) * scale).astype(np.float32))
        if i == 1:
            g_np["b"]["w"][2, 1] = np.nan
        gj = dict(g_np, a=jnp.asarray(g_np["a"], jnp.bfloat16))
        gp = params_from_jax(gj, device=CPU)
        pj, sj = jax_opt.apply_updates(pj, gj, sj, cfg_j)
        pp, sp = optimizers.apply_updates(pp, gp, sp, cfg_p)
        _same(sp.step, sj.step, "step")
        for path, want in jax_tree_paths(pj).items():
            got = module.tree_paths(pp)[path]
            if got.dtype == torch.bfloat16:
                np.testing.assert_allclose(
                    _np(got.to(torch.float32)), np.asarray(want, np.float32),
                    rtol=2 ** -7, err_msg=path)
            else:
                _same(got, want, path, atol=1e-7)
        moments = [(sp.m, sj.m)] + ([(sp.v, sj.v)] if kind == "adamw" else [])
        for got_t, want_t in moments:
            for path, want in jax_tree_paths(want_t).items():
                _same(module.tree_paths(got_t)[path], want, path, atol=1e-9)
    assert sp.v is None if kind == "sgd" else sp.v is not None


# --------------------------------------------------------------------------
# loss, gradient and the flat order (H17)
# --------------------------------------------------------------------------
def _jax_flatten(tree):
    """``repro``'s ``flatten`` of ``run_olaf_async``."""
    return jnp.concatenate([jnp.ravel(v).astype(jnp.float32)
                            for v in jax_tree_paths(tree).values()])


def _cfgs():
    return jax_get_config(ARCH).reduced(), get_config(ARCH).reduced()


@pytest.fixture(scope="module")
def jax_params():
    jcfg, _ = _cfgs()
    return jax_api.init_model(jax.random.key(0), jcfg)


def _batch(seed, B=2, S=12, V=256):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, V, (B, S + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def test_flat_order_is_repro_sorted_key_order_h17(jax_params):
    """``repro`` flattens trees rebuilt by ``jax.jit`` (keys sorted); the
    port's ``init_layer`` inserts ``ln1, attn, ln2, mlp``. ``flatten_like``
    walks sorted keys, so it equals ``repro``'s vector bit for bit, and
    the insertion order would not."""
    rebuilt = jax.jit(lambda t: t)(jax_params)
    want = np.asarray(_jax_flatten(rebuilt))
    _, pcfg = _cfgs()
    fresh = api.init_model(torch.Generator().manual_seed(0), pcfg)
    insertion = list(module.tree_paths(fresh))
    assert insertion != sorted(insertion)

    def like_order(tree, like):  # repro's values, the port's key order
        if isinstance(like, dict):
            return {k: like_order(tree[k], like[k]) for k in like}
        return tree

    port = like_order(params_from_jax(jax_params, device=CPU), fresh)
    assert list(module.tree_paths(port)) == insertion
    got = module.flatten_like(port).numpy()
    np.testing.assert_array_equal(got, want)
    by_insertion = np.concatenate([_np(v).ravel() for v in
                                   module.tree_paths(port).values()])
    assert not np.array_equal(by_insertion, want)
    back = module.unflatten_like(torch.from_numpy(want.copy()), port)
    for path, v in module.tree_paths(back).items():
        assert torch.equal(v, module.tree_paths(port)[path]), path


def test_loss_and_gradient_match_value_and_grad(jax_params):
    jcfg, pcfg = _cfgs()
    batch = _batch(1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jax_api.loss_fn(p, b, jcfg)))(jax_params, batch)
    params = params_from_jax(jax_params, device=CPU)
    out = torch.empty(module.flat_size(params))
    loss_p = train.worker_grad(params, {k: _t(v) for k, v in batch.items()},
                               pcfg, out)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax_flatten(grads_j)),
                               rtol=2e-5, atol=2e-5)
    assert float(loss_p) == float(api.loss_fn(
        params, {k: _t(v) for k, v in batch.items()}, pcfg))


def test_pallas_attention_gradient_matches_repro(jax_params):
    """Under autograd the ``pallas`` route runs the flash kernel pair
    (``FlashAttention``: on the CPU its plain forward and backward) and its
    loss and flat gradient equal ``repro``'s ``value_and_grad`` (which
    trains through its dense attention) at the tolerances of the test
    above; the forward alone, without a gradient, takes the same route."""
    jcfg, pcfg = _cfgs()
    cfg = dataclasses.replace(pcfg, attn_impl="pallas")
    batch = _batch(1)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p, b: jax_api.loss_fn(p, b, jcfg)))(jax_params, batch)
    params = params_from_jax(jax_params, device=CPU)
    tbatch = {k: _t(v) for k, v in batch.items()}
    out = torch.empty(module.flat_size(params))
    loss_p = train.worker_grad(params, tbatch, cfg, out)
    np.testing.assert_allclose(float(loss_p), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax_flatten(grads_j)),
                               rtol=2e-5, atol=2e-5)
    with torch.no_grad():
        np.testing.assert_allclose(float(api.loss_fn(params, tbatch, cfg)),
                                   float(loss_j), rtol=1e-5)


# --------------------------------------------------------------------------
# the PS step against repro's functions, 8 steps
# --------------------------------------------------------------------------
W, N_CLUSTERS, CAP, K, U = 6, 3, 2, 2, 3  # capacity 2 < 3 clusters: congested
LR, BOUND, CRASH, RESTART = 1e-3, 0.3, 2, 5


def _jax_unflatten(flat, like):
    """``repro``'s ``unflatten_like`` of ``run_olaf_async``."""
    out, off = {}, 0
    for k, v in jax_tree_paths(like).items():
        n = int(np.prod(v.shape))
        out[k] = flat[off:off + n].reshape(v.shape).astype(v.dtype)
        off += n
    root = {}
    for path, leaf in out.items():
        d = root
        parts = path.split("/")
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = leaf
    return root


def _jax_ps_step(queue, params, opt_state, tx, aom_s, last_seen, med, now,
                 clusters, workers, times, rewards, payloads, losses, active,
                 uniforms):
    """The body of ``repro``'s ``ps_step`` closure (``launch/train.py``),
    from its public functions, with the gate's draws injected."""
    cluster_of = jnp.arange(W, dtype=jnp.int32) % N_CLUSTERS
    tx_cfg = jax_tx.TxControlConfig(delta_threshold=0.5)
    p = jnp.take(jax_tx.jax_send_probability(tx, now, tx_cfg.delta_threshold,
                                             tx_cfg.v), workers)
    send = uniforms < p
    screen, med = jax_screen_mask(payloads, med, factor=16.0, mask=send)
    n_screen = (send & screen).sum()
    queue, out = jax_ops.olaf_step(queue, clusters, workers, times, rewards,
                                   payloads, jnp.inf, send, None, active,
                                   screen, k=K, impl="xla")
    fresh = jax_aom.jax_staleness_mask(now, out["gen_time"], BOUND)
    valid = out["valid"] & fresh
    n_stale = (out["valid"] & ~fresh).sum()
    wts = valid * out["agg_count"].astype(jnp.float32)
    g_mean = jnp.einsum("k,kd->d", wts, out["payload"]) \
        / jnp.maximum(wts.sum(), 1.0)
    frac = n_screen.astype(jnp.float32) \
        / jnp.maximum(send.sum().astype(jnp.float32), 1.0)
    g_flat = jnp.where(frac > 0.25, jax_trimmed_combine(out["payload"], wts),
                       g_mean)
    params, opt_state = jax_opt.apply_updates(
        params, _jax_unflatten(g_flat, params), opt_state,
        jax_opt.OptConfig(lr=LR, grad_clip=1.0))
    aom_s = jax_aom.jax_aom_update_block(
        aom_s, jnp.full(valid.shape, now, jnp.float32), out["gen_time"], valid)
    last_seen = last_seen.at[clusters].max(jnp.where(send, times, -jnp.inf))
    n_active = ((now - last_seen) <= 1.0).sum().astype(jnp.float32)
    acked = jnp.any((cluster_of[:, None] == out["cluster"][None, :])
                    & valid[None, :], axis=1)
    tx = jax_tx.jax_txctl_ack(tx, acked, now, n_active, float(CAP))
    stats = dict(loss=jnp.mean(losses), applied=valid.sum(),
                 combined=wts.sum(), agg_total=queue.n_agg,
                 deferred=(~send).sum(), stale=n_stale, screened=n_screen,
                 occupancy=(queue.cluster >= 0).sum())
    return queue, params, opt_state, tx, aom_s, last_seen, med, stats


def _bursts(D, n_steps=8):
    """A host schedule and seeded payloads: (time, clusters, workers, times,
    rewards, payloads, losses, uniforms) per step. Step 3 carries a NaN
    row (screened, which trips the trimmed fallback), step 5 an outlier."""
    rng = np.random.default_rng(5)
    speed = 1.0 + 0.5 * rng.random(W)
    nxt = np.zeros(W)
    out = []
    for it in range(n_steps):
        if it == CRASH:
            nxt[1] = np.inf
        if it == RESTART:
            nxt[1] = nxt[np.isfinite(nxt)].max() + speed[1]
        w = []
        t = []
        for _ in range(U):
            i = int(np.argmin(nxt))
            w.append(i)
            t.append(nxt[i])
            nxt[i] += speed[i]
        pay = (rng.normal(size=(U, D)) * 0.01).astype(np.float32)
        if it == 3:
            pay[1, 7] = np.nan
        if it == 5:
            pay[0] *= 100.0
        losses = (5.0 + rng.random(U)).astype(np.float32)
        out.append(dict(
            now=np.float32(max(t)), clusters=np.asarray(w, np.int32) % N_CLUSTERS,
            workers=np.asarray(w, np.int32), times=np.float32(t),
            rewards=-losses, payloads=pay, losses=losses,
            uniforms=rng.random(U).astype(np.float32)))
    return out


def test_ps_step_matches_repro_over_8_steps(jax_params):
    """Congestion armed (capacity 2 < 3 clusters), a crash at step 2 and a
    restart at 5, a staleness bound, the screen with a NaN row that trips
    the trimmed fallback; identical flat bursts and injected uniforms."""
    D = int(_jax_flatten(jax_params).shape[0])
    jparams = jax.jit(lambda t: t)(jax_params)
    jopt = jax_opt.init_opt_state(jparams, jax_opt.OptConfig(lr=LR, grad_clip=1.0))
    jq = jax_queue_init(CAP, D)
    jtx = jax_tx.jax_txctl_init(W, track_active=True)
    jaom, jls, jmed = jax_aom.jax_aom_init(), jnp.full((N_CLUSTERS,), -jnp.inf,
                                                       jnp.float32), jnp.float32(0)
    step_j = jax.jit(_jax_ps_step)

    params = params_from_jax(jax_params, device=CPU)
    opt = optimizers.OptConfig(lr=LR, grad_clip=1.0)
    state = train.PSState(
        queue=queue_init(CAP, D, device=CPU), params=params,
        opt_state=optimizers.init_opt_state(params, opt),
        tx=txctl.txctl_init(W, device=CPU, track_active=True),
        aom=aom.aom_init(device=CPU),
        last_seen=torch.full((N_CLUSTERS,), -math.inf),
        med=torch.zeros(()), gen=torch.Generator().manual_seed(0))
    cfg = train.PSConfig(
        drain_k=K, q_max=float(CAP), tx=txctl.TxControlConfig(
            delta_threshold=0.5), opt=opt,
        cluster_of=torch.arange(W, dtype=torch.int32) % N_CLUSTERS,
        screen=True, stale_bound=BOUND)
    active = np.ones(W, bool)
    seen = dict(deferred=0, screened=0, stale=0, trimmed=0)
    for it, b in enumerate(_bursts(D)):
        if it in (CRASH, RESTART):
            active[1] = it == RESTART
            jtx = jax_tx.jax_txctl_set_active(jtx, jnp.asarray(active))
            state.tx = txctl.txctl_set_active(state.tx, _t(active))
        jb = {k: jnp.asarray(v) for k, v in b.items()}
        jq, jparams, jopt, jtx, jaom, jls, jmed, sj = step_j(
            jq, jparams, jopt, jtx, jaom, jls, jmed, jb["now"], jb["clusters"],
            jb["workers"], jb["times"], jb["rewards"], jb["payloads"],
            jb["losses"], jnp.asarray(active), jb["uniforms"])
        burst = {k: _t(v) for k, v in b.items()}
        burst["active"] = _t(active)
        state, sp = train.ps_step(state, burst, cfg=cfg)
        for k in train.STAT_KEYS:
            _same(sp[k], sj[k], f"step {it} {k}")
            # H4: the counters stay int32, as repro's (x64 off)
            assert _np(sp[k]).dtype == np.asarray(sj[k]).dtype, k
        for f, v in state.queue.fields().items():
            _same(v, getattr(jq, f), f"step {it} queue.{f}", atol=1e-8)
        _same_tx(state.tx, jtx, f"step {it} tx")
        for f in ("last_t", "last_gen", "integral"):
            _same(getattr(state.aom, f), getattr(jaom, f), f"step {it} {f}")
        _same(state.last_seen, jls, "last_seen")
        _same(state.med, jmed, "med")
        for path, want in jax_tree_paths(jparams).items():
            _same(module.tree_paths(state.params)[path], want, path, rtol=0,
                  atol=1e-6)
        for k in ("deferred", "screened", "stale"):
            seen[k] += int(sp[k])
        seen["trimmed"] += int(sp["screened"]) * 4 > U - int(sp["deferred"])
    # every regime this test is for was reached
    assert all(n > 0 for n in seen.values()), seen


# --------------------------------------------------------------------------
# the CLI against repro's, and kill-and-resume
# --------------------------------------------------------------------------
ASYNC_ARGV = ["--arch", ARCH, "--reduced", "--mode", "olaf-async",
              "--workers", "4", "--batch", "8", "--seq", "16", "--steps", "6",
              "--burst-size", "2", "--drain-k", "4", "--ingress-screen",
              "--staleness-bound", "0.6", "--crash-workers", "1",
              "--crash-at", "2", "--restart-at", "4", "--log-every", "2",
              "--device", "cpu"]


@pytest.fixture
def same_init(monkeypatch, jax_params):
    """The port's ``api.init_model`` returns ``repro``'s seed-0 weights."""
    monkeypatch.setattr(api, "init_model", lambda gen, cfg: params_from_jax(
        jax_params, device=gen.device))


def _summary(text):
    line = [ln for ln in text.splitlines() if ln.startswith("final loss")][-1]
    parts = line.split("; ")
    head = parts[0].replace("final loss ", "").replace("(first ", "")
    last, first = (float(x) for x in head.rstrip(")").split())
    return (last, first), parts[1:-1]  # the counters and the AoM, not steps/s


def _run(fn, *a):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*a)
    return res, out.getvalue()


def test_olaf_async_cli_matches_repro(same_init):
    args = train.build_parser().parse_args(ASYNC_ARGV)
    got, text_p = _run(train.main, ASYNC_ARGV)
    jargs = argparse.Namespace(**{**vars(args), "step_impl": "xla"})
    want, text_j = _run(jax_train.run_olaf_async,
                        jax_get_config(ARCH).reduced(), jargs)
    (lp, fp), counters_p = _summary(text_p)
    (lj, fj), counters_j = _summary(text_j)
    assert counters_p == counters_j
    assert "stale rejected 1" in counters_p
    np.testing.assert_allclose([lp, fp], [lj, fj], rtol=1e-4)
    np.testing.assert_allclose(got.log_rows[-1][1], want, rtol=1e-4)
    assert [ln for ln in text_p.splitlines() if ln.startswith(("crash", "restart"))] \
        == [ln for ln in text_j.splitlines() if ln.startswith(("crash", "restart"))]
    combined_j = [int(ln.split("combined ")[1].split()[0])
                  for ln in text_j.splitlines() if ln.startswith("applied")]
    assert [c for _, _, c in got.log_rows][1::2] == combined_j


def test_sync_cli_matches_repro(same_init):
    argv = ["--arch", ARCH, "--reduced", "--mode", "sync", "--steps", "4",
            "--batch", "4", "--seq", "16", "--log-every", "1", "--device",
            "cpu"]
    args = train.build_parser().parse_args(argv)
    got, _ = _run(train.main, argv)
    want_lines = _run(jax_train.run_sync, jax_get_config(ARCH).reduced(),
                      args)[1].splitlines()
    want = [float(ln.split("loss ")[1].split()[0]) for ln in want_lines
            if ln.startswith("step ")]
    assert len(got.losses) == len(want) == 4
    np.testing.assert_allclose(got.losses, want, rtol=1e-4)


def _final(tr):
    st = tr.state
    return dict(params=module.flatten_like(st.params).numpy(),
                m=module.flatten_like(st.opt_state.m).numpy(),
                v=module.flatten_like(st.opt_state.v).numpy(),
                **{f"queue.{k}": _np(v) for k, v in st.queue.fields().items()},
                **{f"tx.{k}": _np(v) for k, v in vars(st.tx).items()
                   if v is not None},
                **{f"aom.{k}": _np(v) for k, v in vars(st.aom).items()},
                last_seen=_np(st.last_seen), med=_np(st.med),
                gen=_np(st.gen.get_state()), worker_next=tr.worker_next,
                worker_step=tr.worker_step, active=tr.active_np,
                rows=np.asarray(tr.log_rows[-4:])[:, 1:])


def test_kill_and_resume_is_bitwise(tmp_path):
    """4 steps and a checkpoint, then a resume to 8, against the same 8
    steps uninterrupted: every array of the training plane bit for bit
    (the counterpart of ``tests/test_node_faults.py``'s resume test)."""
    base = ["--arch", ARCH, "--reduced", "--mode", "olaf-async", "--workers",
            "4", "--batch", "8", "--seq", "16", "--ingress-screen",
            "--staleness-bound", "0.6", "--crash-workers", "1", "--crash-at",
            "2", "--restart-at", "6", "--queue-slots", "1", "--log-every",
            "0", "--device", "cpu"]
    whole, _ = _run(train.main, base + ["--steps", "8"])
    ck = str(tmp_path / "ck")
    _run(train.main, base + ["--steps", "4", "--ckpt", ck])
    assert ckpt.latest_step(ck) == 4
    resumed, text = _run(train.main, base + ["--steps", "8", "--ckpt", ck,
                                             "--resume"])
    assert "resumed olaf-async from step 4" in text
    want, got = _final(whole), _final(resumed)
    assert want.keys() == got.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert whole.deferred_total > 0  # the congested gate drew
    assert ckpt.read_manifest(ck)["aux"]["queue"]["n_leaves"] == 13


def test_repro_checkpoint_restores_in_the_port(tmp_path, jax_params):
    """``repro``'s ``save_checkpoint`` (bf16 params widened, an AdamW state
    after one step) restores in the port bit for bit; the port's
    checkpoint restores in ``repro`` the same way."""
    jcfg = dataclasses.replace(jax_get_config(ARCH).reduced(),
                               dtype="bfloat16")
    pj = jax_api.init_model(jax.random.key(3), jcfg)
    ocfg = jax_opt.OptConfig(lr=1e-3, grad_clip=1.0)
    grads = jax.tree.map(lambda x: jnp.full(x.shape, 0.01, x.dtype), pj)
    pj, oj = jax_opt.apply_updates(pj, grads, jax_opt.init_opt_state(pj, ocfg),
                                   ocfg)
    jax_ckpt.save_checkpoint(str(tmp_path / "j"), 7, pj, oj)
    like_p = params_from_jax(pj, device=CPU)
    like_o = opt_state_from_jax(oj, device=CPU)
    step, pp, op = ckpt.restore_checkpoint(
        str(tmp_path / "j"), params_like=module.tree_map(torch.zeros_like,
                                                         like_p),
        opt_like=optimizers.init_opt_state(like_p, optimizers.OptConfig()))
    assert step == 7
    for path, v in module.tree_paths(like_p).items():
        got = module.tree_paths(pp)[path]
        assert got.dtype == torch.bfloat16 and torch.equal(got, v), path
    for got, want in zip(module.tree_leaves(op), module.tree_leaves(like_o)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    ckpt.save_checkpoint(str(tmp_path / "p"), 9, pp, op)
    step, pj2, oj2 = jax_ckpt.restore_checkpoint(
        str(tmp_path / "p"), params_like=jax.eval_shape(lambda: pj),
        opt_like=jax.eval_shape(lambda: oj))
    assert step == 9
    for a, b in zip(jax.tree_util.tree_leaves((pj, oj)),
                    jax.tree_util.tree_leaves((pj2, oj2))):
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


# --------------------------------------------------------------------------
# --step-impl: repro's flag and meaning
# --------------------------------------------------------------------------
@pytest.mark.parametrize("impl", ["auto", "xla", "pallas"])
def test_step_impl_flag_is_parsed(impl):
    args = train.build_parser().parse_args(ASYNC_ARGV + ["--step-impl", impl])
    assert args.step_impl == impl


def test_step_impl_defaults_to_auto_and_refuses_other_names():
    assert train.build_parser().parse_args(ASYNC_ARGV).step_impl == "auto"
    with contextlib.redirect_stderr(io.StringIO()), \
            pytest.raises(SystemExit):
        train.build_parser().parse_args(ASYNC_ARGV + ["--step-impl", "cuda"])


def test_step_impl_xla_is_the_cpu_route_and_pallas_raises_off_a_card():
    auto, _ = _run(train.main, ASYNC_ARGV)
    xla, _ = _run(train.main, ASYNC_ARGV + ["--step-impl", "xla"])
    assert xla.log_rows == auto.log_rows
    for f, v in auto.state.queue.fields().items():
        assert torch.equal(getattr(xla.state.queue, f), v), f
    with pytest.raises(ValueError, match="impl='pallas'"):
        _run(train.main, ASYNC_ARGV + ["--step-impl", "pallas"])
