"""Activation checkpointing (``cfg.remat``, ``cfg.remat_policy``) against
``repro``'s.

Reduced dense, moe, ssm, hybrid and encdec configs with ``remat=True``, in
float32 on the CPU, ``repro``'s weights carried across
(``params_from_jax``), tokens and frames from ``np.random.default_rng``:

  * the port's gradient under ``full`` and ``dots`` is bitwise the one
    under ``none`` (recomputing a period on the CPU repeats its arithmetic
    exactly);
  * it is within 2e-5 of ``jax.value_and_grad`` of ``repro``'s loss under
    the same remat config (hazard H19: the gradients are held on their
    own);
  * ``checkpoint`` is entered once per period while autograd records, and
    never under ``torch.no_grad``, ``torch.inference_mode`` or serving.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import api as jax_api  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import serve as port_serve  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.models import api, module  # noqa: E402
from repro_torch.models.transformer import params_from_jax, split_plan  # noqa: E402

ARCHS = ["smollm-360m", "grok-1-314b", "mamba2-130m", "recurrentgemma-9b",
         "whisper-small"]
TOL = 2e-5
B, S = 2, 12


def _cfgs(arch, policy="full"):
    kw = dict(remat=True, remat_policy=policy)
    return (dataclasses.replace(jax_get_config(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_frames, cfg.d_model)).astype(np.float32)
    return batch


def _periods(cfg):
    if cfg.family == "encdec":
        return cfg.n_enc_layers + cfg.n_layers
    return split_plan(cfg)[1]


class Entered:
    """Counts the calls of ``module.checkpoint`` while installed."""

    def __init__(self, monkeypatch):
        self.n, orig = 0, module.checkpoint

        def counted(*a, **kw):
            self.n += 1
            return orig(*a, **kw)

        monkeypatch.setattr(module, "checkpoint", counted)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    arch = request.param
    jc, _ = _cfgs(arch)
    jp = jax.jit(lambda k: jax_api.init_model(k, jc))(jax.random.key(7))
    batch = _batch(jc)
    want = {}
    for policy in ("full", "dots"):  # the remat configs
        jcp, _ = _cfgs(arch, policy)
        loss, g = jax.jit(jax.value_and_grad(
            lambda p: jax_api.loss_fn(p, batch, jcp)))(jp)
        want[policy] = (float(loss), [np.asarray(x, np.float32)
                                      for x in jax.tree_util.tree_leaves(g)])
    return arch, jp, batch, want


def _port_grads(arch, jp, batch, policy):
    _, pc = _cfgs(arch, policy)
    params = params_from_jax(jp, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return port_train.loss_and_grads(params, tb, pc)


def test_full_and_dots_are_bitwise_none(case, monkeypatch):
    arch, jp, batch, _ = case
    entered = Entered(monkeypatch)
    loss0, g0 = _port_grads(arch, jp, batch, "none")
    assert entered.n == 0
    for policy in ("full", "dots"):
        loss, g = _port_grads(arch, jp, batch, policy)
        assert torch.equal(loss, loss0), policy
        assert len(g) == len(g0)
        for a, b in zip(g, g0):
            assert torch.equal(a, b), policy
    assert entered.n == 2 * _periods(_cfgs(arch)[1])


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_gradients_match_repro_value_and_grad(case, policy):
    arch, jp, batch, want = case
    loss, grads = _port_grads(arch, jp, batch, policy)
    w_loss, w_grads = want[policy]
    np.testing.assert_allclose(float(loss), w_loss, rtol=TOL, atol=TOL)
    assert len(grads) == len(w_grads)
    for i, (g, w) in enumerate(zip(grads, w_grads)):
        np.testing.assert_allclose(g.numpy(), w, rtol=TOL, atol=TOL,
                                   err_msg=f"{arch} {policy} leaf {i}")


@pytest.mark.parametrize("arch", ["smollm-360m", "whisper-small"])
def test_no_checkpoint_without_autograd(arch, monkeypatch):
    _, pc = _cfgs(arch)
    params = api.init_model(torch.Generator().manual_seed(0), pc)
    tb = {k: torch.from_numpy(v) for k, v in _batch(pc).items()}
    entered = Entered(monkeypatch)
    for mode in (torch.no_grad, torch.inference_mode):
        with mode():
            api.loss_fn(params, tb, pc)
            logits, caches = api.prefill(params, tb, pc)
            pos = torch.full((B,), S - 1, dtype=torch.int32)
            api.decode_step(params, caches, {"token": tb["tokens"][:, 0],
                                             "pos": pos}, pc)
    assert entered.n == 0
    # grad mode on, but nothing that requires a gradient: still entered
    api.loss_fn(params, tb, pc)
    assert entered.n == _periods(pc)


def test_serving_never_enters_checkpoint(monkeypatch):
    _, pc = _cfgs("smollm-360m")
    entered = Entered(monkeypatch)
    res = port_serve.serve(pc, batch=2, prompt_len=8, gen=3, device="cpu",
                           temperature=0.0)
    assert entered.n == 0 and res is not None


def test_dots_saves_the_batch_free_products_only():
    aten, P = torch.ops.aten, torch.utils.checkpoint.CheckpointPolicy
    a2, a3 = torch.empty(4, 8), torch.empty(1, 4, 8)
    assert module._save_dots(None, aten.mm.default, a2, a2.T) == P.MUST_SAVE
    assert module._save_dots(None, aten.addmm.default, a2, a2, a2.T) \
        == P.MUST_SAVE
    assert module._save_dots(None, aten.bmm.default, a3, a3) == P.MUST_SAVE
    assert module._save_dots(None, aten.bmm.default, a3.expand(6, 4, 8),
                             a3) == P.PREFER_RECOMPUTE
    assert module._save_dots(None, aten.add.Tensor, a2, a2) \
        == P.PREFER_RECOMPUTE


def test_an_unknown_policy_raises():
    _, pc = _cfgs("smollm-360m", "offload")
    params = api.init_model(torch.Generator().manual_seed(0), pc)
    tb = {k: torch.from_numpy(v) for k, v in _batch(pc).items()}
    with pytest.raises(ValueError, match="remat_policy"):
        port_train.loss_and_grads(params, tb, pc)
