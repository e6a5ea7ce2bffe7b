"""Parity of the port's environments, actor-critic and PPO with ``repro``'s.

Inputs are made with numpy from a seed and handed to both packages; the
random streams themselves (``jax.random`` against ``torch.Generator``)
differ by design and are never compared.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.olaf_ppo import PPOConfig as JaxPPOConfig  # noqa: E402
from repro.models import rlnets as jax_rlnets  # noqa: E402
from repro.rl import env as jax_env  # noqa: E402
from repro.rl import ppo as jax_ppo  # noqa: E402
from repro_torch.configs.olaf_ppo import PPOConfig  # noqa: E402
from repro_torch.models import rlnets  # noqa: E402
from repro_torch.rl import env as torch_env  # noqa: E402
from repro_torch.rl import ppo  # noqa: E402


def _jax_params(seed=0):
    """repro's actor-critic for the lander (obs 8, actions 4) as numpy."""
    params = jax_rlnets.init_actor_critic(jax.random.key(seed), JaxPPOConfig())
    return jax.tree_util.tree_map(np.asarray, params)


def _random_states(rng, name, n):
    if name == "cartpole":
        return rng.uniform(-0.3, 0.3, (n, 4)).astype(np.float32)
    s = rng.uniform(-1.0, 1.0, (n, 8)).astype(np.float32)
    s[:, 1] = rng.uniform(-0.05, 1.5, n)  # some steps cross y = 0
    s[:, 6:] = 0.0
    return s


@pytest.mark.parametrize("name", ["cartpole", "lander"])
def test_batched_env_step_matches_vmap(name):
    rng = np.random.default_rng(1)
    env_j, env_t = jax_env.make_env(name), torch_env.make_env(name)
    states = _random_states(rng, name, 256)
    actions = rng.integers(0, env_j.n_actions, 256).astype(np.int32)
    want = jax.vmap(env_j.step)(jnp.asarray(states), jnp.asarray(actions))
    got = env_t.step(torch.from_numpy(states), torch.from_numpy(actions))
    for w, g, what in zip(want, got, ("state", "obs", "reward", "done")):
        if what == "done":
            np.testing.assert_array_equal(np.asarray(w), g.numpy())
        else:
            np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=f"{name} {what}")
    assert got[3].any() and not got[3].all()  # both branches were taken


@pytest.mark.parametrize("name", ["cartpole", "lander"])
def test_env_reset_shape_and_range(name):
    env = torch_env.make_env(name)
    s = env.reset(torch.Generator().manual_seed(0), 32)
    assert s.shape == (32, env.obs_dim) and s.dtype == torch.float32
    bound = 0.05 if name == "cartpole" else 0.5
    assert float(s[:, 0].abs().max()) <= bound


def test_actor_critic_forward_and_flatten_order():
    """H7: params_from_jax then flatten_params gives repro's flat vector bit
    for bit (D = 941 for the paper's lander model), and the forward pass
    agrees."""
    tree = _jax_params()
    params = rlnets.params_from_jax(tree, device="cpu")
    flat_j, _ = jax_rlnets.flatten_params(tree)
    flat_t, spec = rlnets.flatten_params(params)
    assert flat_t.shape == (941,)
    np.testing.assert_array_equal(np.asarray(flat_j), flat_t.numpy())
    back, _ = rlnets.flatten_params(rlnets.unflatten_params(flat_t, spec))
    assert torch.equal(back, flat_t)
    obs = np.random.default_rng(2).normal(size=(5, 7, 8)).astype(np.float32)
    lj, vj = jax_rlnets.apply_actor_critic(tree, jnp.asarray(obs))
    lt, vt = rlnets.apply_actor_critic(params, torch.from_numpy(obs))
    np.testing.assert_allclose(np.asarray(lj), lt.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(np.asarray(vj), vt.numpy(), rtol=1e-5, atol=1e-6)


def _numpy_rollout(rng, T=24, N=6):
    return dict(
        obs=rng.normal(size=(T, N, 8)).astype(np.float32),
        actions=rng.integers(0, 4, (T, N)).astype(np.int32),
        logp=np.log(rng.uniform(0.1, 0.9, (T, N))).astype(np.float32),
        values=rng.normal(size=(T, N)).astype(np.float32),
        rewards=rng.normal(size=(T, N)).astype(np.float32),
        dones=rng.random((T, N)) < 0.1,
        last_value=rng.normal(size=N).astype(np.float32))


def test_gae_matches_scan():
    ro = _numpy_rollout(np.random.default_rng(3))
    want = jax_ppo.gae(jax_ppo.Rollout(**{k: jnp.asarray(v)
                                          for k, v in ro.items()}), 0.99, 0.95)
    got = ppo.gae(ppo.Rollout(**{k: torch.from_numpy(v)
                                 for k, v in ro.items()}), 0.99, 0.95)
    for w, g in zip(want, got):
        np.testing.assert_allclose(np.asarray(w), g.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_ppo_loss_and_gradient_match_value_and_grad():
    """H8: the advantage normalisation uses the population std (ddof 0)."""
    rng = np.random.default_rng(4)
    ro = _numpy_rollout(rng)
    advs = (3.0 + 2.0 * rng.normal(size=ro["values"].shape)).astype(np.float32)
    returns = rng.normal(size=ro["values"].shape).astype(np.float32)
    tree = _jax_params(seed=1)
    cfg_j, cfg_t = JaxPPOConfig(), PPOConfig()
    batch_j = tuple(jnp.asarray(a) for a in (ro["obs"], ro["actions"],
                                             ro["logp"], advs, returns))
    loss_j, grads_j = jax.value_and_grad(jax_ppo.ppo_loss)(tree, batch_j, cfg_j)
    batch_t = (torch.from_numpy(ro["obs"]),
               torch.from_numpy(ro["actions"].astype(np.int64)),
               torch.from_numpy(ro["logp"]), torch.from_numpy(advs),
               torch.from_numpy(returns))
    loss_t, grads_t = ppo.loss_and_grad(
        rlnets.params_from_jax(tree, device="cpu"), batch_t, cfg_t)
    np.testing.assert_allclose(float(loss_j), float(loss_t), rtol=1e-5, atol=1e-5)
    flat_j, _ = jax_rlnets.flatten_params(grads_j)
    flat_t, _ = rlnets.flatten_params(grads_t)
    np.testing.assert_allclose(np.asarray(flat_j), flat_t.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_worker_iteration_gives_a_finite_update():
    params = rlnets.params_from_jax(_jax_params(), device="cpu")
    cfg = PPOConfig(rollout_len=32)
    grads, mean_reward, loss = ppo.worker_iteration(
        params, torch.Generator().manual_seed(0),
        env=torch_env.make_env("lander"), cfg=cfg, n_envs=4)
    flat, _ = rlnets.flatten_params(grads)
    assert flat.shape == (941,) and bool(torch.isfinite(flat).all())
    assert np.isfinite(float(mean_reward)) and np.isfinite(float(loss))
    stepped = ppo.local_update(params, grads, 0.1)
    assert not torch.equal(rlnets.flatten_params(stepped)[0],
                           rlnets.flatten_params(params)[0])
    assert np.isfinite(ppo.evaluate(stepped, torch_env.make_env("lander"),
                                    torch.Generator().manual_seed(1),
                                    n_envs=4, horizon=50))
