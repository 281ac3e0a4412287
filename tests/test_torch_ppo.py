"""Parity of the port's learner (`wheeledlab_torch/rl/`) with the JAX PPO on
the CPU: the actor-critic forward pass on weights carried across with
`convert.actor_critic_from_jax`, GAE and advantage normalization, and one
minibatch update (loss terms, adaptive learning rate, grad clip, Adam)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wheeledlab_tpu.rl.networks import ActorCritic as JActorCritic
from wheeledlab_tpu.rl.networks import gaussian_log_prob as j_log_prob
from wheeledlab_tpu.rl.ppo import PPOCfg as JPPOCfg
from wheeledlab_tpu.rl.ppo import Transition, make_ppo
from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make_env
from wheeledlab_torch.convert import actor_critic_from_jax
from wheeledlab_torch.rl.networks import ActorCritic
from wheeledlab_torch.rl.ppo import PPO, PPOCfg
from wheeledlab_torch.tasks.drift.task import DriftTaskCfg, make_drift_env

torch.set_num_threads(1)
torch.backends.cuda.matmul.allow_tf32 = False

T, B, OBS = 8, 16, 14


def jax_params(seed=0):
    model = JActorCritic(action_dim=2)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, OBS)))
    return model, params


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def state_dicts_close(got: torch.nn.Module, want_params, atol):
    want = actor_critic_from_jax(to_np(want_params)).state_dict()
    for k, v in got.state_dict().items():
        np.testing.assert_allclose(v.numpy(), want[k].numpy(), atol=atol,
                                   rtol=0, err_msg=k)


class TestNetworks:
    def test_forward_matches_flax(self):
        """Same weights, same obs: mean/std/value agree to float32 matmul
        rounding (the two packages sum the dot products in another
        order)."""
        model, params = jax_params()
        obs = np.random.default_rng(0).standard_normal((64, OBS)).astype(
            np.float32)
        jm, js, jv = model.apply(params, jnp.asarray(obs))
        tm = actor_critic_from_jax(to_np(params))
        with torch.no_grad():
            m, s, v = tm(torch.from_numpy(obs))
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), atol=1e-5)
        np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-7)
        np.testing.assert_allclose(v.numpy(), np.asarray(jv), atol=1e-5)

    def test_init_follows_flax_scheme(self):
        """Truncated lecun-normal kernels (variance 1/fan_in, cut at 2
        std) and zero biases, like flax Dense; log_std = log(init std)."""
        net = ActorCritic(OBS, 2, (256, 256), (64, 64), init_noise_std=0.5,
                          generator=torch.Generator().manual_seed(0))
        w = net.actor[2].weight.detach().numpy()     # 256 x 256
        jw = np.asarray(jax.random.truncated_normal(
            jax.random.PRNGKey(1), -2.0, 2.0, (256, 256))) \
            * np.sqrt(1 / 256) / 0.87962566103423978
        assert abs(w.std() / jw.std() - 1) < 0.02
        assert np.abs(w).max() <= 2 * np.sqrt(1 / 256) / 0.8796 + 1e-6
        for m in net.modules():
            if isinstance(m, torch.nn.Linear):
                assert float(m.bias.detach().abs().max()) == 0.0
        np.testing.assert_allclose(net.log_std.detach().numpy(),
                                   np.log([0.5, 0.5]), rtol=1e-6)


def rollout_data(seed, kl_scale, ret_scale):
    """A [T, B] rollout dataset made with numpy around the flax policy's
    outputs; the old policy's mean is shifted by `kl_scale` so the KL of
    the update (and so the adaptive learning rate) is set by the test."""
    rng = np.random.default_rng(seed)
    model, params = jax_params()
    obs = rng.standard_normal((T, B, OBS)).astype(np.float32)
    mean, std, value = (np.asarray(x) for x in model.apply(params, obs))
    old_mean = (mean + kl_scale * rng.standard_normal(mean.shape)).astype(
        np.float32)
    action = (old_mean + std * rng.standard_normal(mean.shape)).astype(
        np.float32)
    log_prob = np.asarray(j_log_prob(old_mean, std, action))
    old_value = (value + 0.1 * rng.standard_normal(value.shape)).astype(
        np.float32)
    ret = (old_value + ret_scale * rng.standard_normal(value.shape)).astype(
        np.float32)
    adv = rng.standard_normal(value.shape).astype(np.float32)
    adv = (adv - adv.mean()) / adv.std()
    return params, (obs, action, log_prob, old_value, ret, adv, old_mean,
                    std)


def port_learner(cfg: PPOCfg):
    env = make_drift_env(DriftTaskCfg(num_envs=B), device="cpu")
    return PPO(env, cfg)


class TestGAE:
    def test_gae_matches_jax(self):
        rng = np.random.default_rng(3)
        reward = rng.standard_normal((T, B)).astype(np.float32)
        value = rng.standard_normal((T, B)).astype(np.float32)
        done = (rng.random((T, B)) < 0.2).astype(np.float32)
        last_value = rng.standard_normal(B).astype(np.float32)

        internals = {}
        make_ppo(j_make_env(JTaskCfg(num_envs=B)), JPPOCfg(), internals)
        z = np.zeros((T, B, 2), np.float32)
        traj = Transition(obs=np.zeros((T, B, OBS), np.float32), action=z,
                          log_prob=reward * 0, value=value, reward=reward,
                          done=done, mean=z, std=z)
        want = [np.asarray(x) for x in internals["compute_gae"](
            traj, jnp.asarray(last_value))]

        learner = port_learner(PPOCfg())
        got = learner.compute_gae(*(torch.from_numpy(x) for x in (
            reward, value, done, last_value)))
        # advantages/returns: the same float32 recursion; the normalized
        # advantages divide by a population std (jnp.std semantics)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-5, atol=1e-5)
        assert abs(float(got[2].std(correction=0)) - 1.0) < 1e-5


class TestMinibatchUpdate:
    @pytest.mark.parametrize("kl_scale,ret_scale,lr_factor", [
        (0.3, 5.0, 1 / 1.5),    # KL > 2 * desired: lr / 1.5
        (0.03, 0.5, 1.5),       # 0 < KL < desired / 2: lr * 1.5
    ])
    def test_one_update_matches_jax(self, kl_scale, ret_scale, lr_factor):
        """One minibatch (the whole batch) with the same weights: loss
        terms, the adaptive LR set before the step, the optax-style global
        norm clip and the Adam step agree. Tolerance: float32 sums in
        another order. Adam's first step is lr * g / (|g| + eps), so for
        the few gradient entries within a few eps of zero the gradient's
        float noise moves the step by up to a few percent of lr (measured
        2.4e-6 on one of ~9k params); params agree to 1e-5 = 1% of lr."""
        params, dataset = rollout_data(0, kl_scale, ret_scale)

        jcfg = JPPOCfg(num_learning_epochs=1, num_mini_batches=1)
        internals = {}
        make_ppo(j_make_env(JTaskCfg(num_envs=B)), jcfg, internals)
        tx = optax.chain(
            optax.clip_by_global_norm(jcfg.max_grad_norm),
            optax.inject_hyperparams(optax.adam)(
                learning_rate=jcfg.learning_rate))
        jparams, jopt, jmetrics = internals["update_epochs"](
            jax.random.PRNGKey(0), params, tx.init(params),
            tuple(jnp.asarray(x) for x in dataset))
        jlr = float(jopt[1].hyperparams["learning_rate"])

        learner = port_learner(PPOCfg(num_learning_epochs=1,
                                      num_mini_batches=1))
        learner.model.load_state_dict(
            actor_critic_from_jax(to_np(params)).state_dict())
        batch = tuple(torch.tensor(x.reshape(T * B, -1)
                                       if x.ndim == 3 else x.reshape(-1))
                      for x in dataset)
        metrics = learner.minibatch_update(batch)

        np.testing.assert_allclose(metrics.numpy(), np.asarray(jmetrics),
                                   rtol=1e-4, atol=1e-6)
        assert jlr == pytest.approx(1e-3 * lr_factor, rel=1e-6)
        np.testing.assert_allclose(float(learner.lr), jlr, rtol=1e-7)
        state_dicts_close(learner.model, jparams, atol=1e-5)


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
