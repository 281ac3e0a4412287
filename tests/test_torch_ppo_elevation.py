"""Parity of the port's PPO update with the JAX learner's in the regime of
elevation's stall (ROADMAP Queue 3): elevation's widths and settings (obs
689, relu, the fused first layer, hidden 64 x 64, 5 epochs x 4
minibatches, the adaptive LR), returns scaled so that the value loss is
near the reference run's 2e7 at iteration 100 (docs/runs/rss_elev_tpu) and
the global-norm clip binds at every step (the gradient's norm is ~9,000
times the clip's), and the old policy equal to the current one, so that
the KL starts at 0 and the adaptive LR then moves with it. Two consecutive `update_epochs` calls, the second carrying the
first's Adam state and LR, against JAX's `update_epochs` (the `internals`
of `make_ppo`), the port fed JAX's permutation in place of its own
`torch.randperm`."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wheeledlab_tpu.rl.networks import ActorCritic as JActorCritic
from wheeledlab_tpu.rl.networks import fused_actor_critic_apply as j_fused
from wheeledlab_tpu.rl.networks import gaussian_log_prob as j_log_prob
from wheeledlab_tpu.rl.ppo import PPOCfg as JPPOCfg
from wheeledlab_tpu.rl.ppo import make_ppo
from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make_env
from wheeledlab_torch.convert import actor_critic_from_jax
from wheeledlab_torch.rl.ppo import PPO
from wheeledlab_torch.rl.run_cfgs import RSS_ELEV_CONFIG

torch.set_num_threads(1)

T, B, OBS, ACT = 8, 32, 689, 2
# returns about value + N(0, 4500^2): the value loss starts near 4500^2 =
# 2.0e7, the reference's at its stall (docs/runs/rss_elev_tpu, iteration
# 100: 2.7e7), and its gradient is thousands of times the clip norm 1.0
RET_SCALE = 4500.0


def cfgs():
    agent = RSS_ELEV_CONFIG.agent
    jcfg = JPPOCfg(**{f: getattr(agent, f) for f in (
        "num_learning_epochs", "num_mini_batches", "clip_param",
        "value_loss_coef", "use_clipped_value_loss", "entropy_coef",
        "learning_rate", "schedule", "desired_kl", "max_grad_norm", "min_lr",
        "max_lr", "actor_hidden", "critic_hidden", "activation",
        "init_noise_std", "fuse_input_layer")})
    return agent, jcfg


def dataset(model, params, seed):
    """A [T, B] rollout dataset made with numpy around the policy's own
    outputs (the fused apply): the old policy is the current one (KL 0),
    the returns RET_SCALE from the values."""
    rng = np.random.default_rng(seed)
    obs = rng.standard_normal((T, B, OBS)).astype(np.float32)
    mean, std, value = (np.asarray(x) for x in j_fused(model, params, obs))
    action = (mean + std * rng.standard_normal(mean.shape)).astype(np.float32)
    log_prob = np.asarray(j_log_prob(mean, std, action))
    ret = (value + RET_SCALE * rng.standard_normal(value.shape)).astype(
        np.float32)
    adv = rng.standard_normal(value.shape).astype(np.float32)
    adv = (adv - adv.mean()) / adv.std()
    return (obs, action, log_prob, value, ret, adv, mean,
            np.broadcast_to(std, mean.shape).astype(np.float32))


def to_np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def as_module_dict(tree):
    """A flax-shaped tree (parameters or an Adam moment) as the port's
    state dict."""
    return actor_critic_from_jax(to_np(tree), activation="relu").state_dict()


def moments(learner, key):
    names = dict(learner.model.named_parameters())
    return {n: learner.optimizer.state[p][key].clone()
            for n, p in names.items()}


def max_rel(got, want):
    """max |got - want| / max |want| over each tensor: how far apart the
    two are against the tensor's own scale."""
    assert set(got) == set(want)
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30) for k in want)


@pytest.fixture(scope="module")
def both():
    """Two update_epochs calls of each learner from the same weights on the
    same datasets; per call: (JAX params, JAX opt_state, JAX metrics, port
    state dict, Adam's moments, LR, Adam's step count, port metrics)."""
    agent, jcfg = cfgs()
    internals = {}
    make_ppo(j_make_env(JTaskCfg(num_envs=B)), jcfg, internals)
    model = JActorCritic(action_dim=ACT, actor_hidden=jcfg.actor_hidden,
                         critic_hidden=jcfg.critic_hidden,
                         activation=jcfg.activation)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    tx = optax.chain(optax.clip_by_global_norm(jcfg.max_grad_norm),
                     optax.inject_hyperparams(optax.adam)(
                         learning_rate=jcfg.learning_rate))
    env = types.SimpleNamespace(device=torch.device("cpu"), obs_dim=OBS,
                                action_dim=ACT)
    learner = PPO(env, agent)
    assert learner.fused
    learner.model.load_state_dict(as_module_dict(params))

    jparams, jopt, out = params, tx.init(params), []
    perm = {}
    real_randperm = torch.randperm

    def jax_randperm(n, generator=None, device=None):
        return torch.from_numpy(np.asarray(
            jax.random.permutation(perm["key"], n)).astype(np.int64))

    torch.randperm = jax_randperm
    try:
        for call in range(2):
            data = dataset(model, jparams, seed=call)
            perm["key"] = jax.random.PRNGKey(10 + call)
            jparams, jopt, jmetrics = internals["update_epochs"](
                perm["key"], jparams, jopt,
                tuple(jnp.asarray(x) for x in data))
            metrics = learner.update_epochs(
                tuple(torch.from_numpy(np.array(x)) for x in data))
            step = next(iter(learner.optimizer.state.values()))["step"]
            out.append((jparams, jopt, np.asarray(jmetrics),
                        {k: v.clone() for k, v in
                         learner.model.state_dict().items()},
                        moments(learner, "exp_avg"),
                        moments(learner, "exp_avg_sq"),
                        float(learner.lr), int(step), metrics.numpy()))
    finally:
        torch.randperm = real_randperm
    return out


@pytest.mark.parametrize("call", [0, 1])
def test_update_epochs_match_jax(both, call):
    """Per call, against JAX's:

    - the LR after the 20 minibatch steps to 1e-6 relative: both set it
      from their KL estimates at each step (x 1.5 below desired_kl / 2,
      / 1.5 above twice desired_kl), which must fall on the same side of
      each threshold every time;
    - Adam's step count exactly;
    - the metrics (total, surrogate, value, entropy, KL, the mean over the
      minibatches) to 1e-5 relative (measured 1.2e-6): float32 sums in
      another order;
    - Adam's first moment to 1e-5 of each tensor's largest entry (measured
      1.0e-6), its second to 1e-4 (measured 1.4e-5: the square doubles
      the gradient's relative noise, and the clip divides by a global norm
      of ~9,000 that carries its own);
    - the parameters to 1e-5 of each tensor's largest entry (measured
      3.3e-6). Adam moves an entry by about lr m / sqrt(v) whatever the
      gradient's size, so the float noise of the gradients shows in the
      parameters at the scale of lr times their relative noise."""
    jparams, jopt, jmetrics, sd, m1, m2, lr, step, metrics = both[call]
    adam = jopt[1].inner_state[0]
    assert step == int(adam.count) == 20 * (call + 1)
    jlr = float(jopt[1].hyperparams["learning_rate"])
    assert lr == pytest.approx(jlr, rel=1e-6)
    np.testing.assert_allclose(metrics, jmetrics, rtol=1e-5, atol=0)
    want_m1, want_m2 = as_module_dict(adam.mu), as_module_dict(adam.nu)
    assert max_rel(m1, want_m1) < 1e-5, max_rel(m1, want_m1)
    assert max_rel(m2, want_m2) < 1e-4, max_rel(m2, want_m2)
    want = as_module_dict(jparams)
    assert max_rel(sd, want) < 1e-5, max_rel(sd, want)


def test_the_regime_is_the_stall(both):
    """The inputs put both learners where the reference stalled: a value
    loss near 2e7 in both calls, a gradient whose global norm is thousands
    of times the clip norm (the clip binds: the actor's share of the step
    is scaled down with the critic's), and a first step with KL 0, which
    leaves the LR where it was; from there the adaptive LR moves it, the
    same in both learners (`test_update_epochs_match_jax`)."""
    agent, jcfg = cfgs()
    for _, _, jmetrics, *_ in both:
        assert 5e6 < jmetrics[2] < 1e8, jmetrics
    model = JActorCritic(action_dim=ACT, actor_hidden=jcfg.actor_hidden,
                         critic_hidden=jcfg.critic_hidden,
                         activation=jcfg.activation)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS)))
    env = types.SimpleNamespace(device=torch.device("cpu"), obs_dim=OBS,
                                action_dim=ACT)
    learner = PPO(env, agent)
    learner.model.load_state_dict(as_module_dict(params))
    batch = tuple(torch.from_numpy(np.array(
        x.reshape(T * B, -1) if x.ndim == 3 else x.reshape(-1)))
        for x in dataset(model, params, seed=0))
    total, (_, value, _, kl) = learner.loss(batch)
    value, kl = float(value.detach()), float(kl.detach())
    total.backward()
    norm = torch.sqrt(sum((p.grad ** 2).sum()
                          for p in learner.model.parameters()))
    assert kl == 0.0
    assert 1e7 < value < 1e8, value
    assert float(norm) > 1000 * jcfg.max_grad_norm, float(norm)
