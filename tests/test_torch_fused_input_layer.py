"""The fused first layer of the port (`rl/networks.py::
fused_actor_critic_apply`, `PPOCfg.fuse_input_layer`) on the CPU: held
against JAX's `fused_actor_critic_apply` on the same flax parameters and
against the port's unfused forward; the state dict unchanged; which learners
take it (ELEV_PPO and VISUAL_PPO do, DRIFT_PPO and the recurrent learner do
not); training, resume and play through it; `scale_bench --fuse-input-layer`
(the counterparts of tests/test_ppo.py::TestFusedInputLayer)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.rl.networks import ActorCritic as JActorCritic
from wheeledlab_tpu.rl.networks import (
    fused_actor_critic_apply as j_fused_apply,
)
import wheeledlab_torch.rl  # noqa: F401  registers run configs
from wheeledlab_torch.convert import actor_critic_from_jax
from wheeledlab_torch.rl import networks
from wheeledlab_torch.rl.networks import fused_actor_critic_apply
from wheeledlab_torch.rl.ppo import PPOCfg, make_learner
from wheeledlab_torch.rl.run_cfgs import DRIFT_PPO, ELEV_PPO, VISUAL_PPO
from wheeledlab_torch.rl.runner import train
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

torch.set_num_threads(1)

# float32: the bar of tests/test_ppo.py::test_matches_module_apply. The
# fused product sums in another blocking than the two N = 64 products, so
# the two agree to a few ulp, not bit for bit. Measured on the CPU: the
# port's fused apply within 9.6e-7 of JAX's at 57, 689 and 3208 wide, and
# equal to its own unfused forward.
F32_TOL = dict(rtol=0.0, atol=1e-5)
# bfloat16: both compute flax's `Dense(dtype=bfloat16)` (operands rounded
# to bfloat16, the product and the bias each rounded to bfloat16). Measured
# on the CPU: equal bit for bit to JAX's and to the unfused forward at the
# shapes below. The bound: one bfloat16 ulp of the value (at most 2^-7 of
# it) plus four of the head's largest value. Where two float32
# accumulations of the first product round to neighbouring bfloat16
# values, the later layers carry that ulp into the heads, where a sum with
# cancellation may make it more than an ulp of a small output.
# chip_smoke.py holds the fused forward to it on the card.
BF16_REL, BF16_OF_MAX = 2.0 ** -7, 4 * 2.0 ** -7

# JAX's test shape (tests/test_ppo.py:161) and elevation's observation
ROWS = 33
WIDTHS = (57, 689)


def flax_pair(activation, obs_dim, compute_dtype="float32"):
    """A flax ActorCritic, its parameters (PRNGKey 0) and the port's model
    carrying them."""
    jm = JActorCritic(action_dim=2, activation=activation,
                      compute_dtype=compute_dtype)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, obs_dim)))
    model = actor_critic_from_jax(jax.tree_util.tree_map(np.asarray, params),
                                  activation, compute_dtype)
    return jm, params, model


def obs_rows(obs_dim, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (ROWS, obs_dim)).astype(np.float32)


def assert_heads(got, want, tol):
    for name, g, w in zip(("mean", "std", "value"), got, want):
        np.testing.assert_allclose(np.asarray(g, dtype=np.float32),
                                   np.asarray(w, dtype=np.float32),
                                   err_msg=name, **tol)


def assert_bf16_heads(got, want):
    for name, g, w in zip(("mean", "std", "value"), got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        bound = BF16_REL * np.abs(w) + BF16_OF_MAX * np.abs(w).max()
        assert (np.abs(g - w) <= bound).all(), (name, np.abs(g - w).max())


class TestFusedApply:
    @pytest.mark.parametrize("obs_dim", WIDTHS)
    @pytest.mark.parametrize("activation", ["elu", "relu"])
    def test_matches_jax_and_the_unfused_forward(self, activation, obs_dim):
        jm, params, model = flax_pair(activation, obs_dim)
        obs = obs_rows(obs_dim)
        want = j_fused_apply(jm, params, jnp.asarray(obs))
        with torch.no_grad():
            got = fused_actor_critic_apply(model, torch.from_numpy(obs))
            unfused = model(torch.from_numpy(obs))
        assert got[0].dtype == got[2].dtype == torch.float32
        assert got[0].shape == (ROWS, 2) and got[2].shape == (ROWS,)
        assert_heads([g.numpy() for g in got], want, F32_TOL)
        assert_heads([g.numpy() for g in got],
                     [u.numpy() for u in unfused], F32_TOL)

    @pytest.mark.parametrize("obs_dim", WIDTHS)
    @pytest.mark.parametrize("activation", ["elu", "relu"])
    def test_bfloat16_matches_jax_and_the_unfused_forward(self, activation,
                                                          obs_dim):
        jm, params, model = flax_pair(activation, obs_dim, "bfloat16")
        obs = obs_rows(obs_dim)
        want = j_fused_apply(jm, params, jnp.asarray(obs))
        with torch.no_grad():
            got = fused_actor_critic_apply(model, torch.from_numpy(obs))
            unfused = model(torch.from_numpy(obs))
        assert got[0].dtype == got[2].dtype == torch.float32
        got = [g.numpy() for g in got]
        assert_bf16_heads(got, want)
        assert_bf16_heads(got, [u.numpy() for u in unfused])

    def test_gradients_match_the_unfused_forward(self):
        """Autograd through the concatenation reaches both first layers:
        the gradients of a loss of (mean, std, value) equal the unfused
        forward's within the float32 bar."""
        _, _, model = flax_pair("relu", 689)
        obs = torch.from_numpy(obs_rows(689))

        def grads(apply):
            model.zero_grad(set_to_none=True)
            mean, std, value = apply(obs)
            (mean.square().sum() + std.log().sum() + value.sum()).backward()
            return {k: p.grad.clone() for k, p in model.named_parameters()}

        fused = grads(lambda o: fused_actor_critic_apply(model, o))
        plain = grads(model)
        assert fused.keys() == plain.keys()
        for k in plain:
            torch.testing.assert_close(fused[k], plain[k], **F32_TOL)


def tiny_drift(num_envs=8):
    return make_env("MushrDriftRL-v0", num_envs=num_envs, device="cpu")


def fused_calls(fn):
    """The result of `fn()` and the calls of the fused apply it made."""
    before = networks.FUSED_CALLS
    out = fn()
    return out, networks.FUSED_CALLS - before


TINY_PPO = dict(num_steps_per_env=8, num_mini_batches=2,
                num_learning_epochs=2)


class TestLearner:
    @pytest.mark.parametrize("name,agent,fused", [
        ("ELEV_PPO", ELEV_PPO, True), ("VISUAL_PPO", VISUAL_PPO, True),
        ("DRIFT_PPO", DRIFT_PPO, False),
        ("recurrent", DRIFT_PPO.replace(
            policy_class="ActorCriticRecurrent", rnn_hidden_size=8,
            fuse_input_layer=True), False),
        ("unequal widths", ELEV_PPO.replace(critic_hidden=(32, 32)), False),
    ])
    def test_which_learners_take_the_fused_path(self, name, agent, fused):
        """A train iteration calls the fused apply at every rollout step,
        in every minibatch update and for the bootstrap value when the
        config asks for it and the first widths agree; never otherwise
        (JAX: `make_ppo` falls back to `model.apply`)."""
        cfg = agent.replace(**TINY_PPO)
        learner = make_learner(tiny_drift(), cfg)
        assert learner.fused == fused
        state = learner.init_state()
        (_, m), calls = fused_calls(lambda: learner.train_iteration(state))
        assert np.isfinite(float(m["loss/total"]))
        assert calls == (8 + 2 * 2 + 1 if fused else 0)

    def test_named_configs(self):
        assert RUN_CONFIGS.get("RSS_ELEV_CONFIG").agent.fuse_input_layer
        assert RUN_CONFIGS.get("RSS_VISUAL_CONFIG").agent.fuse_input_layer
        for name in ("RSS_DRIFT_CONFIG", "F1TENTH_DRIFT_CONFIG",
                     "RSS_DRIFT_RNN_CONFIG", "POD_DRIFT_CONFIG"):
            assert not RUN_CONFIGS.get(name).agent.fuse_input_layer, name

    def test_state_dict_unchanged(self):
        env = tiny_drift()
        sd = {fuse: make_learner(env, PPOCfg(fuse_input_layer=fuse))
              .model.state_dict() for fuse in (False, True)}
        assert {k: v.shape for k, v in sd[True].items()} == \
            {k: v.shape for k, v in sd[False].items()}
        for k in sd[False]:
            torch.testing.assert_close(sd[True][k], sd[False][k],
                                       rtol=0, atol=0)

    def test_training_learns_with_fusion(self):
        """A short fused PPO run on drift (JAX tests/test_ppo.py:172): 8
        envs, 8 steps, 2 epochs x 2 minibatches, 2 iterations; finite
        losses, the parameters moved and the adaptive LR within its
        limits; the policy gives float32 heads of the right shapes."""
        cfg = PPOCfg(fuse_input_layer=True, **TINY_PPO)
        learner = make_learner(tiny_drift(), cfg)
        before = [p.detach().clone() for p in learner.model.parameters()]
        state = learner.init_state()
        for _ in range(2):
            state, metrics = learner.train_iteration(state)
        assert np.isfinite(float(metrics["loss/total"]))
        assert all(not torch.equal(b, p) for b, p in
                   zip(before, learner.model.parameters()))
        assert cfg.min_lr <= float(metrics["lr"]) <= cfg.max_lr
        with torch.no_grad():
            mean, std, value = learner.policy_apply(
                torch.zeros((4, learner.env.obs_dim)))
        assert mean.shape == std.shape == (4, 2) and value.shape == (4,)
        assert mean.dtype == value.dtype == torch.float32

    def test_unfused_checkpoint_resumes_fused(self, tmp_path):
        """A run written with the plain apply loads into a fused learner
        and goes on: the keys and shapes agree, the resumed iteration runs
        through the fused apply, and its rollout equals an unfused resume
        of the same checkpoint within the float32 bar."""
        def cfg(run, iters, fuse, **extra):
            return apply_overrides(RUN_CONFIGS.get("RSS_DRIFT_CONFIG"), {
                "num_envs": 16, "agent.num_steps_per_env": 8,
                "agent.num_learning_epochs": 2, "agent.num_mini_batches": 2,
                "agent.fuse_input_layer": fuse, "device": "cpu",
                "train.log.logs_dir": str(tmp_path),
                "train.log.run_name": run, "train.num_iterations": iters,
                **extra})

        train(cfg("plain", 1, False), verbose=False)
        resumed = {}
        for fuse in (True, False):
            (state, last), calls = fused_calls(lambda: train(cfg(
                f"resume-{fuse}", 2, fuse, **{"train.load_run": "plain"}),
                verbose=False))
            assert state.iteration == 2
            assert calls == (8 + 2 * 2 + 1 if fuse else 0)
            resumed[fuse] = last
        for k in ("rollout/reward_mean", "episode/num_dones"):
            np.testing.assert_allclose(resumed[True][k], resumed[False][k],
                                       err_msg=k, **F32_TOL)


SMALL_MAP = {"map_rows": 100, "map_cols": 100, "env_rows": 20,
             "env_cols": 20, "group_rows": 5, "group_cols": 5}


def test_play_of_a_visual_run_is_fused(tmp_path):
    """`cli/play.py` plays a saved RSS_VISUAL_CONFIG run through the
    learner's apply, which its saved agent config makes the fused one: one
    call a played step (JAX cli/play.py:62,88)."""
    from wheeledlab_torch.cli import play

    cfg = RUN_CONFIGS.get("RSS_VISUAL_CONFIG")
    cfg = apply_overrides(cfg.replace(env_overrides={
        **cfg.env_overrides, **SMALL_MAP}), {
        "num_envs": 8, "agent.num_steps_per_env": 4,
        "agent.num_learning_epochs": 1, "agent.num_mini_batches": 2,
        "train.num_iterations": 1, "train.log.logs_dir": str(tmp_path),
        "train.log.run_name": "vis", "device": "cpu"})
    _, calls = fused_calls(lambda: train(cfg, verbose=False))
    assert calls == 4 + 1 * 2 + 1
    metrics, calls = fused_calls(lambda: play.main([
        "--run", "vis", "--logs-dir", str(tmp_path), "--steps", "3",
        "--num-envs", "2", "--device", "cpu"]))
    assert calls == 3
    assert np.isfinite(metrics["reward_mean"])


class TestScaleBench:
    def test_fuse_needs_full_ppo(self, capsys):
        """JAX's rule (scripts/scale_bench.py:76-78)."""
        from wheeledlab_torch.scripts import scale_bench

        with pytest.raises(SystemExit) as e:
            scale_bench.main(["--device", "cpu", "--fuse-input-layer"])
        assert e.value.code == 2
        assert "--full-ppo" in capsys.readouterr().err

    def test_fused_full_ppo_row(self):
        from wheeledlab_torch.scripts import scale_bench

        row, calls = fused_calls(lambda: scale_bench.main([
            "--device", "cpu", "--envs-per-device", "8", "--rollout", "4",
            "--min-wall", "0.05", "--full-ppo", "--fuse-input-layer"]))
        assert row["mode"] == "full_ppo" and row["fuse_input_layer"]
        # a train iteration: 4 rollout steps, the bootstrap value and
        # 5 epochs x 4 minibatches; 2 warm-ups, then windows that grow
        # until one is long enough
        per = 4 + 1 + 5 * 4
        assert calls % per == 0 and calls >= per * (2 + row["timed_iters"])
