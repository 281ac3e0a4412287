"""Parity of the port's recurrent learner (`wheeledlab_torch/rl/recurrent.py`)
and of its bfloat16 MLP policy with the JAX package on the CPU: the LSTM
actor-critic forward pass on weights carried across with
`convert.actor_critic_recurrent_from_jax`, the ports of
`tests/test_recurrent.py`, flax's init scheme, one minibatch update, a
checkpoint resumed exactly, playback and export of a recurrent run.

Where the flax models are held to rounding points, they run op by op
(`jax.disable_jit`): each operation then rounds to its declared dtype, as
the port's do. Compiled, XLA keeps some bfloat16 intermediates in float32
(its excess-precision rule), so the compiled reference differs from its own
op-by-op run at the bfloat16 level; those comparisons carry that
tolerance. With that rule off (`--xla_allow_excess_precision=false`, in a
process of its own), the compiled reference rounds as declared, and
`TestCompiledExactPrecision` holds the port to it at the op-by-op
bounds."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.traverse_util import flatten_dict

from test_torch_play import jax_play_keys, tiny_run
from test_torch_ppo import rollout_data, to_np
from wheeledlab_tpu.rl.networks import ActorCritic as JActorCritic
from wheeledlab_tpu.rl.networks import gaussian_log_prob as j_log_prob
from wheeledlab_tpu.rl.ppo import PPOCfg as JPPOCfg
from wheeledlab_tpu.rl.ppo import make_ppo
from wheeledlab_tpu.rl.recurrent import ActorCriticRecurrent as JRecurrent
from wheeledlab_tpu.rl.recurrent import RecurrentTransition
from wheeledlab_tpu.rl.recurrent import make_ppo_recurrent
from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make_env
from wheeledlab_torch.cli import export, play
from wheeledlab_torch.convert import (
    actor_critic_from_jax, actor_critic_recurrent_from_jax,
    recurrent_hidden_from_jax,
)
from wheeledlab_torch.rl.ppo import PPO, PPOCfg, make_learner
from wheeledlab_torch.rl.recurrent import (
    ActorCriticRecurrent, RecurrentPPO, RecurrentTrainState,
)
from wheeledlab_torch.rl.runner import checkpoint_steps, train
from wheeledlab_torch.tasks import make_env
from wheeledlab_torch.tasks.drift.task import DriftTaskCfg, make_drift_env
from wheeledlab_torch.utils.config import RUN_CONFIGS, apply_overrides

torch.set_num_threads(1)

OBS, ACT, B, T = 13, 2, 8, 6


def jax_recurrent(seed, hidden=32, layers=1, obs=OBS):
    """flax ActorCriticRecurrent and its params, every leaf moved by a
    seeded normal (0.1) so the biases are not zero."""
    model = JRecurrent(action_dim=ACT, rnn_hidden_size=hidden,
                       rnn_num_layers=layers)
    params = model.init(jax.random.PRNGKey(seed), model.initial_hidden(1),
                        jnp.zeros((1, 1, obs)), jnp.zeros((1, 1)))
    rng = np.random.default_rng(seed)
    return model, jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.normal(0, 0.1, np.shape(a)).astype(
            np.float32), params)


def sequence(seed, model, batch=B, steps=T, obs=OBS):
    """Seeded numpy obs [T, B, D], resets [T, B] (about 30 %) and a
    window-start hidden tree."""
    rng = np.random.default_rng(100 + seed)
    return (rng.standard_normal((steps, batch, obs)).astype(np.float32),
            (rng.random((steps, batch)) < 0.3).astype(np.float32),
            jax.tree_util.tree_map(
                lambda a: 0.5 * rng.standard_normal(a.shape).astype(
                    np.float32), model.initial_hidden(batch)))


def port_apply(params, h0, obs, reset):
    model = actor_critic_recurrent_from_jax(to_np(params))
    with torch.no_grad():
        return model(recurrent_hidden_from_jax(to_np(h0)),
                     torch.from_numpy(obs), torch.from_numpy(reset))


def max_diffs(got, want):
    """Largest |d| of (mean, value, every hidden leaf)."""
    gh, gm, _, gv = got
    wh, wm, _, wv = want
    dh = max(float(np.abs(c.numpy() - np.asarray(wc)).max())
             for chain in ("actor", "critic")
             for pair, wpair in zip(gh[chain], wh[chain])
             for c, wc in zip(pair, wpair))
    return (float(np.abs(gm.numpy() - np.asarray(wm)).max()),
            float(np.abs(gv.numpy() - np.asarray(wv)).max()), dh)


class TestForward:
    @pytest.mark.parametrize("seed,hidden,layers,obs", [
        (0, 32, 1, 13), (1, 16, 2, 14), (2, 32, 1, 14)])
    def test_matches_flax_op_by_op(self, seed, hidden, layers, obs):
        """Same weights, hidden and sequence (resets included): the port
        follows flax's declared rounding points (the projections, their sum
        and the gates in bfloat16; `f * c` and the carry in float32), so it
        agrees with flax run op by op to float32 rounding: the heads' and
        the carry's float32 sums in another order, `tanh` from another
        libm, and a rare bfloat16 product rounded the other way (measured
        over these three cases: 2.4e-7 in the means, 2.7e-7 in the values,
        6.0e-8 in the hidden state)."""
        model, params = jax_recurrent(seed, hidden, layers, obs)
        obs_seq, reset, h0 = sequence(seed, model, obs=obs)
        with jax.disable_jit():
            want = model.apply(params, h0, obs_seq, reset)
        got = port_apply(params, h0, obs_seq, reset)
        dm, dv, dh = max_diffs(got, want)
        assert max(dm, dv, dh) < 2e-6, (dm, dv, dh)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))

    def test_matches_compiled_flax(self):
        """Against the reference as compiled: XLA keeps some of the cell's
        bfloat16 intermediates in float32 (the forget gate enters `f * c`
        unrounded, `i * g` is not rounded), which moves outputs by up to
        6e-3 after 6 steps (measured against the port over the three cases
        above: 2.0e-3 to 5.6e-3 in the means, 1.6e-3 to 2.7e-3 in the
        values, 4.0e-3 to 5.3e-3 in the hidden state); the tolerance is 4
        bfloat16 ulps of an O(1) output, 1.6e-2."""
        model, params = jax_recurrent(0)
        obs_seq, reset, h0 = sequence(0, model)
        want = jax.jit(model.apply)(params, h0, obs_seq, reset)
        dm, dv, dh = max_diffs(port_apply(params, h0, obs_seq, reset), want)
        assert max(dm, dv, dh) < 1.6e-2, (dm, dv, dh)


FORWARD_CASES = [(0, 32, 1, 13), (1, 16, 2, 14), (2, 32, 1, 14)]
GRADIENT_CASES = [(0.3, 5.0), (0.03, 0.5)]


@pytest.fixture(scope="class")
def compiled_exact(tmp_path_factory):
    """`_torch_recurrent_compiled.py` run in a process of its own under
    `--xla_allow_excess_precision=false`: flax's forward on
    FORWARD_CASES, then its minibatch loss and gradient on GRADIENT_CASES'
    data (`recurrent_update_data`). Returns (cases, results)."""
    import pickle
    import subprocess
    import sys

    from _torch_lockstep import exact_precision_env

    cases = []
    for seed, hidden, layers, obs in FORWARD_CASES:
        model, params = jax_recurrent(seed, hidden, layers, obs)
        obs_seq, reset, h0 = sequence(seed, model, obs=obs)
        cases.append(dict(hidden=hidden, layers=layers, params=params,
                          h0=to_np(h0), obs=obs_seq, reset=reset))
    for kl_scale, ret_scale in GRADIENT_CASES:
        _, params, h0, d = recurrent_update_data(0, kl_scale, ret_scale)
        cases.append(dict(hidden=16, layers=1, params=params, h0=to_np(h0),
                          obs=d["obs"], reset=d["reset"], data=d))
    out = tmp_path_factory.mktemp("compiled_exact")
    with open(out / "in.pkl", "wb") as f:
        pickle.dump(cases, f)
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable,
                           os.path.join(here, "_torch_recurrent_compiled.py"),
                           str(out / "in.pkl"), str(out / "out.pkl")],
                          env=exact_precision_env(), capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    with open(out / "out.pkl", "rb") as f:
        return cases, pickle.load(f)


class TestCompiledExactPrecision:
    """Against flax as the runner compiles it, with XLA's excess precision
    off (`--xla_allow_excess_precision=false`, in a process of its own:
    the flag is read when JAX's backend starts). XLA then rounds where
    flax declares, as the port does, so the compiled reference sits where
    the op-by-op one does."""

    @pytest.mark.parametrize("i", range(len(FORWARD_CASES)))
    def test_forward_matches(self, compiled_exact, i):
        """Means, values and hidden state within the op-by-op bound, 2e-6
        (measured over the three cases: 2.4e-7 in the means, 2.7e-7 in
        the values, 2.4e-7 in the hidden state); the std exactly."""
        cases, results = compiled_exact
        c = cases[i]
        got = port_apply(c["params"], c["h0"], c["obs"], c["reset"])
        want = results[i]["forward"]
        dm, dv, dh = max_diffs(got, want)
        print(f"case {FORWARD_CASES[i]}: means {dm:.3g}, values {dv:.3g}, "
              f"hidden {dh:.3g}")
        assert max(dm, dv, dh) < 2e-6, (dm, dv, dh)
        np.testing.assert_array_equal(got[2].numpy(), want[2])

    @pytest.mark.parametrize("i", range(len(GRADIENT_CASES)))
    def test_minibatch_gradient_matches(self, compiled_exact, i):
        """One minibatch's loss terms and gradient (all B envs, the T-step
        window, `make_ppo_recurrent`'s loss jitted) against the port's
        `RecurrentPPO.loss` and autograd from the same parameters and
        data. The loss terms within 1e-5 relative + 1e-6. The gradient:
        the gates' backward follows JAX's rules and the weights' per-step
        gradients add up in float32, as flax's do, so every kernel and
        head agrees within 1e-3 of its tensor's largest entry (measured
        1.6e-4, most kernels bit for bit); the cells' biases within 2e-2
        of theirs (measured 4.6e-3), since XLA reduces a bias's gradient
        over the batch in bfloat16 (the transpose of its broadcast) where
        the port reduces in float32 and rounds once."""
        cases, results = compiled_exact
        c = cases[len(FORWARD_CASES) + i]
        d, res = c["data"], results[len(FORWARD_CASES) + i]
        cfg = PPOCfg(policy_class="ActorCriticRecurrent", rnn_hidden_size=16)
        learner = RecurrentPPO(make_drift_env(DriftTaskCfg(num_envs=B),
                                              device="cpu"), cfg)
        learner.model.load_state_dict(
            actor_critic_recurrent_from_jax(to_np(c["params"])).state_dict())
        t = lambda k: torch.tensor(d[k])
        total, aux = learner.loss((
            recurrent_hidden_from_jax(c["h0"]), t("obs"), t("reset"),
            t("action"), t("log_prob"), t("value"), t("ret"), t("adv"),
            t("mean"), t("std")))
        total.backward()
        np.testing.assert_allclose(
            torch.stack([total, *aux]).detach().numpy(), res["losses"],
            rtol=1e-5, atol=1e-6)
        want = actor_critic_recurrent_from_jax(res["grads"]).state_dict()
        worst = {}
        for k, p in learner.model.named_parameters():
            g = (p.grad if p.grad is not None
                 else torch.zeros_like(p)).numpy()
            scale = max(float(np.abs(want[k].numpy()).max()), 1e-30)
            worst[k] = float(np.abs(g - want[k].numpy()).max()) / scale
        print({k: f"{v:.2e}" for k, v in worst.items()})
        for k, v in worst.items():
            assert v <= (2e-2 if k.endswith(".bh") else 1e-3), (k, v)


def port_model(seed=0, hidden=32):
    return ActorCriticRecurrent(OBS, ACT, rnn_hidden_size=hidden,
                                generator=torch.Generator().manual_seed(seed))


def close_trees(a, b, atol):
    for chain in ("actor", "critic"):
        for pa, pb in zip(a[chain], b[chain]):
            for x, y in zip(pa, pb):
                torch.testing.assert_close(x, y, atol=atol, rtol=0)


class TestModule:
    """Ports of tests/test_recurrent.py::TestModule."""

    def test_sequence_equals_stepwise(self):
        """One T-length sequence == T chained single steps. The sequence
        form projects the obs for all T steps in one product; row for row
        it is the same product, so the results agree to float32
        rounding."""
        model = port_model()
        rng = np.random.default_rng(1)
        obs = torch.from_numpy(rng.standard_normal((T, B, OBS)).astype(
            np.float32))
        reset = torch.from_numpy((rng.random((T, B)) < 0.3).astype(
            np.float32))
        with torch.no_grad():
            h_seq, mean_seq, _, val_seq = model(
                model.initial_hidden(B), obs, reset)
            h = model.initial_hidden(B)
            means, vals = [], []
            for t in range(T):
                h, m, _, v = model.step(h, obs[t], reset[t])
                means.append(m)
                vals.append(v)
        torch.testing.assert_close(mean_seq, torch.stack(means), atol=1e-5,
                                   rtol=0)
        torch.testing.assert_close(val_seq, torch.stack(vals), atol=1e-5,
                                   rtol=0)
        close_trees(h_seq, h, 1e-5)

    def test_done_reset_equals_fresh_hidden(self):
        """reset=1 at step t gives what a zero hidden state gives at t
        (rsl_rl reset(dones))."""
        model = port_model()
        obs = torch.from_numpy(np.random.default_rng(3).standard_normal(
            (3, B, OBS)).astype(np.float32))
        with torch.no_grad():
            h, *_ = model(model.initial_hidden(B), obs[:2],
                          torch.zeros(2, B))
            _, m_reset, _, v_reset = model(h, obs[2:], torch.ones(1, B))
            _, m_fresh, _, v_fresh = model(model.initial_hidden(B), obs[2:],
                                           torch.zeros(1, B))
        torch.testing.assert_close(m_reset, m_fresh, atol=1e-6, rtol=0)
        torch.testing.assert_close(v_reset, v_fresh, atol=1e-6, rtol=0)

    def test_memory_actually_carries(self):
        """Without a reset, an earlier observation changes later
        outputs."""
        model = port_model()
        obs = torch.zeros(2, B, OBS)
        perturbed = obs.clone()
        perturbed[0] = 1.0
        with torch.no_grad():
            _, m1, _, _ = model(model.initial_hidden(B), obs,
                                torch.zeros(2, B))
            _, m2, _, _ = model(model.initial_hidden(B), perturbed,
                                torch.zeros(2, B))
        assert not torch.allclose(m1[1], m2[1], atol=1e-6)

    def test_init_follows_flax_scheme(self):
        """As flax's OptimizedLSTMCell: truncated lecun-normal input kernels
        (the same spread as flax's draw of the same shape), an orthogonal
        recurrent kernel per gate, zero biases; the heads as ActorCritic's;
        log_std = log(init std)."""
        hidden = 256
        model = ActorCriticRecurrent(OBS, ACT, rnn_hidden_size=hidden,
                                     init_noise_std=0.5,
                                     generator=torch.Generator().manual_seed(0))
        jm = JRecurrent(action_dim=ACT, rnn_hidden_size=hidden)
        jp = jm.init(jax.random.PRNGKey(0), jm.initial_hidden(1),
                     jnp.zeros((1, 1, OBS)), jnp.zeros((1, 1)))
        jcell = jp["params"]["memory"]["lstm_a0"]
        for cell in (*model.lstm_a, *model.lstm_c):
            wi = cell.wi.detach().numpy()
            jwi = np.concatenate([np.asarray(jcell[f"i{g}"]["kernel"])
                                  for g in "ifgo"], -1)
            assert wi.shape == jwi.shape == (OBS, 4 * hidden)
            assert abs(wi.std() / jwi.std() - 1) < 0.03
            assert np.abs(wi).max() <= 2 * np.sqrt(1 / OBS) / 0.8796 + 1e-6
            wh = cell.wh.detach().numpy().astype(np.float64)
            for k in range(4):
                w = wh[:, k * hidden:(k + 1) * hidden]
                np.testing.assert_allclose(w.T @ w, np.eye(hidden),
                                           atol=1e-5)
            # flax's recurrent kernels are orthogonal too
            jw = np.asarray(jcell["hf"]["kernel"], np.float64)
            np.testing.assert_allclose(jw.T @ jw, np.eye(hidden), atol=1e-5)
            assert float(cell.bh.detach().abs().max()) == 0.0
        for m in (*model.actor, *model.critic):
            if isinstance(m, torch.nn.Linear):
                assert float(m.bias.detach().abs().max()) == 0.0
                bound = 2 * np.sqrt(1 / m.in_features) / 0.8796 + 1e-6
                assert float(m.weight.detach().abs().max()) <= bound
        np.testing.assert_allclose(model.log_std.detach().numpy(),
                                   np.log([0.5, 0.5]), rtol=1e-6)


# ---------------------------------------------------------------- update


def recurrent_update_data(seed, kl_scale, ret_scale, hidden=16):
    """flax params, window-start hidden and a [T, B] rollout dataset made
    with numpy around the flax policy's outputs (as test_torch_ppo's
    `rollout_data`); the old policy's mean is shifted by `kl_scale`, which
    sets the update's KL and so its adaptive learning rate."""
    model, params = jax_recurrent(seed, hidden, obs=14)
    obs, reset, h0 = sequence(seed, model, obs=14)
    rng = np.random.default_rng(200 + seed)
    with jax.disable_jit():
        _, mean, std, value = (
            jax.tree_util.tree_map(np.asarray, x)
            for x in model.apply(params, h0, obs, reset))
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
    return model, params, h0, dict(
        obs=obs, reset=reset, action=action, log_prob=log_prob,
        value=old_value, ret=ret, adv=adv, mean=old_mean, std=std)


def adam_chain(cfg):
    return optax.chain(
        optax.clip_by_global_norm(cfg.max_grad_norm),
        optax.inject_hyperparams(optax.adam)(learning_rate=cfg.learning_rate))


def params_close(got: dict, want: dict, lr: float):
    """Parameters after one Adam step from the same weights. The first Adam
    step is lr * g / (|g| + eps): about lr * sign(g), whatever g's size.
    Both sides backpropagate through bfloat16 operations that round in
    other places (flax's logistic VJP `g * y * (1 - y)` against the
    autograd of 1 / (1 + exp(-x))), so a gradient entry that is zero up to
    bfloat16 rounding can take the other sign and step 2 lr the other way.
    So: at most 0.5 % of the entries may differ by more than 1e-5, and none
    by more than 2 lr + 1e-5 (measured: 11 of 10,437 bfloat16 MLP entries,
    each by 2 lr; none of 14,661 recurrent entries at the two learning
    rates, whose gates' backward follows JAX's rules)."""
    n_far, n = 0, 0
    for k, w in want.items():
        d = np.abs(got[k].detach().numpy() - w.numpy())
        assert d.max() <= 2 * lr + 1e-5, (k, d.max())
        n_far += int((d > 1e-5).sum())
        n += d.size
    print(f"{n_far} of {n} entries more than 1e-5 apart")
    assert n_far <= 0.005 * n, (n_far, n)


class TestMinibatchUpdate:
    @pytest.mark.parametrize("kl_scale,ret_scale,lr_factor", [
        (0.3, 5.0, 1 / 1.5),    # KL > 2 * desired: lr / 1.5
        (0.03, 0.5, 1.5),       # 0 < KL < desired / 2: lr * 1.5
    ])
    def test_one_update_matches_jax(self, kl_scale, ret_scale, lr_factor):
        """One env-axis minibatch (all B envs, 1 epoch) from the same
        params, h0, trajectory, returns and advantages against JAX's
        `update_epochs`, run op by op: loss terms, the adaptive LR set
        before the step, the global-norm clip and Adam. The loss terms
        agree to float32 rounding, as the forward pass does (measured
        1.5e-6 relative, 5.7e-6 absolute in a total of about 25; bound
        1e-5 relative + 1e-6); the LR exactly; params by
        `params_close`."""
        _, params, h0, d = recurrent_update_data(0, kl_scale, ret_scale)
        jcfg = JPPOCfg(policy_class="ActorCriticRecurrent",
                       rnn_hidden_size=16, num_learning_epochs=1,
                       num_mini_batches=1)
        internals = {}
        make_ppo_recurrent(j_make_env(JTaskCfg(num_envs=B)), jcfg, internals)
        tx = adam_chain(jcfg)
        traj = RecurrentTransition(
            obs=d["obs"], reset=d["reset"], action=d["action"],
            log_prob=d["log_prob"], value=d["value"],
            reward=np.zeros_like(d["value"]), done=d["reset"],
            mean=d["mean"], std=d["std"])
        with jax.disable_jit():
            jparams, jopt, jmetrics = internals["update_epochs"](
                jax.random.PRNGKey(0), params, tx.init(params), h0, traj,
                d["ret"], d["adv"])
        jlr = float(jopt[1].hyperparams["learning_rate"])

        cfg = PPOCfg(policy_class="ActorCriticRecurrent",
                     rnn_hidden_size=16, num_learning_epochs=1,
                     num_mini_batches=1)
        learner = RecurrentPPO(make_drift_env(DriftTaskCfg(num_envs=B),
                                              device="cpu"), cfg)
        learner.model.load_state_dict(
            actor_critic_recurrent_from_jax(to_np(params)).state_dict())
        t = lambda k: torch.tensor(d[k])
        metrics = learner.minibatch_update((
            recurrent_hidden_from_jax(to_np(h0)), t("obs"), t("reset"),
            t("action"), t("log_prob"), t("value"), t("ret"), t("adv"),
            t("mean"), t("std")))

        np.testing.assert_allclose(metrics.numpy(), np.asarray(jmetrics),
                                   rtol=1e-5, atol=1e-6)
        assert jlr == pytest.approx(1e-3 * lr_factor, rel=1e-6)
        np.testing.assert_allclose(float(learner.lr), jlr, rtol=1e-7)
        want = actor_critic_recurrent_from_jax(to_np(jparams)).state_dict()
        params_close(dict(learner.model.named_parameters()), want, jlr)


# ---------------------------------------------------------------- bf16 MLP


@pytest.mark.parametrize("name", ["elu", "relu", "tanh", "gelu"])
def test_activations_match_flax(name):
    """Each activation name is flax's function (`gelu` its tanh
    approximation, flax's default: the exact erf form differs by 4.7e-4),
    to float32 libm rounding (measured at most 9.5e-7 on [-6, 6])."""
    from wheeledlab_tpu.rl.networks import _ACTS as J_ACTS
    from wheeledlab_torch.rl.networks import _ACTS

    x = np.linspace(-6, 6, 10001).astype(np.float32)
    with torch.no_grad():
        got = _ACTS[name]()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(J_ACTS[name](jnp.asarray(x))),
                               atol=2e-6, rtol=0)



class TestBfloat16ActorCritic:
    def test_forward_matches_flax(self):
        """`compute_dtype="bfloat16"`: flax `Dense(dtype=bfloat16)` layers
        (input, kernel and bias cast, the product and the bias sum in
        bfloat16, the activation in bfloat16, the heads cast back to
        float32). The port agrees with flax, run op by op and compiled, but
        for a rare bfloat16 product rounded the other way (another sum
        order): measured 0 differing elements of the means and values at
        three seeds; bound one bfloat16 ulp (2 ** -8 relative) op by op and
        4 ulps compiled, where XLA may keep an intermediate in float32."""
        obs = np.random.default_rng(0).standard_normal((64, 14)).astype(
            np.float32)
        for seed in range(3):
            model = JActorCritic(action_dim=2, compute_dtype="bfloat16")
            params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 14)))
            tm = actor_critic_from_jax(to_np(params),
                                       compute_dtype="bfloat16")
            with torch.no_grad():
                m, s, v = tm(torch.from_numpy(obs))
            assert m.dtype == v.dtype == torch.float32
            with jax.disable_jit():
                jm, js, jv = model.apply(params, jnp.asarray(obs))
            cm, _, cv = jax.jit(model.apply)(params, jnp.asarray(obs))
            for got, eager, compiled in ((m, jm, cm), (v, jv, cv)):
                scale = np.abs(np.asarray(eager)) + 1e-2
                assert (np.abs(got.numpy() - np.asarray(eager))
                        <= scale * 2.0 ** -8).all()
                assert (np.abs(got.numpy() - np.asarray(compiled))
                        <= scale * 2.0 ** -6).all()
            np.testing.assert_array_equal(s.numpy(), np.asarray(js))

    def test_one_update_matches_jax(self):
        """One bfloat16 minibatch update (obs stored in bfloat16) against
        JAX's `update_epochs` with `compute_dtype="bfloat16"`, run op by
        op; tolerances as TestMinibatchUpdate's (measured: loss terms 3.4e-7
        relative, 11 of 10,437 parameters 2 lr apart)."""
        params, dataset = rollout_data(0, 0.3, 5.0)
        model = JActorCritic(action_dim=2, compute_dtype="bfloat16")
        params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 14)))
        obs = dataset[0].astype(jnp.bfloat16)
        jcfg = JPPOCfg(num_learning_epochs=1, num_mini_batches=1,
                       compute_dtype="bfloat16")
        internals = {}
        make_ppo(j_make_env(JTaskCfg(num_envs=16)), jcfg, internals)
        tx = adam_chain(jcfg)
        with jax.disable_jit():
            jparams, jopt, jmetrics = internals["update_epochs"](
                jax.random.PRNGKey(0), params, tx.init(params),
                (jnp.asarray(obs),) + tuple(jnp.asarray(x)
                                            for x in dataset[1:]))
        jlr = float(jopt[1].hyperparams["learning_rate"])

        cfg = PPOCfg(num_learning_epochs=1, num_mini_batches=1,
                     compute_dtype="bfloat16")
        learner = PPO(make_drift_env(DriftTaskCfg(num_envs=16),
                                     device="cpu"), cfg)
        assert learner.obs_dtype == torch.bfloat16
        learner.model.load_state_dict(
            actor_critic_from_jax(to_np(params)).state_dict())
        n = dataset[0].shape[0] * dataset[0].shape[1]
        tobs = torch.from_numpy(dataset[0].reshape(n, -1)).to(torch.bfloat16)
        batch = (tobs,) + tuple(torch.tensor(x.reshape(n, -1) if x.ndim == 3
                                             else x.reshape(-1))
                                for x in dataset[1:])
        metrics = learner.minibatch_update(batch)
        np.testing.assert_allclose(metrics.numpy(), np.asarray(jmetrics),
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(float(learner.lr), jlr, rtol=1e-7)
        want = actor_critic_from_jax(to_np(jparams)).state_dict()
        params_close(dict(learner.model.named_parameters()), want, jlr)

    def test_rollout_stores_bfloat16_obs(self):
        """The bf16 learner's rollout stores its obs in bfloat16 (JAX
        `store_obs`) and its iteration is finite; the recurrent learner
        ignores `compute_dtype`."""
        env = make_env("MushrDriftRL-v0", num_envs=8, device="cpu")
        cfg = PPOCfg(num_steps_per_env=4, num_learning_epochs=1,
                     num_mini_batches=2, compute_dtype="bfloat16")
        learner = make_learner(env, cfg)
        _, _, traj, _ = learner.rollout(learner.init_state())
        assert traj["obs"].dtype == torch.bfloat16
        assert traj["action"].dtype == torch.float32
        _, metrics = learner.train_iteration(learner.init_state())
        assert all(bool(torch.isfinite(v).all()) for v in metrics.values())
        rnn = make_learner(env, cfg.replace(
            policy_class="ActorCriticRecurrent", rnn_hidden_size=8))
        assert rnn.obs_dtype == torch.float32


# ---------------------------------------------------------------- training


def rnn_cfg(**kw):
    return PPOCfg(policy_class="ActorCriticRecurrent", **kw)


class TestRecurrentPPO:
    """Ports of tests/test_recurrent.py::TestRecurrentPPO."""

    def test_train_iteration_runs_and_is_finite(self):
        env = make_env("MushrDriftRL-v0", num_envs=16, device="cpu")
        learner = make_learner(env, rnn_cfg(
            rnn_hidden_size=32, num_steps_per_env=8, num_learning_epochs=2,
            num_mini_batches=2))
        assert isinstance(learner, RecurrentPPO)
        state = learner.init_state()
        state, metrics = learner.train_iteration(state)
        state, metrics = learner.train_iteration(state)
        assert state.iteration == 2
        for k, v in metrics.items():
            assert bool(torch.isfinite(v).all()), (k, v)
        for chain in ("actor", "critic"):
            for c, h in state.hidden[chain]:
                assert c.shape == h.shape == (16, 32)
                assert bool(torch.isfinite(c).all() & torch.isfinite(h).all())
        assert state.reset_prev.shape == (16,)
        with torch.no_grad():
            hidden, mean, std, value = learner.model.step(
                state.hidden, state.obs, state.reset_prev)
        assert mean.shape == (16, env.action_dim) and value.shape == (16,)

    def test_loss_decreases_on_frozen_batch(self):
        """A few updates on the same rollout reduce the PPO loss: the
        gradient flows through the BPTT chain."""
        env = make_env("MushrDriftRL-v0", num_envs=8, device="cpu", seed=1)
        learner = make_learner(env, rnn_cfg(
            rnn_hidden_size=16, num_steps_per_env=8, num_learning_epochs=1,
            num_mini_batches=1, schedule="fixed", learning_rate=3e-4),
            seed=1)
        _, _, _, _, h0, traj, _ = learner.rollout(learner.init_state())
        _, returns, norm_adv = learner.compute_gae(
            traj["reward"], traj["value"], traj["done"], torch.zeros(8))
        dataset = (traj["obs"], traj["reset"], traj["action"],
                   traj["log_prob"], traj["value"], returns, norm_adv,
                   traj["mean"], traj["std"])
        losses = [float(learner.update_epochs(h0, dataset)[0])
                  for _ in range(4)]
        assert losses[-1] < losses[0], losses

    def test_minibatches_split_the_env_axis(self):
        """One env permutation from the learner's generator, shared by the
        epochs; a minibatch is time-major [T, mb_envs] with the window-start
        hidden of the same envs."""
        env = make_env("MushrDriftRL-v0", num_envs=8, device="cpu")
        learner = make_learner(env, rnn_cfg(
            rnn_hidden_size=4, num_steps_per_env=3, num_learning_epochs=2,
            num_mini_batches=2))
        seen = []
        learner.minibatch_update = lambda batch: (
            seen.append(batch), torch.zeros(5))[1]
        h0 = learner.model.initial_hidden(8)
        h0["actor"][0] = (torch.arange(8.0)[:, None].repeat(1, 4),
                          h0["actor"][0][1])
        ids = torch.arange(8.0).repeat(3, 1)                  # [T, B]
        gen = torch.Generator().set_state(learner.generator.get_state())
        learner.update_epochs(h0, (ids[..., None].repeat(1, 1, 14), ids) +
                              (ids,) * 7)
        perm = torch.randperm(8, generator=gen)
        assert len(seen) == 4
        for i, batch in enumerate(seen):
            cols = perm[(i % 2) * 4:(i % 2 + 1) * 4]
            assert batch[1].shape == (3, 4, 14)
            assert torch.equal(batch[2], cols.float().repeat(3, 1))
            assert torch.equal(batch[0]["actor"][0][0][:, 0], cols.float())


class TestRecurrentImproves:
    """Port of tests/test_recurrent.py::TestRecurrentImproves, at its size
    and with its bars: recurrent PPO on the drift MDP raises the rollout
    reward at CPU scale (about 57 s on one worker). Measured on the port,
    seeds 0-2 (env and learner): first5 0.74 / 0.79 / 0.79 -> last5 1.75 /
    1.82 / 2.26 (ratios 2.37 / 2.32 / 2.87), so the 1.3x / +0.3 bars hold
    with margin. At 128 envs the same bars missed at two of three seeds
    (+0.28), so the size is not cut."""

    def test_recurrent_drift_improves(self):
        env = make_env("MushrDriftRL-v0", num_envs=256, device="cpu")
        learner = make_learner(env, rnn_cfg(
            rnn_hidden_size=64, num_steps_per_env=32, num_learning_epochs=3,
            num_mini_batches=4))
        state = learner.init_state()
        rews = []
        for _ in range(40):
            state, m = learner.train_iteration(state)
            rews.append(float(m["rollout/reward_mean"]))
            assert np.isfinite(rews[-1])
        first5, last5 = np.mean(rews[:5]), np.mean(rews[-5:])
        assert last5 > first5 + 0.3, (first5, last5)
        assert last5 > 1.3 * first5, (first5, last5)


# ---------------------------------------------------- runner, play, export

TINY_RNN = {"num_envs": 8, "agent.num_steps_per_env": 4,
            "agent.num_learning_epochs": 1, "agent.num_mini_batches": 2,
            "agent.rnn_hidden_size": 8, "train.log.log_every": 1,
            "train.log.checkpoint_every": 1, "device": "cpu"}


def rnn_run_cfg(logs, run_name, iterations, **extra):
    return apply_overrides(RUN_CONFIGS.get("RSS_DRIFT_RNN_CONFIG"), {
        **TINY_RNN, "train.log.logs_dir": str(logs),
        "train.log.run_name": run_name, "train.num_iterations": iterations,
        **extra})


class TestRunner:
    def test_config_is_registered_as_jax(self):
        from wheeledlab_tpu.utils.config import RUN_CONFIGS as J_RUN_CONFIGS
        import wheeledlab_tpu.rl  # noqa: F401  registers the JAX configs

        cfg = RUN_CONFIGS.get("RSS_DRIFT_RNN_CONFIG")
        jcfg = J_RUN_CONFIGS.get("RSS_DRIFT_RNN_CONFIG")
        assert (cfg.task_name, cfg.num_envs, cfg.train.num_iterations) == (
            jcfg.task_name, jcfg.num_envs, jcfg.train.num_iterations)
        assert dataclasses.asdict(cfg.agent) == dataclasses.asdict(jcfg.agent)

    def test_checkpoint_and_exact_resume(self, tmp_path):
        """Iterations 1-2, then a resume from the checkpoint at 2 to 3,
        equal a straight 3-iteration run: the checkpoint holds the LSTM
        carry (hidden, reset_prev) beside the model, Adam, the env state
        and both generators."""
        state, _ = train(rnn_run_cfg(tmp_path, "r1", 2), verbose=False)
        assert isinstance(state, RecurrentTrainState)
        ck = torch.load(tmp_path / "r1" / "checkpoints" / "2.pt",
                        weights_only=True)
        assert torch.equal(ck["reset_prev"], state.reset_prev)
        close_trees(ck["hidden"], state.hidden, 0)
        train(rnn_run_cfg(tmp_path, "r2", 3, **{"train.load_run": "r1"}),
              verbose=False)
        resumed = read_rows(tmp_path, "r2")
        assert [r["iteration"] for r in resumed] == [3]
        train(rnn_run_cfg(tmp_path, "r3", 3), verbose=False)
        straight = read_rows(tmp_path, "r3")[-1]
        for k in ("loss/total", "loss/kl", "lr", "rollout/reward_mean",
                  "episode/num_dones", "metrics/speed"):
            assert resumed[0][k] == straight[k], k

    def test_cli_runs_on_cpu(self, tmp_path):
        from wheeledlab_torch.cli import train as train_cli

        train_cli.main(["-r", "RSS_DRIFT_RNN_CONFIG", "--device", "cpu",
                        "--num-envs", "8", "--max-iterations", "1",
                        "agent.num_steps_per_env=4",
                        "agent.rnn_hidden_size=8",
                        f"train.log.logs_dir={tmp_path}",
                        "train.log.run_name=cli"])
        assert checkpoint_steps(str(tmp_path / "cli")) == [1]


def read_rows(logs, run_name):
    with open(os.path.join(logs, run_name, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


class TestPlayAndExport:
    def test_recurrent_play_writes_the_jax_keys(self, tmp_path):
        """A recurrent run plays (zero hidden, deterministic mean, carry
        reset by done) and writes the JAX play's npz and metric keys."""
        tiny_run(tmp_path, "RSS_DRIFT_RNN_CONFIG", "rnn",
                 **{"agent.rnn_hidden_size": 8})
        metrics = play.main(["--run", "rnn", "--logs-dir", str(tmp_path),
                             "--steps", "10", "--num-envs", "4",
                             "--device", "cpu"])
        npz_keys, metric_keys = jax_play_keys()
        out = np.load(tmp_path / "rnn" / "play" / "rnn-rollouts.npz")
        assert set(out.files) == npz_keys
        assert out["observations"].shape == (10, 4, 14)
        assert set(metrics) <= metric_keys
        assert {"reward_mean", "speed_mean"} <= set(metrics)
        assert all(np.isfinite(v) for v in metrics.values())

    def test_play_steps_the_recurrent_policy(self, tmp_path):
        """The played actions are the recurrent policy's means, step by
        step from a zero hidden, its carry reset where the previous step
        ended an episode."""
        tiny_run(tmp_path, "RSS_DRIFT_RNN_CONFIG", "rnn",
                 **{"agent.rnn_hidden_size": 8})
        play.main(["--run", "rnn", "--logs-dir", str(tmp_path), "--steps",
                   "6", "--num-envs", "3", "--device", "cpu"])
        out = np.load(tmp_path / "rnn" / "play" / "rnn-rollouts.npz")
        ck = torch.load(tmp_path / "rnn" / "checkpoints" / "1.pt",
                        weights_only=True)
        model = ActorCriticRecurrent(14, 2, rnn_hidden_size=8)
        model.load_state_dict(ck["learner"]["model"])
        obs = torch.from_numpy(out["observations"])
        with torch.no_grad():
            _, mean, _, _ = model(model.initial_hidden(3), obs,
                                  torch.zeros(6, 3))
        # no episode ends in 6 play steps, so no reset fires
        np.testing.assert_allclose(out["actions"], mean.numpy(), atol=1e-6)

    def test_export_matches_flatten_dict(self, tmp_path):
        """flax params -> the port's model -> a recurrent run's checkpoint
        -> cli/export: the npz holds exactly `flatten_dict(params["params"])`
        joined with "." (keys and values), with the JAX export's metadata;
        `--format pt` writes the npz alone."""
        tiny_run(tmp_path, "RSS_DRIFT_RNN_CONFIG", "rnn",
                 **{"agent.rnn_hidden_size": 16})
        _, params = jax_recurrent(3, hidden=16, obs=14)
        run_dir = str(tmp_path / "rnn")
        path = os.path.join(run_dir, "checkpoints", "1.pt")
        ck = torch.load(path, weights_only=True)
        ck["learner"]["model"] = actor_critic_recurrent_from_jax(
            to_np(params)).state_dict()
        torch.save(ck, path)

        want = {".".join(k): np.asarray(v)
                for k, v in flatten_dict(params["params"]).items()}
        for fmt in ("both", "pt"):
            written = export.main(["--run", "rnn", "--logs-dir",
                                   str(tmp_path), "--device", "cpu",
                                   "--format", fmt])
            assert written == [os.path.join(run_dir, "export",
                                            "rnn-policy.npz")]
        npz = np.load(written[0])
        assert sorted(npz.files) == sorted(["__meta__", *want])
        for k, w in want.items():
            assert npz[k].shape == w.shape, k
            np.testing.assert_array_equal(npz[k], w, err_msg=k)
        meta = json.loads(bytes(npz["__meta__"]).decode())
        assert sorted(meta) == sorted([
            "task", "iteration", "obs_dim", "action_dim", "activation",
            "actor_hidden", "critic_hidden", "action_scale", "action_offset",
            "policy_class"])
        assert meta["policy_class"] == "ActorCriticRecurrent"


if __name__ == "__main__":
    import sys

    sys.exit(pytest.main([__file__, "-x", "-q"]))
