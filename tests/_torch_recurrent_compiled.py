"""flax's recurrent actor-critic and its PPO minibatch gradient, compiled,
in a process of its own (tests/test_torch_recurrent.py::
TestCompiledExactPrecision).

    python _torch_recurrent_compiled.py <in.pkl> <out.pkl>

`in.pkl` holds a list of cases, each a dict of `hidden`, `layers`,
`params`, `h0`, `obs`, `reset` and, for a gradient, `data` (the minibatch's
columns as `recurrent_update_data` makes them). `out.pkl` gets, for each,
`jax.jit(model.apply)`'s (hidden, mean, std, value) and, with `data`,
`make_ppo_recurrent`'s minibatch loss terms and gradient, jitted. The
parent starts it with `--xla_allow_excess_precision=false` in `XLA_FLAGS`,
which XLA reads when JAX's backend starts.
"""

import pickle
import sys


def main():
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from wheeledlab_tpu.rl.ppo import PPOCfg
    from wheeledlab_tpu.rl.recurrent import (
        ActorCriticRecurrent, RecurrentTransition, make_ppo_recurrent)
    from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg, make_drift_env

    to_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)
    with open(sys.argv[1], "rb") as f:
        cases = pickle.load(f)
    out = []
    for c in cases:
        model = ActorCriticRecurrent(action_dim=2, rnn_hidden_size=c["hidden"],
                                     rnn_num_layers=c["layers"])
        res = dict(forward=to_np(jax.jit(model.apply)(
            c["params"], c["h0"], c["obs"], c["reset"])))
        if "data" in c:
            d = c["data"]
            cfg = PPOCfg(policy_class="ActorCriticRecurrent",
                         rnn_hidden_size=c["hidden"],
                         rnn_num_layers=c["layers"])
            internals = {}
            make_ppo_recurrent(make_drift_env(DriftTaskCfg(
                num_envs=c["obs"].shape[1])), cfg, internals)
            update = internals["update_epochs"]
            mb = update.__closure__[update.__code__.co_freevars.index(
                "minibatch_update")].cell_contents
            grad_fn = mb.__closure__[mb.__code__.co_freevars.index(
                "grad_fn")].cell_contents
            traj = RecurrentTransition(
                obs=d["obs"], reset=d["reset"], action=d["action"],
                log_prob=d["log_prob"], value=d["value"],
                reward=np.zeros_like(d["value"]), done=d["reset"],
                mean=d["mean"], std=d["std"])
            (total, aux), grads = jax.jit(grad_fn)(
                c["params"], (c["h0"], traj, d["ret"], d["adv"]),
                cfg.clip_param)
            res.update(losses=np.asarray([total, *aux]), grads=to_np(grads))
        out.append(res)
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main()
