"""env_steps_per_s: the env-steps of every iteration completed in the
measured window (num_envs x num_steps_per_env each) over the window, from
its start to the synchronize after the last iteration (host clock)."""


def read(run):
    steps = run.cell.num_envs * run.cell.agent["num_steps_per_env"]
    return run.iterations * steps / run.window_s
