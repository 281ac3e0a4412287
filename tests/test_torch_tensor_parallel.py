"""Tensor parallelism of the port (`parallel/mesh.py::make_mesh`,
`shard_params_model_parallel`, `parallel/distributed.py::global_mesh`,
`gather_columns`, `parallel/tensor_parallel.py`) in real gloo jobs on the
CPU, the counterpart of tests/test_sharding.py::TestTensorParallel.

Two jobs (`_torch_tensor_parallel_worker.py`, 127.0.0.1, a free port): a
world of 2 ranks with m = 2 (one data index) and a world of 4 with data 2
x model 2, JAX's (4, 2) mesh at half size. Every rank builds its share of
the flax ActorCritic of tests/test_sharding.py (action 2, obs 14,
PRNGKey 0), runs its data index's rows of the 16 x 14 batch and takes one
PPO loss of them; the parent holds the shares' forward and gradients
against the one-process policy and JAX's `model.apply`.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wheeledlab_tpu.parallel.mesh import make_mesh as j_make_mesh
from wheeledlab_tpu.parallel.mesh import (
    shard_params_model_parallel as j_shard_params,
)
from wheeledlab_tpu.rl.networks import ActorCritic as JActorCritic
from wheeledlab_torch.convert import actor_critic_from_jax
from wheeledlab_torch.parallel import distributed
from wheeledlab_torch.parallel.mesh import (
    make_mesh, model_parallel_placement, shard_params_model_parallel,
)
from wheeledlab_torch.parallel.tensor_parallel import (
    TensorParallelActorCritic,
)
from wheeledlab_torch.rl.ppo import PPOCfg, make_learner
from wheeledlab_torch.tasks import make_env

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_distributed import run_job  # noqa: E402

torch.set_num_threads(1)

WORKER = os.path.join(os.path.dirname(__file__),
                      "_torch_tensor_parallel_worker.py")
# tests/test_sharding.py's bar. A share's product runs over fewer output
# columns than the whole layer's, which may block the sum another way: the
# two agree to float32 rounding. The gather itself adds only zeros.
TP_TOL = dict(rtol=1e-5, atol=1e-5)
OBS_DIM, ROWS = 14, 16


@pytest.fixture(scope="module")
def reference():
    """The flax policy, its parameters as numpy, the 16 x 14 batch and one
    PPO minibatch's other columns (numpy, seed 0), JAX's forward, and the
    one-process port's forward and gradients of the PPO loss."""
    jm = JActorCritic(action_dim=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))
    obs = jax.random.normal(jax.random.PRNGKey(1), (ROWS, OBS_DIM))
    jax_out = [np.asarray(x) for x in jm.apply(params, obs)]
    params_np = jax.tree_util.tree_map(np.asarray, params)
    obs = torch.from_numpy(np.array(obs))

    rng = np.random.default_rng(0)
    col = lambda *s: torch.from_numpy(
        rng.standard_normal((ROWS,) + s).astype(np.float32))
    action, old_mean = col(2), col(2)
    old_std = torch.exp(0.3 * col(2))
    batch = [action, -col().abs() - 2.0, col(), col(), col(), old_mean,
             old_std]
    cfg = PPOCfg()
    model = actor_critic_from_jax(params_np)
    learner = make_learner(make_env("MushrDriftRL-v0", num_envs=8,
                                    device="cpu"), cfg)
    with torch.no_grad():
        port_out = [x.numpy() for x in model(obs)]
    total, (_, _, _, kl) = learner.ppo_loss(*model(obs), *batch)
    total.backward()
    return {"params": params_np, "obs": obs, "batch": batch, "cfg": cfg,
            "jax": jax_out, "port": port_out, "kl": float(kl.detach()),
            "grads": {k: p.grad for k, p in model.named_parameters()}}


@pytest.fixture(scope="module")
def jobs(reference, tmp_path_factory):
    out = {}
    for nproc, m in ((2, 2), (4, 2)):
        d = tmp_path_factory.mktemp(f"tp{nproc}")
        torch.save({"params": reference["params"], "obs": reference["obs"],
                    "batch": reference["batch"],
                    "ppo_cfg": reference["cfg"]}, d / "inputs.pt")
        out[nproc], _ = run_job(d, f"m{m}", nproc=nproc, worker=WORKER)
    return out


@pytest.mark.parametrize("nproc", [2, 4])
class TestTensorParallelJobs:
    def test_grid(self, jobs, nproc):
        """Row-major ranks (JAX's `reshape(n // m, m)`), the rows of the
        batch split over the data index."""
        per = ROWS // (nproc // 2)
        for r, res in enumerate(jobs[nproc]):
            assert res["coords"] == (r // 2, r % 2)
            assert res["rows"] == (r // 2 * per, (r // 2 + 1) * per)

    @pytest.mark.parametrize("against", ["port", "jax"])
    def test_forward_matches(self, reference, jobs, nproc, against):
        """Every rank's mean, std and value equal the one-process
        forward's (and JAX's `model.apply`) on its rows."""
        for res in jobs[nproc]:
            rows = slice(*res["rows"])
            for i, name in enumerate(("mean", "std", "value")):
                np.testing.assert_allclose(
                    res[name].numpy(), reference[against][i][rows],
                    err_msg=name, **TP_TOL)

    def test_gradients_are_the_one_process_slices(self, reference, jobs,
                                                  nproc):
        """One PPO loss: each share's gradient, averaged over the data
        group, is its slice of the one-process gradient on the whole
        batch; the replicated leaves' gradients are whole on every rank."""
        for res in jobs[nproc]:
            _, j = res["coords"]
            np.testing.assert_allclose(float(res["kl"]), reference["kl"],
                                       **TP_TOL)
            assert res["grads"].keys() == reference["grads"].keys()
            for name, want in reference["grads"].items():
                dim = res["placement"][name]
                if dim is not None:
                    want = want.chunk(2, dim)[j]
                torch.testing.assert_close(res["grads"][name], want,
                                           **TP_TOL, msg=name)


def jax_sharded_leaves(m):
    """The port's names of the leaves that JAX's
    `shard_params_model_parallel` leaves not fully replicated on the
    tests' 8-device CPU mesh (`make_mesh(8, m)`)."""
    jm = JActorCritic(action_dim=2)
    params = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))
    placed = j_shard_params(params, j_make_mesh(8, model_parallel=m))
    names = set()
    for path, x in jax.tree_util.tree_leaves_with_path(placed):
        if x.sharding.is_fully_replicated:
            continue
        keys = [p.key for p in path][1:]          # drop "params"
        if keys == ["log_std"]:
            names.add("log_std")
            continue
        head, dense, leaf = keys
        i = int(dense.split("_")[1])
        names.add(f"{head}.{2 * i}."
                  + {"kernel": "weight", "bias": "bias"}[leaf])
    return names


@pytest.mark.parametrize("m", [2, 4])
def test_sharded_leaves_match_jax(m):
    """At m = 2 every kernel and bias of the [64, 64] policy is split but
    the critic's head (width 1); at m = 4 the actor's head (width 2) is
    replicated too; `log_std` always is."""
    model = actor_critic_from_jax(jax.tree_util.tree_map(
        np.asarray, JActorCritic(action_dim=2).init(
            jax.random.PRNGKey(0), jnp.zeros((1, OBS_DIM)))))
    port = {k for k, d in model_parallel_placement(model, m).items()
            if d is not None}
    assert port == jax_sharded_leaves(m)
    shards = shard_params_model_parallel(model, make_mesh(8, m), rank=5)
    for name, p in model.named_parameters():
        want = p.detach().chunk(m, 0)[5 % m] if name in port else p.detach()
        torch.testing.assert_close(shards[name], want, rtol=0, atol=0)


@pytest.mark.parametrize("m", [1, 2, 4, 8])
def test_mesh_layout_matches_jax(m):
    """Rank r at (r // m, r % m), as JAX lays device r out."""
    jmesh = j_make_mesh(8, model_parallel=m)
    mesh = make_mesh(8, m)
    assert tuple(mesh.shape.values()) == jmesh.devices.shape
    assert tuple(mesh.shape) == jmesh.axis_names
    for (i, j), dev in np.ndenumerate(jmesh.devices):
        assert mesh.coords(dev.id) == (i, j)
        assert mesh.model_group(i)[j] == dev.id
        assert mesh.data_group(j)[i] == dev.id


def test_make_mesh_needs_a_divisor():
    for world, m in ((6, 4), (2, 3), (4, 0)):
        with pytest.raises(ValueError, match="not divisible"):
            make_mesh(world, m)
    with pytest.raises(ValueError, match="not divisible"):
        j_make_mesh(6, model_parallel=4)


def test_world_of_one_issues_no_collective(reference, monkeypatch):
    """Without a process group, `global_mesh()` creates no group, and the
    policy built on it runs the one-process forward and backward with no
    collective."""
    def refuse(*args, **kwargs):
        raise AssertionError("a collective in a world of one")

    for name in ("all_reduce", "new_group", "all_gather", "broadcast"):
        monkeypatch.setattr(torch.distributed, name, refuse)
    assert not torch.distributed.is_initialized()
    pm = distributed.global_mesh()
    assert (pm.data_size, pm.model_size, pm.model_group, pm.data_group) \
        == (1, 1, None, None)
    tp = TensorParallelActorCritic(actor_critic_from_jax(
        reference["params"]), pm)
    mean, std, value = tp(reference["obs"])
    (mean.sum() + value.sum()).backward()
    np.testing.assert_array_equal(mean.detach().numpy(),
                                  reference["port"][0])
    np.testing.assert_array_equal(value.detach().numpy(),
                                  reference["port"][2])
