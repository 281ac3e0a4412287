"""The check that decides `correct`: the reference follows the port at a
tiny size on the CPU; a run whose timed path is broken underneath reads
`correct` false, once for each fault a training cell can have (a step that
leaves its state unchanged, half of each minibatch left out, an answer
altered where the env produces it); on a card, the control (the reference
with TF32 products in the program's place) fails the limits."""

import pytest
import torch

from benchmark import harness
from benchmark.tests.conftest import CELLS, run_tiny, tiny


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port_on_the_cpu(name):
    r = run_tiny(tiny(name))
    assert r["correct"], r["checks"]
    for k, v in r["checks"].items():
        assert v["value"] < 1e-6, (k, v)
    assert r["attempted"] >= 1 and r["failed"] == 0


def unchanged_state(monkeypatch):
    from wheeledlab_torch.rl.ppo import PPO

    orig = PPO.train_iteration

    def step(self, state, capture_traj=False):
        saved = [p.detach().clone() for p in self.model.parameters()]
        out = orig(self, state, capture_traj)
        with torch.no_grad():
            for p, s in zip(self.model.parameters(), saved):
                p.copy_(s)
        return out

    monkeypatch.setattr(PPO, "train_iteration", step)


def half_batch(monkeypatch):
    from wheeledlab_torch.rl.ppo import PPO

    orig = PPO.loss

    def loss(self, batch):
        half = batch[0].shape[0] // 2
        return orig(self, tuple(x[:half] for x in batch))

    monkeypatch.setattr(PPO, "loss", loss)


def altered_reward(monkeypatch):
    from wheeledlab_torch.envs.env import WheeledEnv

    orig = WheeledEnv.step

    def step(self, state, action):
        state, out = orig(self, state, action)
        reward = out.reward.clone()
        reward[0] += 1.0
        return state, out._replace(reward=reward)

    monkeypatch.setattr(WheeledEnv, "step", step)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   altered_reward])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_program_reads_not_correct(name, fault, monkeypatch):
    fault(monkeypatch)
    r = run_tiny(tiny(name))
    assert not r["correct"], r["checks"]


def test_unmoved_leaves_read_one():
    ref = harness.Readings([1.0], {"a": torch.ones(3), "b": torch.ones(2)},
                           {"a": torch.ones(3), "b": torch.ones(2)})
    prog = harness.Readings([1.0], ref.first_grad,
                            {"a": torch.zeros(3), "b": torch.zeros(2)})
    assert harness.compare(prog, ref)["update_gap"] == pytest.approx(1.0)


def test_leaves_the_reference_leaves_unmoved_are_not_compared():
    grads = {"a": torch.ones(3), "b": torch.ones(3), "c": torch.ones(3) * 1e-9}
    ref = harness.Readings([1.0], grads, {k: torch.ones(3) for k in grads})
    prog = harness.Readings([1.0], grads, {"a": torch.ones(3),
                                           "b": torch.ones(3),
                                           "c": torch.ones(3) * 2})
    assert harness.compare(prog, ref)["update_gap"] == 0.0


@pytest.mark.card
@pytest.mark.parametrize("name", CELLS)
def test_control_in_tf32_fails_the_limits(name, card):
    cell = tiny(name, envs=4096, steps=32)
    limits = cell.settings["limits"]
    seeds = (3000000101, 3000000102, 3000000103)
    torch.backends.cuda.matmul.allow_tf32 = False
    refs = [harness.reference_readings(cell, s, card) for s in seeds]
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        ctl = [harness.reference_readings(cell, s, card) for s in seeds]
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    for c, r in zip(ctl, refs):
        numbers = harness.compare(c, r)
        assert any(v > limits[k] for k, v in numbers.items()), numbers



@pytest.mark.card
def test_graphed_elevation_substeps_follow_the_eager_loop(card):
    """On a card the elevation reference replays its substeps from a CUDA
    graph; over successive control steps from its reset state, with
    targets drawn anew each step, they give the eager loop's bits."""
    from benchmark.reference import elevation

    g = torch.Generator(device=card)
    g.manual_seed(3000000111)
    env = elevation.make_env(4096, g, card)
    assert isinstance(env.substeps, elevation.SubstepGraph)
    state, _ = env.reset()
    rows, ca = state.rows, env.contact_atlas
    for _ in range(5):
        patch, org = ca.extract_rows(rows[0], rows[1])
        st = torch.rand((2, 4096), generator=g, device=card) - 0.5
        wt = 60.0 * torch.rand((4, 4096), generator=g, device=card)
        args = (rows, state.params, patch, org, st, wt)
        graphed = env.substeps(*args)
        eager = elevation.decimated_substeps(*args, p=ca.p, nx=ca.nx,
                                             ny=ca.ny)
        assert torch.equal(graphed, eager)
        rows = graphed
