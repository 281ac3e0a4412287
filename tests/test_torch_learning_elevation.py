"""CPU-scale learning check of the port on elevation: the counterpart of
tests/test_learning.py::TestAllTasksImprove::test_elevation_improves, with
the helper and the sizes of tests/test_torch_learning.py (a file of its
own, so that each file takes under two minutes on one worker)."""

import os
import sys

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_learning import first_and_last5  # noqa: E402


class TestAllTasksImprove:
    def test_elevation_improves(self):
        """128 envs, 50 iterations, the reference's terrain overrides.
        Measured for the port at seeds 0-3: first5 215.8-248.7, last5
        199.8-418.9, ratio 0.93-1.83; seed 0 misses both bars (215.8 ->
        199.8: from iteration 32 its KL stays near 0 and the learning rate
        at its maximum); seeds 4-7 1.53-1.83. The JAX test at seeds 0-7
        (the same code at PRNGKey(s)): ratio 1.10-1.82, seed 6 missing
        both bars (213.6 -> 234.5). ROADMAP Queue 3 records the miss."""
        first5, last5 = first_and_last5(
            "MushrElevationRL-v0", 128, 50, terrain_extent=20.0,
            num_mounds=10, spawn_range=8.0, goal_range=8.0)
        assert last5 > first5 + 30.0, (first5, last5)
        assert last5 > 1.1 * first5, (first5, last5)
