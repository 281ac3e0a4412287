"""Shared helpers of the benchmark's own tests. Run them from the root of
the checkout: `python -m pytest benchmark/tests -q`; the tests marked `card`
run their body only where a CUDA card is present."""

import os
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# the cells of BENCHMARK.json, and the elevation cell whose files are kept
# ready though BENCHMARK.json leaves it out (its runs spread too widely on
# a shared host; PERF.md, Open questions)
ELEVATION = {"name": "elev_mushr_mlp.envs_4096", "config": "elev_mushr_mlp",
             "traffic": "envs_4096", "chips": 1}
CELLS = ("drift_mushr_mlp.envs_65536", ELEVATION["name"])


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; decides inside the test")


def tiny(name, envs=32, steps=8):
    """Cell `name` cut to `envs` envs and `steps` steps an env, for the
    CPU."""
    from benchmark import spec

    cell = (spec.cell_of(ELEVATION, spec.load_benchmark())
            if name == ELEVATION["name"] else spec.load_cell(name))
    return cell._replace(
        traffic={**cell.traffic, "num_envs": envs},
        config={**cell.config,
                "agent": {**cell.agent, "num_steps_per_env": steps}})


def run_tiny(cell, device="cpu", trace=False):
    from benchmark import harness

    return harness.run(cell, 3000000019, 0.05, trace, device,
                       time.perf_counter())


@pytest.fixture
def card():
    """The CUDA device; skips the test where there is none."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"
