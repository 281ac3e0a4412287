"""Rules of the port: `wheeledlab_torch` (its scripts included) and
`chip_smoke.py` never import JAX or the JAX package, the entry points run on
CUDA unless the caller asks for the CPU, and nothing but a tensor's device
chooses between a kernel and its plain version."""

import ast
import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "wheeledlab_torch")
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "wheeledlab_tpu")


def port_sources():
    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def port_modules():
    for path in port_sources():
        rel = os.path.relpath(path, ROOT)
        if rel.startswith("wheeledlab_torch"):
            mod = rel[:-3].replace(os.sep, ".")
            yield mod.removesuffix(".__init__")


def test_no_jax_import_in_port_sources():
    bad = []
    for path in port_sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    bad.append(f"{os.path.relpath(path, ROOT)}: {name}")
    assert not bad, bad


def test_importing_every_port_module_leaves_jax_out():
    mods = sorted(port_modules())
    assert len(mods) > 20
    code = ("import sys\n"
            + "".join(f"import {m}\n" for m in mods)
            + "import chip_smoke\n"
            + f"bad = [m for m in sys.modules if m.split('.')[0] in "
              f"{FORBIDDEN!r}]\n"
            + "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_default_device_is_cuda_without_fallback():
    """Without a CUDA device, the entry points raise instead of running on
    the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs there")
    import wheeledlab_torch.rl  # noqa: F401  registers run configs
    from wheeledlab_torch.rl.runner import train
    from wheeledlab_torch.tasks import make_env
    from wheeledlab_torch.utils.config import RUN_CONFIGS, override

    for task in ("MushrDriftRL-v0", "MushrElevationRL-v0",
                 "MushrVisualRL-v0"):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_env(task, num_envs=8)
        with pytest.raises(RuntimeError, match="CUDA"):
            make_env(task, num_envs=8, play=True)
    for name in ("RSS_DRIFT_CONFIG", "RSS_ELEV_CONFIG", "RSS_VISUAL_CONFIG"):
        cfg = override(RUN_CONFIGS.get(name), "num_envs", 8)
        assert cfg.device == "cuda"
        with pytest.raises(RuntimeError, match="CUDA"):
            train(cfg)
    from wheeledlab_torch.cli import export, play
    from wheeledlab_torch.scripts import (
        check_kernel_rng, limiter_probe, mppi_demo, physics_bench,
    )

    for main, argv in ((check_kernel_rng.main, []), (limiter_probe.main, []),
                       (mppi_demo.main, ["--steps", "1"]),
                       (physics_bench.main, ["--num-envs", "8"]),
                       (play.main, ["--run", "none"]),
                       (export.main, ["--run", "none"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)


def test_scripts_are_modules_of_the_port():
    mods = set(port_modules())
    assert {"wheeledlab_torch.scripts.check_kernel_rng",
            "wheeledlab_torch.scripts.limiter_probe",
            "wheeledlab_torch.scripts.mppi_demo",
            "wheeledlab_torch.cli.export", "wheeledlab_torch.envs.wrappers",
            "wheeledlab_torch.render.topdown",
            "wheeledlab_torch.ops.kernel_rng",
            "wheeledlab_torch.ops.multi_step",
            "wheeledlab_torch.sim.dynamics", "wheeledlab_torch.native",
            "wheeledlab_torch.scripts.physics_bench"} <= mods


def test_no_switch_forces_a_plain_version():
    """The port reads these environment variables, none of which chooses
    between a kernel and its plain version: the in-kernel-RNG route (honoured
    on both devices), the probe's width, the CUDA toolkit's place and
    torchrun's description of the job (a rank's card, the number of ranks
    and of ranks a host). A wrapper takes its plain version only where
    `device.type == "cpu"`."""
    read = set()
    for path in port_sources():
        with open(path) as f:
            read |= set(re.findall(r'environ(?:\.get\(|\[)\s*"(\w+)"',
                                   f.read()))
    assert read == {"WHEELEDLAB_KERNEL_RNG", "PROBE_ENVS", "CUDA_HOME",
                    "LOCAL_RANK", "WORLD_SIZE", "LOCAL_WORLD_SIZE"}
    wrappers = {"wheeledlab_torch/tasks/drift/fused.py": 2,
                "wheeledlab_torch/ops/multi_step.py": 1,
                "wheeledlab_torch/ops/kernel_rng.py": 1,
                "wheeledlab_torch/ops/physics_step.py": 1,
                "wheeledlab_torch/ops/physics_step_hf.py": 1}
    for rel, count in wrappers.items():
        with open(os.path.join(ROOT, rel)) as f:
            src = f.read()
        assert src.count('device.type == "cpu"') == count, rel
        assert "is_available" not in src and "except" not in src, rel


if __name__ == "__main__":
    sys.exit(pytest.main([__file__, "-x", "-q"]))
