"""The port's public names against the JAX package's, module by module.

Every module of `wheeledlab_tpu/` is parsed (AST, nothing imported) for its
public top-level functions, classes (with their public methods and
`__call__`) and assignments, and a package's `__init__.py` for the names
it re-exports. Its counterpart in `wheeledlab_torch/` (the same path) must
hold each of them, as a definition or an imported name, unless `JAX_ONLY`
names it with its reason. Names that begin with an underscore are not
compared (among them `wheeledlab_tpu/__init__.py::_enable_compilation_cache`,
the persistent XLA cache, whose stand-in is the nvcc build cache; see
`wheeledlab_torch/utils/__init__.py`). The functions the port gained for
this comparison are held to the JAX functions' values.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wheeledlab_torch
import wheeledlab_tpu

torch.set_num_threads(1)

JAX_ROOT = os.path.dirname(os.path.abspath(wheeledlab_tpu.__file__))
PORT_ROOT = os.path.dirname(os.path.abspath(wheeledlab_torch.__file__))

_KERNEL = ("a Pallas kernel body; its port is the CUDA C++ kernel {} "
           "behind {}")
_UTIL = ("an XLA utility left out by decision; its stand-in is recorded in "
         "wheeledlab_torch/utils/__init__.py")
_SHARDING = ("jax.sharding placement under GSPMD; each rank of the port "
             "holds its own env shard (parallel/distributed.py)")
_FLAX = ("a flax module's call; the port's modules are torch.nn.Modules "
         "(forward)")

# (JAX module, name) -> why the port has no counterpart
JAX_ONLY = {
    ("ops/pallas_substep.py", "pallas_step"): _KERNEL.format(
        "csrc/physics_step.cu", "ops/physics_step.py::physics_step"),
    ("ops/pallas_substep.py", "SUB_TILE"): "the Pallas kernel's tile "
    "width; the CUDA kernel works an env with 4 lanes (csrc/substep.cuh)",
    ("ops/pallas_substep_hf.py", "pallas_step_hf"): _KERNEL.format(
        "csrc/physics_step_hf.cu",
        "ops/physics_step_hf.py::physics_step_hf"),
    ("ops/pallas_substep_hf.py", "SUB_TILE_HF"): "the Pallas kernel's tile "
    "width; the CUDA kernel works an env with 4 lanes (csrc/substep.cuh)",
    ("tasks/drift/fused.py", "fused_drift_pallas"): _KERNEL.format(
        "csrc/fused_drift.cu", "tasks/drift/fused.py::fused_drift_step"),
    ("tasks/drift/fused.py", "fused_drift_pallas_krng"): _KERNEL.format(
        "csrc/fused_drift_krng.cu",
        "tasks/drift/fused.py::fused_drift_step_krng"),
    **{("parallel/mesh.py", n): _SHARDING for n in (
        "ambient_data_shards", "batch_sharding", "constrain_batch",
        "replicated", "shard_batched_pytree", "shard_train_state")},
    **{("parallel/__init__.py", n): _SHARDING for n in (
        "batch_sharding", "constrain_batch", "replicated",
        "shard_batched_pytree", "shard_train_state")},
    ("rl/networks.py", "MLP"): "a flax Dense stack; the port's heads are "
    "torch.nn.Sequential",
    ("rl/networks.py", "MLP.__call__"): _FLAX,
    ("rl/networks.py", "ActorCritic.__call__"): _FLAX,
    ("rl/recurrent.py", "ActorCriticRecurrent.__call__"): _FLAX,
    ("rl/ppo.py", "Transition"): "the JAX rollout's scan pytree; the port's "
    "rollout fills a dict of [T, B] buffers (PPO.new_traj)",
    ("rl/recurrent.py", "RecurrentTransition"): "the JAX rollout's scan "
    "pytree; the port's fills a dict of buffers (PPO.new_traj)",
    ("rl/ppo.py", "accumulate_info"): "the JAX rollout scan's fold of a "
    "step's info into a dict; the port's one rollout step adds "
    "`info_increments` to one stacked accumulator (StepGraph.step)",
    ("rl/ppo.py", "make_ppo"): "the JAX learner as jitted closures; the "
    "port's is the PPO class, built by make_learner",
    ("rl/recurrent.py", "make_ppo_recurrent"): "the JAX learner as jitted "
    "closures; the port's is the RecurrentPPO class, built by make_learner",
    ("rl/__init__.py", "make_ppo"): "as rl/ppo.py::make_ppo",
    ("rl/__init__.py", "make_ppo_recurrent"): "as "
    "rl/recurrent.py::make_ppo_recurrent",
    **{("utils/aot.py", n): _UTIL for n in (
        "cache_dir", "maybe_aot_warm_start", "package_code_hash",
        "resolve_aot_mode")},
    **{("utils/cache.py", n): _UTIL for n in (
        "enable_compilation_cache", "resolve_cache_mode")},
    **{("utils/host.py", n): _UTIL for n in (
        "host_build", "host_build_fn", "host_const")},
    ("utils/rng.py", "enable_fast_prng"): _UTIL,
}


def _public(name: str) -> bool:
    return not name.startswith("_")


def public_names(path: str, imports: str = "") -> set:
    """A module's public top-level names: functions, classes with their
    public methods and `__call__` as `Class.method`, assigned names and
    the names it imports: all of them with `imports="all"`, those of
    `from . import x` and `from .x import y` (what a package's
    `__init__.py` re-exports) with `imports="relative"`."""
    tree = ast.parse(open(path).read())
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(node.name):
                out.add(node.name)
        elif isinstance(node, ast.ClassDef) and _public(node.name):
            out.add(node.name)
            out.update(f"{node.name}.{m.name}" for m in node.body
                       if isinstance(m, (ast.FunctionDef,
                                         ast.AsyncFunctionDef))
                       and (_public(m.name) or m.name == "__call__"))
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets
                       if isinstance(t, ast.Name) and _public(t.id))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            if _public(node.target.id):
                out.add(node.target.id)
        elif (imports == "all" and isinstance(node, (ast.Import,
                                                      ast.ImportFrom))
              or imports == "relative" and isinstance(node, ast.ImportFrom)
              and node.level > 0):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names if _public(a.asname or a.name))
    return out


def jax_modules():
    out = []
    for root, _, files in os.walk(JAX_ROOT):
        for f in files:
            if f.endswith(".py"):
                out.append(os.path.relpath(os.path.join(root, f), JAX_ROOT))
    return sorted(out)


def jax_public(module: str) -> set:
    return public_names(os.path.join(JAX_ROOT, module),
                        "relative" if module.endswith("__init__.py") else "")


def port_public(module: str) -> set:
    path = os.path.join(PORT_ROOT, module)
    return public_names(path, "all") if os.path.exists(path) else set()


@pytest.mark.parametrize("module", jax_modules())
def test_port_module_has_the_public_names(module):
    """Each public name of the JAX module is in the port's module of the
    same path, or in `JAX_ONLY` with its reason."""
    missing = sorted(n for n in jax_public(module) - port_public(module)
                     if (module, n) not in JAX_ONLY)
    assert not missing, f"{module}: the port lacks {missing}"


def test_jax_only_names_are_current():
    """Every `JAX_ONLY` entry names a public name of its JAX module that
    the port's module lacks, and gives a reason."""
    for (module, name), why in JAX_ONLY.items():
        assert name in jax_public(module), (module, name)
        assert name not in port_public(module), (module, name)
        assert why


def test_init_exports_import():
    """The port's package `__init__.py`s that re-export the JAX package's
    names import cleanly and hold them."""
    import wheeledlab_torch.assets as assets
    import wheeledlab_torch.envs as envs
    import wheeledlab_torch.parallel as parallel
    import wheeledlab_torch.render as render
    import wheeledlab_torch.rl as rl
    import wheeledlab_torch.tasks.common as common
    import wheeledlab_torch.tasks.drift as drift
    import wheeledlab_torch.tasks.elevation as elevation
    import wheeledlab_torch.tasks.visual as visual
    import wheeledlab_torch.utils as utils

    for mod, module in ((assets, "assets"), (envs, "envs"),
                        (parallel, "parallel"), (render, "render"),
                        (rl, "rl"), (common, "tasks/common"),
                        (drift, "tasks/drift"),
                        (elevation, "tasks/elevation"),
                        (visual, "tasks/visual"), (utils, "utils")):
        init = f"{module}/__init__.py"
        for name in jax_public(init):
            if (init, name) not in JAX_ONLY:
                assert hasattr(mod, name), (init, name)


def _params_equal(got, want):
    for f in dataclasses.fields(want):
        np.testing.assert_array_equal(
            np.asarray(getattr(got, f.name)),
            np.asarray(getattr(want, f.name)), err_msg=f.name)


@pytest.mark.parametrize("actuators", [
    "HOUND_ACTUATOR_CFG", "HOUND_SUS_ACTUATOR_CFG",
    "HOUND_SUS_2WD_ACTUATOR_CFG", "F1TENTH_4WD_ACTUATOR_CFG", None])
def test_robot_params_match_jax(actuators):
    """`mushr_params` and `f1tenth_params` under each actuator group (and
    their defaults, None) equal the JAX functions' values field for
    field."""
    import wheeledlab_torch.assets.robots as trobots
    import wheeledlab_tpu.assets.robots as jrobots

    for fn in ("mushr_params", "f1tenth_params"):
        args = (() if actuators is None else
                (getattr(trobots, actuators),))
        jargs = (() if actuators is None else
                 (getattr(jrobots, actuators),))
        _params_equal(getattr(trobots, fn)(*args),
                      getattr(jrobots, fn)(*jargs))


@pytest.mark.parametrize("packed", [True, False])
def test_env_state_with_vehicle_matches_jax(packed):
    """`EnvState.with_vehicle` keeps the carry's representation (packed
    rows on the kernel routes, a VehicleState on the per-vehicle route),
    as JAX's: the new state's vehicle and carry equal JAX's, the other
    fields are the old state's."""
    from wheeledlab_torch.convert import env_state_from_jax
    from wheeledlab_torch.sim.types import VehicleState
    from wheeledlab_tpu.sim.types import VehicleState as JVehicleState
    from wheeledlab_tpu.tasks.drift.task import DriftTaskCfg as JTaskCfg
    from wheeledlab_tpu.tasks.drift.task import make_drift_env as j_make

    jenv = j_make(JTaskCfg(num_envs=8))
    jenv._use_pallas = packed
    js, _ = jax.jit(jenv.reset)(jax.random.PRNGKey(3))
    js_np = jax.tree_util.tree_map(np.asarray, js)
    ts = env_state_from_jax(js_np)
    if not packed:
        ts = dataclasses.replace(ts, vehicle_mem=ts.vehicle)
    rng = np.random.default_rng(0)
    fields = {f.name: rng.standard_normal(
        np.shape(getattr(js.vehicle, f.name))).astype(np.float32)
        for f in dataclasses.fields(JVehicleState)}
    jnew = js.with_vehicle(JVehicleState(**{
        k: jnp.asarray(v) for k, v in fields.items()}))
    tnew = ts.with_vehicle(VehicleState(**{
        k: torch.from_numpy(v) for k, v in fields.items()}))
    assert isinstance(tnew.vehicle_mem, VehicleState) != packed
    assert isinstance(jnew.vehicle_mem, JVehicleState) != packed
    for f in dataclasses.fields(JVehicleState):
        np.testing.assert_array_equal(
            getattr(tnew.vehicle, f.name).numpy(),
            np.asarray(getattr(jnew.vehicle, f.name)), err_msg=f.name)
    if packed:
        np.testing.assert_array_equal(tnew.vehicle_mem.numpy(),
                                      np.asarray(jnew.vehicle_mem))
    np.testing.assert_array_equal(tnew.command.numpy(),
                                  np.asarray(jnew.command))
    assert tnew.step_count is ts.step_count


def test_color_map_atlas_sample_patch_matches_jax():
    """`ColorMapAtlas.sample_patch` of each env's window, at points inside
    and outside it (which clamp to its border), equals the JAX one-hot
    contraction on the window JAX extracts, env by env."""
    from wheeledlab_torch.tasks.visual.camera import ColorMap, ColorMapAtlas
    from wheeledlab_tpu.tasks.visual.camera import ColorMap as JColorMap
    from wheeledlab_tpu.tasks.visual.camera import (
        ColorMapAtlas as JColorMapAtlas,
    )

    rng = np.random.default_rng(1)
    grid = rng.random((96, 120)).astype(np.float32)
    cell = 0.1
    jatlas = JColorMapAtlas.build(JColorMap(
        grid=jnp.asarray(grid), cell=cell, rows=96, cols=120))
    tatlas = ColorMapAtlas.build(ColorMap(
        grid=torch.from_numpy(grid), cell=cell, rows=96, cols=120))
    centers = rng.uniform([-6.0, -4.8], [6.0, 4.8], (16, 2)).astype(
        np.float32)
    pts = (centers[:, None] + rng.uniform(-3.0, 3.0, (16, 50, 2))).astype(
        np.float32)
    sr, sc = tatlas.extract(torch.from_numpy(centers[:, 0]),
                            torch.from_numpy(centers[:, 1]))
    got = tatlas.sample_patch(sr, sc, torch.from_numpy(pts)).numpy()
    for e in range(16):
        patch, jsr, jsc = jatlas.extract(jnp.asarray(centers[e]))
        assert (int(jsr), int(jsc)) == (int(sr[e]), int(sc[e]))
        want = np.asarray(jatlas.sample_patch(patch, jsr, jsc,
                                              jnp.asarray(pts[e])))
        np.testing.assert_array_equal(got[e], want, err_msg=str(e))
