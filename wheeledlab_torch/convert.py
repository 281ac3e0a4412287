"""Carry weights and env state across from the JAX package, as numpy.

Nothing here imports JAX: callers hand over the JAX trees with numpy leaves
(e.g. `jax.tree_util.tree_map(np.asarray, tree)`). Nodes may be objects with
attributes (flax structs) or dicts.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .envs.env import EnvState
from .rl.networks import ActorCritic
from .sim.soa import pack_params, pack_state
from .sim.terrain import Heightfield
from .sim.types import VehicleParams, VehicleState


def _get(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _t(x, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def actor_critic_from_jax(params_np, activation: str = "elu") -> ActorCritic:
    """flax ActorCritic params (`{'params': {'actor': {'Dense_i': {kernel
    (in, out), bias}}, 'critic': ..., 'log_std'}}`) -> an ActorCritic on the
    CPU with the same weights (`weight = kernel.T`)."""
    p = params_np["params"]
    dense = lambda tree: [tree[f"Dense_{i}"] for i in range(len(tree))]
    actor, critic = dense(p["actor"]), dense(p["critic"])
    model = ActorCritic(
        obs_dim=np.shape(actor[0]["kernel"])[0],
        action_dim=np.shape(actor[-1]["kernel"])[1],
        actor_hidden=tuple(np.shape(d["kernel"])[1] for d in actor[:-1]),
        critic_hidden=tuple(np.shape(d["kernel"])[1] for d in critic[:-1]),
        activation=activation)
    with torch.no_grad():
        for seq, layers in ((model.actor, actor), (model.critic, critic)):
            linears = [m for m in seq if isinstance(m, torch.nn.Linear)]
            for lin, d in zip(linears, layers):
                lin.weight.copy_(_t(d["kernel"]).T)
                lin.bias.copy_(_t(d["bias"]))
        model.log_std.copy_(_t(p["log_std"]))
    return model


def env_state_from_jax(state_np, ground_friction: float = 1.0,
                       device="cpu") -> EnvState:
    """The JAX `EnvState` (numpy leaves, either carry layout: an AoS
    `VehicleState` or packed (21, B) rows) -> the port's EnvState. The JAX
    PRNG key has no counterpart: the port's env draws from its generator.
    `ground_friction` is folded into the packed params when the JAX state
    carries none (its generic path): the task's ground friction, 1.0 for
    drift and elevation, 2.0 for the visual task."""
    vm = _get(state_np, "vehicle_mem")
    if isinstance(vm, np.ndarray):
        vehicle_mem = _t(vm, device=device)
    else:
        vehicle_mem = pack_state(VehicleState(**{
            f.name: _t(_get(vm, f.name), device=device)
            for f in dataclasses.fields(VehicleState)}))
    packed = _get(state_np, "packed_params")
    if packed is None:
        jp = _get(state_np, "params")
        packed_params = pack_params(VehicleParams(**{
            f.name: _t(_get(jp, f.name), device=device)
            for f in dataclasses.fields(VehicleParams)}), ground_friction)
    else:
        packed_params = _t(packed, device=device)
    i32 = lambda name: _t(_get(state_np, name), torch.int32, device)
    f32 = lambda name: _t(_get(state_np, name), device=device)
    return EnvState(
        vehicle_mem=vehicle_mem.contiguous(),
        packed_params=packed_params.contiguous(),
        step_count=i32("step_count"),
        common_step=int(_get(state_np, "common_step")),
        reward_weights=f32("reward_weights"),
        last_action=f32("last_action"),
        command=f32("command"),
        command_timer=i32("command_timer"),
        push_timers=i32("push_timers"),
        ep_return=f32("ep_return"),
        ep_len=i32("ep_len"),
    )


def heightfield_from_jax(hf_np, device="cpu") -> Heightfield:
    """A JAX `Heightfield` (numpy leaves `height`, `cell`, `friction`) ->
    the port's, on `device`."""
    return Heightfield(height=_t(_get(hf_np, "height"), device=device),
                       cell=float(np.float32(_get(hf_np, "cell"))),
                       friction=float(np.float32(_get(hf_np, "friction"))))
