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
from .rl.recurrent import CHAINS, ActorCriticRecurrent
from .sim.soa import pack_params, pack_state
from .sim.terrain import Heightfield
from .sim.types import VehicleParams, VehicleState


def _get(node, name):
    return node[name] if isinstance(node, dict) else getattr(node, name)


def _t(x, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


GATES = ("i", "f", "g", "o")     # flax OptimizedLSTMCell's gate order


def _copy_heads(model, p):
    """flax `actor`/`critic` Dense stacks and `log_std` into `model`'s
    `nn.Sequential` heads (`weight = kernel.T`)."""
    with torch.no_grad():
        for name in ("actor", "critic"):
            linears = [m for m in getattr(model, name)
                       if isinstance(m, torch.nn.Linear)]
            for i, lin in enumerate(linears):
                d = p[name][f"Dense_{i}"]
                lin.weight.copy_(_t(d["kernel"]).T)
                lin.bias.copy_(_t(d["bias"]))
        model.log_std.copy_(_t(p["log_std"]))


def _hidden_widths(tree):
    """Hidden widths of a flax `actor`/`critic` Dense stack."""
    return tuple(np.shape(tree[f"Dense_{i}"]["kernel"])[1]
                 for i in range(len(tree) - 1))


def actor_critic_from_jax(params_np, activation: str = "elu",
                          compute_dtype: str = "float32") -> ActorCritic:
    """flax ActorCritic params (`{'params': {'actor': {'Dense_i': {kernel
    (in, out), bias}}, 'critic': ..., 'log_std'}}`) -> an ActorCritic on the
    CPU with the same weights (`weight = kernel.T`)."""
    p = params_np["params"]
    actor = p["actor"]
    model = ActorCritic(
        obs_dim=np.shape(actor["Dense_0"]["kernel"])[0],
        action_dim=np.shape(actor[f"Dense_{len(actor) - 1}"]["kernel"])[1],
        actor_hidden=_hidden_widths(actor),
        critic_hidden=_hidden_widths(p["critic"]),
        activation=activation, compute_dtype=compute_dtype)
    _copy_heads(model, p)
    return model


def actor_critic_recurrent_from_jax(params_np, activation: str = "elu"
                                    ) -> ActorCriticRecurrent:
    """flax ActorCriticRecurrent params (`params/memory/lstm_{a,c}{i}/
    {ii..io: kernel (in, H); hi..ho: kernel (H, H), bias}`, the heads as
    `actor_critic_from_jax`'s, `log_std`) -> an ActorCriticRecurrent on the
    CPU with the same weights: each cell's four input kernels concatenated
    in gate order as `wi` (in, 4H), its recurrent kernels as `wh` (H, 4H)
    and their biases as `bh`."""
    p = params_np["params"]
    mem = p["memory"]
    layers = sum(k.startswith("lstm_a") for k in mem)
    obs_dim, hidden = np.shape(mem["lstm_a0"]["ii"]["kernel"])
    actor = p["actor"]
    model = ActorCriticRecurrent(
        obs_dim, np.shape(actor[f"Dense_{len(actor) - 1}"]["kernel"])[1],
        _hidden_widths(actor), _hidden_widths(p["critic"]), activation,
        rnn_hidden_size=hidden, rnn_num_layers=layers)
    cat = lambda cell, side, leaf: _t(np.concatenate(
        [cell[f"{side}{g}"][leaf] for g in GATES], axis=-1))
    with torch.no_grad():
        for chain, cells in (("a", model.lstm_a), ("c", model.lstm_c)):
            for i, cell in enumerate(cells):
                src = mem[f"lstm_{chain}{i}"]
                cell.wi.copy_(cat(src, "i", "kernel"))
                cell.wh.copy_(cat(src, "h", "kernel"))
                cell.bh.copy_(cat(src, "h", "bias"))
    _copy_heads(model, p)
    return model


def recurrent_hidden_from_jax(hidden_np, device="cpu"):
    """The JAX hidden tree (`{'actor': ((c, h), ...), 'critic': ...}`, a
    (c, h) pair a layer, numpy leaves) -> the port's (lists of pairs)."""
    return {chain: [(_t(c, device=device), _t(h, device=device))
                    for c, h in hidden_np[chain]] for chain in CHAINS}


def env_state_from_jax(state_np, ground_friction: float = 1.0,
                       device="cpu") -> EnvState:
    """The JAX `EnvState` (numpy leaves, either carry layout: an AoS
    `VehicleState` or packed (21, B) rows) -> the port's EnvState. The JAX
    PRNG key has no counterpart: the port's env draws from its generator.
    `ground_friction` is folded into the packed params when the JAX state
    carries none (its generic path): the task's ground friction, 1.0 for
    drift and elevation, 2.0 for the visual task. The JAX state's batched
    `params` become the port's `EnvState.params`, which the per-vehicle
    route (`EnvCfg.use_kernels="off"`) steps with."""
    vm = _get(state_np, "vehicle_mem")
    if isinstance(vm, np.ndarray):
        vehicle_mem = _t(vm, device=device)
    else:
        vehicle_mem = pack_state(VehicleState(**{
            f.name: _t(_get(vm, f.name), device=device)
            for f in dataclasses.fields(VehicleState)}))
    jp = _get(state_np, "params")
    params = VehicleParams(**{f.name: _t(_get(jp, f.name), device=device)
                              for f in dataclasses.fields(VehicleParams)})
    packed = _get(state_np, "packed_params")
    if packed is None:
        packed_params = pack_params(params, ground_friction)
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
        params=params,
    )


def heightfield_from_jax(hf_np, device="cpu") -> Heightfield:
    """A JAX `Heightfield` (numpy leaves `height`, `cell`, `friction`) ->
    the port's, on `device`."""
    return Heightfield(height=_t(_get(hf_np, "height"), device=device),
                       cell=float(np.float32(_get(hf_np, "cell"))),
                       friction=float(np.float32(_get(hf_np, "friction"))))
