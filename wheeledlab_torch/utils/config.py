"""Frozen-dataclass config system with named registry + dotted CLI overrides.

The port's own copy of `wheeledlab_tpu/utils/config.py` (the port imports
nothing of the JAX package). Configs are plain frozen dataclasses of Python
scalars/tuples; overrides use the same dotted grammar as the reference CLI
(`env.rewards.side_slip.weight=100.0`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Type, TypeVar

T = TypeVar("T")

_MISSING = dataclasses.MISSING


def configclass(cls: Type[T]) -> Type[T]:
    """Decorator: frozen dataclass with keyword defaults and `.replace()`."""
    cls = dataclasses.dataclass(frozen=True)(cls)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    cls.replace = replace  # type: ignore[attr-defined]
    return cls


def to_dict(cfg: Any) -> Any:
    """Recursively convert a config tree to plain dicts/lists (for logging)."""
    if dataclasses.is_dataclass(cfg) and not isinstance(cfg, type):
        return {f.name: to_dict(getattr(cfg, f.name)) for f in dataclasses.fields(cfg)}
    if isinstance(cfg, (list, tuple)):
        return [to_dict(v) for v in cfg]
    if isinstance(cfg, dict):
        return {k: to_dict(v) for k, v in cfg.items()}
    return cfg


def _coerce(value: str, target: Any) -> Any:
    """Parse a CLI string into the type of the value it replaces."""
    if not isinstance(value, str):
        return value
    if isinstance(target, bool):
        return value.lower() in ("1", "true", "yes", "on")
    if isinstance(target, int) and not isinstance(target, bool):
        return int(float(value))
    if isinstance(target, float):
        return float(value)
    if isinstance(target, tuple):
        parts = [p for p in value.strip("()[] ").split(",") if p]
        elem = target[0] if len(target) else 0.0
        return tuple(type(elem)(float(p) if not isinstance(elem, str) else p) for p in parts)
    if target is None:
        # Best-effort literal parse
        for cast in (int, float):
            try:
                return cast(value)
            except ValueError:
                pass
        if value.lower() in ("true", "false"):
            return value.lower() == "true"
        if value.lower() in ("none", "null"):
            return None
    return value


def override(cfg: T, path: str, value: Any) -> T:
    """Return a copy of `cfg` with the dotted `path` replaced by `value`.

    Mirrors the reference's Hydra dotted-override grammar
    (wheeledlab_rl/docs: `env.rewards.side_slip.weight=100.0`)."""
    parts = path.split(".")

    def rec(node: Any, idx: int) -> Any:
        name = parts[idx]
        if not hasattr(node, name):
            raise KeyError(f"config has no field {'.'.join(parts[: idx + 1])!r}")
        child = getattr(node, name)
        if idx == len(parts) - 1:
            new_child = _coerce(value, child)
        else:
            new_child = rec(child, idx + 1)
        return dataclasses.replace(node, **{name: new_child})

    return rec(cfg, 0)


def apply_overrides(cfg: T, overrides: Dict[str, Any]) -> T:
    for path, value in overrides.items():
        cfg = override(cfg, path, value)
    return cfg


def parse_cli_overrides(argv) -> Dict[str, str]:
    """Collect `a.b.c=value` tokens from an argv list."""
    out: Dict[str, str] = {}
    for tok in argv:
        if "=" in tok and not tok.startswith("-"):
            k, v = tok.split("=", 1)
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# Named registries (tasks and run configs), replacing gym.register + Hydra
# ConfigStore (reference wheeledlab_tasks/__init__.py:14-63, hydra.py:70-99).
# ---------------------------------------------------------------------------


class Registry:
    def __init__(self, kind: str):
        self._kind = kind
        self._entries: Dict[str, Any] = {}

    def register(self, name: str, entry: Any = None):
        if entry is None:  # decorator form
            def deco(fn):
                self._entries[name] = fn
                return fn

            return deco
        self._entries[name] = entry
        return entry

    def get(self, name: str) -> Any:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self._kind} {name!r}; known: {sorted(self._entries)}"
            )
        return self._entries[name]

    def names(self):
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


TASKS = Registry("task")          # task id -> {"cfg", "play_cfg", "make"} (tasks/__init__.py)
RUN_CONFIGS = Registry("run config")  # run name -> RunConfig
