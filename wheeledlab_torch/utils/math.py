"""Quaternion / rotation / frame math on torch tensors — the port of
`wheeledlab_tpu/utils/math.py` that the ported slices need.

Quaternions are (w, x, y, z); every function is shape-polymorphic over
leading batch dims.
"""

from __future__ import annotations

import functools
from typing import Tuple

import torch


@functools.lru_cache(maxsize=None)
def const_vector(values: Tuple[float, ...], dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    """`torch.tensor(values)` on `device`, made once a (values, dtype,
    device): a step that reads it copies nothing from the host, which a
    CUDA graph could not capture (`rl/ppo.py::StepGraph`). Shared by every
    caller, so never written to."""
    return torch.tensor(values, dtype=dtype, device=device)


def quat_identity() -> torch.Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=torch.float32)


def quat_normalize(q: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """q over its norm (at least eps), the squares summed in (w, x, y, z)
    order as the reference's reduction and the packed-row step add them."""
    w, x, y, z = q.unbind(-1)
    norm = torch.sqrt(w * w + x * x + y * y + z * z)[..., None]
    return q / torch.clamp(norm, min=eps)


def quat_mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a*b, (w, x, y, z)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def quat_integrate(q: torch.Tensor, omega_w: torch.Tensor,
                   dt: float) -> torch.Tensor:
    """Integrate the quaternion by the world-frame angular velocity over dt:
    q' = q + 0.5 * dt * (omega_quat * q), renormalized."""
    zeros = torch.zeros_like(omega_w[..., :1])
    omega_quat = torch.cat([zeros, omega_w], dim=-1)
    dq = 0.5 * dt * quat_mul(omega_quat, q)
    return quat_normalize(q + dq)


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    return q * const_vector((1.0, -1.0, -1.0, -1.0), q.dtype, q.device)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v from body to world frame by quaternion q."""
    qw = q[..., 0:1]
    qv = q[..., 1:4]
    t = 2.0 * torch.linalg.cross(qv, v, dim=-1)
    return v + qw * t + torch.linalg.cross(qv, t, dim=-1)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v from world to body frame by quaternion q."""
    return quat_rotate(quat_conj(q), v)


def quat_from_euler_xyz(roll: torch.Tensor, pitch: torch.Tensor,
                        yaw: torch.Tensor) -> torch.Tensor:
    """Quaternion from intrinsic XYZ euler angles (isaaclab
    math_utils.quat_from_euler_xyz)."""
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack(
        [
            cy * cp * cr + sy * sp * sr,
            cy * cp * sr - sy * sp * cr,
            cy * sp * cr + sy * cp * sr,
            sy * cp * cr - cy * sp * sr,
        ],
        dim=-1,
    )


def euler_xyz_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Euler XYZ (roll, pitch, yaw) from quaternion, stacked (..., 3), with
    the EXACT atan2/asin (the reset observation uses these; the fused step's
    observation uses the approximations of `sim/soa.py`)."""
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2.0 * (w * x + y * z), 1.0 - 2.0 * (x * x + y * y))
    sinp = torch.clamp(2.0 * (w * y - z * x), -1.0, 1.0)
    pitch = torch.asin(sinp)
    yaw = torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))
    return torch.stack([roll, pitch, yaw], dim=-1)


def quat_from_yaw(yaw: torch.Tensor) -> torch.Tensor:
    zeros = torch.zeros_like(yaw)
    return quat_from_euler_xyz(zeros, zeros, yaw)


def yaw_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def matrix_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) from quaternion (w, x, y, z)."""
    w, x, y, z = q.unbind(-1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    return torch.stack([torch.stack([r00, r01, r02], -1),
                        torch.stack([r10, r11, r12], -1),
                        torch.stack([r20, r21, r22], -1)], -2)


def up_dot(q: torch.Tensor) -> torch.Tensor:
    """z-component of the body z axis in the world frame, R[2, 2]."""
    w, x, y, z = q.unbind(-1)
    return 1 - 2 * (x * x + y * y)


def wrap_to_pi(angle: torch.Tensor) -> torch.Tensor:
    return torch.atan2(torch.sin(angle), torch.cos(angle))


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """`x / c` divided exactly, as JAX and the CUDA kernels divide. On a
    CUDA tensor, PyTorch's `tensor / python_float` multiplies by the
    reciprocal instead, an ulp away wherever `1 / c` is inexact (`dt`,
    a stride of 6), so the divisor is made a tensor there."""
    if x.is_cuda:
        return x / torch.full_like(x, c)
    return x / c
