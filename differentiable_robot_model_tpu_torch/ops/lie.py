"""Batched SO(3) helpers on tensors (the part of the JAX package's `ops/lie.py`
that forward kinematics needs).

Every function is shape-polymorphic over leading batch dims and branchless.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector; (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], dim=-1),
            torch.stack([z, zero, -x], dim=-1),
            torch.stack([-y, x, zero], dim=-1),
        ],
        dim=-2,
    )


def _axis_rot(angle: torch.Tensor, i: int) -> torch.Tensor:
    """Rotation about coordinate axis i (0=x, 1=y, 2=z); (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    rows = {
        0: [[o, z, z], [z, c, -s], [z, s, c]],
        1: [[c, z, s], [z, o, z], [-s, z, c]],
        2: [[c, -s, z], [s, c, z], [z, z, o]],
    }[i]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF roll-pitch-yaw to rotation matrix: R = Rz(yaw) Ry(pitch) Rx(roll).
    (..., 3) -> (..., 3, 3)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    return _axis_rot(yaw, 2) @ _axis_rot(pitch, 1) @ _axis_rot(roll, 0)


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula for a *unit* axis; (..., 3), (...,) -> (..., 3, 3)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    eye = torch.eye(3, dtype=axis.dtype, device=axis.device).expand(K.shape)
    aaT = axis[..., :, None] * axis[..., None, :]
    return c * eye + s * K + (1.0 - c) * aaT


def matrix_to_quaternion(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> quaternion in (x, y, z, w) order, branchless.

    Computes the quaternion through each of the four numerically stable
    candidates and selects the one keyed by the largest diagonal combination
    (the w-branch yields w >= 0).
    """
    r00, r01, r02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    r10, r11, r12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    r20, r21, r22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    t_w = 1.0 + r00 + r11 + r22  # 4 w^2
    t_x = 1.0 + r00 - r11 - r22  # 4 x^2
    t_y = 1.0 - r00 + r11 - r22  # 4 y^2
    t_z = 1.0 - r00 - r11 + r22  # 4 z^2

    cand_w = torch.stack([r21 - r12, r02 - r20, r10 - r01, t_w], dim=-1)
    cand_x = torch.stack([t_x, r01 + r10, r02 + r20, r21 - r12], dim=-1)
    cand_y = torch.stack([r10 + r01, t_y, r12 + r21, r02 - r20], dim=-1)
    cand_z = torch.stack([r20 + r02, r21 + r12, t_z, r10 - r01], dim=-1)

    cands = torch.stack([cand_w, cand_x, cand_y, cand_z], dim=-2)  # (..., 4, 4)
    ts = torch.stack([t_w, t_x, t_y, t_z], dim=-1)  # (..., 4)
    denom = 2.0 * torch.sqrt(torch.clamp(ts, min=_EPS))
    cands = cands / denom[..., None]

    idx = torch.argmax(ts, dim=-1, keepdim=True)  # (..., 1)
    return torch.gather(cands, -2, idx[..., None].expand(idx.shape + (4,))).squeeze(-2)
