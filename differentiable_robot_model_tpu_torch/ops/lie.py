"""Batched SO(3)/SE(3) Lie-group math on tensors.

PyTorch counterpart of the JAX package's `ops/lie.py`. Every function is
shape-polymorphic over leading batch dims and branchless: the small-angle
cases of the log/exp maps switch to Taylor series with `torch.where` on both
operands, so the values stay finite at zero.
"""

from __future__ import annotations

import torch

_EPS = 1e-9


def skew(v: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix of a 3-vector; (..., 3) -> (..., 3, 3)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return _rows([[zero, -z, y], [z, zero, -x], [-y, x, zero]])


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product over the last axis."""
    return torch.linalg.cross(a, b, dim=-1)


def _rows(rows) -> torch.Tensor:
    """A (..., 3, 3) matrix from nested lists of (...,) entries."""
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def x_rot(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +x; (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[o, z, z], [z, c, -s], [z, s, c]])


def y_rot(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +y; (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[c, z, s], [z, o, z], [-s, z, c]])


def z_rot(angle: torch.Tensor) -> torch.Tensor:
    """Rotation about +z; (...,) -> (..., 3, 3)."""
    c, s = torch.cos(angle), torch.sin(angle)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[c, -s, z], [s, c, z], [z, z, o]])


def rpy_to_matrix(rpy: torch.Tensor) -> torch.Tensor:
    """URDF roll-pitch-yaw to rotation matrix: R = Rz(yaw) Ry(pitch) Rx(roll).
    (..., 3) -> (..., 3, 3)."""
    roll, pitch, yaw = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    return z_rot(yaw) @ y_rot(pitch) @ x_rot(roll)


def axis_angle_to_matrix(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula for a *unit* axis; (..., 3), (...,) -> (..., 3, 3)."""
    c = torch.cos(angle)[..., None, None]
    s = torch.sin(angle)[..., None, None]
    K = skew(axis)
    aaT = axis[..., :, None] * axis[..., None, :]
    return c * _eye_like(K) + s * K + (1.0 - c) * aaT


def exp_so3(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) exponential map; (..., 3) -> (..., 3, 3), with Taylor series for
    small angles."""
    theta_sq = (omega * omega).sum(-1)
    theta = torch.sqrt(theta_sq + _EPS**2)
    small = theta_sq < _EPS
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta_sq + _EPS**2))
    K = skew(omega)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """SO(3) logarithm; (..., 3, 3) -> (..., 3), the principal branch
    (|omega| <= pi), through the quaternion."""
    q = matrix_to_quaternion(R)  # (x, y, z, w)
    # q and -q are the same rotation: take w >= 0.
    q = q * torch.where(q[..., 3:4] < 0, -1.0, 1.0)
    v, w = q[..., :3], q[..., 3]
    vn = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < _EPS
    scale = torch.where(small, 2.0 / torch.clamp(w, min=_EPS), angle / torch.where(small, 1.0, vn))
    return v * scale[..., None]


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

    idx = torch.argmax(ts, dim=-1, keepdim=True)  # (..., 1), the first of equal maxima
    return torch.gather(cands, -2, idx[..., None].expand(idx.shape + (4,))).squeeze(-2)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w), normalised first -> rotation matrix;
    (..., 4) -> (..., 3, 3)."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return _rows([
        [1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)],
        [2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)],
        [2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)],
    ])


def quaternion_to_axis_angle(q: torch.Tensor) -> torch.Tensor:
    """Quaternion (x, y, z, w) -> rotation vector (axis * angle); (..., 4) -> (..., 3)."""
    v, w = q[..., :3], q[..., 3]
    vn = torch.linalg.norm(v, dim=-1)
    angle = 2.0 * torch.atan2(vn, w)
    small = vn < _EPS
    scale = torch.where(small, 2.0, angle / torch.where(small, 1.0, vn))
    return v * scale[..., None]


def axis_angle_to_quaternion(aa: torch.Tensor) -> torch.Tensor:
    """Rotation vector -> quaternion (x, y, z, w); (..., 3) -> (..., 4)."""
    angle = torch.linalg.norm(aa, dim=-1)
    half = 0.5 * angle
    small = angle < _EPS
    s = torch.where(small, 0.5 - angle * angle / 48.0, torch.sin(half) / torch.where(small, 1.0, angle))
    return torch.cat([aa * s[..., None], torch.cos(half)[..., None]], dim=-1)


def integrate_axis_angle(aa: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """Integrate an angular velocity onto an axis-angle orientation:
    log(exp(omega dt) exp(aa))."""
    return log_so3(exp_so3(omega * dt) @ exp_so3(aa))


def angular_error(R_des: torch.Tensor, R_cur: torch.Tensor) -> torch.Tensor:
    """Rotation error vector log(R_des R_cur^T)."""
    return log_so3(R_des @ R_cur.transpose(-1, -2))


def hat_so3(v: torch.Tensor) -> torch.Tensor:
    """so(3) hat map (`skew`)."""
    return skew(v)


def vee_so3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of the so(3) hat map; (..., 3, 3) -> (..., 3), averaging the
    two off-diagonal estimates of each entry."""
    x = 0.5 * (M[..., 2, 1] - M[..., 1, 2])
    y = 0.5 * (M[..., 0, 2] - M[..., 2, 0])
    z = 0.5 * (M[..., 1, 0] - M[..., 0, 1])
    return torch.stack([x, y, z], dim=-1)


def hat_se3(xi: torch.Tensor) -> torch.Tensor:
    """se(3) hat map: xi = (v, omega) (..., 6) -> (..., 4, 4) twist matrix."""
    v, omega = xi[..., :3], xi[..., 3:]
    top = torch.cat([skew(omega), v[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=xi.dtype, device=xi.device)
    return torch.cat([top, bottom], dim=-2)


def vee_se3(M: torch.Tensor) -> torch.Tensor:
    """Inverse of the se(3) hat map; (..., 4, 4) -> (..., 6) as (v, omega)."""
    return torch.cat([M[..., :3, 3], vee_so3(M[..., :3, :3])], dim=-1)


def homogeneous_matrix(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> 4x4 homogeneous transform."""
    top = torch.cat([R, t[..., :, None]], dim=-1)
    bottom = torch.zeros(top.shape[:-2] + (1, 4), dtype=R.dtype, device=R.device)
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def homogeneous_inverse(T: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of a homogeneous transform (..., 4, 4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return homogeneous_matrix(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def exp_se3(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """SE(3) exponential. xi = (v, omega) (..., 6) -> (R (..., 3, 3), t (..., 3)),
    with the closed-form left Jacobian."""
    v, omega = xi[..., :3], xi[..., 3:]
    R = exp_so3(omega)
    theta_sq = (omega * omega).sum(-1)
    theta = torch.sqrt(theta_sq + _EPS**2)
    small = theta_sq < _EPS
    K = skew(omega)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(theta)) / (theta_sq + _EPS**2))
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta - torch.sin(theta)) / (theta_sq * theta + _EPS**3),
    )
    V = _eye_like(K) + b[..., None, None] * K + c[..., None, None] * (K @ K)
    return R, torch.einsum("...ij,...j->...i", V, v)


def log_se3(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """SE(3) logarithm -> xi = (v, omega) (..., 6)."""
    omega = log_so3(R)
    theta_sq = (omega * omega).sum(-1)
    theta = torch.sqrt(theta_sq + _EPS**2)
    small = theta_sq < _EPS
    K = skew(omega)
    # V^-1 = I - K/2 + (1/theta^2)(1 - theta sin / (2 (1 - cos))) K^2
    half_theta = 0.5 * theta
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - half_theta * torch.cos(half_theta) / torch.sin(half_theta)) / (theta_sq + _EPS**2),
    )
    Vinv = _eye_like(K) - 0.5 * K + cot_term[..., None, None] * (K @ K)
    return torch.cat([torch.einsum("...ij,...j->...i", Vinv, t), omega], dim=-1)
