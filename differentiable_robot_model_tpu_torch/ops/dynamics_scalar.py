"""Scalar-expanded topological sweep over the links (the part of the JAX
package's `ops/dynamics_scalar.py` that forward kinematics uses).

Every 3-vector and rotation is a tuple of tensors and the link loop unrolls
over the static topology, so a dof-major `q [D, B...]` runs the sweep on
`[B...]` lanes with elementwise ops only.
"""

from __future__ import annotations

import torch

from ..models.structs import JOINT_PRISMATIC, JOINT_REVOLUTE, RobotStruct


def _link_dof_map(robot: RobotStruct):
    return {l: d for d, l in enumerate(robot.dof_links)}


def _ancestors(robot: RobotStruct, link_idx: int) -> set:
    """Links on the path root..link_idx (inclusive)."""
    chain = {link_idx}
    while link_idx != 0:
        link_idx = robot.parent[link_idx]
        chain.add(link_idx)
    return chain


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _rot(R, v):
    """R @ v with R a 9-tuple (row major)."""
    return (
        R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
        R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
        R[6] * v[0] + R[7] * v[1] + R[8] * v[2],
    )


def _local_rotation(robot: RobotStruct, l: int, q_l):
    """Local joint rotation R_rpy @ R_axis(q) as a 9-tuple."""
    roll, pitch, yaw = robot.rot_angles[l, 0], robot.rot_angles[l, 1], robot.rot_angles[l, 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    F = (
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    )
    if robot.joint_types[l] != JOINT_REVOLUTE:
        return F
    ax, ay, az = robot.axis[l, 0], robot.axis[l, 1], robot.axis[l, 2]
    c, s = torch.cos(q_l), torch.sin(q_l)
    C = 1.0 - c
    J = (
        c + ax * ax * C, ax * ay * C - az * s, ax * az * C + ay * s,
        ay * ax * C + az * s, c + ay * ay * C, ay * az * C - ax * s,
        az * ax * C - ay * s, az * ay * C + ax * s, c + az * az * C,
    )
    return (
        F[0] * J[0] + F[1] * J[3] + F[2] * J[6],
        F[0] * J[1] + F[1] * J[4] + F[2] * J[7],
        F[0] * J[2] + F[1] * J[5] + F[2] * J[8],
        F[3] * J[0] + F[4] * J[3] + F[5] * J[6],
        F[3] * J[1] + F[4] * J[4] + F[5] * J[7],
        F[3] * J[2] + F[4] * J[5] + F[5] * J[8],
        F[6] * J[0] + F[7] * J[3] + F[8] * J[6],
        F[6] * J[1] + F[7] * J[4] + F[8] * J[7],
        F[6] * J[2] + F[7] * J[5] + F[8] * J[8],
    )


def _world_poses_scalar(robot: RobotStruct, q: torch.Tensor, link_idx: int | None = None):
    """World (Rw 9-tuple, pw 3-tuple) per link via a topological sweep.

    q is dof-indexed: [D] or dof-major [D, B...]. With `link_idx`, only that
    link's ancestors are computed (the others stay None), which is what the
    JAX package gets from dead-code elimination.
    """
    L = robot.n_links
    keep = _ancestors(robot, link_idx) if link_idx is not None else set(range(L))
    one = torch.ones(q.shape[1:], dtype=q.dtype, device=q.device)
    zero = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
    ld = _link_dof_map(robot)
    Rw = [None] * L
    pw = [None] * L
    Rw[0] = (one, zero, zero, zero, one, zero, zero, zero, one)
    pw[0] = (zero, zero, zero)
    for l in range(1, L):
        if l not in keep:
            continue
        par = robot.parent[l]
        q_l = q[ld[l]] if l in ld else zero
        R = _local_rotation(robot, l, q_l)
        t = (robot.trans[l, 0], robot.trans[l, 1], robot.trans[l, 2])
        if robot.joint_types[l] == JOINT_PRISMATIC:
            F = _local_rotation(robot, l, zero)
            a = (robot.axis[l, 0], robot.axis[l, 1], robot.axis[l, 2])
            t = _add(t, _scale(_rot(F, a), q_l))
        Rp, pp = Rw[par], pw[par]
        pw[l] = _add(pp, _rot(Rp, t))
        Rw[l] = (
            Rp[0] * R[0] + Rp[1] * R[3] + Rp[2] * R[6],
            Rp[0] * R[1] + Rp[1] * R[4] + Rp[2] * R[7],
            Rp[0] * R[2] + Rp[1] * R[5] + Rp[2] * R[8],
            Rp[3] * R[0] + Rp[4] * R[3] + Rp[5] * R[6],
            Rp[3] * R[1] + Rp[4] * R[4] + Rp[5] * R[7],
            Rp[3] * R[2] + Rp[4] * R[5] + Rp[5] * R[8],
            Rp[6] * R[0] + Rp[7] * R[3] + Rp[8] * R[6],
            Rp[6] * R[1] + Rp[7] * R[4] + Rp[8] * R[7],
            Rp[6] * R[2] + Rp[7] * R[5] + Rp[8] * R[8],
        )
    return Rw, pw
