"""Rigid-body dynamics on stacked link tensors, world-frame formulation, and
the articulated-body algorithm.

PyTorch counterpart of the JAX package's `ops/dynamics.py`. Every spatial
quantity is expressed at the world origin, so the tree sweeps of RNEA and
of the composite inertias become sums over ancestors or descendants: dense
products with the ancestor mask. `aba` is the O(L) articulated-body
algorithm in link-local frames, an independent check of the CRB path.

The JAX functions take one sample and are vmapped; these take leading batch
dims (q [..., D]). Gravity enters as a fictitious +g z base acceleration
(d'Alembert).
"""

from __future__ import annotations

import torch

from ..models.structs import RobotStruct
from .dynamics_scalar import GRAVITY, forward_dynamics_scalar
from .kinematics import body_velocities, fk_world, joint_local_transforms, world_joint_subspaces
from .lie import skew
from .spatial import (
    inertia_times_motion,
    motion_cross_force,
    motion_cross_motion,
    spatial_inertia_matrix,
)


def _world_inertia_terms(robot: RobotStruct, R: torch.Tensor, p: torch.Tensor):
    """World-frame per-link COM position and rotational inertia about the COM."""
    com_w = p + torch.einsum("...lij,lj->...li", R, robot.com)
    i_cw = R @ robot.inertia_com @ R.transpose(-1, -2)
    return com_w, i_cw


def _gravity_acc(robot: RobotStruct, include_gravity: bool, gravity: float) -> torch.Tensor:
    a = torch.zeros((6,), dtype=robot.dtype, device=robot.device)
    if include_gravity:
        a[5] = gravity  # +g z linear acceleration of the base
    return a


def rnea(robot: RobotStruct, q, qd, qdd, include_gravity: bool = True, use_damping: bool = True,
         gravity: float = GRAVITY) -> torch.Tensor:
    """Inverse dynamics: the torques [..., D] that give qdd at (q, qd)."""
    R, p = fk_world(robot, q)
    return rnea_given_fk(robot, R, p, q, qd, qdd, include_gravity, use_damping, gravity)


def rnea_given_fk(robot: RobotStruct, R, p, q, qd, qdd, include_gravity: bool = True,
                  use_damping: bool = True, gravity: float = GRAVITY) -> torch.Tensor:
    """World-frame RNEA from the link poses (R [..., L, 3, 3], p [..., L, 3]):
    A = anc (S qdd + (V x S) qd) + a_g, F = I A + V x* I V summed over each
    joint's descendants, tau = <S, F>."""
    S = world_joint_subspaces(robot, R, p)
    qd_link = qd @ robot.dof_select.T
    qdd_link = qdd @ robot.dof_select.T
    V = body_velocities(robot, S, qd)
    A_rel = S * qdd_link[..., None] + motion_cross_motion(V, S) * qd_link[..., None]
    A = torch.einsum("lj,...jk->...lk", robot.anc_mask, A_rel)
    A = A + _gravity_acc(robot, include_gravity, gravity)
    com_w, i_cw = _world_inertia_terms(robot, R, p)
    IV = inertia_times_motion(robot.mass, com_w, i_cw, V)
    F_body = inertia_times_motion(robot.mass, com_w, i_cw, A) + motion_cross_force(V, IV)
    F_joint = torch.einsum("lj,...lk->...jk", robot.anc_mask, F_body)
    tau = (S * F_joint).sum(-1) @ robot.dof_select  # [..., D]
    if use_damping:
        tau = tau + robot.damping * qd
    return tau


def nonlinear_effects(robot: RobotStruct, q, qd, include_gravity: bool = True,
                      use_damping: bool = True, gravity: float = GRAVITY) -> torch.Tensor:
    """Coriolis, centrifugal and gravity (and damping) torques: RNEA at qdd = 0."""
    return rnea(robot, q, qd, torch.zeros_like(q), include_gravity, use_damping, gravity)


def mass_matrix(robot: RobotStruct, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix H(q) [..., D, D] by world-frame composite
    rigid bodies."""
    R, p = fk_world(robot, q)
    return mass_matrix_given_fk(robot, R, p)


def mass_matrix_given_fk(robot: RobotStruct, R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """H from the link poses: Ic_j = the descendants' spatial inertias,
    H_ij = <S_i, Ic_j S_j> for i an ancestor of j (or j itself), symmetrised."""
    S = world_joint_subspaces(robot, R, p)
    com_w, i_cw = _world_inertia_terms(robot, R, p)
    I_w = spatial_inertia_matrix(robot.mass, com_w, i_cw)  # [..., L, 6, 6]
    Ic = torch.einsum("lj,...lab->...jab", robot.anc_mask, I_w)
    F = torch.einsum("...jab,...jb->...ja", Ic, S)
    G = torch.einsum("...ia,...ja->...ij", S, F)
    Hl = G * robot.anc_mask.T
    H_link = Hl + Hl.transpose(-1, -2) - torch.diag_embed(torch.diagonal(G, dim1=-2, dim2=-1))
    return robot.dof_select.T @ H_link @ robot.dof_select


def forward_dynamics_crb(robot: RobotStruct, q, qd, f, include_gravity: bool = True,
                         use_damping: bool = False, gravity: float = GRAVITY) -> torch.Tensor:
    """Forward dynamics qdd = H^-1 (f - nle) [..., D] by the scalar-expanded
    path (`forward_dynamics_scalar`: NLE by the scalar RNEA, the CRB mass
    matrix, an unrolled LDL^T solve) with the batch on its lanes."""
    lanes = lambda x: x.movedim(-1, 0)
    qdd = forward_dynamics_scalar(
        robot, lanes(q), lanes(qd), lanes(f), include_gravity, use_damping, gravity
    )
    return qdd.movedim(0, -1)


def sym_solve(H: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """Solve H x = rhs for symmetric positive-definite H [..., D, D] and rhs
    [..., D] by Cholesky, in float32 at least, cast back to H's dtype."""
    dtype = H.dtype
    compute = torch.promote_types(dtype, torch.float32)
    chol = torch.linalg.cholesky(H.to(compute))
    return torch.cholesky_solve(rhs.to(compute)[..., None], chol)[..., 0].to(dtype)


def _mv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", M, v)


def aba(robot: RobotStruct, q, qd, f, include_gravity: bool = True, use_damping: bool = False,
        gravity: float = GRAVITY) -> torch.Tensor:
    """Articulated-body forward dynamics [..., D], O(L), in link-local
    frames. The three sweeps unroll over the static topology; each step is
    a batched 6x6 update. The 1e-37 added to each joint's articulated
    inertia smooths zero-mass links and makes fixed joints (S = 0) come out
    as no motion."""
    if use_damping:
        f = f - robot.damping * qd
    L = robot.n_links
    batch = q.shape[:-1]
    R_loc, t_loc = joint_local_transforms(robot, q)
    qd_link = qd @ robot.dof_select.T
    f_link = f @ robot.dof_select.T
    zero_axis = torch.zeros_like(robot.axis)
    # Local motion subspace: [axis, 0] revolute, [0, axis] prismatic.
    S = (robot.rev_mask[:, None] * torch.cat([robot.axis, zero_axis], -1)
         + robot.prism_mask[:, None] * torch.cat([zero_axis, robot.axis], -1))
    # Motion transform child <- parent: X = [[R^T, 0], [-R^T t~, R^T]].
    Rt = R_loc.transpose(-1, -2)
    X_up = torch.cat([
        torch.cat([Rt, torch.zeros_like(Rt)], dim=-1),
        torch.cat([-Rt @ skew(t_loc), Rt], dim=-1),
    ], dim=-2)  # [..., L, 6, 6]
    X = [X_up[..., l, :, :] for l in range(L)]
    I_sp = spatial_inertia_matrix(robot.mass, robot.com, robot.inertia_com)  # [L, 6, 6]
    eps = 1e-37

    z6 = q.new_zeros(batch + (6,))
    v, c, pA = [z6] * L, [z6] * L, [z6] * L
    for l in range(1, L):  # root -> leaves: velocities and bias terms
        vJ = S[l] * qd_link[..., l, None]
        v[l] = _mv(X[l], v[robot.parent[l]]) + vJ
        c[l] = motion_cross_motion(v[l], vJ)
        pA[l] = motion_cross_force(v[l], _mv(I_sp[l], v[l]))

    IA = [I_sp[l].expand(batch + (6, 6)) for l in range(L)]
    U, d, u = [z6] * L, [q.new_ones(batch)] * L, [q.new_zeros(batch)] * L
    for l in range(L - 1, 0, -1):  # leaves -> root: articulated inertias
        U[l] = _mv(IA[l], S[l])
        d[l] = (S[l] * U[l]).sum(-1)
        u[l] = f_link[..., l] - (S[l] * pA[l]).sum(-1)
        par = robot.parent[l]
        Ia = IA[l] - U[l][..., :, None] * U[l][..., None, :] / (d[l] + eps)[..., None, None]
        pa = pA[l] + _mv(Ia, c[l]) + U[l] * (u[l] / (d[l] + eps))[..., None]
        Xt = X[l].transpose(-1, -2)
        IA[par] = IA[par] + Xt @ Ia @ X[l]
        pA[par] = pA[par] + _mv(Xt, pa)

    a = [_gravity_acc(robot, include_gravity, gravity).expand(batch + (6,))] + [z6] * (L - 1)
    qdd_link = [q.new_zeros(batch)] * L
    for l in range(1, L):  # root -> leaves: accelerations
        a_l = _mv(X[l], a[robot.parent[l]]) + c[l]
        qdd_link[l] = (u[l] - (U[l] * a_l).sum(-1)) / (d[l] + eps)
        a[l] = a_l + S[l] * qdd_link[l][..., None]
    return torch.stack(qdd_link, dim=-1) @ robot.dof_select
