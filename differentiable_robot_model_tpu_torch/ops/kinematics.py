"""Kinematics on stacked link tensors: FK, world joint subspaces, velocities
and Jacobians.

PyTorch counterpart of the JAX package's `ops/kinematics.py`. The JAX
functions take one sample and are vmapped; here each takes leading batch
dims (q [..., D]) and writes the batch out. Two FK forms give the same
poses:
- the scalar topological sweep (`fk_world_scalar`): rotations are nine
  tensors, positions three, and the link loop unrolls over the static
  topology, so a batch runs as elementwise ops on lanes (the model API's
  default);
- the composition of the per-link local transforms (`fk_world`), by
  pointer doubling over the parent array (index gathers and batched 3x3
  products, ceil(log2(depth)) rounds) or sequentially.
"""

from __future__ import annotations

import torch

from ..models.structs import RobotStruct
from .dynamics_scalar import _world_poses_scalar
from .lie import axis_angle_to_matrix, cross, rpy_to_matrix


def _links(robot: RobotStruct, x: torch.Tensor) -> torch.Tensor:
    """A per-dof [..., D] tensor scattered onto the links [..., L] (0 on
    fixed links)."""
    return x @ robot.dof_select.T


def joint_local_transforms(robot: RobotStruct, q: torch.Tensor):
    """Per-link local transform (parent <- link) for q [..., D]: returns
    (R_loc [..., L, 3, 3], t_loc [..., L, 3]), with R_loc = R_rpy R_axis(a, q)
    for a revolute joint and t_loc = xyz + R_rpy (a q) for a prismatic one."""
    q_link = _links(robot, q)
    R_fix = rpy_to_matrix(robot.rot_angles)  # [L, 3, 3]
    R_joint = axis_angle_to_matrix(robot.axis, q_link * robot.rev_mask)
    t_prism = torch.einsum("lij,...lj->...li", R_fix, robot.axis * (q_link * robot.prism_mask)[..., None])
    return R_fix @ R_joint, robot.trans + t_prism


def fk_compose_doubling(robot: RobotStruct, R_loc: torch.Tensor, t_loc: torch.Tensor):
    """Compose local transforms into world poses by pointer doubling.

    After k rounds, (R[i], t[i]) composes the local transforms on the path
    from the 2^k-th ancestor (exclusive) down to link i. The root is its
    own parent with an identity transform, so extra rounds change nothing;
    the rounds end when every pointer reaches the root.
    """
    pi = list(robot.parent)
    R, t = R_loc, t_loc
    while any(p != 0 for p in pi):
        idx = torch.tensor(pi, device=R.device)
        Rp, tp = R.index_select(-3, idx), t.index_select(-2, idx)
        t = torch.einsum("...lij,...lj->...li", Rp, t) + tp
        R = Rp @ R
        pi = [pi[p] for p in pi]
    return R, t


def fk_compose_sequential(robot: RobotStruct, R_loc: torch.Tensor, t_loc: torch.Tensor):
    """The same composition link by link in topological order."""
    Rs, ts = [R_loc[..., 0, :, :]], [t_loc[..., 0, :]]
    for i in range(1, robot.n_links):
        p = robot.parent[i]
        Rs.append(Rs[p] @ R_loc[..., i, :, :])
        ts.append(torch.einsum("...ij,...j->...i", Rs[p], t_loc[..., i, :]) + ts[p])
    return torch.stack(Rs, dim=-3), torch.stack(ts, dim=-2)


def fk_world(robot: RobotStruct, q: torch.Tensor, sequential: bool = False):
    """World pose of every link for q [..., D] by composing the local
    transforms. Returns (R [..., L, 3, 3], p [..., L, 3])."""
    R_loc, t_loc = joint_local_transforms(robot, q)
    if sequential:
        return fk_compose_sequential(robot, R_loc, t_loc)
    return fk_compose_doubling(robot, R_loc, t_loc)


def fk_world_scalar(robot: RobotStruct, q: torch.Tensor):
    """World pose of every link for q [..., D] by the scalar topological
    sweep. Returns (R [..., L, 3, 3], p [..., L, 3])."""
    batch = q.shape[:-1]
    Rw, pw = _world_poses_scalar(robot, q.movedim(-1, 0))
    R = torch.stack([torch.stack(r) for r in Rw])  # [L, 9, *batch]
    p = torch.stack([torch.stack(t) for t in pw])  # [L, 3, *batch]
    R = R.movedim(0, -1).movedim(0, -1).reshape(batch + (robot.n_links, 3, 3))
    p = p.movedim(0, -1).movedim(0, -1)
    return R, p


def fk_link_position(robot: RobotStruct, q: torch.Tensor, link_idx: int) -> torch.Tensor:
    """World position of one link for q: [..., D] -> [..., 3] (the dof-first
    sweep below with the batch moved to its lanes)."""
    return fk_link_position_dof_first(robot, q.movedim(-1, 0), link_idx).movedim(0, -1)


def fk_link_position_dof_first(
    robot: RobotStruct, qM: torch.Tensor, link_idx: int
) -> torch.Tensor:
    """World position of one link for dof-first configs qM: [D, B...] ->
    [3, B...]; the sweep runs on the batch lanes, ancestors only."""
    _, pw = _world_poses_scalar(robot, qM, link_idx)
    return torch.stack(pw[link_idx])


def world_joint_subspaces(robot: RobotStruct, R: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """World-frame joint motion subspaces [..., L, 6] in [ang, lin] order,
    about the world origin: [z, p x z] for a revolute joint at p with world
    axis z = R a, [0, z] for a prismatic one, 0 for a fixed one."""
    z = torch.einsum("...lij,lj->...li", R, robot.axis)
    s_rev = torch.cat([z, cross(p, z)], dim=-1)
    s_prism = torch.cat([torch.zeros_like(z), z], dim=-1)
    return robot.rev_mask[:, None] * s_rev + robot.prism_mask[:, None] * s_prism


def body_velocities(robot: RobotStruct, S: torch.Tensor, qd: torch.Tensor) -> torch.Tensor:
    """World-origin spatial velocity of every link [..., L, 6]: the sum of
    S_j qd_j over the link's ancestors (itself included)."""
    return torch.einsum("lj,...jk->...lk", robot.anc_mask, S * _links(robot, qd)[..., None])


def link_jacobian(robot: RobotStruct, q: torch.Tensor, link_idx: int):
    """Geometric Jacobian of link `link_idx` for q [..., D]: (J_lin, J_ang),
    each [..., 3, D]. Every dof's column is the joint's world subspace moved
    to the link's origin, masked by ancestry, so branched trees need no walk."""
    R, p = fk_world_scalar(robot, q)
    S = world_joint_subspaces(robot, R, p)
    p_e = p[..., link_idx, :]
    j_ang_link = S[..., :3]
    j_lin_link = S[..., 3:] + cross(S[..., :3], p_e[..., None, :].expand(j_ang_link.shape))
    mask = robot.anc_mask[link_idx][:, None]  # [L, 1]
    dofs = torch.tensor(robot.dof_links, dtype=torch.long, device=q.device)
    j_ang = (j_ang_link * mask).index_select(-2, dofs).transpose(-1, -2)
    j_lin = (j_lin_link * mask).index_select(-2, dofs).transpose(-1, -2)
    return j_lin, j_ang
