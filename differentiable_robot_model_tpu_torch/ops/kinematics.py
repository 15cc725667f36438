"""Forward kinematics on tensors (the part of the JAX package's
`ops/kinematics.py` that the kinematic MPC path uses).

All of them run the scalar-expanded topological sweep: rotations are nine
tensors, positions three, and the link loop unrolls over the static
topology, so a batch of configurations runs as elementwise ops on lanes.
"""

from __future__ import annotations

import torch

from ..models.structs import RobotStruct
from .dynamics_scalar import _world_poses_scalar


def fk_world_scalar(robot: RobotStruct, q: torch.Tensor):
    """World pose of every link for q: [..., D].

    Returns (R [..., L, 3, 3], p [..., L, 3]); the batch runs on lanes of the
    topological sweep.
    """
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
