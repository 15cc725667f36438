"""Trajectory cost functions (pure, batched, differentiable): goal
tracking, action effort, joint-limit barriers and joint velocity."""

from __future__ import annotations

import torch

from ..models.structs import RobotStruct


def dense_goal_cost(goal: torch.Tensor, trajectory: torch.Tensor, weight: float = 100.0):
    """mean((weight * (traj - goal))^2), the reference's DenseGoalCost."""
    d = weight * (trajectory - goal)
    return torch.mean(d * d)


def terminal_goal_cost(goal: torch.Tensor, trajectory: torch.Tensor, weight: float = 100.0):
    """Squared distance of the final trajectory point to the goal."""
    d = weight * (trajectory[..., -1, :] - goal)
    return torch.mean(d * d)


def action_effort_cost(actions: torch.Tensor, weight: float = 1.0):
    """Quadratic penalty on actions (regularizes the solve; keeps the iLQR
    Quu positive definite)."""
    return weight * torch.mean(actions * actions)


def joint_limit_barrier(robot: RobotStruct, q_traj: torch.Tensor, weight: float = 1.0,
                        margin: float = 0.0):
    """Smooth one-sided quadratic barrier outside [lower+margin, upper-margin]."""
    lo = robot.limit_lower + margin
    hi = robot.limit_upper - margin
    below = torch.clamp(lo - q_traj, min=0.0)
    above = torch.clamp(q_traj - hi, min=0.0)
    return weight * torch.mean(below * below + above * above)


def velocity_cost(qd_traj: torch.Tensor, weight: float = 1.0):
    return weight * torch.mean(qd_traj * qd_traj)
