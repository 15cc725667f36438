"""Trajectory cost functions (pure, batched, differentiable)."""

from __future__ import annotations

import torch


def dense_goal_cost(goal: torch.Tensor, trajectory: torch.Tensor, weight: float = 100.0):
    """mean((weight * (traj - goal))^2), the reference's DenseGoalCost."""
    d = weight * (trajectory - goal)
    return torch.mean(d * d)
