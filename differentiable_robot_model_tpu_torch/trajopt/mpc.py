"""Receding-horizon MPC: warm-started replanning.

PyTorch counterpart of the kinematic MPC drivers in the JAX package's
`trajopt/mpc.py`. An MPC step is (solve with warm start) + (execute the
first action(s)) + (shift the plan); the batched step replans a whole fleet
of B scenarios with one solve.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.structs import RobotStruct
from ..ops import kinematics as K
from ..ops.kernels.fk import fk_position_dof_major
from .rollout import clip_to_limits
from .solvers import resolve_engine, solve_kinematic_adam, solve_kinematic_adam_batch


@dataclasses.dataclass(frozen=True)
class MPCConfig:
    horizon: int = 50
    iters_per_step: int = 10
    lr: float = 0.05
    goal_weight: float = 100.0
    replan_interval: int = 1  # execute this many actions per replan
    # Engine of the batched driver (see solvers.solve_kinematic_adam_batch):
    # "auto" is the whole-solve kernel for a CUDA float32 robot, the
    # per-iteration FK kernels for other CUDA robots and plain torch on the
    # CPU; "fused" / "kernel" / "scalar" force a choice. The per-sample
    # `make_mpc_step` ignores it.
    fk_impl: str = "auto"


class MPCState(NamedTuple):
    q: torch.Tensor  # [..., D] current joint position
    plan: torch.Tensor  # [..., H, D] warm-start action sequence
    step_count: torch.Tensor  # [...]


class MPCMetrics(NamedTuple):
    cost: torch.Tensor  # final solve cost
    cost_initial: torch.Tensor  # cost before this replan's iterations
    goal_distance: torch.Tensor  # current ee distance to goal
    plan_norm: torch.Tensor  # action-plan RMS


def mpc_init(robot: RobotStruct, q0: torch.Tensor, config: MPCConfig) -> MPCState:
    """Initial state(s) for q0 [..., D] on the robot's device, zero plan."""
    q = torch.as_tensor(q0, dtype=robot.dtype, device=robot.device)
    batch = q.shape[:-1]
    plan = torch.zeros(batch + (config.horizon, robot.n_dofs), dtype=robot.dtype, device=robot.device)
    return MPCState(q, plan, torch.zeros(batch, dtype=torch.int32, device=robot.device))


def make_mpc_step(robot: RobotStruct, ee_link_idx: int, config: MPCConfig):
    """The per-sample MPC step: (state, goal [3]) -> (state', metrics)."""

    def step(state: MPCState, goal: torch.Tensor):
        result = solve_kinematic_adam(
            robot, state.q, goal, ee_link_idx,
            horizon=config.horizon, n_iters=config.iters_per_step, lr=config.lr,
            goal_weight=config.goal_weight, init_actions=state.plan,
        )
        with torch.no_grad():
            n_exec = config.replan_interval
            q_next = state.q
            for i in range(n_exec):
                q_next = clip_to_limits(robot, q_next + result.actions[i])
            plan_next = torch.cat(
                [result.actions[n_exec:], result.actions.new_zeros((n_exec, robot.n_dofs))]
            )
            ee = K.fk_link_position(robot, q_next, ee_link_idx)
            metrics = MPCMetrics(
                cost=result.cost,
                cost_initial=result.cost_history[0],
                goal_distance=torch.linalg.norm(ee - goal),
                plan_norm=torch.sqrt(torch.mean(result.actions**2)),
            )
        return MPCState(q_next, plan_next, state.step_count + 1), metrics

    return step


def make_mpc_step_batch(
    robot: RobotStruct,
    ee_link_idx: int,
    config: MPCConfig,
    fk_impl: str | None = None,
    eps: float = 1e-8,
):
    """The fleet MPC step: (states [B], goals [B, 3]) -> (states', metrics),
    one batched solve (solvers.solve_kinematic_adam_batch) per replan.

    The engine comes from `config.fk_impl`; the `fk_impl` argument, when
    given, overrides it. With a kernel engine the end-effector position for
    the metrics comes from the FK kernel K1 too (its plain version on the
    CPU): in eager PyTorch the scalar sweep would be over a thousand small
    launches per replan.
    """
    engine = resolve_engine(
        config.fk_impl if fk_impl is None else fk_impl,
        robot, config.horizon, config.iters_per_step,
    )
    if engine == "scalar":
        ee_position = lambda q: K.fk_link_position(robot, q, ee_link_idx)
    else:
        ee_position = lambda q: fk_position_dof_major(robot, q.T.contiguous(), ee_link_idx).T

    def step(states: MPCState, goals: torch.Tensor):
        result = solve_kinematic_adam_batch(
            robot, states.q, goals, ee_link_idx,
            horizon=config.horizon, n_iters=config.iters_per_step, lr=config.lr,
            goal_weight=config.goal_weight, fk_impl=engine, eps=eps,
            init_actions=states.plan,
        )
        with torch.no_grad():
            n_exec = config.replan_interval
            q_next = states.q
            for i in range(n_exec):
                q_next = clip_to_limits(robot, q_next + result.actions[:, i])
            B = result.actions.shape[0]
            plan_next = torch.cat(
                [
                    result.actions[:, n_exec:],
                    result.actions.new_zeros((B, n_exec, robot.n_dofs)),
                ],
                dim=1,
            )
            ee = ee_position(q_next)
            metrics = MPCMetrics(
                cost=result.cost,
                cost_initial=result.cost_history[0],
                goal_distance=torch.linalg.norm(ee - goals, dim=-1),
                plan_norm=torch.sqrt(torch.mean(result.actions**2, dim=(1, 2))),
            )
        return MPCState(q_next, plan_next, states.step_count + 1), metrics

    return step
