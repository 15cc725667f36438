"""Receding-horizon MPC: warm-started replanning.

PyTorch counterpart of the kinematic and torque-space MPC drivers in the
JAX package's `trajopt/mpc.py`. An MPC step is (solve with warm start) +
(execute the first action(s)) + (shift the plan); the batched steps replan
a whole fleet of B scenarios with one solve, and `run_closed_loop` runs N
ticks of any of them.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..models.structs import RobotStruct
from ..ops import kinematics as K
from ..ops.dynamics_scalar import rnea_scalar
from ..ops.kernels.fk import fk_position_dof_major
from ..ops.kernels.rollout import dyn_rollout_ee_fwd, dyn_rollout_ee_fwd_reference
from .rollout import clip_to_limits
from .solvers import (
    resolve_dynamic_engine,
    resolve_engine,
    solve_dynamic_adam_batch,
    solve_kinematic_adam,
    solve_kinematic_adam_batch,
)


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


@dataclasses.dataclass(frozen=True)
class DynamicMPCConfig:
    """Config of the torque-space (dynamics-in-the-loop) MPC step."""

    horizon: int = 50
    iters_per_step: int = 10
    lr: float = 0.5
    dt: float = 0.02
    goal_weight: float = 10.0
    effort_weight: float = 1e-4
    eps: float = 1e-1  # gradient-scale Adam eps
    replan_interval: int = 1
    # Enforce the URDF effort limits as a box on planned and executed torques.
    respect_effort_limits: bool = False
    # Engine (see solvers.solve_dynamic_adam_batch): "auto" is the whole-solve
    # kernel for a CUDA float32 robot, the per-iteration rollout kernels for
    # other CUDA robots and plain torch on the CPU; "fused" / "kernel" /
    # "scan" force a choice.
    rollout_impl: str = "auto"


class DynamicMPCState(NamedTuple):
    q: torch.Tensor  # [..., D] joint position
    qd: torch.Tensor  # [..., D] joint velocity
    plan: torch.Tensor  # [..., H, D] warm-start absolute torque sequence
    step_count: torch.Tensor  # [...]


def dynamic_mpc_init(robot: RobotStruct, q0, qd0, config: DynamicMPCConfig) -> DynamicMPCState:
    """Initial state(s) for q0, qd0 [..., D] with the plan at gravity
    compensation (the solver's zero-delta reference), so the first replan
    warm-starts from a hold-still rollout."""
    q = torch.as_tensor(q0, dtype=robot.dtype, device=robot.device)
    qd = torch.as_tensor(qd0, dtype=robot.dtype, device=robot.device)
    qT = q.movedim(-1, 0)
    tau_ref = rnea_scalar(robot, qT, torch.zeros_like(qT), torch.zeros_like(qT)).movedim(0, -1)
    batch = q.shape[:-1]
    plan = tau_ref.unsqueeze(-2).expand(batch + (config.horizon, robot.n_dofs)).contiguous()
    return DynamicMPCState(q, qd, plan, torch.zeros(batch, dtype=torch.int32, device=robot.device))


def make_dynamic_mpc_step_batch(robot: RobotStruct, ee_link_idx: int, config: DynamicMPCConfig):
    """The fleet torque-space MPC step: (states [B], goals [B, 3]) ->
    (states', metrics), one batched solve (solvers.solve_dynamic_adam_batch)
    per replan, warm-started from the previous plan.

    The plant executes the first `replan_interval` torques through the
    integrator the plan uses (semi-implicit Euler, implicit joint damping,
    velocity clamp), and the plan shifts with its last torque held over the
    tail. With a kernel engine the plant step is one launch of the rollout
    kernel `dyn_rollout_ee_fwd`, which also gives the ee position for the
    metrics (its plain version on the CPU).
    """
    engine = resolve_dynamic_engine(config.rollout_impl, robot, config.iters_per_step)
    plant = dyn_rollout_ee_fwd_reference if engine == "scan" else dyn_rollout_ee_fwd

    def step(states: DynamicMPCState, goals: torch.Tensor):
        result = solve_dynamic_adam_batch(
            robot, states.q, states.qd, goals, ee_link_idx,
            horizon=config.horizon, dt=config.dt, n_iters=config.iters_per_step,
            lr=config.lr, goal_weight=config.goal_weight,
            effort_weight=config.effort_weight, eps=config.eps,
            init_actions=states.plan, respect_effort_limits=config.respect_effort_limits,
            rollout_impl=engine,
        )
        with torch.no_grad():
            n_exec = config.replan_interval
            actions = result.actions  # [B, H, D]
            qs, qds, ps = plant(
                robot, states.q.T.contiguous(), states.qd.T.contiguous(),
                actions[:, :n_exec].permute(1, 2, 0).contiguous(), config.dt, ee_link_idx,
            )
            B = actions.shape[0]
            plan_next = torch.cat(
                [actions[:, n_exec:], actions[:, -1:].expand(B, n_exec, robot.n_dofs)], dim=1
            )
            metrics = MPCMetrics(
                cost=result.cost,
                cost_initial=result.cost_history[0],
                goal_distance=torch.linalg.norm(ps[-1].T - goals, dim=-1),
                plan_norm=torch.sqrt(torch.mean(actions**2, dim=(1, 2))),
            )
        state = DynamicMPCState(qs[-1].T, qds[-1].T, plan_next, states.step_count + 1)
        return state, metrics

    return step


def make_dynamic_mpc_step(robot: RobotStruct, ee_link_idx: int, config: DynamicMPCConfig):
    """The single-scenario torque-space MPC step: (state, goal [3]) ->
    (state', metrics), the batched step at B=1 (the JAX package does the
    same: one dof-major program serves both)."""
    step_batch = make_dynamic_mpc_step_batch(robot, ee_link_idx, config)

    def step(state: DynamicMPCState, goal: torch.Tensor):
        states, metrics = step_batch(DynamicMPCState(*(x[None] for x in state)), goal[None])
        return DynamicMPCState(*(x[0] for x in states)), MPCMetrics(*(x[0] for x in metrics))

    return step


def run_closed_loop(step_fn, state0, goal, n_steps: int, per_tick_goal: bool = False):
    """N warm-started MPC ticks of `step_fn` (any of this module's steps:
    `(state, goal) -> (state', metrics)`). Returns (final state, metrics
    with every field stacked over the ticks on a new leading axis). With
    `per_tick_goal`, `goal[i]` is tick i's goal (a moving setpoint);
    otherwise every tick shares `goal`."""
    state, history = state0, []
    for i in range(n_steps):
        state, metrics = step_fn(state, goal[i] if per_tick_goal else goal)
        history.append(metrics)
    if not history:
        raise ValueError("run_closed_loop needs n_steps >= 1")
    return state, type(history[0])(*(torch.stack(f) for f in zip(*history)))
