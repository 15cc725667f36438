"""Receding-horizon MPC: warm-started replanning.

PyTorch counterpart of the kinematic and torque-space MPC drivers in the
JAX package's `trajopt/mpc.py`. An MPC step is (solve with warm start) +
(execute the first action(s)) + (shift the plan); the batched steps replan
a whole fleet of B scenarios with one solve, and `run_closed_loop` runs N
ticks of any of them. Four families: kinematic (Adam on joint deltas),
torque-space (Adam through the forward dynamics), sampling (MPPI through
the forward dynamics) and second-order (iLQR through the forward
dynamics).
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch

from ..models.structs import RobotStruct
from ..ops import kinematics as K
from ..ops.dynamics_scalar import rnea_scalar
from ..ops.kernels.fk import fk_position_dof_major
from ..ops.kernels.rng import prng_key, split_key
from ..ops.kernels.rollout import dyn_rollout_ee_fwd, dyn_rollout_ee_fwd_reference
from .rollout import _positive_or_inf, clip_to_limits
from .solvers import (
    autodiff_f_AB,
    autodiff_linearize,
    ilqr_batch,
    make_gn_reach_linearize,
    make_ift_f_AB,
    make_plant_dynamics,
    resolve_dynamic_engine,
    resolve_engine,
    resolve_mppi_engine,
    solve_dynamic_adam_batch,
    solve_dynamic_mppi,
    solve_dynamic_mppi_batch,
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


def run_mpc(
    robot: RobotStruct,
    q0: torch.Tensor,
    goal: torch.Tensor,
    ee_link_idx: int,
    config: MPCConfig,
    n_steps: int,
):
    """Closed-loop kinematic MPC of one scenario: `n_steps` ticks of
    `make_mpc_step` from `mpc_init`. Returns (final MPCState, MPCMetrics
    with every field stacked over the ticks, q trajectory [n_steps, D])."""
    step = make_mpc_step(robot, ee_link_idx, config)
    state = mpc_init(robot, q0, config)
    metrics, q_traj = [], []
    for _ in range(n_steps):
        state, met = step(state, goal)
        metrics.append(met)
        q_traj.append(state.q)
    if not metrics:
        raise ValueError("run_mpc needs n_steps >= 1")
    return state, MPCMetrics(*(torch.stack(f) for f in zip(*metrics))), torch.stack(q_traj)


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
        q, qd, plan_next, metrics = _plant_tick(
            robot, ee_link_idx, config, plant, states, goals, result.actions, result.cost,
            result.cost_history[0],
        )
        return DynamicMPCState(q, qd, plan_next, states.step_count + 1), metrics

    return step


@torch.no_grad()
def _plant_tick(robot, ee_link_idx, config, plant, states, goals, actions, cost, cost_initial):
    """The rest of a batched torque-space tick after its solve: the plant
    executes the first `replan_interval` torques of actions [B, H, D]
    (`plant`: the rollout kernel K7 or its plain version, which also gives
    the ee position), the plan shifts with its last torque held over the
    tail, and the metrics. Returns (q', qd' [B, D], plan', metrics)."""
    n_exec = config.replan_interval
    qs, qds, ps = plant(
        robot, states.q.T.contiguous(), states.qd.T.contiguous(),
        actions[:, :n_exec].permute(1, 2, 0).contiguous(), config.dt, ee_link_idx,
    )
    B = actions.shape[0]
    plan_next = torch.cat([actions[:, n_exec:], actions[:, -1:].expand(B, n_exec, robot.n_dofs)], dim=1)
    metrics = MPCMetrics(
        cost=cost,
        cost_initial=cost_initial,
        goal_distance=torch.linalg.norm(ps[-1].T - goals, dim=-1),
        plan_norm=torch.sqrt(torch.mean(actions**2, dim=(1, 2))),
    )
    return qs[-1].T, qds[-1].T, plan_next, metrics


def make_dynamic_mpc_step(robot: RobotStruct, ee_link_idx: int, config: DynamicMPCConfig):
    """The single-scenario torque-space MPC step: (state, goal [3]) ->
    (state', metrics), the batched step at B=1 (the JAX package does the
    same: one dof-major program serves both)."""
    step_batch = make_dynamic_mpc_step_batch(robot, ee_link_idx, config)

    def step(state: DynamicMPCState, goal: torch.Tensor):
        states, metrics = step_batch(DynamicMPCState(*(x[None] for x in state)), goal[None])
        return DynamicMPCState(*(x[0] for x in states)), MPCMetrics(*(x[0] for x in metrics))

    return step


@dataclasses.dataclass(frozen=True)
class MPPIMPCConfig:
    """Config of the closed-loop sampling-based (MPPI) MPC step."""

    horizon: int = 30
    iters_per_step: int = 5
    n_samples: int = 128
    temperature: float = 0.01
    noise_sigma: float = 5.0  # rad/s^2 (acceleration-unit sampling)
    dt: float = 0.02
    goal_weight: float = 10.0
    effort_weight: float = 1e-4
    replan_interval: int = 1
    respect_effort_limits: bool = False
    # Engine (see solvers.solve_dynamic_mppi_batch): "auto" is the
    # whole-solve kernel K10 in the batch driver for a CUDA float32 robot,
    # the per-iteration rollout kernel K7 in the per-scenario driver and for
    # other CUDA robots, plain torch on the CPU; "fused" (batch only) /
    # "kernel" / "scan" force a choice.
    rollout_impl: str = "auto"
    # Per-dof noise-scale and softmax-temperature adaptation
    # (solvers.solve_dynamic_mppi adapt_sigma / adapt_temperature).
    adapt_sigma: bool = False
    adapt_temperature: bool = False


class MPPIMPCState(NamedTuple):
    q: torch.Tensor  # [..., D]
    qd: torch.Tensor  # [..., D]
    plan: torch.Tensor  # [..., H, D] warm-start absolute torque sequence
    key: torch.Tensor  # [..., 2] Philox key words (int64, on the CPU), threaded through replans
    step_count: torch.Tensor  # [...]


def mppi_mpc_init(robot: RobotStruct, q0, qd0, config: MPPIMPCConfig, key) -> MPPIMPCState:
    """Initial state(s) for q0, qd0 [..., D]: the plan at gravity
    compensation, and the key the state owns, so the closed loop is
    deterministic in it. `key` is [..., 2] with the states' batch shape, or
    one key (an int or [2]) that a batch splits into one per scenario
    (ops/kernels/rng.py `split_key`)."""
    hold = dynamic_mpc_init(robot, q0, qd0, DynamicMPCConfig(horizon=config.horizon))
    batch = hold.q.shape[:-1]
    key = prng_key(key) if isinstance(key, int) else torch.as_tensor(key, dtype=torch.int64).cpu()
    if key.shape == (2,) and batch:
        key = split_key(key, math.prod(batch)).reshape(batch + (2,))
    if key.shape != batch + (2,):
        raise ValueError(f"key must be [2] or {list(batch + (2,))}, got {tuple(key.shape)}")
    return MPPIMPCState(hold.q, hold.qd, hold.plan, key, hold.step_count)


def _mppi_solve_kwargs(config: MPPIMPCConfig) -> dict:
    return dict(
        horizon=config.horizon, n_samples=config.n_samples, n_iters=config.iters_per_step,
        dt=config.dt, temperature=config.temperature, noise_sigma=config.noise_sigma,
        goal_weight=config.goal_weight, effort_weight=config.effort_weight,
        respect_effort_limits=config.respect_effort_limits, adapt_sigma=config.adapt_sigma,
        adapt_temperature=config.adapt_temperature,
    )


def make_mppi_mpc_step_batch(robot: RobotStruct, ee_link_idx: int, config: MPPIMPCConfig):
    """The fleet MPPI MPC step: (states [B], goals [B, 3]) -> (states',
    metrics), one batched sampling solve (solvers.solve_dynamic_mppi_batch)
    per replan, warm-started from the shifted plan.

    Every scenario's key advances each tick, and, as the JAX package does,
    the solve draws all scenarios' noise from scenario 0's key (scenario b
    at counter word b of its stream): each tick draws fresh noise and the
    loop is deterministic in the initial keys. The plant executes the first
    `replan_interval` torques through the integrator the samples use, one
    launch of the rollout kernel K7 (`dyn_rollout_ee_fwd`, its plain version
    on the "scan" engine), which also gives the ee position for the metrics.
    With "auto" on a CUDA float32 robot a replan is three launches: the
    prologue, K10 and K7.
    """
    engine = resolve_mppi_engine(config.rollout_impl, robot, config.n_samples,
                                 config.adapt_sigma or config.adapt_temperature, batched=True)
    plant = dyn_rollout_ee_fwd_reference if engine == "scan" else dyn_rollout_ee_fwd
    kwargs = _mppi_solve_kwargs(config)

    def step(states: MPPIMPCState, goals: torch.Tensor):
        keys = split_key(states.key)  # [B, 2, 2]
        key_next, key_solve = keys[:, 0], keys[:, 1]
        result = solve_dynamic_mppi_batch(
            robot, states.q, states.qd, goals, ee_link_idx, key=key_solve[0],
            init_actions=states.plan, rollout_impl=engine, **kwargs,
        )
        q, qd, plan_next, metrics = _plant_tick(
            robot, ee_link_idx, config, plant, states, goals, result.actions, result.cost,
            result.cost_history[:, 0],
        )
        return MPPIMPCState(q, qd, plan_next, key_next, states.step_count + 1), metrics

    return step


def make_mppi_mpc_step(robot: RobotStruct, ee_link_idx: int, config: MPPIMPCConfig):
    """The single-scenario MPPI MPC step: (state, goal [3]) -> (state',
    metrics), on `solvers.solve_dynamic_mppi` with the state's key split
    each tick; the plant step and the plan shift as in the batch step."""
    engine = resolve_mppi_engine(config.rollout_impl, robot, config.n_samples,
                                 config.adapt_sigma or config.adapt_temperature, batched=False)
    plant = dyn_rollout_ee_fwd_reference if engine == "scan" else dyn_rollout_ee_fwd
    kwargs = _mppi_solve_kwargs(config)

    def step(state: MPPIMPCState, goal: torch.Tensor):
        key_next, key_solve = split_key(state.key)
        result = solve_dynamic_mppi(
            robot, state.q, state.qd, goal, ee_link_idx, key=key_solve,
            init_actions=state.plan, rollout_impl=engine, **kwargs,
        )
        q, qd, plan_next, metrics = _plant_tick(
            robot, ee_link_idx, config, plant, MPPIMPCState(*(x[None] for x in state)), goal[None],
            result.actions[None], result.cost[None], result.cost_history[:1],
        )
        new = MPPIMPCState(q[0], qd[0], plan_next[0], key_next, state.step_count + 1)
        return new, MPCMetrics(*(x[0] for x in metrics))

    return step


@dataclasses.dataclass(frozen=True)
class ILQRMPCConfig:
    """Config of the closed-loop second-order (iLQR) torque-space MPC step.
    The solver budget is iLQR iterations, each one Riccati backward pass and
    the parallel line search."""

    horizon: int = 20
    iters_per_step: int = 5
    dt: float = 0.02
    goal_weight: float = 10.0
    effort_weight: float = 1e-4
    reg: float = 1e-6
    replan_interval: int = 1
    respect_effort_limits: bool = False
    riccati: str = "sequential"  # or "parallel" (see solvers.ilqr_batch)
    # Stage derivatives: "gauss_newton" (analytic cost derivatives from the
    # ee's geometric Jacobian, lxx = 2w J^T J; solvers.make_gn_reach_linearize)
    # or "exact" (solvers.autodiff_linearize: the full cost Hessian through
    # the FK by torch.func, and the dynamics Jacobians by forward mode).
    linearization: str = "gauss_newton"
    # Dynamics Jacobians of "gauss_newton": "ift" (solvers.make_ift_f_AB,
    # from the rollout adjoint's phase A kernel and back-substitutions) or
    # "autodiff" (forward mode through the plain plant step).
    dynamics_jacobians: str = "ift"


class ILQRMPCState(NamedTuple):
    q: torch.Tensor  # [..., D]
    qd: torch.Tensor  # [..., D]
    plan: torch.Tensor  # [..., H, D] warm-start absolute torque sequence
    step_count: torch.Tensor  # [...]


def ilqr_mpc_init(robot: RobotStruct, q0, qd0, config: ILQRMPCConfig) -> ILQRMPCState:
    """Initial state(s) for q0, qd0 [..., D] with the plan at gravity
    compensation (a hold-still warm start), as `dynamic_mpc_init`."""
    return ILQRMPCState(*dynamic_mpc_init(robot, q0, qd0, DynamicMPCConfig(horizon=config.horizon)))


def make_ilqr_mpc_step_batch(robot: RobotStruct, ee_link_idx: int, config: ILQRMPCConfig):
    """The fleet iLQR MPC step: (states [B], goals [B, 3]) -> (states',
    metrics), one `solvers.ilqr_batch` solve per replan, warm-started from
    the shifted plan.

    State x = [q; qd], control u = the applied torques; the dynamics are
    the plant of the other torque-space drivers (semi-implicit Euler,
    implicit joint damping, the URDF velocity clamp), one launch of the
    rollout kernel K5 a step (`solvers.make_plant_dynamics`; its plain
    version on the CPU). The cost is the Adam driver's: goal_weight^2 / (3H)
    |p_ee(q) - goal|^2 on every state, the same on the last, and
    effort_weight / (H D) |u - tau_ref|^2 around the gravity torques at the
    tick's start state. `respect_effort_limits` imposes the URDF effort box
    by forward-pass projection. The plant then executes `replan_interval`
    torques through the same step, and the plan shifts with its last
    torque held over the tail. The "exact" and "autodiff" engines
    differentiate the plain plant step by `torch.func`; the rollouts run on
    K5 all the same.
    """
    if config.linearization not in ("gauss_newton", "exact"):
        raise ValueError(f"linearization must be 'gauss_newton' or 'exact', got {config.linearization!r}")
    if config.dynamics_jacobians not in ("ift", "autodiff"):
        raise ValueError(f"dynamics_jacobians must be 'ift' or 'autodiff', got "
                         f"{config.dynamics_jacobians!r}")
    D, H = robot.n_dofs, config.horizon
    control_bounds = None
    if config.respect_effort_limits:
        e = _positive_or_inf(robot.limit_effort)
        control_bounds = (-e, e)
    plant = make_plant_dynamics(robot, config.dt)
    smooth = make_plant_dynamics(robot, config.dt, plain=True)
    gw = config.goal_weight**2 / (3.0 * H)
    ew = config.effort_weight / (H * D)

    def step(states: ILQRMPCState, goals: torch.Tensor):
        qT = states.q.T
        tau_ref = rnea_scalar(robot, qT, torch.zeros_like(qT), torch.zeros_like(qT)).T  # [B, D]

        def goal_term(x):
            p = K.fk_link_position(robot, x[..., :D], ee_link_idx)
            return gw * torch.sum((p - goals) ** 2, dim=-1)

        def cost(x, u):
            # x_0's goal term is a constant of the controls; it keeps the
            # stage cost uniform
            return goal_term(x) + ew * torch.sum((u - tau_ref) ** 2, dim=-1)

        if config.linearization == "gauss_newton":
            f_AB = (make_ift_f_AB(robot, config.dt) if config.dynamics_jacobians == "ift"
                    else autodiff_f_AB(smooth))
            linearize = make_gn_reach_linearize(robot, ee_link_idx, plant, goals, stage_goal_w=gw,
                                                effort_w=ew, u_ref=tau_ref, f_AB=f_AB)
        else:
            linearize = autodiff_linearize(smooth, cost, goal_term)
        with torch.no_grad():  # the MPC step differentiates nothing: no graph
            result = ilqr_batch(
                plant, cost, goal_term, torch.cat([states.q, states.qd], dim=-1), states.plan,
                n_iters=config.iters_per_step, reg=config.reg, riccati=config.riccati,
                control_bounds=control_bounds, linearize=linearize,
            )
            n_exec = config.replan_interval
            x = torch.cat([states.q, states.qd], dim=-1)
            for i in range(n_exec):
                x = plant(x, result.us[:, i])
            q, qd = x[:, :D], x[:, D:]
            B = result.us.shape[0]
            plan_next = torch.cat([result.us[:, n_exec:], result.us[:, -1:].expand(B, n_exec, D)], dim=1)
            ee = K.fk_link_position(robot, q, ee_link_idx)
            metrics = MPCMetrics(
                cost=result.cost,
                cost_initial=result.cost_history[:, 0],
                goal_distance=torch.linalg.norm(ee - goals, dim=-1),
                plan_norm=torch.sqrt(torch.mean(result.us**2, dim=(1, 2))),
            )
        return ILQRMPCState(q, qd, plan_next, states.step_count + 1), metrics

    return step


def make_ilqr_mpc_step(robot: RobotStruct, ee_link_idx: int, config: ILQRMPCConfig):
    """The single-scenario iLQR MPC step: (state, goal [3]) -> (state',
    metrics), the batched step at B=1."""
    step_batch = make_ilqr_mpc_step_batch(robot, ee_link_idx, config)

    def step(state: ILQRMPCState, goal: torch.Tensor):
        states, metrics = step_batch(ILQRMPCState(*(x[None] for x in state)), goal[None])
        return ILQRMPCState(*(x[0] for x in states)), MPCMetrics(*(x[0] for x in metrics))

    return step


def make_fleet_dynamic_mpc_step_specialized(robots, ee_link_idxs, config):
    """The torque-space MPC step of a fleet of different robots: one
    `make_dynamic_mpc_step_batch` per member, each on its own robot's
    solver and plant (on the card the prologue and K9 a replan, K7 at H=1
    the plant step; K9's build chosen per member). `(states, goals) ->
    (states', metrics)` with `states` a tuple of per-member batched
    `DynamicMPCState` ([B_r, ...]; B_r may differ) and `goals` a tuple of
    [B_r, 3]; the metrics are a tuple of `MPCMetrics`. `config` is one
    `DynamicMPCConfig` for every member or a list, one a member (horizons
    and budgets may differ). Composes with `run_closed_loop`."""
    configs = list(config) if isinstance(config, (list, tuple)) else [config] * len(robots)
    if not len(robots) == len(ee_link_idxs) == len(configs):
        raise ValueError("one end effector and one config per member")
    steps = [make_dynamic_mpc_step_batch(r, e, c) for r, e, c in zip(robots, ee_link_idxs, configs)]

    def step(states, goals):
        outs = [fn(st, g) for fn, st, g in zip(steps, states, goals)]
        return tuple(o[0] for o in outs), tuple(o[1] for o in outs)

    return step


def _index(tree, i):
    """Entry i of every tensor in a tensor or a (named) tuple of them."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    items = [_index(x, i) for x in tree]
    return type(tree)(*items) if hasattr(tree, "_fields") else type(tree)(items)


def _stack(trees):
    """Tensors, or (named) tuples of them nested alike, stacked leaf by leaf
    on a new leading axis."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(trees)
    items = [_stack(list(leaves)) for leaves in zip(*trees)]
    return type(first)(*items) if hasattr(first, "_fields") else type(first)(items)


def run_closed_loop(step_fn, state0, goal, n_steps: int, per_tick_goal: bool = False):
    """N warm-started MPC ticks of `step_fn` (any of this module's steps:
    `(state, goal) -> (state', metrics)`, the fleet step's tuples of
    per-member states, goals and metrics included). Returns (final state,
    metrics with every tensor stacked over the ticks on a new leading
    axis, in the step's nesting). With `per_tick_goal`, entry i of every
    goal tensor is tick i's goal (a moving setpoint); otherwise every tick
    shares `goal`."""
    state, history = state0, []
    for i in range(n_steps):
        state, metrics = step_fn(state, _index(goal, i) if per_tick_goal else goal)
        history.append(metrics)
    if not history:
        raise ValueError("run_closed_loop needs n_steps >= 1")
    return state, _stack(history)
