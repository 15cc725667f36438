"""Kinematic trajectory optimization: Adam on joint-delta action sequences.

PyTorch counterpart of the kinematic solvers in the JAX package's
`trajopt/solvers.py`. Adam follows optax's `adam(lr, eps=eps,
eps_root=1e-8)`: a -= lr * m_hat / (sqrt(v_hat + eps_root) + eps).
`torch.optim.Adam` has no eps_root, and here eps does real work: it damps
the steps along action directions that barely move the end effector.

`solve_kinematic_adam_batch` has three engines:
- "scalar": plain torch with autograd through the scalar-expanded FK;
- "kernel": the FK kernels K1/K2 as a torch.autograd.Function, once per
  Adam iteration (the JAX package's "pallas" engine);
- "fused": the whole solve in one launch of kernel K3.
"auto" picks "fused" for a CUDA float32 robot with horizon >= 2 and
n_iters >= 1, "kernel" for any other CUDA case, "scalar" on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.structs import RobotStruct
from ..ops.kernels.fk import fk_position_dof_major
from ..ops.kernels.solver import kinematic_adam_solve
from ..ops.kinematics import fk_link_position_dof_first
from .costs import dense_goal_cost
from .rollout import clamp_affine_q_traj, kinematic_rollout

ENGINES = ("auto", "scalar", "kernel", "fused")

_B1 = 0.9
_B2 = 0.999


class TrajOptResult(NamedTuple):
    actions: torch.Tensor  # [H, D] optimized action sequence
    cost: torch.Tensor  # [] final cost
    cost_history: torch.Tensor  # [iters]


class BatchTrajOptResult(NamedTuple):
    actions: torch.Tensor  # [B, H, D] optimized action sequences
    cost: torch.Tensor  # [B] final costs
    cost_history: torch.Tensor  # [iters, B]


def _adam_update(x, g, m, v, t, lr, eps, eps_root=1e-8):
    """One step of optax.adam at count t (1-based): returns (x', m', v')."""
    m = (1 - _B1) * g + _B1 * m
    v = (1 - _B2) * (g * g) + _B2 * v
    m_hat = m / (1 - _B1**t)
    v_hat = v / (1 - _B2**t)
    return x + (-lr) * (m_hat / (torch.sqrt(v_hat + eps_root) + eps)), m, v


def solve_kinematic_adam(
    robot: RobotStruct,
    q0: torch.Tensor,
    goal_ee_pos: torch.Tensor,
    ee_link_idx: int,
    horizon: int,
    n_iters: int = 100,
    lr: float = 1e-3,
    goal_weight: float = 100.0,
    init_actions: torch.Tensor | None = None,
    stop_gradient_between_steps: bool = False,
    eps: float = 1e-8,
) -> TrajOptResult:
    """Optimize one action sequence [H, D] to bring the end effector to a goal:
    the reference's Adam loop (run_kinematic_trajectory_opt.py:88-99) over
    the dense goal cost of the kinematic rollout."""
    D = robot.n_dofs
    actions = (
        init_actions.detach().clone()
        if init_actions is not None
        else torch.zeros((horizon, D), dtype=robot.dtype, device=robot.device)
    )

    def cost_fn(a):
        ee_traj, _ = kinematic_rollout(
            robot, q0, a, ee_link_idx,
            stop_gradient_between_steps=stop_gradient_between_steps,
        )
        return dense_goal_cost(goal_ee_pos, ee_traj, goal_weight)

    m = torch.zeros_like(actions)
    v = torch.zeros_like(actions)
    costs = []
    for t in range(1, n_iters + 1):
        with torch.enable_grad():
            a = actions.requires_grad_(True)
            cost = cost_fn(a)
            (g,) = torch.autograd.grad(cost, a)
        costs.append(cost.detach())
        with torch.no_grad():
            actions, m, v = _adam_update(actions.detach(), g, m, v, t, lr, eps)
    with torch.no_grad():
        final = cost_fn(actions)
    history = torch.stack(costs) if costs else actions.new_zeros((0,))
    return TrajOptResult(actions, final, history)


def resolve_engine(fk_impl: str, robot: RobotStruct, horizon: int, n_iters: int) -> str:
    """The engine `fk_impl` names, with "auto" resolved for this robot."""
    if fk_impl not in ENGINES:
        raise ValueError(f"fk_impl must be one of {ENGINES}, got {fk_impl!r}")
    if fk_impl != "auto":
        return fk_impl
    if robot.device.type != "cuda":
        return "scalar"
    if robot.dtype == torch.float32 and horizon >= 2 and n_iters >= 1:
        return "fused"
    return "kernel"


def solve_kinematic_adam_batch(
    robot: RobotStruct,
    q0: torch.Tensor,  # [B, D]
    goal_ee_pos: torch.Tensor,  # [B, 3]
    ee_link_idx: int,
    horizon: int,
    n_iters: int = 100,
    lr: float = 1e-3,
    goal_weight: float = 100.0,
    fk_impl: str = "auto",
    eps: float = 1e-8,
    init_actions: torch.Tensor | None = None,  # [B, H, D] warm start
) -> BatchTrajOptResult:
    """Batched twin of `solve_kinematic_adam` for B scenarios at once.

    Every tensor inside is dof-major ([D or 3, ..., B], scenario batch
    minor), the layout of the kernels' boundary; the horizon integration is
    the clamp-affine scan and all B x H configurations go through one FK
    call per Adam iteration. q0 is clipped to the limits first.
    """
    B, D = q0.shape
    H = horizon
    engine = resolve_engine(fk_impl, robot, H, n_iters)

    lo = robot.limit_lower[:, None, None]  # [D, 1, 1]
    hi = robot.limit_upper[:, None, None]
    q0T = torch.minimum(torch.maximum(q0.T, lo[:, 0]), hi[:, 0]).contiguous()  # [D, B]
    goalT = goal_ee_pos.T.contiguous()  # [3, B]
    if init_actions is not None:
        aT0 = init_actions.detach().to(robot.dtype).permute(2, 1, 0)  # [D, H, B]
    else:
        aT0 = torch.zeros((D, H, B), dtype=robot.dtype, device=q0.device)

    if engine == "fused":
        a_out, costs_all = kinematic_adam_solve(
            robot, q0T, goalT, aT0.permute(1, 0, 2).contiguous(), ee_link_idx,
            n_iters=n_iters, lr=lr, goal_weight=goal_weight, eps=eps,
        )  # [H, D, B], [n_iters+1, B]
        return BatchTrajOptResult(
            a_out.permute(2, 0, 1), costs_all[n_iters], costs_all[:n_iters]
        )

    if engine == "kernel":
        fk_fn = lambda qM: fk_position_dof_major(robot, qM, ee_link_idx)
    else:
        fk_fn = lambda qM: fk_link_position_dof_first(robot, qM, ee_link_idx)

    def cost_fn(aT):  # aT: [D, H, B]
        q_traj = clamp_affine_q_traj(q0T, aT[:, : H - 1], lo, hi, axis=1)  # [D, H, B]
        p = fk_fn(q_traj.reshape(D, H * B)).reshape(3, H, B)
        err = goal_weight * (p - goalT[:, None, :])
        cost_b = torch.mean(err * err, dim=(0, 1))  # [B], mean over 3*H terms
        return torch.sum(cost_b), cost_b

    aT = aT0.clone(memory_format=torch.contiguous_format)
    m = torch.zeros_like(aT)
    v = torch.zeros_like(aT)
    costs = []
    for t in range(1, n_iters + 1):
        with torch.enable_grad():
            a = aT.requires_grad_(True)
            total, cost_b = cost_fn(a)
            (g,) = torch.autograd.grad(total, a)
        costs.append(cost_b.detach())
        with torch.no_grad():
            aT, m, v = _adam_update(aT.detach(), g, m, v, t, lr, eps)
    with torch.no_grad():
        _, final_cost = cost_fn(aT)
    history = torch.stack(costs) if costs else final_cost.new_zeros((0, B))
    return BatchTrajOptResult(aT.permute(2, 1, 0), final_cost, history)
