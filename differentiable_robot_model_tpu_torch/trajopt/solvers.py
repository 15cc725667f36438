"""Trajectory optimization: Adam on joint-delta action sequences
(kinematic) and on torque sequences through the forward dynamics (dynamic).

PyTorch counterpart of the kinematic and torque-space solvers in the JAX
package's `trajopt/solvers.py`. Adam follows optax's `adam(lr, eps=eps,
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

`solve_dynamic_adam_batch` has three likewise, named as the JAX package
names them: "scan" (plain torch with autograd), "kernel" (the rollout
kernel pair once per Adam iteration, JAX's "pallas") and "fused" (kernel
K9, the whole solve in one launch); "auto" picks "fused" for a CUDA
float32 robot with n_iters >= 1, "kernel" for other CUDA robots and "scan"
on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.structs import RobotStruct
from ..ops.kernels.fk import fk_position_dof_major
from ..ops.kernels.rng import mppi_normals
from ..ops.kernels.rollout import dyn_rollout_ee_fwd, dynamic_rollout_ee
from ..ops.kernels.solver import (
    MAX_SAMPLES,
    dyn_prologue,
    dyn_prologue_reference,
    dynamic_adam_solve,
    kinematic_adam_solve,
    mppi_solve,
)
from ..ops.kinematics import fk_link_position_dof_first
from .costs import dense_goal_cost
from .rollout import _clip, _effort_bound, clamp_affine_q_traj, dynamic_rollout_dof_major, kinematic_rollout

ENGINES = ("auto", "scalar", "kernel", "fused")
DYNAMIC_ENGINES = ("auto", "scan", "kernel", "fused")
MPPI_ENGINES = ("auto", "scan", "kernel")
MPPI_BATCH_ENGINES = ("auto", "scan", "kernel", "fused")

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


def resolve_dynamic_engine(rollout_impl: str, robot: RobotStruct, n_iters: int) -> str:
    """The engine `rollout_impl` names, with "auto" resolved for this robot."""
    if rollout_impl not in DYNAMIC_ENGINES:
        raise ValueError(f"rollout_impl must be one of {DYNAMIC_ENGINES}, got {rollout_impl!r}")
    if rollout_impl != "auto":
        return rollout_impl
    if robot.device.type != "cuda":
        return "scan"
    if robot.dtype == torch.float32 and n_iters >= 1:
        return "fused"
    return "kernel"


def solve_dynamic_adam_batch(
    robot: RobotStruct,
    q0: torch.Tensor,  # [B, D]
    qd0: torch.Tensor,  # [B, D]
    goal_ee_pos: torch.Tensor,  # [B, 3]
    ee_link_idx: int,
    horizon: int,
    dt: float = 0.02,
    n_iters: int = 10,
    lr: float = 0.5,
    goal_weight: float = 10.0,
    effort_weight: float = 1e-4,
    eps: float = 1e-8,
    init_actions: torch.Tensor | None = None,  # [B, H, D] absolute torques
    use_damping: bool = True,
    precondition: bool = True,
    respect_effort_limits: bool = False,
    rollout_impl: str = "auto",
) -> BatchTrajOptResult:
    """Batched torque-space MPC solve: Adam on H torque deltas per scenario
    through the semi-implicit Euler forward dynamics and the ee FK.

    The actions are acceleration-unit deltas a with tau = tau_ref + H0 a
    (tau_ref the gravity torques and H0 the mass matrix at q0: the
    computed-torque preconditioner; with `precondition=False`, tau = tau_ref
    + a). The cost per scenario is the mean over 3 H terms of
    (goal_weight (p - goal))^2 plus effort_weight times the mean of the
    squared torque deltas (unclipped). With `respect_effort_limits` every
    torque is clipped to the URDF effort box before it is applied.
    `init_actions` are absolute torques [B, H, D], mapped back to deltas
    through H0. Returns the applied torques [B, H, D] (clipped with
    `respect_effort_limits`), the final costs and the cost before each
    update. Every tensor inside is dof-major ([D, ..., B]).
    """
    B, D = q0.shape
    H = horizon
    engine = resolve_dynamic_engine(rollout_impl, robot, n_iters)
    q0T = q0.T.contiguous()
    qd0T = qd0.T.contiguous()
    goalT = goal_ee_pos.T.contiguous()
    init_tauT = None
    if init_actions is not None:
        init_tauT = init_actions.detach().to(robot.dtype).permute(1, 2, 0).contiguous()
    prologue = dyn_prologue_reference if engine == "scan" else dyn_prologue
    tau_refT, H0, aT0 = prologue(robot, q0T, init_tauT, H, precondition)

    if engine == "fused":
        tau_out, costs_all = dynamic_adam_solve(
            robot, q0T, qd0T, goalT, tau_refT, H0, aT0, ee_link_idx,
            n_iters=n_iters, dt=dt, lr=lr, goal_weight=goal_weight,
            effort_weight=effort_weight, eps=eps, use_damping=use_damping,
            respect_effort_limits=respect_effort_limits,
        )  # [H, D, B], [n_iters+1, B]
        return BatchTrajOptResult(tau_out.permute(2, 0, 1), costs_all[n_iters], costs_all[:n_iters])

    emax = _effort_bound(robot, 1) if respect_effort_limits else None
    if engine == "kernel":
        def ee_traj(tauT):  # [H, D, B] -> [H, 3, B]
            return dynamic_rollout_ee(robot, q0T, qd0T, tauT, dt, ee_link_idx, use_damping=use_damping)[2]
    else:
        def ee_traj(tauT):
            qs, _ = dynamic_rollout_dof_major(robot, q0T, qd0T, tauT, dt, use_damping=use_damping)
            p = fk_link_position_dof_first(robot, qs.transpose(0, 1).reshape(D, H * B), ee_link_idx)
            return p.reshape(3, H, B).transpose(0, 1)

    def torque_deltas(aT):
        return aT if H0 is None else torch.einsum("deb,heb->hdb", H0, aT)

    def applied(dtau):
        tauT = tau_refT + dtau
        return tauT if emax is None else _clip(tauT, -emax, emax)

    def cost_fn(aT):  # aT: [H, D, B]
        dtau = torque_deltas(aT)
        err = goal_weight * (ee_traj(applied(dtau)) - goalT)
        cost_b = torch.mean(err * err, dim=(0, 1)) + effort_weight * torch.mean(dtau * dtau, dim=(0, 1))
        return torch.sum(cost_b), cost_b

    aT = aT0.detach().clone()
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
        actions = applied(torque_deltas(aT))
    history = torch.stack(costs) if costs else final_cost.new_zeros((0, B))
    return BatchTrajOptResult(actions.permute(2, 0, 1), final_cost, history)


# ---------------------------------------------------------------------------
# MPPI (sampling-based torque-space MPC)
# ---------------------------------------------------------------------------


class MPPIResult(NamedTuple):
    actions: torch.Tensor  # [H, D] applied torques (updated nominal); [B, H, D] batched
    cost: torch.Tensor  # [] nominal cost after the last update; [B] batched
    cost_history: torch.Tensor  # [iters] best sampled cost per iteration; [B, iters] batched


def resolve_mppi_engine(rollout_impl: str, robot: RobotStruct, n_samples: int, adapt: bool,
                        batched: bool) -> str:
    """The engine `rollout_impl` names, with "auto" resolved: for a batch the
    whole-solve kernel K10 ("fused") on a CUDA float32 robot without
    adaptation and with at most 1024 samples, the per-iteration rollout
    kernel ("kernel") on other CUDA robots, plain torch ("scan") on the CPU.
    An explicit "fused" that K10 cannot run raises."""
    engines = MPPI_BATCH_ENGINES if batched else MPPI_ENGINES
    if rollout_impl not in engines:
        raise ValueError(f"rollout_impl must be one of {engines}, got {rollout_impl!r}")
    if rollout_impl == "fused":
        if adapt:
            raise ValueError("rollout_impl='fused' (kernel mppi_solve) runs no sigma or "
                             "temperature adaptation: use 'kernel' or 'scan'")
        if n_samples > MAX_SAMPLES:
            raise ValueError(f"rollout_impl='fused' takes at most {MAX_SAMPLES} samples, "
                             f"got {n_samples}")
    if rollout_impl != "auto":
        return rollout_impl
    if robot.device.type != "cuda":
        return "scan"
    if batched and robot.dtype == torch.float32 and not adapt and n_samples <= MAX_SAMPLES:
        return "fused"
    return "kernel"


def _mppi_iterate(robot, q0T, qd0T, goalT, tau_refT, H0, aT0, normals, ee_traj, n_iters: int,
                  n_samples: int, temperature: float, noise_sigma: float, goal_weight: float,
                  effort_weight: float, respect_effort_limits: bool, adapt_sigma: bool,
                  adapt_temperature: bool, ess_target_frac: float):
    """The MPPI iterations of B independent solves, dof-major: `normals(t)`
    gives iteration t's standard normals [H, D, B, K] and `ee_traj(q0, qd0,
    tau)` the ee trajectory [H, 3, N] of N = B k lanes (scenario-major).
    Returns (applied torques [H, D, B], final nominal cost [B], best sampled
    cost per iteration [n_iters, B]). The public solvers draw the normals
    from Philox (ops/kernels/rng.py); a test can hand in others."""
    H, D, B = aT0.shape
    K, dtype, dev = n_samples, aT0.dtype, aT0.device
    emax = _effort_bound(robot, 2) if respect_effort_limits else None

    def torque_deltas(aK):  # [H, D, B, k]
        return aK if H0 is None else torch.einsum("deb,hebk->hdbk", H0, aK)

    def sample_costs(aK):  # [H, D, B, k] -> [B, k]
        k = aK.shape[-1]
        dtau = torque_deltas(aK)
        tau = tau_refT[None, :, :, None] + dtau
        if emax is not None:
            tau = _clip(tau, -emax, emax)
        lanes = lambda x: x[:, :, None].expand(D, B, k).reshape(D, B * k)
        p = ee_traj(lanes(q0T), lanes(qd0T), tau.reshape(H, D, B * k)).reshape(H, 3, B, k)
        err = goal_weight * (p - goalT[None, :, :, None])
        return torch.mean(err * err, dim=(0, 1)) + effort_weight * torch.mean(dtau * dtau, dim=(0, 1))

    sigma = torch.full((D, B), noise_sigma, dtype=dtype, device=dev)
    temp = torch.full((B,), temperature, dtype=dtype, device=dev)
    nominal = (torch.arange(K, device=dev) == 0)[None, None, None]  # sample 0 is unperturbed
    a = aT0
    best = []
    for t in range(n_iters):
        eps = torch.where(nominal, 0.0, sigma[None, :, :, None] * normals(t))
        costs = sample_costs(a[..., None] + eps)
        cmin = torch.min(costs, dim=-1).values
        w = torch.softmax(-(costs - cmin[:, None]) / temp[:, None], dim=-1)  # [B, K]
        a = a + torch.einsum("hdbk,bk->hdb", eps, w)
        # derivative-free: torch.clamp's values are jnp.clip's
        if adapt_sigma:
            m2 = torch.einsum("hdbk,bk->db", eps * eps, w) / H
            sigma = torch.sqrt(0.5 * sigma**2 + 0.5 * m2).clamp(noise_sigma / 10.0, noise_sigma * 3.0)
        if adapt_temperature:
            ess = 1.0 / torch.sum(w * w, dim=-1)
            ratio = (ess_target_frac * K) / ess
            temp = (temp * ratio.clamp(0.7, 1.4)).clamp(temperature / 30.0, temperature * 30.0)
        best.append(cmin)
    final = sample_costs(a[..., None])[:, 0]
    tau = tau_refT + torque_deltas(a[..., None])[..., 0]
    if emax is not None:
        tau = _clip(tau, -emax[..., 0], emax[..., 0])
    history = torch.stack(best) if best else final.new_zeros((0, B))
    return tau, final, history


def _mppi_dof_major(robot, q0, qd0, goal_ee_pos, ee_link_idx, horizon, key, init_actions, engine,
                    n_samples, n_iters, dt, temperature, noise_sigma, goal_weight, effort_weight,
                    use_damping, precondition, respect_effort_limits, adapt_sigma,
                    adapt_temperature, ess_target_frac, normals=None):
    """B solves on one engine from batch-major inputs: (tau [H, D, B], cost
    [B], history [n_iters, B]). Scenario b draws its noise at counter word
    b of `key`'s stream, unless `normals` is given."""
    B, D = q0.shape
    H = horizon
    q0T, qd0T, goalT = (x.T.contiguous() for x in (q0, qd0, goal_ee_pos))
    init_tauT = None
    if init_actions is not None:
        init_tauT = init_actions.detach().to(robot.dtype).permute(1, 2, 0).contiguous()
    prologue = dyn_prologue_reference if engine == "scan" else dyn_prologue
    tau_refT, H0, aT0 = prologue(robot, q0T, init_tauT, H, precondition)
    if engine == "fused":
        tau, costs = mppi_solve(
            robot, q0T, qd0T, goalT, tau_refT, H0, aT0, key, ee_link_idx, n_iters=n_iters,
            n_samples=n_samples, dt=dt, temperature=temperature, noise_sigma=noise_sigma,
            goal_weight=goal_weight, effort_weight=effort_weight, use_damping=use_damping,
            respect_effort_limits=respect_effort_limits,
        )
        return tau, costs[n_iters], costs[:n_iters]
    if engine == "kernel":
        def ee_traj(a, b, tau):
            return dyn_rollout_ee_fwd(robot, a.contiguous(), b.contiguous(), tau.contiguous(), dt,
                                      ee_link_idx, use_damping=use_damping)[2]
    else:
        def ee_traj(a, b, tau):
            qs, _ = dynamic_rollout_dof_major(robot, a, b, tau, dt, use_damping=use_damping)
            n = tau.shape[-1]
            p = fk_link_position_dof_first(robot, qs.transpose(0, 1).reshape(D, H * n), ee_link_idx)
            return p.reshape(3, H, n).transpose(0, 1)
    if normals is None:
        normals = lambda t: mppi_normals(key, B, t, H, D, n_samples, robot.dtype, q0.device)
    return _mppi_iterate(
        robot, q0T, qd0T, goalT, tau_refT, H0, aT0, normals, ee_traj, n_iters, n_samples,
        temperature, noise_sigma, goal_weight, effort_weight, respect_effort_limits, adapt_sigma,
        adapt_temperature, ess_target_frac,
    )


def solve_dynamic_mppi(
    robot: RobotStruct,
    q0: torch.Tensor,  # [D]
    qd0: torch.Tensor,  # [D]
    goal_ee_pos: torch.Tensor,  # [3]
    ee_link_idx: int,
    horizon: int,
    key,  # an int in [0, 2^64) or a key tensor (ops/kernels/rng.py)
    n_samples: int = 256,
    n_iters: int = 10,
    dt: float = 0.02,
    temperature: float = 0.01,
    noise_sigma: float = 5.0,
    goal_weight: float = 10.0,
    effort_weight: float = 1e-4,
    use_damping: bool = True,
    precondition: bool = True,
    respect_effort_limits: bool = False,
    init_actions: torch.Tensor | None = None,  # [H, D] absolute torques
    rollout_impl: str = "auto",
    adapt_sigma: bool = False,
    adapt_temperature: bool = False,
    ess_target_frac: float = 0.5,
) -> MPPIResult:
    """Gradient-free torque-space MPC: Model Predictive Path Integral
    control (Williams et al., ICRA 2017) over the forward-dynamics rollout.

    Per iteration `n_samples` perturbed copies of the nominal action
    sequence (acceleration units, noise `noise_sigma` rad/s^2 per dof,
    sample 0 unperturbed) are rolled out, their costs softmax-weighted at
    `temperature`, and the nominal moves by the weighted noise. The
    parametrization and cost are `solve_dynamic_adam_batch`'s: tau = tau_ref
    + H0 a (tau_ref the gravity torques, H0 the mass matrix at q0 with
    `precondition`), the mean goal tracking plus effort on the unclipped
    torque deltas, the URDF effort box with `respect_effort_limits`.
    `init_actions` are absolute torques [H, D]. `adapt_sigma` adapts a
    per-dof noise scale and `adapt_temperature` the temperature toward an
    effective sample size of `ess_target_frac * n_samples`, as the JAX
    package does.

    Deterministic in `key`: the noise is the Philox stream of
    ops/kernels/rng.py at scenario 0 (this solve equals scenario 0 of
    `solve_dynamic_mppi_batch` under the same key). Engines: "scan" (plain
    torch), "kernel" (the rollout kernel K7 on the K sample lanes once per
    iteration; JAX's "pallas"); "auto" is "kernel" on CUDA, "scan" on the
    CPU. Returns the applied torques [H, D], the final nominal cost and the
    best sampled cost of each iteration.
    """
    engine = resolve_mppi_engine(rollout_impl, robot, n_samples, adapt_sigma or adapt_temperature,
                                 batched=False)
    tau, cost, history = _mppi_dof_major(
        robot, q0[None], qd0[None], goal_ee_pos[None], ee_link_idx, horizon, key,
        None if init_actions is None else init_actions[None], engine, n_samples, n_iters, dt,
        temperature, noise_sigma, goal_weight, effort_weight, use_damping, precondition,
        respect_effort_limits, adapt_sigma, adapt_temperature, ess_target_frac,
    )
    return MPPIResult(tau[:, :, 0], cost[0], history[:, 0])


def solve_dynamic_mppi_batch(
    robot: RobotStruct,
    q0: torch.Tensor,  # [B, D]
    qd0: torch.Tensor,  # [B, D]
    goal_ee_pos: torch.Tensor,  # [B, 3]
    ee_link_idx: int,
    horizon: int,
    key,
    init_actions: torch.Tensor | None = None,  # [B, H, D] absolute torques
    n_samples: int = 256,
    n_iters: int = 10,
    dt: float = 0.02,
    temperature: float = 0.01,
    noise_sigma: float = 5.0,
    goal_weight: float = 10.0,
    effort_weight: float = 1e-4,
    use_damping: bool = True,
    precondition: bool = True,
    respect_effort_limits: bool = False,
    rollout_impl: str = "auto",
    adapt_sigma: bool = False,
    adapt_temperature: bool = False,
    ess_target_frac: float = 0.5,
) -> MPPIResult:
    """B independent `solve_dynamic_mppi` solves at once; results stack on
    axis 0 (actions [B, H, D], cost [B], cost_history [B, n_iters]).
    Scenario b draws its noise from `key`'s Philox stream at counter word b,
    so every scenario has its own noise and all derive from one key.

    Engines: "scan", "kernel" (K7 on [H, D, K B] lanes once per iteration),
    and "fused": the whole solve (noise, the K rollouts, the softmax
    weighting, the nominal updates, the final cost) in one launch of K10
    (ops/kernels/solver.py `mppi_solve`), after the `dyn_prologue` kernel.
    "fused" runs no adaptation and at most 1024 samples, and raises where
    asked for either. "auto" is "fused" for a CUDA float32 robot where it
    can run, "kernel" for other CUDA robots, "scan" on the CPU. On one key
    the engines draw the same noise, so they differ only by rounding.
    """
    engine = resolve_mppi_engine(rollout_impl, robot, n_samples, adapt_sigma or adapt_temperature,
                                 batched=True)
    tau, cost, history = _mppi_dof_major(
        robot, q0, qd0, goal_ee_pos, ee_link_idx, horizon, key, init_actions, engine, n_samples,
        n_iters, dt, temperature, noise_sigma, goal_weight, effort_weight, use_damping,
        precondition, respect_effort_limits, adapt_sigma, adapt_temperature, ess_target_frac,
    )
    return MPPIResult(tau.permute(2, 0, 1), cost, history.T)
