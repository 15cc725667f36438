"""Trajectory optimization: Adam on joint-delta action sequences
(kinematic) and on torque sequences through the forward dynamics (dynamic).

PyTorch counterpart of the kinematic and torque-space solvers in the JAX
package's `trajopt/solvers.py`. Adam follows optax's `adam(lr, eps=eps,
eps_root=1e-8)`: a -= lr * m_hat / (sqrt(v_hat + eps_root) + eps).
`torch.optim.Adam` has no eps_root, and here eps does real work: it damps
the steps along action directions that barely move the end effector.

Every solver takes its plain engine for a robot whose tensors require grad,
whatever engine it is given (the JAX package's kernel engines run their
plain path for a traced robot); the Adam and MPPI solvers do so too where
q0, qd0, the goals or the warm start require grad, and then stay
differentiable w.r.t. the robot and those inputs through the whole solve
(identification through it, gradients w.r.t. a solve's inputs). iLQR
follows the caller's grad mode: its plant and IFT Jacobians keep their
graphs through the rollout kernels' autograd entry and the plain replay.

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

`ilqr_batch` (and `ilqr`, the same at B=1) is the second-order solver:
iterative LQR over generic batched callables (the batch contract heads
its section), with the torque plant on the rollout kernel K5
(`make_plant_dynamics`) and its dynamics Jacobians from the rollout
adjoint's phase A kernel (`make_ift_f_AB`); the Riccati recursion and the
line search are eager PyTorch. `ilqr_batch(mesh=)` shards the scenarios
over a mesh's ranks and `ilqr(riccati="horizon_sharded")` the backward
pass over them (`parallel/`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..models.structs import RobotStruct
from ..ops import kinematics as K
from ..ops.dynamics_scalar import ldl_back, ldl_solve_scalar, mass_matrix_scalar, rnea_scalar
from ..ops.kernels.fk import fk_position_dof_major
from ..ops.kernels.rng import mppi_normals
from ..ops.kernels.rollout import (
    dyn_rollout_ee_fwd,
    dyn_rollout_fwd,
    dyn_rollout_fwd_reference,
    dyn_rollout_replay,
    dyn_rollout_replay_reference,
    dynamic_rollout,
    dynamic_rollout_ee,
    replay_layout,
)
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
from .rollout import (
    _clip,
    _effort_bound,
    _velocity_bound,
    associative_scan,
    clamp_affine_q_traj,
    dynamic_rollout_dof_major,
    fd_step_implicit_damping,
    kinematic_rollout,
)

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


def _needs_graph(robot, *inputs) -> bool:
    """Whether a solve must keep its graph: the robot's (or fleet's) tensors
    or any of the given inputs (None for an absent one) require grad."""
    return robot.requires_grad or any(x is not None and x.requires_grad for x in inputs)


def _adam_loop(cost_fn, actions, n_iters: int, lr: float, eps: float, through: bool):
    """n_iters Adam steps (`_adam_update`) on `actions` over cost_fn(a) ->
    (the scalar to differentiate, the costs to record). Returns the actions
    and the recorded costs before each step. With `through` (`_needs_graph`:
    a robot or an input that requires grad) every gradient and update keeps
    its graph, so the whole loop stays differentiable w.r.t. them, as the
    JAX package's scanned loop is; otherwise each step runs detached."""
    m = torch.zeros_like(actions)
    v = torch.zeros_like(actions)
    history = []
    for t in range(1, n_iters + 1):
        with torch.enable_grad():
            a = actions if actions.requires_grad else actions.detach().requires_grad_(True)
            total, costs = cost_fn(a)
            (g,) = torch.autograd.grad(total, a, create_graph=through)
        history.append(costs if through else costs.detach())
        with torch.set_grad_enabled(through):
            actions, m, v = _adam_update(a if through else a.detach(), g, m, v, t, lr, eps)
    return actions, history


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
    through = _needs_graph(robot, q0, goal_ee_pos, init_actions)
    if init_actions is None:
        actions = torch.zeros((horizon, D), dtype=robot.dtype, device=robot.device)
    else:
        actions = init_actions.clone()

    def cost_fn(a):
        ee_traj, _ = kinematic_rollout(
            robot, q0, a, ee_link_idx,
            stop_gradient_between_steps=stop_gradient_between_steps,
        )
        return dense_goal_cost(goal_ee_pos, ee_traj, goal_weight)

    actions, costs = _adam_loop(lambda a: (cost_fn(a),) * 2, actions, n_iters, lr, eps, through)
    with torch.set_grad_enabled(through):
        final = cost_fn(actions)
    history = torch.stack(costs) if costs else actions.new_zeros((0,))
    return TrajOptResult(actions, final, history)


def resolve_engine(fk_impl: str, robot: RobotStruct, horizon: int, n_iters: int,
                   grad: bool = False) -> str:
    """The engine `fk_impl` names, resolved for this robot once, before any
    launch: the plain "scalar" on the CPU ("auto") and, whatever `fk_impl`
    names, for a robot whose tensors require grad or with `grad` (an input
    of the solve requires grad: the kernels are no autograd nodes for it;
    the JAX package likewise runs its plain differentiable path for a
    traced robot), else "fused" for float32 and "kernel" ("auto"), or the
    engine named."""
    if fk_impl not in ENGINES:
        raise ValueError(f"fk_impl must be one of {ENGINES}, got {fk_impl!r}")
    if grad or robot.requires_grad:
        return "scalar"
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
    call per Adam iteration. q0 is clipped to the limits first. For a
    robot whose tensors require grad, or a q0, goals or warm start that
    does, the engine is "scalar" and the whole solve (every Adam step and
    the final cost) stays differentiable w.r.t. them, as the JAX package's
    is.
    """
    B, D = q0.shape
    H = horizon
    through = _needs_graph(robot, q0, goal_ee_pos, init_actions)
    engine = resolve_engine(fk_impl, robot, H, n_iters, grad=through)

    lo = robot.limit_lower[:, None, None]  # [D, 1, 1]
    hi = robot.limit_upper[:, None, None]
    q0T = torch.minimum(torch.maximum(q0.T, lo[:, 0]), hi[:, 0]).contiguous()  # [D, B]
    goalT = goal_ee_pos.T.contiguous()  # [3, B]
    if init_actions is not None:
        aT0 = init_actions.to(robot.dtype).permute(2, 1, 0)  # [D, H, B]
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

    aT, costs = _adam_loop(cost_fn, aT0.clone(memory_format=torch.contiguous_format), n_iters, lr,
                           eps, through)
    with torch.set_grad_enabled(through):
        _, final_cost = cost_fn(aT)
    history = torch.stack(costs) if costs else final_cost.new_zeros((0, B))
    return BatchTrajOptResult(aT.permute(2, 1, 0), final_cost, history)


def solve_dynamic_adam(
    robot: RobotStruct,
    q0: torch.Tensor,  # [D]
    qd0: torch.Tensor,  # [D]
    goal_ee_pos: torch.Tensor,  # [3]
    ee_link_idx: int,
    horizon: int,
    dt: float = 0.02,
    n_iters: int = 10,
    lr: float = 0.5,
    goal_weight: float = 10.0,
    effort_weight: float = 1e-4,
    eps: float = 1e-8,
    init_actions: torch.Tensor | None = None,  # [H, D] absolute torques
    use_damping: bool = True,
    precondition: bool = True,
    respect_effort_limits: bool = False,
) -> TrajOptResult:
    """Torque-space trajectory optimization of one scenario: Adam on an
    applied-torque sequence through the eager forward-dynamics rollout
    (`fd_step_implicit_damping`, semi-implicit Euler, the velocity clamp)
    and the ee FK, with autograd.

    The parametrization and the cost are `solve_dynamic_adam_batch`'s:
    tau = tau_ref + H(q0) a (tau_ref the gravity torques at q0; with
    `precondition=False`, tau = tau_ref + a), the mean of (goal_weight (p -
    goal))^2 over the 3 H terms plus effort_weight times the mean of the
    squared torque deltas, and with `respect_effort_limits` the URDF effort
    box on every applied torque. `init_actions` are absolute torques [H, D],
    mapped back to deltas through H(q0). Returns the applied torques [H, D],
    the final cost and the cost before each update; differentiable w.r.t.
    the robot and the inputs wherever they require grad.
    """
    D = robot.n_dofs
    H = horizon
    through = _needs_graph(robot, q0, qd0, goal_ee_pos, init_actions)
    zeros = torch.zeros_like(q0)
    tau_ref = rnea_scalar(robot, q0, zeros, zeros)  # [D]
    H0 = mass_matrix_scalar(robot, q0) if precondition else None
    if init_actions is not None:
        dtau0 = init_actions.to(robot.dtype) - tau_ref  # [H, D]
        actions = dtau0 if H0 is None else ldl_solve_scalar(H0, dtau0.T).T
    else:
        actions = torch.zeros((H, D), dtype=robot.dtype, device=q0.device)
    vmax = _velocity_bound(robot, 0)
    emax = _effort_bound(robot, 0) if respect_effort_limits else None

    def torque_deltas(a):
        return a if H0 is None else torch.einsum("de,he->hd", H0, a)

    def applied(a):
        taus = tau_ref + torque_deltas(a)
        return taus if emax is None else _clip(taus, -emax, emax)

    def cost_fn(a):
        dtau = torque_deltas(a)
        q, qd, qs = q0, qd0, []
        for tau in applied(a):
            qdd = fd_step_implicit_damping(robot, q, qd, tau, dt, use_damping=use_damping)
            qd = _clip(qd + dt * qdd, -vmax, vmax)
            q = q + dt * qd
            qs.append(q)
        p = fk_link_position_dof_first(robot, torch.stack(qs).T, ee_link_idx)  # [3, H]
        err = goal_weight * (p - goal_ee_pos[:, None])
        return torch.mean(err * err) + effort_weight * torch.mean(dtau * dtau)

    actions, costs = _adam_loop(lambda a: (cost_fn(a),) * 2, actions, n_iters, lr, eps, through)
    with torch.set_grad_enabled(through):
        final = cost_fn(actions)
        taus = applied(actions)
    history = torch.stack(costs) if costs else actions.new_zeros((0,))
    return TrajOptResult(taus, final, history)


def resolve_dynamic_engine(rollout_impl: str, robot: RobotStruct, n_iters: int,
                           grad: bool = False) -> str:
    """The engine `rollout_impl` names, resolved for this robot once, before
    any launch: the plain "scan" on the CPU ("auto") and, whatever
    `rollout_impl` names, for a robot whose tensors require grad or with
    `grad` (an input of the solve requires grad; as the JAX package's
    "pallas" and "fused" run its scan for a traced robot), else "fused" for
    float32 and "kernel" ("auto"), or the engine named."""
    if rollout_impl not in DYNAMIC_ENGINES:
        raise ValueError(f"rollout_impl must be one of {DYNAMIC_ENGINES}, got {rollout_impl!r}")
    if grad or robot.requires_grad:
        return "scan"
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
    rollout_unroll: int = 1,
    respect_effort_limits: bool = False,
    rollout_remat: bool = False,
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
    update. Every tensor inside is dof-major ([D, ..., B]). For a robot
    whose tensors require grad, or a q0, qd0, goals or warm start that
    does, the engine is "scan" and the whole solve (tau_ref, H0, the warm
    start, every Adam step and the final cost) stays differentiable w.r.t.
    them, as the JAX package's is.

    `rollout_unroll` and `rollout_remat` go to the "scan" engine's
    `dynamic_rollout_dof_major` (`unroll`, `remat`: the same values and
    gradients, `remat` recomputing each step in the backward pass); the
    "kernel" and "fused" engines ignore them, as the JAX package's fused
    path does. `rollout_unroll` below 1 raises on every engine.
    """
    if rollout_unroll < 1:
        raise ValueError(f"rollout_unroll must be an int >= 1, got {rollout_unroll!r}")
    B, D = q0.shape
    H = horizon
    through = _needs_graph(robot, q0, qd0, goal_ee_pos, init_actions)
    engine = resolve_dynamic_engine(rollout_impl, robot, n_iters, grad=through)
    q0T = q0.T.contiguous()
    qd0T = qd0.T.contiguous()
    goalT = goal_ee_pos.T.contiguous()
    init_tauT = None
    if init_actions is not None:
        init_tauT = init_actions.to(robot.dtype).permute(1, 2, 0).contiguous()
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
            qs, _ = dynamic_rollout_dof_major(robot, q0T, qd0T, tauT, dt, use_damping=use_damping,
                                              unroll=rollout_unroll, remat=rollout_remat)
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

    aT, costs = _adam_loop(cost_fn, aT0, n_iters, lr, eps, through)
    with torch.set_grad_enabled(through):
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
                        batched: bool, grad: bool = False) -> str:
    """The engine `rollout_impl` names, resolved once, before any launch: for
    a batch the whole-solve kernel K10 ("fused") on a CUDA float32 robot
    without adaptation and with at most 1024 samples, the per-iteration
    rollout kernel ("kernel") on other CUDA robots, plain torch ("scan") on
    the CPU ("auto"), or the engine named; "scan", whatever `rollout_impl`
    names, for a robot whose tensors require grad or with `grad` (q0, qd0,
    the goals or the warm start require grad: the kernels are no autograd
    nodes for them; the JAX package's kernel engines run its scan for a
    traced robot). An explicit "fused" that K10 cannot run raises, whatever
    `grad` says."""
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
    if grad or robot.requires_grad:
        return "scan"
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
    b of `key`'s stream, or under its own key with per-scenario keys [B,
    2] (ops/kernels/rng.py), unless `normals` is given."""
    B, D = q0.shape
    H = horizon
    q0T, qd0T, goalT = (x.T.contiguous() for x in (q0, qd0, goal_ee_pos))
    init_tauT = None
    if init_actions is not None:
        init_tauT = init_actions.to(robot.dtype).permute(1, 2, 0).contiguous()
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
    best sampled cost of each iteration. For a robot whose tensors require
    grad, or a q0, qd0, goal or warm start that does, the engine is "scan"
    whatever `rollout_impl` names, and the solve (the prologue, every
    iteration's softmax-weighted update, the final cost) stays
    differentiable w.r.t. them, as the JAX package's scanned solve is.
    """
    engine = resolve_mppi_engine(rollout_impl, robot, n_samples, adapt_sigma or adapt_temperature,
                                 batched=False,
                                 grad=_needs_graph(robot, q0, qd0, goal_ee_pos, init_actions))
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
    so every scenario has its own noise and all derive from one key. Or
    `key` holds one key a scenario, int64 [B, 2] (`rng.split_key(key, B)`,
    on the host or the card): scenario b then draws under key[b] the noise
    `solve_dynamic_mppi` under key[b] draws, wherever b sits in the batch,
    on every engine (the counterpart of the JAX package's vmap of
    `solve_dynamic_mppi` over keys, which `parallel.mesh.sharded_mppi`
    runs).

    Engines: "scan", "kernel" (K7 on [H, D, K B] lanes once per iteration),
    and "fused": the whole solve (noise, the K rollouts, the softmax
    weighting, the nominal updates, the final cost) in one launch of K10
    (ops/kernels/solver.py `mppi_solve`), after the `dyn_prologue` kernel.
    "fused" runs no adaptation and at most 1024 samples, and raises where
    asked for either. "auto" is "fused" for a CUDA float32 robot where it
    can run, "kernel" for other CUDA robots, "scan" on the CPU. On one key
    the engines draw the same noise, so they differ only by rounding. An
    input or a robot that requires grad takes "scan", whatever
    `rollout_impl` names, as `solve_dynamic_mppi` does.
    """
    engine = resolve_mppi_engine(rollout_impl, robot, n_samples, adapt_sigma or adapt_temperature,
                                 batched=True,
                                 grad=_needs_graph(robot, q0, qd0, goal_ee_pos, init_actions))
    tau, cost, history = _mppi_dof_major(
        robot, q0, qd0, goal_ee_pos, ee_link_idx, horizon, key, init_actions, engine, n_samples,
        n_iters, dt, temperature, noise_sigma, goal_weight, effort_weight, use_damping,
        precondition, respect_effort_limits, adapt_sigma, adapt_temperature, ess_target_frac,
    )
    return MPPIResult(tau.permute(2, 0, 1), cost, history.T)


# ---------------------------------------------------------------------------
# iLQR (second-order torque-space MPC)
# ---------------------------------------------------------------------------
#
# The batch contract. PyTorch has no transform that batches a whole solver
# as cheaply as `jax.vmap` does, so `ilqr_batch` runs B scenarios in one
# solve and `ilqr` is `ilqr_batch` at B=1. The callables take the scenario
# axis last but one, after any leading axes: dynamics(x [..., B, n], u [...,
# B, m]) -> [..., B, n], cost(x, u) -> [..., B], final_cost(x [..., B, n])
# -> [..., B], where scenario b's data (a goal [B, 3], a reference torque
# [B, m]) broadcast against them. The line search passes [n_alphas, B, .]
# (every step size at once), the cost [H, n_alphas, B, .] (every stage at
# once). `linearize(xs [H+1, B, n], us [H, B, m])` takes the trajectories
# stage-major and returns A [H, B, n, n], B [H, B, n, m], lx [H, B, n], lu
# [H, B, m], lxx [H, B, n, n], luu [H, B, m, m], lux [H, B, m, n], Vx [B, n]
# and Vxx [B, n, n].

RICCATI = ("sequential", "parallel")
LINE_SEARCH_ALPHAS = (1.0, 0.5, 0.25, 0.1, 0.03, 0.01)


class ILQRResult(NamedTuple):
    xs: torch.Tensor  # [H+1, n] optimized state trajectory; [B, H+1, n] batched
    us: torch.Tensor  # [H, m] optimized controls; [B, H, m] batched
    cost: torch.Tensor  # [] final total cost; [B] batched
    cost_history: torch.Tensor  # [iters+1], [0] before any iteration; [B, iters+1] batched


def _rollout(dynamics, x0, us):
    """The states [H+1, ..., n] from x0 [..., n] under us [H, ..., m]."""
    xs = [x0]
    for u in us:
        xs.append(dynamics(xs[-1], u))
    return torch.stack(xs)


def _total_cost(cost, final_cost, xs, us):
    """The stage costs of xs[:-1] under us summed over the stages, plus the
    final cost of xs[-1]: [...]."""
    return torch.sum(cost(xs[:-1], us), dim=0) + final_cost(xs[-1])


def _mv(M, v):
    """M [..., a, b] times v [..., b]."""
    return (M @ v[..., None])[..., 0]


def riccati_combine(ej, ei, eye):
    """Compose conditional-value-function elements: `ei` earlier, `ej` later.

    V_ij(x, z) = min_y V_i(x, y) + V_j(y, z) for elements of the form
    V(x, z) = 0.5 (z - A x - b)^T C^+ (z - A x - b) + 0.5 x^T J x - eta^T x,
    each a tuple (A, b, C, eta, J) batched over any leading axes. C and J
    are symmetrised after each combine, as the JAX package does."""
    Aj, bj, Cj, etaj, Jj = ej
    Ai, bi, Ci, etai, Ji = ei
    M = torch.linalg.solve((eye + Ci @ Jj).mT, Aj.mT).mT  # Aj (I + Ci Jj)^-1
    N = torch.linalg.solve((eye + Jj @ Ci).mT, Ai).mT  # Ai^T (I + Jj Ci)^-1
    C_new = M @ Ci @ Aj.mT + Cj
    J_new = N @ Jj @ Ai + Ji
    return (
        M @ Ai,
        _mv(M, bi + _mv(Ci, etaj)) + bj,
        0.5 * (C_new + C_new.mT),
        _mv(N, etaj - _mv(Jj, bi)) + etai,
        0.5 * (J_new + J_new.mT),
    )


def riccati_stage_elements(A, B, lx, lu, lxx, luu, lux, Vx, Vxx):
    """The H stage elements and the terminal one (stacked on axis 0) for the
    parallel Riccati: with u eliminated, A_e = A - B luu^-1 lux, b_e = -B
    luu^-1 lu, C_e = B luu^-1 B^T, J_e = lxx - lux^T luu^-1 lux, eta_e =
    -(lx - lux^T luu^-1 lu); terminal (0, 0, 0, -Vx, Vxx)."""
    luu_inv_lux = torch.linalg.solve(luu, lux)
    luu_inv_lu = torch.linalg.solve(luu, lu[..., None])[..., 0]
    luu_inv_Bt = torch.linalg.solve(luu, B.mT)
    A_e = A - B @ luu_inv_lux
    b_e = -_mv(B, luu_inv_lu)
    C_e = B @ luu_inv_Bt
    J_e = lxx - lux.mT @ luu_inv_lux
    eta_e = -(lx - _mv(lux.mT, luu_inv_lu))
    zeros = A.new_zeros((1,) + A.shape[1:])
    return (
        torch.cat([A_e, zeros]),
        torch.cat([b_e, b_e.new_zeros((1,) + b_e.shape[1:])]),
        torch.cat([C_e, zeros]),
        torch.cat([eta_e, -Vx[None]]),
        torch.cat([J_e, Vxx[None]]),
    )


def riccati_gains_from_suffix(A, B, lu, luu, lux, P, p):
    """Feedback gains (ks, Ks) given the suffix value functions V_{k+1} = (P, p)."""
    BtP = B.mT @ P
    Quu = luu + BtP @ B
    Qux = lux + BtP @ A
    Qu = lu - _mv(B.mT, p)
    ks = -torch.linalg.solve(Quu, Qu[..., None])[..., 0]
    Ks = -torch.linalg.solve(Quu, Qux)
    return ks, Ks


def _parallel_riccati_gains(A, B, lx, lu, lxx, luu, lux, Vx, Vxx):
    """The Riccati backward pass as one associative scan over the horizon
    (Sarkka & Garcia-Fernandez, "Temporal Parallelization of Dynamic
    Programming", IEEE TAC 2021): the conditional value functions compose
    associatively (`riccati_combine`), so every suffix value function comes
    out of `trajopt.rollout.associative_scan`, run in reverse as
    `jax.lax.associative_scan(..., reverse=True)` runs it (flip, scan,
    flip), in O(log H) rounds of batched [n, n] solves. Returns (ks [H, ...,
    m], Ks [H, ..., m, n]) with u = u_ref + alpha k + K (x - x_ref)."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    elems = riccati_stage_elements(A, B, lx, lu, lxx, luu, lux, Vx, Vxx)
    combine = lambda ej, ei: riccati_combine(ej, ei, eye)
    suffix = associative_scan(combine, tuple(e.flip(0) for e in elems), 0)
    P = suffix[4].flip(0)[1:]  # V_{k+1}
    p = suffix[3].flip(0)[1:]  # eta_{k+1}
    return riccati_gains_from_suffix(A, B, lu, luu, lux, P, p)


def _ldl_solve_small(A, B_rhs, pivot_eps=1e-30):
    """Unrolled LDL^T solve of small symmetric systems A [..., m, m] (the
    LM-damped Quu) for the right-hand sides B_rhs [..., m, k] -> [..., m, k].

    Not `torch.linalg.solve` and not a Cholesky: on an indefinite block (the
    exact Hessian far from the optimum) they give other gains, or NaN gains
    that poison every earlier stage of the reverse recursion. Here each
    pivot is clamped away from zero keeping its sign, so the gains stay
    finite and the line search rejects a step that does not descend. Every
    entry is formed in the JAX package's order; a column of L and the
    forward substitution run on all their rows at once, and both
    substitutions on the k columns at once."""
    m = A.shape[-1]
    cols, d = [], []  # cols[j]: rows j+1.. of L's column j, [..., m-j-1]
    for j in range(m):
        s = A[..., j:, j]  # rows j.. of column j
        for t in range(j):
            c = cols[t][..., j - t - 1:]  # L[j:, t]
            s = s - c * c[..., :1] * d[t][..., None]
        dj = s[..., 0]
        clamped = torch.where(dj >= 0, dj.new_full((), pivot_eps), dj.new_full((), -pivot_eps))
        dj = torch.where(dj.abs() < pivot_eps, clamped, dj)
        d.append(dj)
        cols.append(s[..., 1:] / dj[..., None])
    y, rest = [], B_rhs  # L y = b
    for t in range(m):
        y.append(rest[..., 0, :])
        if t + 1 < m:
            rest = rest[..., 1:, :] - cols[t][..., :, None] * y[t][..., None, :]
    x = [None] * m  # D z = y; L^T x = z
    for i in reversed(range(m)):
        s = y[i] / d[i][..., None]
        for t in range(i + 1, m):
            s = s - cols[i][..., t - i - 1, None] * x[t]
        x[i] = s
    return torch.stack(x, dim=-2)


def _jacobian_rows(f, args):
    """Jacobians of f's rows by forward mode: f maps tensors [..., k_i]
    (`args`) to [..., n], each row on the inputs' same row only, and the
    result is [..., n, sum k_i], every argument's columns in turn. One
    perturbation z added to every row at once gives each row's own
    Jacobian, so k tangents suffice for any number of rows."""
    sizes = [a.shape[-1] for a in args]
    z0 = args[0].new_zeros(sum(sizes))

    def shifted(z):
        return f(*(a + zi for a, zi in zip(args, z.split(sizes))))

    return torch.func.jacfwd(shifted)(z0)


def autodiff_f_AB(dynamics):
    """The dynamics Jacobians by forward mode through `dynamics` (which must
    be differentiable by `torch.func`: the plain plant, not a kernel):
    f_AB(xs [H, B, n], us [H, B, m]) -> (A [H, B, n, n], B [H, B, n, m]), n + m
    tangents through one batched call."""

    def f_AB(xs, us):
        n = xs.shape[-1]
        AB = _jacobian_rows(dynamics, (xs, us))
        return AB[..., :n], AB[..., n:]

    return f_AB


def autodiff_linearize(dynamics, cost, final_cost):
    """The generic `linearize` by `torch.func`: the dynamics Jacobians by
    forward mode (`autodiff_f_AB`) and the cost derivatives forward over
    reverse (each stage's gradient and Hessian in (x, u)), the final cost's
    likewise. `dynamics` must be differentiable by `torch.func`."""
    f_AB = autodiff_f_AB(dynamics)

    def stage_grad(x, u):
        gx, gu = torch.func.grad(lambda a, b: cost(a, b).sum(), argnums=(0, 1))(x, u)
        return torch.cat([gx, gu], dim=-1)

    final_grad = torch.func.grad(lambda a: final_cost(a).sum())

    def linearize(xs, us):
        n = xs.shape[-1]
        A, B = f_AB(xs[:-1], us)
        g = stage_grad(xs[:-1], us)
        Hm = _jacobian_rows(stage_grad, (xs[:-1], us))
        return (A, B, g[..., :n], g[..., n:], Hm[..., :n, :n], Hm[..., n:, n:], Hm[..., n:, :n],
                final_grad(xs[-1]), _jacobian_rows(final_grad, (xs[-1],)))

    return linearize


def _keeps_graph(robot, *inputs) -> bool:
    """Whether a call must record its graph: grad mode is on and the robot
    or one of the inputs requires grad."""
    return torch.is_grad_enabled() and _needs_graph(robot, *inputs)


def make_plant_dynamics(robot: RobotStruct, dt: float, use_damping: bool = True,
                        plain: bool = False):
    """The torque-space plant every dynamic MPC driver integrates, as an
    iLQR `dynamics` callable: state x = [q; qd] [..., 2D], control u = the
    applied torques [..., D]; one semi-implicit Euler step with implicit
    joint damping and the URDF velocity clamp. The leading axes go onto the
    lanes of one launch of the rollout kernel K5 (`dyn_rollout_fwd` at H=1,
    its plain version on CPU tensors); with `plain=True` always the plain
    version, which `torch.func` can differentiate (K5's wrapper cannot).

    A call that must keep its graph (grad mode on, and x, u or the robot
    requiring grad: a graph-keeping `ilqr_batch`) goes through the autograd
    entry `ops.kernels.rollout.dynamic_rollout` at H=1 instead: K5 forward
    and the adjoint kernel K6 backward, or the plain differentiable rollout
    for a robot whose tensors require grad. This is decided per call,
    before any launch; a call that keeps no graph launches K5 alone, as
    before. A kernel's build or launch error raises either way."""
    D = robot.n_dofs

    def dynamics(x, u):
        lead = x.shape[:-1]
        q = x[..., :D].reshape(-1, D).T.contiguous()
        qd = x[..., D:].reshape(-1, D).T.contiguous()
        tau = u.reshape(-1, D).T.contiguous()[None]
        if plain:
            step = dyn_rollout_fwd_reference
        else:
            step = dynamic_rollout if _keeps_graph(robot, x, u) else dyn_rollout_fwd
        qs, qds = step(robot, q, qd, tau, dt, use_damping=use_damping)
        return torch.cat([qs[0].T, qds[0].T], dim=-1).reshape(lead + (2 * D,))

    return dynamics


def make_ift_f_AB(
    robot: RobotStruct,
    dt: float,
    vmax: torch.Tensor | None = None,
    include_gravity: bool = True,
    use_damping: bool = True,
    plain: bool = False,
):
    """Analytic (implicit-function-theorem) dynamics Jacobians of the plant
    `make_plant_dynamics` integrates, from the rollout adjoint's phase A.

    The step solves F(q, qd, qdd, tau) = RNEA(q, qd, qdd) + dt d qdd - tau =
    0 for qdd, so with Ĥ = H(q) + dt diag(d), d qdd/d tau = Ĥ^-1 and
    d qdd/d(q, qd) = -Ĥ^-1 dRNEA(q, qd, qdd*)/d(q, qd). The phase A kernel
    (`ops.kernels.rollout.dyn_rollout_replay`, `replay_kernel`; its plain
    version on CPU tensors or with `plain=True`) writes for every stage and
    scenario in one launch all of that but the solves: Ĥ's LDL^T factor,
    the clamp's mask and the D rows of dRNEA/d(q, qd) at qdd*; then X =
    Ĥ^-1 [-dF | I] is 3D back-substitutions on the factor, batched over the
    stages. The Euler step and the clamp are differentiated in closed form:
    with c = 1{-vmax <= qd + dt qdd <= vmax} (the mask is 1/2 at a tie, so
    c = mask > 0) and S_y = c (d qd/d y + dt d qdd/d y),

        A = [[I + dt S_q, dt S_qd], [S_q, S_qd]],   B = [[dt S_tau], [S_tau]].

    Returns f_AB(xs [H, B, 2D], us [H, B, D]) -> (A [H, B, 2D, 2D], B [H, B,
    2D, D]), a drop-in for `autodiff_f_AB`. The mask is taken at the
    robot's URDF velocity bound: `vmax`, kept for the JAX package's
    signature, must be that bound.

    A call that must keep its graph (grad mode on, and xs, us or the robot
    requiring grad: a graph-keeping `ilqr_batch`, whose gains then carry
    the Jacobians' derivatives) takes the plain replay
    `dyn_rollout_replay_reference`, which autograd differentiates; the
    replay kernel has no backward. This is decided per call, before any
    launch. The mask is piecewise constant and carries no gradient, as the
    JAX package's comparisons carry none.
    """
    D = robot.n_dofs
    lay = replay_layout(D, False, False)
    bound = _velocity_bound(robot, 0)
    if vmax is not None and not torch.equal(torch.as_tensor(vmax, dtype=bound.dtype,
                                                            device=bound.device), bound):
        raise ValueError("make_ift_f_AB takes the clamp's mask at the robot's URDF velocity "
                         "bound; vmax must be that bound")

    def f_AB(xs, us):
        plain_replay = plain or _keeps_graph(robot, xs, us)
        replay = dyn_rollout_replay_reference if plain_replay else dyn_rollout_replay
        H_, B_ = xs.shape[0], xs.shape[1]
        dtype, dev = xs.dtype, xs.device
        qT = xs[..., :D].transpose(1, 2)  # [H, D, B]
        qdT = xs[..., D:].transpose(1, 2)
        # the replay reads each stage's incoming state: x_h is stage h's,
        # the last entry of qs, qds is not read
        later = lambda x: torch.cat([x[1:], x[-1:]]).contiguous()
        scr = replay(robot, qT[0].contiguous(), qdT[0].contiguous(),
                     us.to(dtype).transpose(1, 2).contiguous(), later(qT), later(qdT), dt,
                     use_damping=use_damping, include_gravity=include_gravity)  # [H, K, B]
        L = [[scr[:, i * (i - 1) // 2 + j, None] if j < i else None for j in range(D)]
             for i in range(D)]
        dg = [scr[:, lay.dg + i, None] for i in range(D)]
        dF = scr[:, lay.rows:lay.rows + 2 * D * D].reshape(H_, D, 2 * D, B_)
        eye = torch.eye(D, dtype=dtype, device=dev)
        rhs = torch.cat([-dF, eye[None, :, :, None].expand(H_, D, D, B_)], dim=2)
        X = torch.stack(ldl_back(L, dg, rhs.unbind(1)), dim=1).permute(0, 3, 1, 2)  # [H, B, D, 3D]
        c = (scr[:, lay.mask:lay.mask + D] > 0).to(dtype).transpose(1, 2)[..., None]  # [H, B, D, 1]
        zeros = torch.zeros((D, D), dtype=dtype, device=dev)
        Sx = c * (torch.cat([zeros, eye], dim=1) + dt * X[..., :2 * D])  # [H, B, D, 2D]
        Su = c * (dt * X[..., 2 * D:])  # [H, B, D, D]
        A = torch.cat([torch.cat([eye, zeros], dim=1) + dt * Sx, Sx], dim=-2)
        B = torch.cat([dt * Su, Su], dim=-2)
        return A, B

    return f_AB


def make_gn_reach_linearize(
    robot: RobotStruct,
    ee_link_idx: int,
    dynamics,
    goal: torch.Tensor,  # [3] or [B, 3]
    stage_goal_w: float,
    effort_w: float,
    u_ref: torch.Tensor | float = 0.0,  # [m] or [B, m] reference control (e.g. tau_ref)
    final_goal_w: float | None = None,
    f_AB=None,
):
    """Analytic Gauss-Newton `linearize` for `ilqr` / `ilqr_batch` on the
    reach problem: state x = [q; qd], stage cost stage_goal_w |p_ee(q) -
    goal|^2 + effort_w |u - u_ref|^2, final cost final_goal_w |p_ee(q) -
    goal|^2. From the geometric Jacobian J of the ee (ops/kinematics.py
    `link_jacobian`): lx = 2w J^T r, lxx = 2w J^T J (the FK's second
    derivative dropped, so lxx is PSD), lu = 2 effort_w (u - u_ref), luu = 2
    effort_w I, lux = 0. `goal` and `u_ref` are one scenario's or one per
    scenario ([B, 3], [B, m]).

    `f_AB` gives the dynamics Jacobians (`make_ift_f_AB`'s for the standard
    plant); without it they come by forward mode through `dynamics`
    (`autodiff_f_AB`), which must then be differentiable by `torch.func`.
    The callables passed to the solver beside it must describe the same
    problem (they drive the rollouts and the line search).
    """
    D = robot.n_dofs
    wf = stage_goal_w if final_goal_w is None else final_goal_w
    if f_AB is None:
        f_AB = autodiff_f_AB(dynamics)
    goal = torch.as_tensor(goal, dtype=robot.dtype, device=robot.device)

    def goal_gn(x, w):
        q = x[..., :D]
        n = x.shape[-1]
        p = K.fk_link_position(robot, q, ee_link_idx)
        J, _ = K.link_jacobian(robot, q, ee_link_idx)  # [..., 3, D]
        g = x.new_zeros(x.shape)
        g[..., :D] = 2.0 * w * _mv(J.mT, p - goal)
        Hm = x.new_zeros(x.shape + (n,))
        Hm[..., :D, :D] = 2.0 * w * (J.mT @ J)
        return g, Hm

    def linearize(xs, us):
        us = us.to(xs.dtype)  # a float64 warm start must not leak into a float32 solve
        m, n = us.shape[-1], xs.shape[-1]
        A, B = f_AB(xs[:-1], us)
        lx, lxx = goal_gn(xs[:-1], stage_goal_w)
        lu = 2.0 * effort_w * (us - u_ref)
        eye = torch.eye(m, dtype=us.dtype, device=us.device)
        luu = (2.0 * effort_w * eye).expand(us.shape + (m,))
        lux = us.new_zeros(us.shape + (n,))
        Vx, Vxx = goal_gn(xs[-1], wf)
        return A, B, lx, lu, lxx, luu, lux, Vx, Vxx

    return linearize


def ilqr_batch(
    dynamics,
    cost,
    final_cost,
    x0s: torch.Tensor,  # [B, n]
    us_init: torch.Tensor,  # [B, H, m]
    n_iters: int = 10,
    reg: float = 1e-6,
    line_search_alphas: tuple = LINE_SEARCH_ALPHAS,
    riccati: str = "sequential",
    mesh=None,
    axis_name: str = "scenario",
    control_bounds: tuple | None = None,
    linearize=None,
    diagnostics: bool = False,
):
    """B independent iLQR solves at once (the batch contract above the
    section), each as the JAX package's `ilqr` runs one.

    Per iteration: the linearization about the current trajectory
    (`linearize`, by default `autodiff_linearize` through the callables),
    the Riccati backward pass with the Levenberg-Marquardt lambda on Quu
    (`riccati="sequential"`: the reverse recursion, Quu solved by
    `_ldl_solve_small`, Vxx symmetrised each stage; "parallel": one
    associative scan, `_parallel_riccati_gains`), then the parallel line
    search: every step size in `line_search_alphas` rolled out at once, a
    NaN cost taken as inf, the first minimum taken, accepted where it
    lowers the scenario's cost; lambda halves (down to `reg`) on success and
    grows tenfold (up to 1e8) otherwise, from max(reg, 1e-3).
    `control_bounds=(lo, hi)` (each broadcastable to [m]) clips the warm
    start and every control of the forward passes (forward-pass
    projection; the backward pass stays unconstrained).

    Returns an ILQRResult of stacked leaves: xs [B, H+1, n], us [B, H, m],
    cost [B], cost_history [B, n_iters+1]. With `diagnostics=True`, also a
    dict of per-iteration internals, as the JAX package's `ilqr` gives them
    per scenario: `alpha_idx`, `improved`, `lam` (after the update),
    `k_norm` [B, iters], `ls_costs` [B, iters, n_alphas] and `us_iter` [B,
    iters, H, m].

    With `mesh` (a 1-D `parallel.mesh.make_mesh`), x0s and us_init are
    sharded over its ranks (DTensors `Shard(0)`, or whole tensors, sharded
    from rank 0), each rank solves its own scenarios with no collective,
    and every output is a DTensor sharded likewise (`full_tensor()`
    gathers it). The callables then see the local scenarios only: data
    they hold per scenario must be this rank's block. On the card the
    torque plant (K5) and the IFT Jacobians (the replay kernel) launch on
    each rank's scenarios as they do unsharded.
    `riccati="horizon_sharded"` does not compose with a scenario batch and
    raises: use `ilqr` per scenario.

    Each iteration's parts run under `torch.profiler` spans for a trace to
    read: "ilqr.backward_pass" (with "ilqr.linearize" inside),
    "ilqr.line_search", and "ilqr.plant" around each dynamics step.

    The solve follows the caller's grad mode, as `jax.grad` follows the JAX
    package's trace: where x0s, us_init or a tensor the callables close
    over (a goal, the robot) requires grad, every output stays
    differentiable w.r.t. it through every iteration (the linearization,
    the Riccati gains, the line search's selection; `lam` carries no
    gradient). Where none does, autograd records nothing. The callables
    must then be differentiable: `make_plant_dynamics` and `make_ift_f_AB`
    keep their graphs through the rollout kernels' autograd entry and the
    plain replay, decided per call. The `mesh=` form keeps the graph too.
    """
    if riccati == "horizon_sharded":
        raise ValueError("horizon_sharded does not compose with the scenario batch; use "
                         "ilqr() per scenario or riccati='parallel' here")
    if riccati not in RICCATI:
        raise ValueError(f"riccati must be one of {RICCATI}, got {riccati!r}")
    if mesh is not None:
        from torch.utils._pytree import tree_map

        from ..parallel.mesh import _local, _wrap  # parallel.mesh imports this module

        out = ilqr_batch(dynamics, cost, final_cost, _local(mesh, x0s), _local(mesh, us_init),
                         n_iters=n_iters, reg=reg, line_search_alphas=line_search_alphas,
                         riccati=riccati, control_bounds=control_bounds, linearize=linearize,
                         diagnostics=diagnostics)
        return tree_map(lambda x: _wrap(mesh, x), out)
    return _ilqr(dynamics, cost, final_cost, x0s, us_init, n_iters, reg, line_search_alphas,
                 riccati, control_bounds, linearize, diagnostics)


def _backward_pass(linearize, riccati, xs, us, lam, riccati_mesh=None):
    """The feedback gains (ks [H, B, m], Ks [H, B, m, n]) about (xs, us)."""
    with torch.profiler.record_function("ilqr.linearize"):
        A, B, lx, lu, lxx, luu, lux, Vx, Vxx = linearize(xs, us)
    m = us.shape[-1]
    lam_eye = lam[:, None, None] * torch.eye(m, dtype=us.dtype, device=us.device)
    # lam I on Quu is lam I on luu throughout
    if riccati == "parallel":
        return _parallel_riccati_gains(A, B, lx, lu, lxx, luu + lam_eye, lux, Vx, Vxx)
    if riccati == "horizon_sharded":
        from ..parallel.horizon import riccati_gains_horizon_sharded  # it imports this module

        return riccati_gains_horizon_sharded(riccati_mesh, A, B, lx, lu, lxx, luu + lam_eye, lux,
                                             Vx, Vxx)
    ks, Ks = [None] * len(us), [None] * len(us)
    for t in reversed(range(len(us))):
        At, Bt = A[t], B[t]
        Qx = lx[t] + _mv(At.mT, Vx)
        Qu = lu[t] + _mv(Bt.mT, Vx)
        Qxx = lxx[t] + At.mT @ Vxx @ At
        Quu = luu[t] + Bt.mT @ Vxx @ Bt + lam_eye
        Qux = lux[t] + Bt.mT @ Vxx @ At
        # one factorization serves both the k and the K solves
        kK = -_ldl_solve_small(Quu, torch.cat([Qu[..., None], Qux], dim=-1))
        k, Kt = kK[..., 0], kK[..., 1:]
        Vx = Qx + _mv(Kt.mT @ Quu, k) + _mv(Kt.mT, Qu) + _mv(Qux.mT, k)
        Vxx = Qxx + Kt.mT @ Quu @ Kt + Kt.mT @ Qux + Qux.mT @ Kt
        Vxx = 0.5 * (Vxx + Vxx.mT)
        ks[t], Ks[t] = k, Kt
    return torch.stack(ks), torch.stack(Ks)


def _ilqr(dynamics, cost, final_cost, x0s, us_init, n_iters, reg, line_search_alphas, riccati,
          control_bounds, linearize, diagnostics, riccati_mesh=None):
    B_, H, m = us_init.shape
    n = x0s.shape[-1]
    dtype, dev = us_init.dtype, us_init.device
    us = us_init.transpose(0, 1)  # [H, B, m]: stage-major inside
    clip = lambda u: u
    if control_bounds is not None:
        u_lo, u_hi = (torch.broadcast_to(torch.as_tensor(b, dtype=dtype, device=dev), (m,))
                      for b in control_bounds)
        clip = lambda u: _clip(u, u_lo, u_hi)
        us = clip(us)
    if linearize is None:
        linearize = autodiff_linearize(dynamics, cost, final_cost)
    alphas = torch.tensor(line_search_alphas, dtype=dtype, device=dev)[:, None, None]  # [A, 1, 1]
    lanes = torch.arange(B_, device=dev)

    def forward_pass(xs, us, ks, Ks):
        x = x0s.expand((len(alphas),) + x0s.shape)
        xs_c, us_c = [x], []
        for t in range(H):
            u = clip(us[t] + alphas * ks[t] + _mv(Ks[t], x - xs[t]))
            with torch.profiler.record_function("ilqr.plant"):
                x = dynamics(x, u)
            xs_c.append(x)
            us_c.append(u)
        xs_c, us_c = torch.stack(xs_c), torch.stack(us_c)  # [H+1, A, B, n], [H, A, B, m]
        return xs_c, us_c, _total_cost(cost, final_cost, xs_c, us_c)  # [A, B]

    with torch.profiler.record_function("ilqr.plant"):
        xs = _rollout(dynamics, x0s, us)  # [H+1, B, n]
    best_cost = _total_cost(cost, final_cost, xs, us)
    lam = torch.full((B_,), max(reg, 1e-3), dtype=dtype, device=dev)
    history, diag = [best_cost], []
    for _ in range(n_iters):
        with torch.profiler.record_function("ilqr.backward_pass"):
            ks, Ks = _backward_pass(linearize, riccati, xs, us, lam, riccati_mesh)
        with torch.profiler.record_function("ilqr.line_search"):
            xs_c, us_c, costs_c = forward_pass(xs, us, ks, Ks)
            costs_c = torch.where(torch.isnan(costs_c), torch.inf, costs_c)
            best = torch.argmin(costs_c, dim=0)  # the first minimum
            c_best = costs_c[best, lanes]
            improved = c_best < best_cost
            xs = torch.where(improved[:, None], xs_c[:, best, lanes], xs)
            us = torch.where(improved[:, None], us_c[:, best, lanes], us)
            best_cost = torch.where(improved, c_best, best_cost)
            lam = torch.where(improved, torch.clamp(lam * 0.5, min=reg),
                              torch.clamp(lam * 10.0, max=1e8))
        history.append(best_cost)
        if diagnostics:
            diag.append((best, improved, lam, costs_c.T, us.transpose(0, 1),
                         torch.sqrt(torch.mean(ks * ks, dim=(0, 2)))))
    result = ILQRResult(xs.transpose(0, 1), us.transpose(0, 1), best_cost,
                        torch.stack(history, dim=1))
    if not diagnostics:
        return result
    names = ("alpha_idx", "improved", "lam", "ls_costs", "us_iter", "k_norm")
    if not diag:
        raise ValueError("diagnostics need n_iters >= 1")
    return result, {k: torch.stack(v, dim=1) for k, v in zip(names, zip(*diag))}


def ilqr(
    dynamics,
    cost,
    final_cost,
    x0: torch.Tensor,  # [n]
    us_init: torch.Tensor,  # [H, m]
    n_iters: int = 10,
    reg: float = 1e-6,
    line_search_alphas: tuple = LINE_SEARCH_ALPHAS,
    riccati: str = "sequential",
    riccati_mesh=None,
    control_bounds: tuple | None = None,
    diagnostics: bool = False,
    linearize=None,
):
    """Iterative LQR of one scenario: `ilqr_batch` at B=1, so the callables
    follow the batch contract above the section (a scenario axis of 1).
    Returns ILQRResult(xs [H+1, n], us [H, m], cost [], cost_history
    [n_iters+1]) and, with `diagnostics=True`, the dict of per-iteration
    internals of one scenario. `riccati="horizon_sharded"` spreads the
    backward pass over the ranks of `riccati_mesh` (a 1-D mesh of
    `parallel.mesh.make_mesh`, or the "horizon" axis of a mesh of more
    dimensions; `parallel.horizon.riccati_gains_horizon_sharded`, with lam
    I on luu as the parallel form takes it): every rank calls `ilqr` with
    the same arguments and the same `requires_grad` pattern, gets the
    whole solve, and differentiates the same loss of it; it raises without
    a mesh. Differentiable as `ilqr_batch` is; a graph-keeping
    horizon-sharded solve differentiates as the "parallel" form does, its
    Riccati's backward adding two all-reduces an iteration."""
    if riccati == "horizon_sharded":
        if riccati_mesh is None:
            raise ValueError("riccati='horizon_sharded' requires riccati_mesh")
    elif riccati not in RICCATI:
        raise ValueError(f"riccati must be one of {RICCATI + ('horizon_sharded',)}, "
                         f"got {riccati!r}")
    out = _ilqr(dynamics, cost, final_cost, x0[None], us_init[None], n_iters, reg,
                line_search_alphas, riccati, control_bounds, linearize, diagnostics, riccati_mesh)
    if not diagnostics:
        return ILQRResult(*(x[0] for x in out))
    return ILQRResult(*(x[0] for x in out[0])), {k: v[0] for k, v in out[1].items()}
