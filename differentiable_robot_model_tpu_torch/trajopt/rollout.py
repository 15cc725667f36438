"""Rollouts: clamped joint-delta integration with the ee trajectory
(kinematic), and Euler integration through the forward dynamics (dynamic:
the unbatched `dynamic_rollout` and the dof-major batched twin with
implicit damping and the velocity clamp).

PyTorch counterpart of the JAX package's `trajopt/rollout.py`. Clipping is
`torch.minimum(torch.maximum(x, lo), hi)` everywhere, never `torch.clamp`:
like `jnp.clip` it passes a gradient of 0.5 at an exact tie with a limit,
where `torch.clamp` passes 1.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.structs import RobotStruct
from ..ops import kinematics as K
from ..ops.dynamics import forward_dynamics_crb
from ..ops.dynamics_scalar import GRAVITY, ldl_solve_scalar, mass_matrix_scalar, rnea_scalar


def _clip(x, lo, hi):
    return torch.minimum(torch.maximum(x, lo), hi)


def clip_to_limits(robot: RobotStruct, q: torch.Tensor) -> torch.Tensor:
    """Clamp joint positions (dof on the last axis) to the URDF limits."""
    return _clip(q, robot.limit_lower, robot.limit_upper)


def _positive_or_inf(x: torch.Tensor) -> torch.Tensor:
    """A URDF bound, with non-positive (missing) entries meaning unbounded."""
    return torch.where(x > 0, x, torch.full_like(x, float("inf")))


def clip_to_effort(robot: RobotStruct, tau: torch.Tensor) -> torch.Tensor:
    """Clamp applied torques (dof on the last axis) to the URDF effort
    limits, the box constraint of the torque-space solvers; non-positive
    limits mean unbounded."""
    e = _positive_or_inf(robot.limit_effort)
    return _clip(tau, -e, e)


def _effort_bound(robot: RobotStruct, n_batch_dims: int) -> torch.Tensor:
    """Per-dof applied-torque bound for dof-major layouts, shaped [D, 1...]."""
    e = _positive_or_inf(robot.limit_effort)
    return e.reshape(e.shape + (1,) * n_batch_dims)


def _velocity_bound(robot: RobotStruct, n_batch_dims: int) -> torch.Tensor:
    """Per-dof velocity clamp of the dynamic rollouts, shaped [D, 1...]: it
    keeps every scenario of a large batch inside the integrator's stable
    region. Non-positive limits mean unbounded."""
    v = _positive_or_inf(robot.limit_velocity)
    return v.reshape(v.shape + (1,) * n_batch_dims)


def fd_step_implicit_damping(
    robot: RobotStruct,
    q: torch.Tensor,  # [D] or dof-major [D, B...]
    qd: torch.Tensor,
    tau: torch.Tensor,
    dt: float,
    include_gravity: bool = True,
    use_damping: bool = True,
    gravity: float = GRAVITY,
) -> torch.Tensor:
    """Forward-dynamics acceleration with the joint damping taken implicitly:
    (H + dt diag(d)) qdd = tau - nle_with_damping(q, qd), which keeps
    semi-implicit Euler stable for low-inertia damped joints. `gravity` is
    the base's upward acceleration where `include_gravity` is on."""
    nle = rnea_scalar(
        robot, q, qd, torch.zeros_like(q),
        include_gravity=include_gravity, use_damping=use_damping, gravity=gravity,
    )
    H = mass_matrix_scalar(robot, q)
    if use_damping:
        idx = torch.arange(robot.n_dofs, device=q.device)
        damp = robot.damping.reshape(robot.damping.shape + (1,) * (q.dim() - 1))
        H = H.index_put((idx, idx), H[idx, idx] + dt * damp)
    return ldl_solve_scalar(H, tau - nle)


def dynamic_rollout_dof_major(
    robot: RobotStruct,
    q0T: torch.Tensor,  # [D, B]
    qd0T: torch.Tensor,  # [D, B]
    tauT: torch.Tensor,  # [H, D, B]
    dt: float,
    include_gravity: bool = True,
    use_damping: bool = True,
    unroll: int = 1,
    respect_effort_limits: bool = False,
    remat: bool = False,
    gravity: float = GRAVITY,
):
    """Integrate B scenarios through H semi-implicit Euler steps of the
    forward dynamics (`fd_step_implicit_damping`), with the URDF velocity
    clamp after each step and, with `respect_effort_limits`, the effort box
    on each torque first. Returns (qs, qds), each [H, D, B]: the state after
    each step.

    `unroll` is the JAX package's unroll factor of its horizon scan; eager
    torch runs the steps one by one whatever it is, so any int >= 1 gives
    the same values (below 1 raises). `remat=True` recomputes each step in
    the backward pass (`torch.utils.checkpoint`), which keeps only the
    [D, B] carry per step alive between the forward and the backward: the
    JAX package's `jax.checkpoint` trade, with the same values and
    gradients."""
    if unroll < 1:
        raise ValueError(f"unroll must be an int >= 1, got {unroll!r}")
    vmax = _velocity_bound(robot, q0T.dim() - 1)
    emax = _effort_bound(robot, q0T.dim() - 1) if respect_effort_limits else None

    def step(q, qd, tau_t):
        if emax is not None:
            tau_t = _clip(tau_t, -emax, emax)
        qdd = fd_step_implicit_damping(
            robot, q, qd, tau_t, dt, include_gravity=include_gravity, use_damping=use_damping,
            gravity=gravity,
        )
        qd = _clip(qd + dt * qdd, -vmax, vmax)
        return q + dt * qd, qd

    q, qd, qs, qds = q0T, qd0T, [], []
    for tau_t in tauT:
        if remat:
            q, qd = checkpoint(step, q, qd, tau_t, use_reentrant=False)
        else:
            q, qd = step(q, qd, tau_t)
        qs.append(q)
        qds.append(qd)
    return torch.stack(qs), torch.stack(qds)


class DynRolloutResult(NamedTuple):
    q: torch.Tensor  # [H, D]
    qd: torch.Tensor  # [H, D]
    ee: torch.Tensor  # [H, 3]


def dynamic_rollout(
    robot: RobotStruct,
    q0: torch.Tensor,
    qd0: torch.Tensor,
    taus: torch.Tensor,
    dt: float,
    ee_link_idx: int,
    include_gravity: bool = True,
    use_damping: bool = True,
    respect_effort_limits: bool = False,
) -> DynRolloutResult:
    """Integrate applied torques through the forward dynamics (semi-implicit
    Euler, `forward_dynamics_crb`, no velocity clamp), recording the joint
    states and the world position of `ee_link_idx` (`fk_world`) after each
    step. Unbatched: q0, qd0 [D]; taus [H, D]. `respect_effort_limits=True`
    clamps each torque to the URDF effort limits first."""
    if respect_effort_limits:
        taus = clip_to_effort(robot, taus)
    q, qd = q0, qd0
    qs, qds, ees = [], [], []
    for tau in taus:
        qdd = forward_dynamics_crb(
            robot, q, qd, tau, include_gravity=include_gravity, use_damping=use_damping
        )
        qd = qd + dt * qdd
        q = q + dt * qd
        qs.append(q)
        qds.append(qd)
        ees.append(K.fk_world(robot, q)[1][ee_link_idx])
    return DynRolloutResult(torch.stack(qs), torch.stack(qds), torch.stack(ees))


def clamp_affine_combine(e1, e2):
    """Associative composition of clamp-affine maps f(x)=min(max(x+a,b),c).

    (f2 o f1) = (a1+a2, max(b1+a2, b2), min(max(c1+a2, b2), c2)).
    """
    a1, b1, c1 = e1
    a2, b2, c2 = e2
    return (
        a1 + a2,
        torch.maximum(b1 + a2, b2),
        torch.minimum(torch.maximum(c1 + a2, b2), c2),
    )


def _slice(x: torch.Tensor, dim: int, start, stop=None, step=1):
    return x[(slice(None),) * dim + (slice(start, stop, step),)]


def _interleave(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """[a0, b0, a1, b1, ...] along dim; a has as many or one more entries."""
    n = b.shape[dim]
    pairs = torch.stack([_slice(a, dim, 0, n), b], dim=dim + 1).flatten(dim, dim + 1)
    if a.shape[dim] == n:
        return pairs
    return torch.cat([pairs, _slice(a, dim, n)], dim=dim)


def associative_scan(fn, elems, dim: int):
    """Inclusive scan of the associative `fn` over a tuple of tensors along
    `dim`, combining in the same tree as `jax.lax.associative_scan`, so the
    values and the subgradients at ties match the JAX package's term for
    term."""
    n = elems[0].shape[dim]
    if n < 2:
        return elems
    reduced = fn(
        tuple(_slice(e, dim, 0, -1, 2) for e in elems),
        tuple(_slice(e, dim, 1, None, 2) for e in elems),
    )
    odd = associative_scan(fn, reduced, dim)
    if n % 2 == 0:
        even = fn(
            tuple(_slice(e, dim, 0, -1) for e in odd),
            tuple(_slice(e, dim, 2, None, 2) for e in elems),
        )
    else:
        even = fn(odd, tuple(_slice(e, dim, 2, None, 2) for e in elems))
    even = tuple(
        torch.cat([_slice(e, dim, 0, 1), r], dim=dim) for e, r in zip(elems, even)
    )
    return tuple(_interleave(e, o, dim) for e, o in zip(even, odd))


def clamp_affine_q_traj(q_start, u, lo, hi, axis: int = 0):
    """Clipped joint trajectory from the composed steps min(max(x + u_t, lo), hi).

    `u` carries the H-1 steps on `axis`; `lo`/`hi` broadcast against `u`;
    `q_start` is `u` without the horizon axis. Returns the [.., H, ..]
    trajectory with `q_start` as entry 0 along `axis`.
    """
    q_start_h = q_start.unsqueeze(axis)
    if u.shape[axis] == 0:  # horizon == 1: no integration steps
        return q_start_h
    A, Bnd, Cnd = associative_scan(
        clamp_affine_combine,
        (u, torch.broadcast_to(lo, u.shape), torch.broadcast_to(hi, u.shape)),
        axis,
    )
    q_tail = _clip(q_start_h + A, Bnd, Cnd)
    return torch.cat([q_start_h, q_tail], dim=axis)


def kinematic_rollout(
    robot: RobotStruct,
    q0: torch.Tensor,
    actions: torch.Tensor,
    ee_link_idx: int,
    stop_gradient_between_steps: bool = False,
):
    """Roll joint-position deltas through FK. Unbatched: q0 [D], actions [H, D].

    Returns (ee_traj [H, 3], q_traj [H, D]): entry 0 is the start state, then
    H-1 action steps (the last action is unused, as in the reference).
    `stop_gradient_between_steps=True` detaches the state between steps, so
    each action reaches the cost only through its own step's FK.
    """
    q_start = clip_to_limits(robot, q0)
    if stop_gradient_between_steps:
        qs = [q_start]
        for u in actions[:-1]:
            qs.append(clip_to_limits(robot, qs[-1].detach() + u))
        q_clipped = torch.stack(qs)
    else:
        q_clipped = clamp_affine_q_traj(
            q_start, actions[:-1], robot.limit_lower, robot.limit_upper
        )  # [H, D]
    ee_traj = K.fk_link_position(robot, q_clipped, ee_link_idx)
    # q_traj keeps the raw q0 as entry 0; the clipped start only feeds the FK.
    q_traj = torch.cat([q0[None], q_clipped[1:]], dim=0)
    return ee_traj, q_traj
