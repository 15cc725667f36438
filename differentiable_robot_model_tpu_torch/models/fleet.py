"""Heterogeneous robot fleets: one padded form serves any robot.

PyTorch counterpart of the JAX package's `models/fleet.py`. Topology is
data, not structure:

- the kinematic tree is a padded parent-index tensor; FK composes the local
  transforms with ceil(log2(Lmax)) pointer-jumping rounds of gathers
  (`torch.take_along_dim`) and batched 3x3 products;
- the dynamics reuse the world-frame formulations of `ops/dynamics.py`
  (`rnea_given_fk`, `mass_matrix_given_fk`, `sym_solve`), which reach the
  topology only through the `anc_mask` and `dof_select` tensors;
- padded links are massless fixed joints parented to the root: no force,
  no velocity, no Jacobian column; padded dofs get identity rows in the
  mass matrix, limits [0, 0] and zero outputs.

A fleet of R robots is a `FleetRobot` of [R, Lmax, ...] stacked tensors.
Every per-member function takes one padded member or the stacked fleet;
with the stacked fleet, every tensor argument carries the member axis
first and the function is mapped over the members by `torch.func.vmap`,
which stays differentiable under ordinary autograd. The rematerialized
functions (`ee_trajectory_fleet`, `dynamic_rollout_fleet`) put
`torch.utils.checkpoint` around the mapped chunk or step: a checkpoint
cannot sit inside `vmap` (its recompute runs outside the map). The padded
solvers run one Adam loop over the whole [R, (B,) H, Dmax] stack and take
one gradient of the summed costs: members and scenarios are independent,
so each gets its own gradient.

`solve_fleet_*_specialized` take the opposite trade for a roster known in
advance: one batch solver per member (`trajopt/solvers.py`), each on its
own robot's kernels.
"""

from __future__ import annotations

import functools
import math
from typing import List, NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops.dynamics import mass_matrix_given_fk, rnea_given_fk, sym_solve
from ..ops.kinematics import joint_local_transforms, world_joint_subspaces
from ..ops.lie import cross
from ..trajopt.rollout import _clip, _positive_or_inf, clamp_affine_q_traj
from ..trajopt.solvers import _adam_loop, _needs_graph, solve_dynamic_adam_batch, solve_kinematic_adam_batch
from .structs import RobotStruct, resolve_device


class FleetRobot(NamedTuple):
    """One padded robot, or R of them stacked on a leading axis: tensors
    only. The field names are `RobotStruct`'s, so the world-frame ops of
    `ops/kinematics.py` and `ops/dynamics.py` take either type."""

    trans: torch.Tensor  # [Lmax, 3]
    rot_angles: torch.Tensor  # [Lmax, 3]
    axis: torch.Tensor  # [Lmax, 3]
    mass: torch.Tensor  # [Lmax]
    com: torch.Tensor  # [Lmax, 3]
    inertia_com: torch.Tensor  # [Lmax, 3, 3]
    damping: torch.Tensor  # [Dmax]
    limit_lower: torch.Tensor  # [Dmax]
    limit_upper: torch.Tensor  # [Dmax]
    limit_velocity: torch.Tensor  # [Dmax] (<= 0 means unbounded)
    limit_effort: torch.Tensor  # [Dmax] (<= 0 means unbounded)
    anc_mask: torch.Tensor  # [Lmax, Lmax]
    dof_select: torch.Tensor  # [Lmax, Dmax]
    rev_mask: torch.Tensor  # [Lmax]
    prism_mask: torch.Tensor  # [Lmax]
    parent_idx: torch.Tensor  # [Lmax] int64 (data, not structure)
    dof_valid: torch.Tensor  # [Dmax] 1 for real dofs
    ee_onehot: torch.Tensor  # [Lmax] selects this robot's end effector

    @property
    def dtype(self) -> torch.dtype:
        return self.trans.dtype

    @property
    def device(self) -> torch.device:
        return self.trans.device

    @property
    def requires_grad(self) -> bool:
        return any(x.requires_grad for x in self)

    @classmethod
    def from_arrays(cls, arrays: dict, device=None) -> "FleetRobot":
        """The fleet from another fleet's leaves as numpy [R, ...] (e.g. the
        JAX package's `FleetRobot`), floating dtypes kept, `parent_idx` as
        int64: how a fleet's weights are carried across."""
        device = resolve_device(device)
        missing = set(cls._fields) - set(arrays)
        if missing:
            raise KeyError(f"FleetRobot.from_arrays: missing arrays {sorted(missing)}")
        return cls(**{
            k: torch.as_tensor(np.array(arrays[k], np.int64 if k == "parent_idx" else None),
                               device=device)
            for k in cls._fields
        })


def pad_robot(struct: RobotStruct, ee_link: str, max_links: int, max_dofs: int,
              dtype: torch.dtype | None = None) -> FleetRobot:
    """One robot padded to fleet dimensions on its own device. Padded links
    are massless fixed joints parented to the root (identity local
    transform); padded dofs have limits [0, 0] and `dof_valid` 0."""
    dtype = dtype or struct.dtype
    L, D = struct.n_links, struct.n_dofs
    if L > max_links or D > max_dofs:
        raise ValueError(f"{struct.name} has {L} links and {D} dofs; the fleet pads to "
                         f"{max_links} and {max_dofs}")

    def pad(x, shape):
        pads = [p for s, t in zip(reversed(x.shape), reversed(shape)) for p in (0, t - s)]
        return torch.nn.functional.pad(x.to(dtype), pads)

    dev = struct.device
    parent = torch.zeros(max_links, dtype=torch.long, device=dev)
    parent[:L] = torch.tensor(struct.parent, dtype=torch.long, device=dev)
    ee = torch.zeros(max_links, dtype=dtype, device=dev)
    ee[struct.link_index(ee_link)] = 1.0
    dof_valid = torch.zeros(max_dofs, dtype=dtype, device=dev)
    dof_valid[:D] = 1.0
    per_link = (max_links,)
    per_dof = (max_dofs,)
    return FleetRobot(
        trans=pad(struct.trans, per_link + (3,)),
        rot_angles=pad(struct.rot_angles, per_link + (3,)),
        axis=pad(struct.axis, per_link + (3,)),
        mass=pad(struct.mass, per_link),
        com=pad(struct.com, per_link + (3,)),
        inertia_com=pad(struct.inertia_com, per_link + (3, 3)),
        damping=pad(struct.damping, per_dof),
        limit_lower=pad(struct.limit_lower, per_dof),
        limit_upper=pad(struct.limit_upper, per_dof),
        limit_velocity=pad(struct.limit_velocity, per_dof),
        limit_effort=pad(struct.limit_effort, per_dof),
        anc_mask=pad(struct.anc_mask, (max_links, max_links)),
        dof_select=pad(struct.dof_select, (max_links, max_dofs)),
        rev_mask=pad(struct.rev_mask, per_link),
        prism_mask=pad(struct.prism_mask, per_link),
        parent_idx=parent,
        dof_valid=dof_valid,
        ee_onehot=ee,
    )


def build_fleet(robots: List[RobotStruct], ee_links: List[str],
                dtype: torch.dtype = torch.float32) -> FleetRobot:
    """R robots padded to the largest one and stacked on a leading axis, on
    the members' device (members on different devices raise)."""
    if len(robots) != len(ee_links) or not robots:
        raise ValueError("build_fleet needs one end-effector link per robot, and a robot")
    devices = {s.device for s in robots}
    if len(devices) > 1:
        raise ValueError(f"fleet members are on different devices: {sorted(map(str, devices))}")
    max_links = max(s.n_links for s in robots)
    max_dofs = max(s.n_dofs for s in robots)
    padded = [pad_robot(s, ee, max_links, max_dofs, dtype) for s, ee in zip(robots, ee_links)]
    return FleetRobot(*(torch.stack(leaves) for leaves in zip(*padded)))


def _each_member(fn):
    """`fn(robot, ...)` for one padded member; for a stacked fleet (the
    member axis first on every leaf and every tensor argument) `fn` mapped
    over the members by `torch.func.vmap`."""

    @functools.wraps(fn)
    def wrapper(robot, *args, **kwargs):
        if robot.parent_idx.dim() == 1:
            return fn(robot, *args, **kwargs)
        in_dims = (0,) + tuple(0 if isinstance(a, torch.Tensor) else None for a in args)
        return torch.func.vmap(functools.partial(fn, **kwargs), in_dims=in_dims)(robot, *args)

    return wrapper


def _member_view(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """A per-member [*F, D] tensor viewed as [*F, 1, ..., 1, D] with `ndim`
    dims, to broadcast against batched [*F, ..., D] operands."""
    return x.reshape(x.shape[:-1] + (1,) * (ndim - x.dim()) + x.shape[-1:])


# ---------------------------------------------------------------------------
# Kinematics: the topology is the parent-index tensor
# ---------------------------------------------------------------------------


@_each_member
def fk_world_fleet(robot: FleetRobot, q: torch.Tensor):
    """World pose of every link for q [..., Dmax]: (R [..., Lmax, 3, 3],
    p [..., Lmax, 3]) by pointer jumping over the parent index.
    ceil(log2(Lmax)) rounds always suffice (padded links hang off the
    root); rounds past a robot's depth change nothing (the root is its own
    parent with an identity local transform)."""
    L = robot.parent_idx.shape[-1]
    R, t = joint_local_transforms(robot, q)
    pi = robot.parent_idx
    for _ in range(max(1, math.ceil(math.log2(L)))):
        idx = pi.reshape((1,) * (t.dim() - 2) + (L, 1))
        Rp = torch.take_along_dim(R, idx[..., None], dim=-3)
        tp = torch.take_along_dim(t, idx, dim=-2)
        t = torch.einsum("...lij,...lj->...li", Rp, t) + tp
        R = Rp @ R
        pi = torch.take_along_dim(pi, pi, dim=0)
    return R, t


@_each_member
def ee_position_fleet(robot: FleetRobot, q: torch.Tensor) -> torch.Tensor:
    """World position [..., 3] of the member's end effector for q [..., Dmax]."""
    _, p = fk_world_fleet(robot, q)
    return torch.einsum("l,...li->...i", robot.ee_onehot, p)


def ee_trajectory_fleet(robot: FleetRobot, q_traj: torch.Tensor, remat_chunk: int | None = 8):
    """End-effector positions [..., H, 3] of a trajectory q_traj [..., H,
    Dmax], the H axis in chunks of `remat_chunk` whose FK is recomputed in
    the backward pass (`torch.utils.checkpoint`): the backward keeps one
    chunk's pointer-jumping rotations at a time instead of every step's.
    `remat_chunk=None` (or >= H) runs the trajectory at once."""
    H = q_traj.shape[-2]
    if remat_chunk is None or remat_chunk >= H:
        return ee_position_fleet(robot, q_traj)
    return torch.cat([checkpoint(ee_position_fleet, robot, chunk, use_reentrant=False)
                      for chunk in q_traj.split(remat_chunk, dim=-2)], dim=-2)


@_each_member
def ee_jacobian_fleet(robot: FleetRobot, q: torch.Tensor):
    """Geometric Jacobian of the member's end effector for q [..., Dmax]:
    (lin, ang), each [..., 3, Dmax]; padded dofs' columns are 0."""
    R, p = fk_world_fleet(robot, q)
    S = world_joint_subspaces(robot, R, p)
    p_e = torch.einsum("l,...li->...i", robot.ee_onehot, p)
    mask = (robot.ee_onehot @ robot.anc_mask)[:, None]  # [Lmax, 1] ancestors of the ee
    j_ang = S[..., :3] * mask
    j_lin = (S[..., 3:] + cross(S[..., :3], p_e[..., None, :].expand(j_ang.shape))) * mask
    to_dofs = lambda j: torch.einsum("ld,...li->...id", robot.dof_select, j)
    return to_dofs(j_lin), to_dofs(j_ang)


# ---------------------------------------------------------------------------
# Dynamics: the world-frame formulations of ops/dynamics.py
# ---------------------------------------------------------------------------


@_each_member
def rnea_fleet(robot: FleetRobot, q, qd, qdd, include_gravity: bool = True,
               use_damping: bool = True) -> torch.Tensor:
    """Inverse dynamics [..., Dmax]; padded dofs' torques are 0."""
    R, p = fk_world_fleet(robot, q)
    tau = rnea_given_fk(robot, R, p, q, qd, qdd, include_gravity, use_damping)
    return tau * robot.dof_valid


def _padded_mass_matrix(robot: FleetRobot, R, p) -> torch.Tensor:
    valid = robot.dof_valid
    Hm = mass_matrix_given_fk(robot, R, p) * valid[:, None] * valid
    return Hm + torch.diag_embed(1.0 - valid)


@_each_member
def mass_matrix_fleet(robot: FleetRobot, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia [..., Dmax, Dmax] with identity rows and columns
    on padded dofs, so that it stays positive definite."""
    return _padded_mass_matrix(robot, *fk_world_fleet(robot, q))


def _bias_and_mass_matrix(robot: FleetRobot, q, qd, include_gravity: bool, use_damping: bool):
    """(nle [..., Dmax], H [..., Dmax, Dmax]) from one FK."""
    R, p = fk_world_fleet(robot, q)
    nle = rnea_given_fk(robot, R, p, q, qd, torch.zeros_like(q), include_gravity, use_damping)
    return nle * robot.dof_valid, _padded_mass_matrix(robot, R, p)


@_each_member
def forward_dynamics_fleet(robot: FleetRobot, q, qd, f, include_gravity: bool = True,
                           use_damping: bool = False) -> torch.Tensor:
    """Forward dynamics qdd = H^-1 (f - nle) [..., Dmax]; 0 on padded dofs."""
    nle, Hm = _bias_and_mass_matrix(robot, q, qd, include_gravity, use_damping)
    return sym_solve(Hm, (f - nle) * robot.dof_valid) * robot.dof_valid


@_each_member
def fd_step_implicit_damping_fleet(robot: FleetRobot, q, qd, tau, dt: float,
                                   include_gravity: bool = True,
                                   use_damping: bool = True) -> torch.Tensor:
    """Fleet twin of `trajopt.rollout.fd_step_implicit_damping`:
    (H + dt diag(d)) qdd = tau - nle(q, qd), the damping taken at qd_{k+1}.
    Padded dofs keep their identity rows and zero torque: qdd is 0 there."""
    nle, Hm = _bias_and_mass_matrix(robot, q, qd, include_gravity, use_damping)
    if use_damping:
        Hm = Hm + dt * torch.diag_embed(robot.damping * robot.dof_valid)
    return sym_solve(Hm, (tau - nle) * robot.dof_valid) * robot.dof_valid


@_each_member
def _rollout_step(robot: FleetRobot, q, qd, tau, dt: float, use_damping: bool,
                  respect_effort_limits: bool):
    """One semi-implicit Euler step: the effort box (optional), the implicit
    damping FD, the velocity clamp."""
    if respect_effort_limits:
        emax = _positive_or_inf(robot.limit_effort)
        tau = _clip(tau, -emax, emax)
    qdd = fd_step_implicit_damping_fleet(robot, q, qd, tau, dt, use_damping=use_damping)
    vmax = _positive_or_inf(robot.limit_velocity)
    qd_next = _clip(qd + dt * qdd, -vmax, vmax)
    return q + dt * qd_next, qd_next


def dynamic_rollout_fleet(robot: FleetRobot, q0, qd0, taus, dt: float, use_damping: bool = True,
                          respect_effort_limits: bool = False, remat: bool = True):
    """Semi-implicit Euler through the fleet forward dynamics from (q0, qd0
    [..., Dmax]) under the applied torques taus [..., H, Dmax]: implicit
    joint damping, the URDF velocity clamp and, with
    `respect_effort_limits`, the effort box on every torque. Returns (qs,
    qds), each [..., H, Dmax], the state after each step. `remat` (default)
    recomputes each step in the backward pass (`torch.utils.checkpoint`),
    which keeps the backward's memory at the carry's size."""
    step = functools.partial(_rollout_step, dt=dt, use_damping=use_damping,
                             respect_effort_limits=respect_effort_limits)
    q, qd, qs, qds = q0, qd0, [], []
    for tau in taus.unbind(-2):
        if remat:
            q, qd = checkpoint(step, robot, q, qd, tau, use_reentrant=False)
        else:
            q, qd = step(robot, q, qd, tau)
        qs.append(q)
        qds.append(qd)
    return torch.stack(qs, dim=-2), torch.stack(qds, dim=-2)


# ---------------------------------------------------------------------------
# Padded fleet solvers: one Adam loop over every member
# ---------------------------------------------------------------------------


class FleetTrajOptResult(NamedTuple):
    actions: torch.Tensor  # [R, (B,) H, Dmax] optimized action sequences
    cost: torch.Tensor  # [R, (B,)] final costs
    cost_history: torch.Tensor  # [R, (B,) iters] the cost before each update


def kinematic_rollout_fleet(robot: FleetRobot, q0: torch.Tensor, actions: torch.Tensor):
    """The clamp-affine rollout and the fleet FK: q0 [..., Dmax], actions
    [..., H, Dmax] -> (ee_traj [..., H, 3], q_traj [..., H, Dmax]), entry 0
    the clipped start, then H-1 action steps (as
    `trajopt.rollout.kinematic_rollout`). Padded dofs have limits [0, 0]:
    the clip pins them to 0 and no FK reads them, so their actions get
    exactly zero gradients."""
    lo, hi = (_member_view(x, q0.dim()) for x in (robot.limit_lower, robot.limit_upper))
    q_start = _clip(q0, lo, hi)
    q_traj = clamp_affine_q_traj(q_start, actions[..., :-1, :], lo.unsqueeze(-2), hi.unsqueeze(-2),
                                 axis=actions.dim() - 2)
    return ee_trajectory_fleet(robot, q_traj), q_traj


def _history(history, final):
    return torch.stack(history, dim=-1) if history else final.new_zeros(final.shape + (0,))


def solve_fleet_kinematic_adam(
    fleet: FleetRobot,  # [R, ...] stacked
    q0: torch.Tensor,  # [R, Dmax] or [R, B, Dmax]
    goal_ee_pos: torch.Tensor,  # [R, 3] or [R, B, 3]
    horizon: int,
    n_iters: int = 100,
    lr: float = 1e-2,
    goal_weight: float = 100.0,
    eps: float = 1e-8,
) -> FleetTrajOptResult:
    """Kinematic reach for R different robots (and B scenarios each) in one
    Adam loop: per member and scenario the mean over 3 H terms of
    (goal_weight (p - goal))^2 along the clamp-affine rollout. The whole
    solve is differentiable w.r.t. any fleet tensor (identification through
    the solve)."""
    through = _needs_graph(fleet, q0, goal_ee_pos)
    goal = goal_ee_pos.unsqueeze(-2)

    def cost_fn(a):
        ee, _ = kinematic_rollout_fleet(fleet, q0, a)
        err = goal_weight * (ee - goal)
        costs = torch.mean(err * err, dim=(-2, -1))
        return costs.sum(), costs

    actions0 = q0.new_zeros(q0.shape[:-1] + (horizon, q0.shape[-1]))
    actions, history = _adam_loop(cost_fn, actions0, n_iters, lr, eps, through)
    with torch.set_grad_enabled(through):
        _, final = cost_fn(actions)
    return FleetTrajOptResult(actions, final, _history(history, final))


def solve_fleet_dynamic_adam(
    fleet: FleetRobot,  # [R, ...] stacked
    q0: torch.Tensor,  # [R, Dmax] or [R, B, Dmax]
    qd0: torch.Tensor,  # as q0
    goal_ee_pos: torch.Tensor,  # [R, 3] or [R, B, 3]
    horizon: int,
    dt: float = 0.02,
    n_iters: int = 10,
    lr: float = 0.5,
    goal_weight: float = 10.0,
    effort_weight: float = 1e-4,
    eps: float = 1e-1,
    use_damping: bool = True,
    precondition: bool = True,
    respect_effort_limits: bool = False,
    init_actions: torch.Tensor | None = None,  # [R, (B,) H, Dmax] absolute torques
) -> FleetTrajOptResult:
    """Torque-space reach for R different robots in one Adam loop, the
    algorithm of `trajopt.solvers.solve_dynamic_adam`: Adam on deltas a with
    tau = tau_ref + H0 a (tau_ref the gravity torques and H0 the mass
    matrix at q0; tau_ref + a without `precondition`) through the fleet
    rollout, the cost the mean over 3 H terms of (goal_weight (p -
    goal))^2 plus effort_weight times the mean squared torque delta over
    the member's real dofs (so each member's cost and gradients are the
    single-robot solver's whatever the padding). `init_actions` are
    absolute torques, mapped back through H0. Returns the applied torques
    [R, (B,) H, Dmax], exactly 0 on padded dofs. The whole solve is
    differentiable w.r.t. any fleet tensor."""
    through = _needs_graph(fleet, q0, qd0, goal_ee_pos, init_actions)
    valid = _member_view(fleet.dof_valid, q0.dim() + 1)  # [R, (1,) 1, Dmax]
    n_real = fleet.dof_valid.sum(-1).reshape((-1,) + (1,) * (q0.dim() - 2))  # [R, (1,)]
    goal = goal_ee_pos.unsqueeze(-2)
    with torch.set_grad_enabled(through):
        zeros = torch.zeros_like(q0)
        tau_ref = rnea_fleet(fleet, q0, zeros, zeros).unsqueeze(-2)  # gravity compensation
        H0 = mass_matrix_fleet(fleet, q0).unsqueeze(-3) if precondition else None
    emax = _member_view(_positive_or_inf(fleet.limit_effort), q0.dim() + 1)

    def torque_deltas(a):
        return (a if H0 is None else (H0 @ a[..., None])[..., 0]) * valid

    def applied(dtau):
        taus = tau_ref + dtau
        return _clip(taus, -emax, emax) if respect_effort_limits else taus

    def cost_fn(a):
        dtau = torque_deltas(a)
        qs, _ = dynamic_rollout_fleet(fleet, q0, qd0, applied(dtau), dt, use_damping=use_damping)
        err = goal_weight * (ee_trajectory_fleet(fleet, qs) - goal)
        effort = torch.sum(dtau * dtau, dim=(-2, -1)) / (horizon * n_real)
        costs = torch.mean(err * err, dim=(-2, -1)) + effort_weight * effort
        return costs.sum(), costs

    if init_actions is None:
        actions0 = q0.new_zeros(q0.shape[:-1] + (horizon, q0.shape[-1]))
    else:
        dtau0 = init_actions - tau_ref
        actions0 = (dtau0 if H0 is None else sym_solve(H0.expand(dtau0.shape + dtau0.shape[-1:]),
                                                       dtau0)) * valid
    actions, history = _adam_loop(cost_fn, actions0, n_iters, lr, eps, through)
    with torch.set_grad_enabled(through):
        _, final = cost_fn(actions)
        taus = applied(torque_deltas(actions)) * valid
    return FleetTrajOptResult(taus, final, _history(history, final))


# ---------------------------------------------------------------------------
# Specialized fleet solvers: one batch solver per member
# ---------------------------------------------------------------------------


def solve_fleet_kinematic_specialized(
    structs: List[RobotStruct],
    ee_link_idxs: List[int],
    q0s,  # per member [B_r, D_r]
    goals,  # per member [B_r, 3]
    horizon: int,
    n_iters: int = 100,
    lr: float = 1e-2,
    goal_weight: float = 100.0,
    fk_impl: str = "auto",
    eps: float = 1e-8,
):
    """The kinematic fleet on its fast path: one `solve_kinematic_adam_batch`
    per member on its own robot, no padding (on the card by default K3,
    one launch a member). `fk_impl` takes the port's engine names ("auto",
    "fused", "kernel", "scalar"; the JAX package's "pallas" is "kernel").
    Returns a tuple of `BatchTrajOptResult` in member order."""
    if not len(structs) == len(ee_link_idxs) == len(q0s) == len(goals):
        raise ValueError("one end effector, start and goal per member")
    return tuple(
        solve_kinematic_adam_batch(struct, q0, goal, ee, horizon=horizon, n_iters=n_iters, lr=lr,
                                   goal_weight=goal_weight, fk_impl=fk_impl, eps=eps)
        for struct, ee, q0, goal in zip(structs, ee_link_idxs, q0s, goals)
    )


def solve_fleet_dynamic_specialized(
    structs: List[RobotStruct],
    ee_link_idxs: List[int],
    q0s,  # per member [B_r, D_r]
    qd0s,  # as q0s
    goals,  # per member [B_r, 3]
    horizon: int,
    dt: float = 0.02,
    n_iters: int = 10,
    lr: float = 0.5,
    goal_weight: float = 10.0,
    effort_weight: float = 1e-4,
    eps: float = 1e-1,
    use_damping: bool = True,
    respect_effort_limits: bool = False,
    rollout_impl: str = "auto",
):
    """The torque-space fleet on its fast path: one `solve_dynamic_adam_batch`
    per member, each on its own robot's dynamics and kernels with no
    padding (on the card by default the prologue and K9, one launch each
    a member, K9's build chosen per member by `kernel_variant`).
    `rollout_impl` takes the port's engine names ("auto", "fused",
    "kernel", "scan"; the JAX package's "pallas" is "kernel"). Returns a
    tuple of `BatchTrajOptResult` (applied torques [B_r, H, D_r]) in member
    order. Use the padded `solve_fleet_dynamic_adam` where the topology
    must be data."""
    if not len(structs) == len(ee_link_idxs) == len(q0s) == len(qd0s) == len(goals):
        raise ValueError("one end effector, start state and goal per member")
    return tuple(
        solve_dynamic_adam_batch(struct, q0, qd0, goal, ee, horizon=horizon, dt=dt,
                                 n_iters=n_iters, lr=lr, goal_weight=goal_weight,
                                 effort_weight=effort_weight, eps=eps, use_damping=use_damping,
                                 respect_effort_limits=respect_effort_limits,
                                 rollout_impl=rollout_impl)
        for struct, ee, q0, qd0, goal in zip(structs, ee_link_idxs, q0s, qd0s, goals)
    )
