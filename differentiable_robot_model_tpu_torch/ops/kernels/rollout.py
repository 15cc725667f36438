"""The dynamic rollouts: kernels `dyn_rollout_fwd` / `dyn_rollout_bwd` (the
states only) and `dyn_rollout_ee_fwd` / `dyn_rollout_ee_bwd` (with the
end-effector trajectory), all in csrc/dyn_rollout.cu, their plain PyTorch
versions, and the autograd entries `dynamic_rollout` and
`dynamic_rollout_ee`.

Replaces the JAX package's ops/pallas/rollout.py `_fwd_kernel` and
`_fwd_ee_kernel` (H semi-implicit Euler forward-dynamics steps, the latter
each followed by the ee FK) and `_bwd_kernel` / `_bwd_ee_kernel` (their
adjoints, by replay and `jax.vjp` of the step inside the kernel). CUDA has
no `jax.vjp`, so the adjoint of a step is written out by the
implicit-function identity: with Ĥ = M(q) + dt diag(d) and qdd* the step's
acceleration,

    x̄ = (ḡqd' + dt ḡq') * dclip(x),   λ = Ĥ⁻¹ (dt x̄),   τ̄ = λ,
    q̄ = ḡq' - (∂RNEA(q, qd, qdd*)/∂q)ᵀ λ,   q̄d = x̄ - (∂RNEA/∂qd)ᵀ λ,

where ḡq' holds the cotangent on qs plus J(q')ᵀ ḡp from the ee FK, and ḡqd'
the cotangent on qds. The adjoint kernels take the cotangents on qs and qds
each optionally, so every cotangent pattern JAX's custom VJPs accept runs
on a kernel.

The adjoint runs in two phases. Phase A (`replay_reference`, kernel
`replay_kernel`) computes, for every stage at once, all that does not
depend on the carried cotangent: Ĥ's LDLᵀ factor, the clamp's mask, the D
rows of ∂RNEA/∂(q, qd) at qdd* (D reverse RNEA sweeps with unit
cotangents), and the cotangents gqs[h] + J^T gps[h] and gqds[h], into a
scratch [stage, K, B] (`replay_layout`). Phase B (`adjoint_reference`,
kernel `adjoint_kernel`) then runs the short chain from the last stage
back: one LDLᵀ solve and one 2D x D product a stage. The scratch is capped
at SCRATCH_CAP_BYTES = 256 MiB (120 MB at iiwa H=50, B=4096 in float32):
past it, both phases run over windows of stages from the last back, the
carry handed from one window to the next; a window of one stage that does
not fit is an error.

Bound on the H100: per scenario and step the function needs one RNEA, one
composite-rigid-body mass matrix, an LDL^T factor and solve (and one chain
FK for the ee pair); the adjoint a replay of the step, one more solve, one
reverse RNEA sweep (and the J^T g sweep): a few thousand FP32 operations
for iiwa over a few hundred bytes, so operations bound it. Each scenario's
chain of H dependent steps sets the forward's time: on a serial chain of a
built shape the forwards spread a scenario's step over a group of lanes,
one lane a link, while one thread a scenario would leave the card short of
warps, and run one thread a scenario at larger batches and on every other
robot (csrc/dyn_rollout.cu); the adjoint's phase A runs H B independent
threads, and its phase B one thread per scenario on a chain a fraction of
a step long.

On a CUDA tensor the wrappers launch the kernels or raise; they take the
plain versions only for tensors on the CPU. The autograd entries
`dynamic_rollout` and `dynamic_rollout_ee` also take the plain
differentiable rollout for a robot whose tensors require grad, as the JAX
package's fall back to its scan for a traced robot.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import numpy as np
import torch

from ...models.structs import JOINT_FIXED, JOINT_PRISMATIC, JOINT_REVOLUTE, RobotStruct
from ...trajopt.rollout import _clip, _effort_bound, _velocity_bound, dynamic_rollout_dof_major
from ..dynamics_scalar import (
    GRAVITY,
    _link_dof_map,
    _local_transforms,
    _rnea_sweeps,
    ldl_back,
    ldl_factor,
    mass_matrix_scalar,
    rnea_scalar,
    rnea_vjp_scalar,
)
from . import build
from .fk import (
    CHAIN_CTYPES,
    MAX_CHAIN,
    MAX_DOF,
    _check_cuda,
    _suffix,
    chain_constants,
    chain_struct,
    chain_sweep,
    check_unit_axes,
    fixed_rotation,
    joint_vjp,
)
from ..kinematics import fk_link_position_dof_first

# Must match DRM_MAX_LINKS in csrc/dyn_step.cuh (checked at load). The
# largest bundled robot has 29 links (kuka_iiwa7_allegro).
MAX_LINKS = 32

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# ---------------------------------------------------------------------------
# The robot's tree as the kernels see it.
# ---------------------------------------------------------------------------


def _tree_ctypes(ctype):
    class Link(ctypes.Structure):
        _fields_ = [
            ("parent", ctypes.c_int), ("type", ctypes.c_int), ("dof", ctypes.c_int),
            ("F", ctype * 9), ("a", ctype * 3), ("Fa", ctype * 3), ("t", ctype * 3),
            ("mass", ctype), ("com", ctype * 3), ("I6", ctype * 6),
        ]

    class Tree(ctypes.Structure):
        _fields_ = [
            ("n", ctypes.c_int), ("D", ctypes.c_int), ("use_damping", ctypes.c_int),
            ("dt", ctype), ("gravity", ctype),
            ("dof_link", ctypes.c_int * MAX_DOF), ("anc", ctypes.c_uint * MAX_DOF),
            ("damping", ctype * MAX_DOF), ("dt_damping", ctype * MAX_DOF),
            ("vmax", ctype * MAX_DOF), ("emax", ctype * MAX_DOF),
            ("link", Link * MAX_LINKS),
        ]

    return Tree


TREE_CTYPES = {
    torch.float32: _tree_ctypes(ctypes.c_float),
    torch.float64: _tree_ctypes(ctypes.c_double),
}


@dataclasses.dataclass(frozen=True)
class StepFlags:
    """What the dynamics kernels take besides the robot: the step dt (unused
    by the RNEA kernels), joint damping on or off, and the base's upward
    acceleration `gravity`, 0 where `include_gravity` is off."""

    dt: float = 0.0
    use_damping: bool = True
    include_gravity: bool = True
    gravity: float = GRAVITY


def check_constant_robot(robot: RobotStruct) -> None:
    """The dynamics kernels and their autograd entries treat the robot as
    constant: raise if a tensor they read requires grad."""
    for f in ("trans", "rot_angles", "axis", "mass", "com", "inertia_com", "damping",
              "limit_velocity", "limit_effort"):
        if getattr(robot, f).requires_grad:
            raise ValueError(
                f"robot.{f} requires grad: the dynamics kernels treat the robot as "
                "constant; differentiate w.r.t. the robot through the plain paths "
                "(rollout_impl='scan', id_impl='scalar')"
            )


def tree_struct(robot: RobotStruct, flags: StepFlags):
    """The by-value `Tree<T>` kernel argument: every link's constants (F from
    cos/sin rounded to the dtype, axis, F@a, translation, mass, COM,
    inertia), the base's upward acceleration (`flags.gravity`, or 0 without
    gravity) and per dof its damping, f(dt * damping) (the implicit-damping
    diagonal, rounded as ops/pallas/rollout.py:276 rounds it), velocity and
    effort bounds (inf where the URDF gives none), each rounded to the
    struct's dtype. Built on the host once per struct and flags."""
    if robot.dtype not in _NP_DTYPE:
        raise TypeError(f"the dynamics kernels take float32 or float64 robots, not {robot.dtype}")
    check_constant_robot(robot)
    return robot.memo(("tree", flags), lambda: _tree_struct(robot, flags))


def _tree_struct(robot: RobotStruct, flags: StepFlags):
    L, D = robot.n_links, robot.n_dofs
    if L > MAX_LINKS:
        raise ValueError(f"{L} links exceed MAX_LINKS={MAX_LINKS}")
    if D > MAX_DOF:
        raise ValueError(f"{D} dofs exceed MAX_DOF={MAX_DOF}")
    nd = _NP_DTYPE[robot.dtype]
    r = lambda x: float(nd(x))
    rnd = lambda x: np.asarray(x, nd).astype(np.float64)
    host = robot.numpy()
    ld = _link_dof_map(robot)
    tr = TREE_CTYPES[robot.dtype]()
    tr.n, tr.D, tr.use_damping = L, D, int(flags.use_damping)
    tr.dt = r(flags.dt)
    tr.gravity = r(flags.gravity) if flags.include_gravity else 0.0
    for l in range(L):
        k = tr.link[l]
        k.parent, k.type, k.dof = robot.parent[l], robot.joint_types[l], ld.get(l, -1)
        F = fixed_rotation(host["rot_angles"][l], rnd)
        a = host["axis"][l].astype(np.float64)
        k.F[:] = rnd(F).ravel().tolist()
        k.a[:] = rnd(a).tolist()
        k.Fa[:] = rnd(F @ a).tolist()
        k.t[:] = rnd(host["trans"][l]).tolist()
        k.mass = r(host["mass"][l])
        k.com[:] = rnd(host["com"][l]).tolist()
        I = host["inertia_com"][l]
        k.I6[:] = rnd([I[0, 0], I[0, 1], I[0, 2], I[1, 1], I[1, 2], I[2, 2]]).tolist()
    for d, l in enumerate(robot.dof_links):
        tr.dof_link[d] = l
        anc, k = 0, l
        while k != 0:
            if robot.joint_types[k] != JOINT_FIXED:
                anc |= 1 << ld[k]
            k = robot.parent[k]
        tr.anc[d] = anc
        damp = r(host["damping"][d])
        tr.damping[d] = damp
        tr.dt_damping[d] = r(r(flags.dt) * damp)
        v, e = float(host["limit_velocity"][d]), float(host["limit_effort"][d])
        tr.vmax[d] = r(v) if v > 0 else float("inf")
        tr.emax[d] = r(e) if e > 0 else float("inf")
    return tr


# ---------------------------------------------------------------------------
# The plain PyTorch versions.
# ---------------------------------------------------------------------------


def _clip_grad(x, lo, hi):
    """d min(max(x, lo), hi) / dx under JAX's rule for max and min: 1
    strictly inside, 0.5 at an exact tie with a bound, 0 outside."""
    g_max = torch.where(x > lo, 1.0, torch.where(x == lo, 0.5, 0.0))
    y = torch.maximum(x, lo)
    g_min = torch.where(y < hi, 1.0, torch.where(y == hi, 0.5, 0.0))
    return (g_max * g_min).to(x.dtype)


class _Dual:
    """A lane value with K tangents stacked in front of its lanes: the
    forward-mode number type that `rnea_jacobians` runs the RNEA sweeps on."""

    __slots__ = ("v", "t")

    def __init__(self, v, t):
        self.v, self.t = v, t

    def __add__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v + o.v, self.t + o.t)
        return _Dual(self.v + o, self.t)

    __radd__ = __add__

    def __sub__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v - o.v, self.t - o.t)
        return _Dual(self.v - o, self.t)

    def __rsub__(self, o):
        return _Dual(o - self.v, -self.t)

    def __neg__(self):
        return _Dual(-self.v, -self.t)

    def __mul__(self, o):
        if isinstance(o, _Dual):
            return _Dual(self.v * o.v, self.t * o.v + self.v * o.t)
        return _Dual(self.v * o, self.t * o)

    __rmul__ = __mul__


def rnea_jacobians(robot: RobotStruct, q, qd, qdd, use_damping=True, include_gravity=True,
                   gravity=GRAVITY):
    """Per dof d, the rows ∂RNEA_d(q, qd, qdd)/∂(q, qd) as [2D, lanes...]
    (entry k < D is ∂/∂q_k, entry D + k is ∂/∂qd_k), by 2D forward-mode
    tangents through the RNEA sweeps on dof-major lanes. `qdd` is a per-dof
    list or a [D, lanes...] tensor."""
    D = robot.n_dofs
    K = 2 * D
    lanes = q.shape[1:]
    zero = torch.zeros(lanes, dtype=q.dtype, device=q.device)
    seeds = torch.eye(K, dtype=q.dtype, device=q.device).reshape((K, K) + (1,) * len(lanes))
    qv = [_Dual(q[d], seeds[d]) for d in range(D)]
    qdv = [_Dual(qd[d], seeds[D + d]) for d in range(D)]
    ld = _link_dof_map(robot)
    L = robot.n_links
    q_link = [qv[ld[l]] if l in ld else zero for l in range(L)]
    cs_link = [None] * L
    for l in range(1, L):
        if robot.joint_types[l] == JOINT_REVOLUTE:
            x = q_link[l]
            c, s = torch.cos(x.v), torch.sin(x.v)
            cs_link[l] = (_Dual(c, -s * x.t), _Dual(s, c * x.t))
    Rl, tl = _local_transforms(robot, q_link, zero, cs_link)
    gz = zero + gravity if include_gravity else zero
    tau_link = _rnea_sweeps(
        robot, Rl, tl,
        [qdv[ld[l]] if l in ld else zero for l in range(L)],
        [qdd[ld[l]] if l in ld else zero for l in range(L)],
        zero, gz,
    )
    rows = []
    for d, l in enumerate(robot.dof_links):
        tau_d = tau_link[l]
        if use_damping:
            tau_d = tau_d + robot.damping[d] * qdv[d]
        rows.append(tau_d.t)
    return rows


# The instantiations of the register-resident kernels (K6/K8's backward, K9,
# K10) by their code (csrc/dyn_step.cuh `DrmVariant`): the generic builds
# for up to 16 and 32 links and dofs, and one per serial-chain shape (links,
# dofs) whose topology is fixed at compile time (`DrmSerial`).
VARIANTS = ("generic16", "generic32", "serial9x7", "serial4x2")
SERIAL_SHAPES = {(9, 7): "serial9x7", (4, 2): "serial4x2"}


def kernel_variant(robot: RobotStruct) -> str:
    """The instantiation for the robot: "serial{L}x{D}" for a serial chain
    of a built shape (link l's parent l - 1, links 1..D revolute with dofs
    0..D-1, the rest fixed: iiwa, panda_no_gripper, fetch_arm, the 2-link
    robot), else "generic16" or "generic32" by its link and dof counts.
    Raises for a robot beyond 32 links or dofs."""
    return _variant_of(tuple(robot.parent), tuple(robot.joint_types), tuple(robot.dof_links))


def variant_code(robot: RobotStruct) -> int:
    """`kernel_variant(robot)`'s code, the leading int of each entry."""
    return VARIANTS.index(kernel_variant(robot))


@functools.lru_cache(maxsize=None)
def _variant_of(parent: tuple, joint_types: tuple, dof_links: tuple) -> str:
    """`kernel_variant` of a topology, computed once per topology (it runs
    on every launch of K4-K10)."""
    L, D = len(parent), len(dof_links)
    if L > MAX_LINKS or D > MAX_DOF:
        raise ValueError(f"{L} links and {D} dofs exceed the kernels' {MAX_LINKS} and {MAX_DOF}")
    types = (JOINT_FIXED,) + (JOINT_REVOLUTE,) * D + (JOINT_FIXED,) * (L - 1 - D)
    serial = (
        all(parent[l] == l - 1 for l in range(1, L))
        and joint_types == types
        and dof_links == tuple(range(1, D + 1))
    )
    if serial and (L, D) in SERIAL_SHAPES:
        return SERIAL_SHAPES[(L, D)]
    return "generic16" if L <= 16 and D <= 16 else "generic32"


def _check_variants(sizes, first: int, source: str) -> None:
    """The serial shapes a kernel library reports from `first` on match
    SERIAL_SHAPES."""
    shapes = tuple(zip(sizes[first::2], sizes[first + 1::2]))
    if shapes != tuple(SERIAL_SHAPES):
        raise RuntimeError(
            f"{source} builds serial shapes {shapes}, Python expects {tuple(SERIAL_SHAPES)}")


@dataclasses.dataclass(frozen=True)
class ReplayLayout:
    """The rows of one stage in the adjoint's scratch [stage, K, B]: Ĥ's
    LDLᵀ factor (its strict lower triangle, entry (i, j) at i(i-1)/2 + j),
    its diagonal at `dg`, the clamp's mask at `mask`, the D rows of
    ∂RNEA/∂(q, qd) at qdd* from `rows` on (row d's 2D entries, q partials
    then qd partials, at rows + 2D d), then the folded cotangent on q'
    (gqs[h] plus J(q'_h)ᵀ gps[h]) at `ox` and that on qd' (gqds[h]) at
    `odx`, each -1 where absent (zeros)."""

    D: int
    K: int
    ox: int
    odx: int

    @property
    def dg(self):
        return self.D * (self.D - 1) // 2

    @property
    def mask(self):
        return self.dg + self.D

    @property
    def rows(self):
        return self.mask + self.D


def replay_layout(D: int, gqx: bool, gqdx: bool) -> ReplayLayout:
    """The scratch layout for D dofs, with or without the folded cotangent
    rows (csrc/dyn_rollout.cu `replay_base` for the rest)."""
    base = D * (D - 1) // 2 + 2 * D + 2 * D * D
    ox = base if gqx else -1
    odx = base + D * gqx if gqdx else -1
    return ReplayLayout(D, base + D * (gqx + gqdx), ox, odx)


def replay_reference(robot: RobotStruct, q, qd, tau, flags: StepFlags, gqx=None, gqdx=None):
    """Plain version of the adjoint's phase A (csrc/dyn_rollout.cu
    `replay_kernel`) for the stages whose incoming states are q, qd and
    torques tau ([n, D, B]): everything of the step's adjoint that does not
    depend on the carried cotangent, batched over the [n, B] lanes (RNEA
    bias, mass matrix, the LDLᵀ factor of Ĥ, qdd*, the clamp's mask, and the
    rows of ∂RNEA/∂(q, qd) at qdd* from D reverse sweeps, `rnea_vjp_scalar`
    with the unit cotangents), and the folded cotangents gqx, gqdx [n, D, B]
    (or None). Returns the scratch [n, K, B] of `replay_layout`."""
    D = robot.n_dofs
    n, _, B = q.shape
    qT, qdT = q.transpose(0, 1), qd.transpose(0, 1)  # [D, n, B]
    nle = rnea_scalar(robot, qT, qdT, torch.zeros_like(qT), flags.include_gravity,
                      flags.use_damping, flags.gravity)
    M = mass_matrix_scalar(robot, qT)
    rows = [[M[i][j] for j in range(D)] for i in range(D)]
    if flags.use_damping:
        for d in range(D):
            rows[d][d] = rows[d][d] + flags.dt * robot.damping[d]
    L, dg = ldl_factor(rows)
    qdd = torch.stack(ldl_back(L, dg, tau.transpose(0, 1) - nle))
    vmax = _velocity_bound(robot, 2)
    mask = _clip_grad(qdT + flags.dt * qdd, -vmax, vmax)
    unit = torch.eye(D, dtype=q.dtype, device=q.device)[:, :, None, None].expand(D, D, n, B)
    sweep = lambda x: x[:, None].expand(D, D, n, B)  # dof, sweep, stage, scenario
    jac = rnea_vjp_scalar(robot, sweep(qT), sweep(qdT), sweep(qdd), unit, flags.include_gravity,
                          flags.use_damping, flags.gravity)  # [2D, D, n, B]: entry k of row d
    parts = [L[i][j] for i in range(1, D) for j in range(i)] + list(dg) + list(mask.unbind(0))
    blocks = [torch.stack(parts, 1), jac.permute(2, 1, 0, 3).reshape(n, 2 * D * D, B)]
    blocks += [x for x in (gqx, gqdx) if x is not None]
    return torch.cat(blocks, 1).contiguous()


def pull_stage(s, D: int, dt: float, gqn, gqdn):
    """The adjoint of one stage from its scratch rows s [K, B] (phase B's
    stage, csrc/dyn_rollout.cu `adjoint_kernel`, element for element): for
    the cotangents gqn on q' and gqdn on qd' ([D, B]), x̄ = (gqdn + dt gqn)
    mask, λ = Ĥ⁻¹ dt x̄; returns (τ̄ = λ, q̄, q̄d)."""
    lay = replay_layout(D, False, False)
    L = [[s[i * (i - 1) // 2 + j] if j < i else None for j in range(D)] for i in range(D)]
    gx = (gqdn + dt * gqn) * s[lay.mask:lay.mask + D]
    lam = ldl_back(L, s[lay.dg:lay.dg + D], dt * gx)
    rows = s[lay.rows:lay.rows + 2 * D * D].reshape(D, 2 * D, -1)
    jac = 0.0
    for d in range(D):
        jac = jac + lam[d] * rows[d]
    return torch.stack(lam), gqn - jac[:D], gx - jac[D:]


def adjoint_reference(scr, lay: ReplayLayout, dt: float, gq, gqd):
    """Plain version of the adjoint's phase B (csrc/dyn_rollout.cu
    `adjoint_kernel`) over the stages whose scratch scr [n, K, B] holds,
    from the last back, with the carry (gq, gqd [D, B]) of the stages after
    them. Returns (gtau [n, D, B], the carry out)."""
    D = lay.D
    gtau = scr.new_empty((scr.shape[0], D, scr.shape[2]))
    for l in range(scr.shape[0] - 1, -1, -1):
        s = scr[l]
        gqn = gq + s[lay.ox:lay.ox + D] if lay.ox >= 0 else gq
        gqdn = gqd + s[lay.odx:lay.odx + D] if lay.odx >= 0 else gqd
        gtau[l], gq, gqd = pull_stage(s, D, dt, gqn, gqdn)
    return gtau, gq, gqd


# The adjoint's scratch is capped: past it, both phases run over windows of
# stages, from the last window back, the carry handed from one window to
# the next (`_windows`). At iiwa H=50, B=4096 the scratch is about 120 MB
# in float32 and 240 MB in float64, so one window serves both.
SCRATCH_CAP_BYTES = 256 << 20


def _windows(H: int, lay: ReplayLayout, B: int, itemsize: int):
    """(window stages, the windows (h0, h1) from the last back) for H stages
    of scratch rows `lay` over B scenarios under SCRATCH_CAP_BYTES. Raises
    where one stage's scratch passes the cap."""
    per_stage = lay.K * B * itemsize
    W = min(H, SCRATCH_CAP_BYTES // per_stage, 65535)
    if W < 1:
        raise ValueError(
            f"one stage of the adjoint's scratch ({per_stage} bytes: {lay.K} rows x B={B}) "
            f"passes its cap of {SCRATCH_CAP_BYTES} bytes; split the batch")
    return W, [(max(0, h1 - W), h1) for h1 in range(H, 0, -W)]


def check_same(robot, named):
    """Each (name, tensor) is on the robot's device in its dtype."""
    for name, x in named:
        if x.dtype != robot.dtype or x.device != robot.device:
            raise ValueError(
                f"{name} is {x.dtype} on {x.device}; the robot is {robot.dtype} on {robot.device}"
            )


def _check_rollout(robot, q0T, qd0T, tauT, extra=()):
    if tauT.dim() != 3 or tauT.shape[0] == 0:
        raise ValueError(f"tauT must be [H >= 1, D, B], got {tuple(tauT.shape)}")
    H, D, B = tauT.shape
    if D == 0 or D != robot.n_dofs:
        raise ValueError(f"tauT has {D} dofs; the robot has {robot.n_dofs} (and needs >= 1)")
    for name, x, shape in (("q0T", q0T, (D, B)), ("qd0T", qd0T, (D, B)), *extra):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
    check_same(robot, [("q0T", q0T), ("qd0T", qd0T), ("tauT", tauT), *((n, x) for n, x, _ in extra)])
    return H, D, B


def ee_jacobian_t(robot: RobotStruct, qs, ps, gps, ee_link_idx: int):
    """J(q'_h)ᵀ ḡp_h for every stage at once: one chain sweep over the [H, B]
    lanes of qs [H, D, B], with the ee positions ps [H, 3, B] known."""
    consts = chain_constants(robot, ee_link_idx)
    p = (ps[:, 0], ps[:, 1], ps[:, 2])
    g = (gps[:, 0], gps[:, 1], gps[:, 2])
    rows = [torch.zeros_like(qs[:, 0]) for _ in range(robot.n_dofs)]

    def record(jt, dof, z, o):
        rows[dof] = joint_vjp(jt, z, o, p, g)

    chain_sweep(consts, lambda d: qs[:, d], qs[:, 0], record)
    return torch.stack(rows, dim=1)


def dyn_rollout_fwd_reference(robot, q0T, qd0T, tauT, dt, use_damping=True, include_gravity=True,
                              gravity=GRAVITY):
    """Plain version of `dyn_rollout_fwd`: `dynamic_rollout_dof_major`.
    Returns (qs, qds [H, D, B])."""
    _check_rollout(robot, q0T, qd0T, tauT)
    return dynamic_rollout_dof_major(
        robot, q0T, qd0T, tauT, dt, include_gravity=include_gravity, use_damping=use_damping,
        gravity=gravity,
    )


def dyn_rollout_ee_fwd_reference(robot, q0T, qd0T, tauT, dt, ee_link_idx, use_damping=True,
                                 include_gravity=True, gravity=GRAVITY):
    """Plain version of `dyn_rollout_ee_fwd`: `dynamic_rollout_dof_major` and
    the chain FK of every state. Returns (qs, qds [H, D, B], ps [H, 3, B])."""
    qs, qds = dyn_rollout_fwd_reference(
        robot, q0T, qd0T, tauT, dt, use_damping, include_gravity, gravity
    )
    consts = chain_constants(robot, ee_link_idx)
    ps = torch.stack(chain_sweep(consts, lambda d: qs[:, d], qs[:, 0]), dim=1)
    return qs, qds, ps


def _cotangent_rows(robot, gqs, qs, ps, gps, ee_link_idx):
    """The folded cotangent on every q'_h: gqs plus, with the ee trajectory,
    J(q'_h)ᵀ gps[h] (None where neither is given)."""
    if ps is None:
        return gqs
    jtg = ee_jacobian_t(robot, qs, ps, gps, ee_link_idx)
    return jtg if gqs is None else gqs + jtg


def _adjoint_reference(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, flags, ps=None, gps=None,
                       ee_link_idx=None):
    """The adjoint kernels' arithmetic in eager torch: over the windows of
    `_windows` from the last, phase A (`replay_reference`) then phase B
    (`adjoint_reference`); the cotangent of q'_h is the carry plus gqs[h]
    plus J^T gps[h] (with ps), that of qd'_h the carry plus gqds[h]; an
    absent one counts as zeros. Returns (gtau [H, D, B], gq0, gqd0)."""
    H, D, B = tauT.shape
    lay = replay_layout(D, gqs is not None or ps is not None, gqds is not None)
    _, windows = _windows(H, lay, B, tauT.element_size())
    q_in, qd_in = _states_before(q0T, qs), _states_before(qd0T, qds)
    gq, gqd = torch.zeros_like(q0T), torch.zeros_like(q0T)
    gtau = torch.empty_like(tauT)
    for h0, h1 in windows:
        w = slice(h0, h1)
        gqx = _cotangent_rows(robot, None if gqs is None else gqs[w], qs[w],
                              None if ps is None else ps[w], None if gps is None else gps[w],
                              ee_link_idx)
        scr = replay_reference(robot, q_in[w], qd_in[w], tauT[w], flags, gqx,
                               None if gqds is None else gqds[w])
        gtau[w], gq, gqd = adjoint_reference(scr, lay, flags.dt, gq, gqd)
    return gtau, gq, gqd


def _bwd_shapes(tauT, qs, qds, gqs, gqds, ps=None, gps=None):
    """The adjoint's operands with the shapes `_check_rollout` holds them to
    (the absent cotangents left out)."""
    H, D, B = tauT.shape if tauT.dim() == 3 else (1, 0, 0)
    ee = (("ps", ps, (H, 3, B)), ("gps", gps, (H, 3, B))) if ps is not None else ()
    state = tuple((n, x, (H, D, B)) for n, x in (("gqs", gqs), ("gqds", gqds)) if x is not None)
    return (("qs", qs, (H, D, B)), ("qds", qds, (H, D, B)), *ee, *state)


def dyn_rollout_bwd_reference(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, dt, use_damping=True,
                              include_gravity=True, gravity=GRAVITY):
    """Plain version of `dyn_rollout_bwd`: the VJP of the rollout for the
    cotangents gqs on qs and gqds on qds ([H, D, B] each, or None for
    zeros). Returns (gtau [H, D, B], gq0, gqd0 [D, B])."""
    _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds))
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    return _adjoint_reference(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, flags)


def dyn_rollout_ee_bwd_reference(robot, q0T, qd0T, tauT, qs, qds, ps, gps, dt, ee_link_idx,
                                 use_damping=True, include_gravity=True, gravity=GRAVITY,
                                 gqs=None, gqds=None):
    """Plain version of `dyn_rollout_ee_bwd`: the VJP of the rollout with the
    ee trajectory for the ee cotangents gps [H, 3, B], pulled back by the
    geometric Jacobian, and optionally gqs on qs and gqds on qds. Returns
    (gtau [H, D, B], gq0, gqd0 [D, B])."""
    _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds, ps, gps))
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    return _adjoint_reference(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, flags, ps, gps,
                              ee_link_idx)


def _states_before(x0, xs):
    """Each stage's incoming state: x0, then the saved states but the last."""
    return torch.cat([x0[None], xs[:-1]])


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------


def _configure(lib: ctypes.CDLL) -> None:
    sizes = (ctypes.c_int64 * 10)()
    lib.dyn_rollout_layout.argtypes = [ctypes.c_void_p]
    lib.dyn_rollout_layout.restype = None
    lib.dyn_rollout_layout(sizes)
    expect = (
        ctypes.sizeof(TREE_CTYPES[torch.float32]),
        ctypes.sizeof(TREE_CTYPES[torch.float64]),
        ctypes.sizeof(CHAIN_CTYPES[torch.float32]),
        ctypes.sizeof(CHAIN_CTYPES[torch.float64]),
        MAX_LINKS,
    )
    if tuple(sizes[:5]) != expect:
        raise RuntimeError(f"csrc/dyn_rollout.cu layout {tuple(sizes[:5])} != Python's {expect}")
    _check_variants(sizes[:9], 5, "csrc/dyn_rollout.cu")
    if sizes[9] != replay_layout(7, False, False).K:
        raise RuntimeError(f"csrc/dyn_rollout.cu lays out {sizes[9]} scratch rows for 7 dofs, "
                           f"Python {replay_layout(7, False, False).K}")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # (leading ints, pointers, trailing ints) of each entry, then B and the stream
    shapes = {"dyn_rollout_fwd": (1, 6, 1), "dyn_rollout_ee_fwd": (1, 8, 1),
              "dyn_rollout_replay": (1, 12, 5), "dyn_rollout_adjoint": (1, 5, 6)}
    for name, (lead, n, trail) in shapes.items():
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = [i] * lead + [p] * n + [i] * trail + [i64, p]
            fn.restype = ctypes.c_int
    lib.dyn_rollout_fwd_one_thread_from.argtypes = []
    lib.dyn_rollout_fwd_one_thread_from.restype = i64


def _launch(name, args, dev):
    lib = build.load("dyn_rollout", _configure)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def fwd_one_thread_from(device) -> int:
    """The least batch at which K5/K7 on a serial chain run one thread a
    scenario on the CUDA `device` (`use_group`, csrc/dyn_rollout.cu);
    below it each scenario's step runs on a group of lanes."""
    lib = build.load("dyn_rollout", _configure)
    with torch.cuda.device(device):
        return int(lib.dyn_rollout_fwd_one_thread_from())


def _ptr(x):
    """A tensor's device pointer, or NULL for an absent cotangent."""
    return None if x is None else x.data_ptr()


def _check_all_cuda(named):
    for name, x in named:
        if x is not None:
            _check_cuda(x, name)


def _fwd_launch(robot, flags, ee_link_idx, q0T, qd0T, tauT, outs):
    """Launch K5 (`ee_link_idx` None; outs qs, qds) or K7 (outs qs, qds, ps)
    on the build `kernel_variant` picks for the robot."""
    H, D, B = tauT.shape
    structs = (ctypes.byref(tree_struct(robot, flags)),)
    name = "dyn_rollout_fwd"
    if ee_link_idx is not None:
        structs += (ctypes.byref(chain_struct(robot, ee_link_idx)),)
        name = "dyn_rollout_ee_fwd"
    _launch(
        f"{name}_{_suffix(tauT.dtype)}",
        (variant_code(robot), *structs,
         *(x.data_ptr() for x in (q0T, qd0T, tauT, *outs)), H, B),
        tauT.device,
    )


def dyn_rollout_fwd(robot, q0T, qd0T, tauT, dt, use_damping=True, include_gravity=True,
                    gravity=GRAVITY):
    """Kernel `dyn_rollout_fwd`: H steps from (q0T, qd0T [D, B]) under
    tauT [H, D, B]; returns (qs, qds [H, D, B]), the state after each step."""
    H, D, B = _check_rollout(robot, q0T, qd0T, tauT)
    if q0T.device.type == "cpu":
        return dyn_rollout_fwd_reference(
            robot, q0T, qd0T, tauT, dt, use_damping, include_gravity, gravity
        )
    _check_all_cuda((("q0T", q0T), ("qd0T", qd0T), ("tauT", tauT)))
    qs, qds = torch.empty_like(tauT), torch.empty_like(tauT)
    if B:
        _fwd_launch(robot, StepFlags(dt, use_damping, include_gravity, gravity), None, q0T, qd0T,
                    tauT, (qs, qds))
        dyn_rollout_fwd.launches += 1
    return qs, qds


dyn_rollout_fwd.launches = 0


def dyn_rollout_ee_fwd(robot, q0T, qd0T, tauT, dt, ee_link_idx, use_damping=True,
                       include_gravity=True, gravity=GRAVITY):
    """Kernel `dyn_rollout_ee_fwd`: H steps from (q0T, qd0T [D, B]) under
    tauT [H, D, B]; returns (qs, qds [H, D, B], ps [H, 3, B]), the state and
    the ee position after each step."""
    H, D, B = _check_rollout(robot, q0T, qd0T, tauT)
    if q0T.device.type == "cpu":
        return dyn_rollout_ee_fwd_reference(
            robot, q0T, qd0T, tauT, dt, ee_link_idx, use_damping, include_gravity, gravity
        )
    _check_all_cuda((("q0T", q0T), ("qd0T", qd0T), ("tauT", tauT)))
    qs, qds = torch.empty_like(tauT), torch.empty_like(tauT)
    ps = torch.empty((H, 3, B), dtype=tauT.dtype, device=tauT.device)
    if B:
        _fwd_launch(robot, StepFlags(dt, use_damping, include_gravity, gravity), ee_link_idx, q0T,
                    qd0T, tauT, (qs, qds, ps))
        dyn_rollout_ee_fwd.launches += 1
    return qs, qds, ps


dyn_rollout_ee_fwd.launches = 0


def _bwd_operands(robot, flags, ee_link_idx, ins):
    """The kernels' constants, scratch layout and instantiation for a
    backward call on `ins` (q0T, qd0T, tauT, qs, qds, ps, gps, gqs, gqds,
    the absent ones None)."""
    ps, gqs, gqds = ins[5], ins[7], ins[8]
    tree = tree_struct(robot, flags)
    ch = None if ps is None else chain_struct(robot, ee_link_idx)
    lay = replay_layout(robot.n_dofs, gqs is not None or ps is not None, gqds is not None)
    return tree, ch, lay, variant_code(robot)


def _replay_launch(tree, ch, variant, lay, ins, scr, h0, nh, B, dev):
    """Phase A of stages h0 ... h0 + nh - 1 into scr. `ins` are (q0T, qd0T,
    tauT, qs, qds, ps, gps, gqs, gqds), the absent ones None."""
    _launch(
        f"dyn_rollout_replay_{_suffix(scr.dtype)}",
        (variant, ctypes.byref(tree), None if ch is None else ctypes.byref(ch),
         *(_ptr(x) for x in ins), scr.data_ptr(), h0, nh, lay.K, lay.ox, lay.odx, B),
        dev,
    )


def _adjoint_launch(tree, variant, lay, scr, gtau, gq0, gqd0, h0, nh, carry_in, B, dev):
    """Phase B of stages h0 + nh - 1 ... h0 from scr; the carry in and out
    in gq0, gqd0."""
    _launch(
        f"dyn_rollout_adjoint_{_suffix(scr.dtype)}",
        (variant, ctypes.byref(tree), scr.data_ptr(), gtau.data_ptr(), gq0.data_ptr(),
         gqd0.data_ptr(), h0, nh, lay.K, lay.ox, lay.odx, int(carry_in), B),
        dev,
    )


def _bwd_kernels(robot, flags, ee_link_idx, q0T, qd0T, tauT, qs, qds, ps, gps, gqs, gqds):
    """The adjoint on the card: per window of `_windows` from the last,
    phase A then phase B, on the current stream. Returns (gtau, gq0, gqd0)
    and the device launches made."""
    H, D, B = tauT.shape
    ins = (q0T, qd0T, tauT, qs, qds, ps, gps, gqs, gqds)
    tree, ch, lay, variant = _bwd_operands(robot, flags, ee_link_idx, ins)
    W, windows = _windows(H, lay, B, tauT.element_size())
    gtau = torch.empty_like(tauT)
    gq0, gqd0 = torch.empty_like(q0T), torch.empty_like(q0T)
    scr = torch.empty((W, lay.K, B), dtype=tauT.dtype, device=tauT.device)
    for h0, h1 in windows:
        _replay_launch(tree, ch, variant, lay, ins, scr, h0, h1 - h0, B, tauT.device)
        _adjoint_launch(tree, variant, lay, scr, gtau, gq0, gqd0, h0, h1 - h0, h1 != H, B,
                        tauT.device)
    return (gtau, gq0, gqd0), 2 * len(windows)


def dyn_rollout_replay_reference(robot, q0T, qd0T, tauT, qs, qds, dt, use_damping=True,
                                 include_gravity=True, gravity=GRAVITY, gqs=None, gqds=None,
                                 ps=None, gps=None, ee_link_idx=None):
    """Plain version of `dyn_rollout_replay`: `replay_reference` over every
    stage."""
    _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds, ps, gps))
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    gqx = _cotangent_rows(robot, gqs, qs, ps, gps, ee_link_idx)
    return replay_reference(robot, _states_before(q0T, qs), _states_before(qd0T, qds), tauT, flags,
                            gqx, gqds)


def dyn_rollout_replay(robot, q0T, qd0T, tauT, qs, qds, dt, use_damping=True,
                       include_gravity=True, gravity=GRAVITY, gqs=None, gqds=None, ps=None,
                       gps=None, ee_link_idx=None):
    """The adjoints' phase A alone (kernel `replay_kernel`), over every stage
    at once: the scratch [H, K, B] of `replay_layout(D, gqs or ps given,
    gqds given)`. With ps, gps and ee_link_idx the folded cotangent rows
    hold J^T gps, as for `dyn_rollout_ee_bwd`. For holding the kernel's
    phase A to its plain version, timing it, and the iLQR dynamics
    Jacobians (trajopt/solvers.py `make_ift_f_AB`). Raises for a revolute
    joint whose axis is not of unit length (the rows' reverse sweeps assume
    one)."""
    H, D, B = _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds, ps, gps))
    check_unit_axes(robot, range(1, robot.n_links), "dyn_rollout_replay")
    if q0T.device.type == "cpu":
        return dyn_rollout_replay_reference(robot, q0T, qd0T, tauT, qs, qds, dt, use_damping,
                                            include_gravity, gravity, gqs, gqds, ps, gps,
                                            ee_link_idx)
    ins = (q0T, qd0T, tauT, qs, qds, ps, gps, gqs, gqds)
    _check_all_cuda(zip(("q0T", "qd0T", "tauT", "qs", "qds", "ps", "gps", "gqs", "gqds"), ins))
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    tree, ch, lay, variant = _bwd_operands(robot, flags, ee_link_idx, ins)
    scr = torch.empty((H, lay.K, B), dtype=tauT.dtype, device=tauT.device)
    if B:
        _replay_launch(tree, ch, variant, lay, ins, scr, 0, H, B, tauT.device)
        dyn_rollout_replay.launches += 1
    return scr


dyn_rollout_replay.launches = 0


def _check_scratch(robot, scr, gqx, gqdx):
    lay = replay_layout(robot.n_dofs, gqx, gqdx)
    if scr.dim() != 3 or scr.shape[1] != lay.K:
        raise ValueError(f"scr must be [H, {lay.K}, B], got {tuple(scr.shape)}")
    check_same(robot, [("scr", scr)])
    return lay


def dyn_rollout_adjoint_reference(robot, scr, dt, gqx: bool, gqdx: bool):
    """Plain version of `dyn_rollout_adjoint`: `adjoint_reference` from a
    zero carry."""
    lay = _check_scratch(robot, scr, gqx, gqdx)
    zero = scr.new_zeros((lay.D, scr.shape[2]))
    return adjoint_reference(scr, lay, dt, zero, zero)


def dyn_rollout_adjoint(robot, scr, dt, gqx: bool, gqdx: bool, use_damping=True,
                        include_gravity=True, gravity=GRAVITY):
    """The adjoints' phase B alone (kernel `adjoint_kernel`), over every
    stage of the scratch scr [H, K, B] of `dyn_rollout_replay`, laid out
    with or without the folded cotangent rows: (gtau [H, D, B], gq0,
    gqd0)."""
    if scr.device.type == "cpu":
        return dyn_rollout_adjoint_reference(robot, scr, dt, gqx, gqdx)
    lay = _check_scratch(robot, scr, gqx, gqdx)
    _check_cuda(scr, "scr")
    H, _, B = scr.shape
    tree = tree_struct(robot, StepFlags(dt, use_damping, include_gravity, gravity))
    gtau = scr.new_empty((H, lay.D, B))
    gq0, gqd0 = scr.new_empty((lay.D, B)), scr.new_empty((lay.D, B))
    if B:
        _adjoint_launch(tree, variant_code(robot), lay, scr.contiguous(), gtau,
                        gq0, gqd0, 0, H, False, B, scr.device)
    return gtau, gq0, gqd0


def dyn_rollout_bwd(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, dt, use_damping=True,
                    include_gravity=True, gravity=GRAVITY):
    """Kernel `dyn_rollout_bwd`: the VJP of `dyn_rollout_fwd` for the
    cotangents gqs on qs and gqds on qds ([H, D, B] each; either may be None,
    and then no tensor is read for it), from its saved outputs, in two
    phases a window (module docstring). Returns (gtau [H, D, B], gq0, gqd0
    [D, B]). Raises for a revolute joint whose axis is not of unit length."""
    H, D, B = _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds))
    check_unit_axes(robot, range(1, robot.n_links), "dyn_rollout_bwd")
    if q0T.device.type == "cpu":
        return dyn_rollout_bwd_reference(
            robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, dt, use_damping, include_gravity, gravity
        )
    ins = (("q0T", q0T), ("qd0T", qd0T), ("tauT", tauT), ("qs", qs), ("qds", qds),
           ("gqs", gqs), ("gqds", gqds))
    _check_all_cuda(ins)
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    if not B:
        return torch.empty_like(tauT), torch.empty_like(q0T), torch.empty_like(q0T)
    out, n = _bwd_kernels(robot, flags, None, q0T, qd0T, tauT, qs, qds, None, None, gqs, gqds)
    dyn_rollout_bwd.launches += 1
    dyn_rollout_bwd.device_launches += n
    return out


dyn_rollout_bwd.launches = 0
dyn_rollout_bwd.device_launches = 0


def dyn_rollout_ee_bwd(robot, q0T, qd0T, tauT, qs, qds, ps, gps, dt, ee_link_idx,
                       use_damping=True, include_gravity=True, gravity=GRAVITY,
                       gqs=None, gqds=None):
    """Kernel `dyn_rollout_ee_bwd`: the VJP of `dyn_rollout_ee_fwd` for ee
    cotangents gps [H, 3, B] and, optionally, gqs on qs and gqds on qds
    ([H, D, B]; None reads no tensor), from its saved outputs, in two phases
    a window (module docstring). Returns (gtau [H, D, B], gq0, gqd0 [D,
    B]). Raises for a revolute joint whose axis is not of unit length."""
    H, D, B = _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds, ps, gps))
    check_unit_axes(robot, range(1, robot.n_links), "dyn_rollout_ee_bwd")
    if q0T.device.type == "cpu":
        return dyn_rollout_ee_bwd_reference(
            robot, q0T, qd0T, tauT, qs, qds, ps, gps, dt, ee_link_idx, use_damping,
            include_gravity, gravity, gqs, gqds,
        )
    ins = (("q0T", q0T), ("qd0T", qd0T), ("tauT", tauT), ("qs", qs), ("qds", qds),
           ("ps", ps), ("gps", gps), ("gqs", gqs), ("gqds", gqds))
    _check_all_cuda(ins)
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    if not B:
        return torch.empty_like(tauT), torch.empty_like(q0T), torch.empty_like(q0T)
    out, n = _bwd_kernels(robot, flags, ee_link_idx, q0T, qd0T, tauT, qs, qds, ps, gps, gqs, gqds)
    dyn_rollout_ee_bwd.launches += 1
    dyn_rollout_ee_bwd.device_launches += n
    return out


dyn_rollout_ee_bwd.launches = 0
dyn_rollout_ee_bwd.device_launches = 0


def _contiguous(g):
    return None if g is None else g.contiguous()


class DynamicRollout(torch.autograd.Function):
    """`dyn_rollout_fwd` forward, `dyn_rollout_bwd` backward for any pattern
    of cotangents on (qs, qds), w.r.t. (q0T, qd0T, tauT); the robot is
    constant."""

    @staticmethod
    def forward(ctx, q0T, qd0T, tauT, robot, flags):
        check_constant_robot(robot)
        qs, qds = dyn_rollout_fwd(robot, q0T, qd0T, tauT, **dataclasses.asdict(flags))
        ctx.save_for_backward(q0T, qd0T, tauT, qs, qds)
        ctx.args = (robot, flags)
        ctx.set_materialize_grads(False)
        return qs, qds

    @staticmethod
    def backward(ctx, gqs, gqds):
        none = (None, None)
        if gqs is None and gqds is None:
            return (None, None, None) + none
        robot, flags = ctx.args
        gtau, gq0, gqd0 = dyn_rollout_bwd(
            robot, *ctx.saved_tensors, _contiguous(gqs), _contiguous(gqds), **dataclasses.asdict(flags)
        )
        return (gq0, gqd0, gtau) + none


class DynamicRolloutEE(torch.autograd.Function):
    """`dyn_rollout_ee_fwd` forward; backward `dyn_rollout_ee_bwd` when the ee
    trajectory has a cotangent, else `dyn_rollout_bwd`, for any pattern of
    cotangents on (qs, qds, ps), w.r.t. (q0T, qd0T, tauT); the robot is
    constant."""

    @staticmethod
    def forward(ctx, q0T, qd0T, tauT, robot, flags, ee_link_idx):
        check_constant_robot(robot)
        qs, qds, ps = dyn_rollout_ee_fwd(robot, q0T, qd0T, tauT, ee_link_idx=ee_link_idx,
                                         **dataclasses.asdict(flags))
        ctx.save_for_backward(q0T, qd0T, tauT, qs, qds, ps)
        ctx.args = (robot, flags, ee_link_idx)
        ctx.set_materialize_grads(False)
        return qs, qds, ps

    @staticmethod
    def backward(ctx, gqs, gqds, gps):
        none = (None,) * 3
        if gqs is None and gqds is None and gps is None:
            return (None, None, None) + none
        robot, flags, ee = ctx.args
        q0T, qd0T, tauT, qs, qds, ps = ctx.saved_tensors
        gqs, gqds = _contiguous(gqs), _contiguous(gqds)
        if gps is None:
            gtau, gq0, gqd0 = dyn_rollout_bwd(
                robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, **dataclasses.asdict(flags)
            )
        else:
            gtau, gq0, gqd0 = dyn_rollout_ee_bwd(
                robot, q0T, qd0T, tauT, qs, qds, ps, gps.contiguous(), ee_link_idx=ee,
                gqs=gqs, gqds=gqds, **dataclasses.asdict(flags),
            )
        return (gq0, gqd0, gtau) + none


def _effort_box(robot, tauT, respect_effort_limits):
    """The URDF effort box on the torques, before the kernel (JAX's clip and
    its tie rule)."""
    if not respect_effort_limits:
        return tauT
    emax = _effort_bound(robot, 1)
    return _clip(tauT, -emax, emax)


def dynamic_rollout(robot: RobotStruct, q0T, qd0T, tauT, dt: float, include_gravity: bool = True,
                    use_damping: bool = True, gravity: float = GRAVITY,
                    respect_effort_limits: bool = False):
    """(qs, qds [H, D, B]) of H forward-dynamics steps from (q0T, qd0T [D, B])
    under tauT [H, D, B], differentiable w.r.t. (q0T, qd0T, tauT) through
    both outputs: the counterpart of the JAX package's
    `dynamic_rollout_pallas`. For a robot whose tensors require grad it
    takes the plain differentiable rollout (`dynamic_rollout_dof_major`)
    instead, decided here before any launch, as the JAX package's falls
    back to its scan for a traced robot."""
    tauT = _effort_box(robot, tauT, respect_effort_limits)
    if robot.requires_grad:
        return dynamic_rollout_dof_major(robot, q0T, qd0T, tauT, dt, include_gravity=include_gravity,
                                         use_damping=use_damping, gravity=gravity)
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    return DynamicRollout.apply(q0T, qd0T, tauT, robot, flags)


def dynamic_rollout_ee(robot: RobotStruct, q0T, qd0T, tauT, dt: float, ee_link_idx: int,
                       include_gravity: bool = True, use_damping: bool = True,
                       gravity: float = GRAVITY):
    """(qs, qds [H, D, B], ps [H, 3, B]) of H forward-dynamics steps with the
    ee trajectory, differentiable w.r.t. (q0T, qd0T, tauT) through all three
    outputs: the `"kernel"` engine's rollout, the counterpart of the JAX
    package's `dynamic_rollout_ee_pallas`. For a robot whose tensors
    require grad it takes the plain differentiable rollout and the scalar
    FK instead, decided here before any launch, as the JAX package's falls
    back to its scan for a traced robot."""
    if robot.requires_grad:
        qs, qds = dynamic_rollout_dof_major(robot, q0T, qd0T, tauT, dt, include_gravity=include_gravity,
                                            use_damping=use_damping, gravity=gravity)
        H, D, B = qs.shape
        p = fk_link_position_dof_first(robot, qs.transpose(0, 1).reshape(D, H * B), ee_link_idx)
        return qs, qds, p.reshape(3, H, B).transpose(0, 1)
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    return DynamicRolloutEE.apply(q0T, qd0T, tauT, robot, flags, ee_link_idx)
