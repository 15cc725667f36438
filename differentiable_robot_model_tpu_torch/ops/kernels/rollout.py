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
implicit-function identity (`StepReplay`): with Ĥ = M(q) + dt diag(d) and
qdd* the step's acceleration,

    x̄ = (ḡqd' + dt ḡq') * dclip(x),   λ = Ĥ⁻¹ (dt x̄),   τ̄ = λ,
    q̄ = ḡq' - (∂RNEA(q, qd, qdd*)/∂q)ᵀ λ,   q̄d = x̄ - (∂RNEA/∂qd)ᵀ λ,

where ḡq' holds the cotangent on qs plus J(q')ᵀ ḡp from the ee FK, and ḡqd'
the cotangent on qds. The RNEA partials come from 2D forward-mode tangents
(duals) through the RNEA sweeps. The adjoint kernels take the cotangents on
qs and qds each optionally, so every cotangent pattern JAX's custom VJPs
accept runs on a kernel.

Bound on the H100: per scenario and step the function needs one RNEA, one
composite-rigid-body mass matrix, an LDL^T factor and solve (and one chain
FK for the ee pair); the adjoint a replay of the step, one more solve, the
RNEA partials (and the J^T g sweep): a few thousand FP32 operations for
iiwa over a few hundred bytes, so operations bound it. One thread per
scenario runs the whole horizon with the state in registers and local
memory; at B=4096 that is one warp per SM, so each thread's dependent chain
sets the time.

On a CUDA tensor the wrappers launch the kernel or raise; they take the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes
import dataclasses

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
    fixed_rotation,
    joint_vjp,
)

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
    forward-mode number type that `rnea_jacobians` runs the RNEA sweeps on
    (csrc/dyn_step.cuh carries one tangent per sweep instead)."""

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


class StepReplay:
    """The steps (q_h, qd_h, tau_h) -> (q'_h, qd'_h) of a rollout replayed
    for its adjoint, batched over the stages: q, qd, tau are [H, D, B].

    The replay (RNEA bias, mass matrix, the LDL^T factor of Ĥ, qdd*, the
    clamp's mask and the RNEA partials) needs only the saved states, so it
    runs once on [H, B] lanes; `pull(h, ...)` is then the adjoint of stage h
    by the implicit-function identity (module docstring), the kernel's
    arithmetic element for element."""

    def __init__(self, robot: RobotStruct, q, qd, tau, flags: StepFlags):
        D = robot.n_dofs
        qT, qdT = q.transpose(0, 1), qd.transpose(0, 1)  # [D, H, B]
        self.dt, self.D = flags.dt, D
        nle = rnea_scalar(robot, qT, qdT, torch.zeros_like(qT), flags.include_gravity,
                          flags.use_damping, flags.gravity)
        M = mass_matrix_scalar(robot, qT)
        rows = [[M[i][j] for j in range(D)] for i in range(D)]
        if flags.use_damping:
            for d in range(D):
                rows[d][d] = rows[d][d] + flags.dt * robot.damping[d]
        self.L, self.dg = ldl_factor(rows)
        qdd = ldl_back(self.L, self.dg, tau.transpose(0, 1) - nle)
        vmax = _velocity_bound(robot, 2)
        x = qdT + flags.dt * torch.stack(qdd)
        self.mask = _clip_grad(x, -vmax, vmax)  # [D, H, B]
        self.jac = rnea_jacobians(robot, qT, qdT, qdd, flags.use_damping, flags.include_gravity,
                                  flags.gravity)

    def pull(self, h: int, gqn, gqdn):
        """(τ̄, q̄, q̄d) of stage h for the cotangents gqn on q' and gqdn on
        qd' ([D, B] each)."""
        D, dt = self.D, self.dt
        L_h = [[None if e is None else e[h] for e in row] for row in self.L]
        gx = (gqdn + dt * gqn) * self.mask[:, h]
        lam = ldl_back(L_h, [d[h] for d in self.dg], dt * gx)
        jac = 0.0
        for d in range(D):
            jac = jac + lam[d] * self.jac[d][:, h]
        return torch.stack(lam), gqn - jac[:D], gx - jac[D:]


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


def _adjoint_reference(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, flags, jtg=None):
    """The adjoint kernels' arithmetic in eager torch, stage by stage from
    the last (`StepReplay.pull`): the cotangent of q'_h is the carry plus
    gqs[h] plus jtg[h] (J^T gps[h]), that of qd'_h the carry plus gqds[h];
    an absent one counts as zeros. Returns (gtau [H, D, B], gq0, gqd0)."""
    replay = StepReplay(robot, _states_before(q0T, qs), _states_before(qd0T, qds), tauT, flags)
    gq, gqd = torch.zeros_like(q0T), torch.zeros_like(q0T)
    gtau = torch.empty_like(tauT)
    for h in range(tauT.shape[0] - 1, -1, -1):
        gqn = gq if gqs is None else gq + gqs[h]
        if jtg is not None:
            gqn = gqn + jtg[h]
        gqdn = gqd if gqds is None else gqd + gqds[h]
        gtau[h], gq, gqd = replay.pull(h, gqn, gqdn)
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
    jtg = ee_jacobian_t(robot, qs, ps, gps, ee_link_idx)
    return _adjoint_reference(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, flags, jtg)


def _states_before(x0, xs):
    """Each stage's incoming state: x0, then the saved states but the last."""
    return torch.cat([x0[None], xs[:-1]])


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------


def _configure(lib: ctypes.CDLL) -> None:
    sizes = (ctypes.c_int64 * 5)()
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
    if tuple(sizes) != expect:
        raise RuntimeError(f"csrc/dyn_rollout.cu layout {tuple(sizes)} != Python's {expect}")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    n_ptrs = {"dyn_rollout_fwd": 6, "dyn_rollout_ee_fwd": 8, "dyn_rollout_bwd": 11,
              "dyn_rollout_ee_bwd": 14}
    for name, n in n_ptrs.items():
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = [p] * n + [i, i64, p]
            fn.restype = ctypes.c_int


def _launch(name, args, dev):
    lib = build.load("dyn_rollout", _configure)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _ptr(x):
    """A tensor's device pointer, or NULL for an absent cotangent."""
    return None if x is None else x.data_ptr()


def _check_all_cuda(named):
    for name, x in named:
        if x is not None:
            _check_cuda(x, name)


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
    tree = tree_struct(robot, StepFlags(dt, use_damping, include_gravity, gravity))
    qs, qds = torch.empty_like(tauT), torch.empty_like(tauT)
    if B:
        _launch(
            f"dyn_rollout_fwd_{_suffix(tauT.dtype)}",
            (ctypes.byref(tree), q0T.data_ptr(), qd0T.data_ptr(), tauT.data_ptr(),
             qs.data_ptr(), qds.data_ptr(), H, B),
            tauT.device,
        )
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
    tree = tree_struct(robot, StepFlags(dt, use_damping, include_gravity, gravity))
    ch = chain_struct(robot, ee_link_idx)
    qs, qds = torch.empty_like(tauT), torch.empty_like(tauT)
    ps = torch.empty((H, 3, B), dtype=tauT.dtype, device=tauT.device)
    if B:
        _launch(
            f"dyn_rollout_ee_fwd_{_suffix(tauT.dtype)}",
            (ctypes.byref(tree), ctypes.byref(ch), q0T.data_ptr(), qd0T.data_ptr(),
             tauT.data_ptr(), qs.data_ptr(), qds.data_ptr(), ps.data_ptr(), H, B),
            tauT.device,
        )
        dyn_rollout_ee_fwd.launches += 1
    return qs, qds, ps


dyn_rollout_ee_fwd.launches = 0


def dyn_rollout_bwd(robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, dt, use_damping=True,
                    include_gravity=True, gravity=GRAVITY):
    """Kernel `dyn_rollout_bwd`: the VJP of `dyn_rollout_fwd` for the
    cotangents gqs on qs and gqds on qds ([H, D, B] each; either may be None,
    and then no tensor is read for it), from its saved outputs. Returns
    (gtau [H, D, B], gq0, gqd0 [D, B])."""
    H, D, B = _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds))
    if q0T.device.type == "cpu":
        return dyn_rollout_bwd_reference(
            robot, q0T, qd0T, tauT, qs, qds, gqs, gqds, dt, use_damping, include_gravity, gravity
        )
    ins = (("q0T", q0T), ("qd0T", qd0T), ("tauT", tauT), ("qs", qs), ("qds", qds),
           ("gqs", gqs), ("gqds", gqds))
    _check_all_cuda(ins)
    tree = tree_struct(robot, StepFlags(dt, use_damping, include_gravity, gravity))
    gtau = torch.empty_like(tauT)
    gq0, gqd0 = torch.empty_like(q0T), torch.empty_like(q0T)
    if B:
        _launch(
            f"dyn_rollout_bwd_{_suffix(tauT.dtype)}",
            (ctypes.byref(tree), *(_ptr(x) for _, x in ins),
             gtau.data_ptr(), gq0.data_ptr(), gqd0.data_ptr(), H, B),
            tauT.device,
        )
        dyn_rollout_bwd.launches += 1
    return gtau, gq0, gqd0


dyn_rollout_bwd.launches = 0


def dyn_rollout_ee_bwd(robot, q0T, qd0T, tauT, qs, qds, ps, gps, dt, ee_link_idx,
                       use_damping=True, include_gravity=True, gravity=GRAVITY,
                       gqs=None, gqds=None):
    """Kernel `dyn_rollout_ee_bwd`: the VJP of `dyn_rollout_ee_fwd` for ee
    cotangents gps [H, 3, B] and, optionally, gqs on qs and gqds on qds
    ([H, D, B]; None reads no tensor), from its saved outputs. Returns (gtau
    [H, D, B], gq0, gqd0 [D, B])."""
    H, D, B = _check_rollout(robot, q0T, qd0T, tauT, _bwd_shapes(tauT, qs, qds, gqs, gqds, ps, gps))
    if q0T.device.type == "cpu":
        return dyn_rollout_ee_bwd_reference(
            robot, q0T, qd0T, tauT, qs, qds, ps, gps, dt, ee_link_idx, use_damping,
            include_gravity, gravity, gqs, gqds,
        )
    ins = (("q0T", q0T), ("qd0T", qd0T), ("tauT", tauT), ("qs", qs), ("qds", qds),
           ("ps", ps), ("gps", gps), ("gqs", gqs), ("gqds", gqds))
    _check_all_cuda(ins)
    tree = tree_struct(robot, StepFlags(dt, use_damping, include_gravity, gravity))
    ch = chain_struct(robot, ee_link_idx)
    gtau = torch.empty_like(tauT)
    gq0, gqd0 = torch.empty_like(q0T), torch.empty_like(q0T)
    if B:
        _launch(
            f"dyn_rollout_ee_bwd_{_suffix(tauT.dtype)}",
            (ctypes.byref(tree), ctypes.byref(ch), *(_ptr(x) for _, x in ins),
             gtau.data_ptr(), gq0.data_ptr(), gqd0.data_ptr(), H, B),
            tauT.device,
        )
        dyn_rollout_ee_bwd.launches += 1
    return gtau, gq0, gqd0


dyn_rollout_ee_bwd.launches = 0


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
    `dynamic_rollout_pallas`. Raises if a robot tensor the kernels read
    requires grad."""
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    tauT = _effort_box(robot, tauT, respect_effort_limits)
    return DynamicRollout.apply(q0T, qd0T, tauT, robot, flags)


def dynamic_rollout_ee(robot: RobotStruct, q0T, qd0T, tauT, dt: float, ee_link_idx: int,
                       include_gravity: bool = True, use_damping: bool = True,
                       gravity: float = GRAVITY):
    """(qs, qds [H, D, B], ps [H, 3, B]) of H forward-dynamics steps with the
    ee trajectory, differentiable w.r.t. (q0T, qd0T, tauT) through all three
    outputs: the `"kernel"` engine's rollout, the counterpart of the JAX
    package's `dynamic_rollout_ee_pallas`. Raises if a robot tensor the
    kernels read requires grad."""
    flags = StepFlags(dt, use_damping, include_gravity, gravity)
    return DynamicRolloutEE.apply(q0T, qd0T, tauT, robot, flags, ee_link_idx)
