"""Chain FK of one link for a dof-major batch: kernels K1 `fk_fwd` and K2
`fk_bwd` (csrc/fk.cu), their plain PyTorch versions, and the autograd entry.

Replaces the JAX package's ops/pallas/fk.py `_fwd_kernel`
(world position of one link, the root->link chain unrolled) and
`_bwd_kernel` (its VJP w.r.t. q by replay: g.(z_l x (p - o_l)) for a
revolute joint, g.z_l for a prismatic one).

Bound on the H100: per configuration the function needs one sincos and a
few dozen FP32 operations per revolute link once the robot's zero and unit
constants are folded, and moves (D + 3) * 4 bytes (K1) or (2 D + 3) * 4
bytes (K2), so the bytes bound it, and at small M the launch latency. The
kernels sweep the chain unrolled over a compile-time bound of 8 or 16
links; a joint whose axis is exactly +-e_k (each link's `axes` kind,
computed here) turns by a planar rotation, and K2 keeps each revolute
joint's record in registers and sweeps once (csrc/fk.cu). The robot's
constants reach the kernel as one by-value `Chain` argument (built here by
`chain_constants`), so one build serves every robot; the TPU kernels bake
them in as immediates instead.

On a CUDA tensor the wrappers launch the kernel or raise; they take the
plain version only for a tensor on the CPU. The autograd entry
`fk_position_dof_major` also takes the plain differentiable FK for a robot
whose tensors require grad, as the JAX package's wrapper does for a traced
robot.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from ...models.structs import JOINT_FIXED, JOINT_PRISMATIC, JOINT_REVOLUTE, RobotStruct, _axis_codes_of
from ..kinematics import fk_link_position_dof_first
from . import build

# Must match DRM_MAX_CHAIN / DRM_MAX_DOF in csrc/chain.cuh (checked at load).
MAX_CHAIN = 16
MAX_DOF = 32

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def chain_to(robot: RobotStruct, link_idx: int) -> list:
    """Static ancestor chain root -> link_idx (root excluded)."""
    chain = []
    l = link_idx
    while l != 0:
        chain.append(l)
        l = robot.parent[l]
    return chain[::-1]


@dataclasses.dataclass(frozen=True)
class ChainConsts:
    """Per chain link: joint type, dof, axis kind (`axis_kind`), F (fixed
    rpy rotation, row major), axis a, F@a and translation t, each value
    rounded to the struct's dtype (held as Python floats)."""

    types: tuple
    dofs: tuple
    axes: tuple
    F: tuple
    a: tuple
    Fa: tuple
    t: tuple
    n_dofs: int
    dtype: torch.dtype


def _check_constant(robot: RobotStruct, fields) -> None:
    for f in fields:
        if getattr(robot, f).requires_grad:
            raise ValueError(
                f"robot.{f} requires grad: the FK kernels treat the robot as "
                "constant; use fk_impl='scalar' to differentiate w.r.t. the robot"
            )


def chain_constants(robot: RobotStruct, link_idx: int) -> ChainConsts:
    """The kernels' view of the chain to `link_idx`, built on the host once
    per struct. F comes from cos/sin rounded to the struct's dtype, as the
    TPU kernels fold it (ops/pallas/fk.py `_rpy_entries`)."""
    _check_constant(robot, ("trans", "rot_angles", "axis"))
    if robot.dtype not in _NP_DTYPE:
        raise TypeError(f"chain FK takes float32 or float64 robots, not {robot.dtype}")
    return robot.memo(("chain", link_idx), lambda: _chain_constants(robot, link_idx))


UNIT_AXIS_TOL = 1e-6


def check_unit_axes(robot: RobotStruct, links, what: str) -> None:
    """Raise unless every revolute joint among `links` has a unit axis
    (within UNIT_AXIS_TOL). `what`'s hand-written adjoint uses identities
    that hold only for unit axes (a rotation about a, Rᵀ dR/dq = [a]×; the
    geometric Jacobian z × (p - o)); URDF ingest normalises the axes, but
    `struct_from_arrays` takes them as given (ROADMAP W6). The norms are read
    once per axis tensor (again after it is written in place), so that a
    struct which only overlays other tensors, as learnable parameters do,
    reads nothing from the device."""
    links = tuple(links)
    revolute = [l for l in links if robot.joint_types[l] == JOINT_REVOLUTE]
    axis = robot.axis
    stamp = (axis._version, axis.data_ptr())
    cached = getattr(axis, "_unit_axis_norms", None)
    if cached is None or cached[0] != stamp:
        norms = np.linalg.norm(axis.detach().cpu().numpy().astype(np.float64), axis=-1)
        cached = axis._unit_axis_norms = (stamp, norms)
    norms = cached[1][revolute]
    for l, norm in zip(revolute, norms):
        if abs(norm - 1.0) > UNIT_AXIS_TOL:
            raise ValueError(
                f"{what} needs unit joint axes: link {l} ({robot.link_names[l]}) has a "
                f"revolute axis of length {float(norm)!r}"
            )


def fixed_rotation(rpy, rnd) -> np.ndarray:
    """The joint origin's rpy rotation Rz(yaw) Ry(pitch) Rx(roll) from
    cos/sin each rounded by `rnd`, as the TPU kernels fold it."""
    roll, pitch, yaw = np.asarray(rpy, np.float64)
    cr, sr = rnd(np.cos(roll)), rnd(np.sin(roll))
    cp, sp = rnd(np.cos(pitch)), rnd(np.sin(pitch))
    cy, sy = rnd(np.cos(yaw)), rnd(np.sin(yaw))
    return np.array(
        [
            [cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
            [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
            [-sp, cp * sr, cp * cr],
        ]
    )


AXIS_GENERAL = 0  # csrc/chain.cuh DRM_AXIS_GENERAL


def axis_kind(a) -> int:
    """csrc/chain.cuh `ChainLink::axis` of the axis a (as rounded to the
    struct's dtype): k + 1 where a is exactly +e_k, -(k + 1) where it is
    exactly -e_k, AXIS_GENERAL otherwise. K1/K2 turn a revolute joint of a
    coordinate axis by a planar rotation."""
    code = _axis_codes_of(np.asarray(a, np.float64)[None])[0]
    return AXIS_GENERAL if code is None else code[1] * (code[0] + 1)


def _chain_constants(robot: RobotStruct, link_idx: int) -> ChainConsts:
    chain = chain_to(robot, link_idx)
    if len(chain) > MAX_CHAIN:
        raise ValueError(f"chain of {len(chain)} links exceeds MAX_CHAIN={MAX_CHAIN}")
    if robot.n_dofs > MAX_DOF:
        raise ValueError(f"{robot.n_dofs} dofs exceed MAX_DOF={MAX_DOF}")
    nd = _NP_DTYPE[robot.dtype]
    rnd = lambda x: np.asarray(x, nd).astype(np.float64)  # round to dtype
    host = robot.numpy()
    link_dof = {l: d for d, l in enumerate(robot.dof_links)}
    F_all, a_all, Fa_all, t_all = [], [], [], []
    for l in chain:
        F = fixed_rotation(host["rot_angles"][l], rnd)
        a = host["axis"][l].astype(np.float64)
        F_all.append(tuple(rnd(F).ravel().tolist()))
        a_all.append(tuple(a.tolist()))
        Fa_all.append(tuple(rnd(F @ a).tolist()))
        t_all.append(tuple(host["trans"][l].astype(np.float64).tolist()))
    return ChainConsts(
        types=tuple(robot.joint_types[l] for l in chain),
        dofs=tuple(link_dof.get(l, -1) for l in chain),
        axes=tuple(axis_kind(a) for a in a_all),
        F=tuple(F_all),
        a=tuple(a_all),
        Fa=tuple(Fa_all),
        t=tuple(t_all),
        n_dofs=robot.n_dofs,
        dtype=robot.dtype,
    )


# ---------------------------------------------------------------------------
# The plain PyTorch versions: the kernels' arithmetic, op for op, on lanes.
# ---------------------------------------------------------------------------


def _rot(R, v):
    return tuple(R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2] for i in range(3))


def _mat3(A, B):
    return tuple(
        A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
        for i in range(3)
        for j in range(3)
    )


def _rodrigues(a, c, s):
    C = 1.0 - c
    diag = []
    for i in range(3):
        aa = a[i] * a[i]
        diag.append(1.0 if aa == 1.0 else (c if aa == 0.0 else c + aa * C))
    return (
        diag[0], a[0] * a[1] * C - a[2] * s, a[0] * a[2] * C + a[1] * s,
        a[1] * a[0] * C + a[2] * s, diag[1], a[1] * a[2] * C - a[0] * s,
        a[2] * a[0] * C - a[1] * s, a[2] * a[1] * C + a[0] * s, diag[2],
    )


def chain_sweep(consts: ChainConsts, q_of, lanes: torch.Tensor, record=None):
    """csrc/chain.cuh `drm_chain_sweep` in torch ops: `q_of(d)` gives dof d
    on the lanes; `record(type, dof, z, o)` sees each joint's world axis and
    origin. Returns the chain end's world position as a 3-tuple of lanes."""
    one, zero = torch.ones_like(lanes), torch.zeros_like(lanes)
    Rw = (one, zero, zero, zero, one, zero, zero, zero, one)
    pw = (zero, zero, zero)
    for k, jt in enumerate(consts.types):
        F, a, Fa, t = consts.F[k], consts.a[k], consts.Fa[k], consts.t[k]
        tt = t
        if jt == JOINT_REVOLUTE:
            qv = q_of(consts.dofs[k])
            R = _mat3(F, _rodrigues(a, torch.cos(qv), torch.sin(qv)))
        else:
            R = F
            if jt == JOINT_PRISMATIC:
                qv = q_of(consts.dofs[k])
                tt = tuple(t[i] + Fa[i] * qv for i in range(3))
        z = _rot(Rw, Fa) if jt != JOINT_FIXED else None
        dt = _rot(Rw, tt)
        pw = tuple(pw[i] + dt[i] for i in range(3))
        if jt != JOINT_FIXED and record is not None:
            record(jt, consts.dofs[k], z, pw)
        Rw = _mat3(Rw, R)
    return pw


def joint_vjp(jt, z, o, p, g):
    """csrc/chain.cuh `drm_joint_vjp`: g.(z x (p - o)) revolute, g.z prismatic."""
    if jt == JOINT_REVOLUTE:
        r = (p[0] - o[0], p[1] - o[1], p[2] - o[2])
        return (
            g[0] * (z[1] * r[2] - z[2] * r[1])
            + g[1] * (z[2] * r[0] - z[0] * r[2])
            + g[2] * (z[0] * r[1] - z[1] * r[0])
        )
    return g[0] * z[0] + g[1] * z[1] + g[2] * z[2]


def fk_position_dof_major_reference(robot: RobotStruct, qM: torch.Tensor, link_idx: int):
    """Plain version of K1: world position [3, M] of link `link_idx` for
    dof-major configs qM [D, M]. Differentiable by autograd."""
    consts = chain_constants(robot, link_idx)
    return torch.stack(chain_sweep(consts, lambda d: qM[d], qM[0]))


def fk_position_dof_major_vjp_reference(
    robot: RobotStruct, qM: torch.Tensor, g: torch.Tensor, link_idx: int
):
    """Plain version of K2: the VJP dq [D, M] of K1 at qM with cotangent
    g [3, M], by the geometric-Jacobian identity, in one sweep as K2 makes
    it: each revolute joint keeps w = g x z and b = o.w, and its row
    g.(z x (p - o)) = p.w - b is formed once p is known; a prismatic
    joint's row is g.z. Rows of dofs off the chain are zero."""
    consts = chain_constants(robot, link_idx)
    rows = [torch.zeros_like(qM[0]) for _ in range(qM.shape[0])]
    records = []

    def record(jt, dof, z, o):
        if jt == JOINT_REVOLUTE:
            w = (g[1] * z[2] - g[2] * z[1], g[2] * z[0] - g[0] * z[2], g[0] * z[1] - g[1] * z[0])
            records.append((dof, w, o[0] * w[0] + o[1] * w[1] + o[2] * w[2]))
        else:
            rows[dof] = g[0] * z[0] + g[1] * z[1] + g[2] * z[2]

    p = chain_sweep(consts, lambda d: qM[d], qM[0], record)
    for dof, w, b in records:
        rows[dof] = p[0] * w[0] + p[1] * w[1] + p[2] * w[2] - b
    return torch.stack(rows)


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------


def _chain_ctypes(ctype):
    class Link(ctypes.Structure):
        _fields_ = [
            ("type", ctypes.c_int), ("dof", ctypes.c_int), ("axis", ctypes.c_int), ("F", ctype * 9),
            ("a", ctype * 3), ("Fa", ctype * 3), ("t", ctype * 3),
        ]

    class Chain(ctypes.Structure):
        _fields_ = [
            ("n", ctypes.c_int), ("D", ctypes.c_int), ("dof_mask", ctypes.c_uint),
            ("link", Link * MAX_CHAIN),
        ]

    return Chain


CHAIN_CTYPES = {
    torch.float32: _chain_ctypes(ctypes.c_float),
    torch.float64: _chain_ctypes(ctypes.c_double),
}


def chain_struct(robot: RobotStruct, link_idx: int):
    """The by-value `Chain<T>` kernel argument for the chain to `link_idx`."""
    consts = chain_constants(robot, link_idx)

    def make():
        ch = CHAIN_CTYPES[consts.dtype]()
        ch.n, ch.D = len(consts.types), consts.n_dofs
        for k, jt in enumerate(consts.types):
            L = ch.link[k]
            L.type, L.dof, L.axis = jt, max(consts.dofs[k], 0), consts.axes[k]
            L.F[:], L.a[:], L.Fa[:], L.t[:] = consts.F[k], consts.a[k], consts.Fa[k], consts.t[k]
            if jt != JOINT_FIXED:
                ch.dof_mask |= 1 << consts.dofs[k]
        return ch

    return robot.memo(("chain_ctypes", link_idx), make)


def _configure(lib: ctypes.CDLL) -> None:
    sizes = (ctypes.c_int64 * 4)()
    lib.fk_layout.argtypes = [ctypes.c_void_p]
    lib.fk_layout.restype = None
    lib.fk_layout(sizes)
    expect = (
        ctypes.sizeof(CHAIN_CTYPES[torch.float32]),
        ctypes.sizeof(CHAIN_CTYPES[torch.float64]),
        MAX_CHAIN,
        MAX_DOF,
    )
    if tuple(sizes) != expect:
        raise RuntimeError(f"csrc/fk.cu layout {tuple(sizes)} != Python's {expect}")
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    for fn in ("fk_fwd_f32", "fk_fwd_f64"):
        getattr(lib, fn).argtypes = [p, p, p, i64, p]
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("fk_bwd_f32", "fk_bwd_f64"):
        getattr(lib, fn).argtypes = [p, p, p, p, i64, p]
        getattr(lib, fn).restype = ctypes.c_int


def _check_operand(robot: RobotStruct, x: torch.Tensor, rows: int, what: str) -> None:
    if x.dim() != 2 or x.shape[0] != rows:
        raise ValueError(f"{what} must be [{rows}, M], got {tuple(x.shape)}")
    if x.dtype != robot.dtype or x.device != robot.device:
        raise ValueError(
            f"{what} is {x.dtype} on {x.device}; the robot is {robot.dtype} on {robot.device}"
        )


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what} must be a CUDA or CPU tensor, not on {x.device}")
    if not x.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _suffix(dtype: torch.dtype) -> str:
    return "f32" if dtype == torch.float32 else "f64"


def fk_fwd(robot: RobotStruct, qM: torch.Tensor, link_idx: int) -> torch.Tensor:
    """K1: world position p [3, M] of link `link_idx` for qM [D, M]."""
    _check_operand(robot, qM, robot.n_dofs, "qM")
    if qM.device.type == "cpu":
        return fk_position_dof_major_reference(robot, qM, link_idx)
    _check_cuda(qM, "qM")
    ch = chain_struct(robot, link_idx)
    M = qM.shape[1]
    p = torch.empty((3, M), dtype=qM.dtype, device=qM.device)
    if M == 0:
        return p
    lib = build.load("fk", _configure)
    with torch.cuda.device(qM.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"fk_fwd_{_suffix(qM.dtype)}")(
            ctypes.byref(ch), qM.data_ptr(), p.data_ptr(), M, stream
        )
    if rc != 0:
        raise RuntimeError(f"fk_fwd: CUDA error {rc} at launch")
    fk_fwd.launches += 1
    return p


fk_fwd.launches = 0


def fk_bwd(robot: RobotStruct, qM: torch.Tensor, g: torch.Tensor, link_idx: int) -> torch.Tensor:
    """K2: dq [D, M], the VJP of K1 at qM with cotangent g [3, M]. Raises
    for a revolute axis on the chain that is not of unit length (the
    identity it uses holds only for unit axes, ROADMAP W6)."""
    _check_operand(robot, qM, robot.n_dofs, "qM")
    _check_operand(robot, g, 3, "g")
    if g.shape[1] != qM.shape[1]:
        raise ValueError(f"g has {g.shape[1]} columns, qM {qM.shape[1]}")
    check_unit_axes(robot, chain_to(robot, link_idx), "fk_bwd")
    if qM.device.type == "cpu":
        return fk_position_dof_major_vjp_reference(robot, qM, g, link_idx)
    _check_cuda(qM, "qM")
    _check_cuda(g, "g")
    ch = chain_struct(robot, link_idx)
    D, M = qM.shape
    dq = torch.empty((D, M), dtype=qM.dtype, device=qM.device)
    if M == 0:
        return dq
    lib = build.load("fk", _configure)
    with torch.cuda.device(qM.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, f"fk_bwd_{_suffix(qM.dtype)}")(
            ctypes.byref(ch), qM.data_ptr(), g.data_ptr(), dq.data_ptr(), M, stream
        )
    if rc != 0:
        raise RuntimeError(f"fk_bwd: CUDA error {rc} at launch")
    fk_bwd.launches += 1
    return dq


fk_bwd.launches = 0


class FkPositionDofMajor(torch.autograd.Function):
    """K1 forward, K2 backward (w.r.t. qM only; the robot is constant)."""

    @staticmethod
    def forward(ctx, qM, robot, link_idx):
        ctx.save_for_backward(qM)
        ctx.robot, ctx.link_idx = robot, link_idx
        return fk_fwd(robot, qM, link_idx)

    @staticmethod
    def backward(ctx, g):
        (qM,) = ctx.saved_tensors
        return fk_bwd(ctx.robot, qM, g.contiguous(), ctx.link_idx), None, None


def fk_position_dof_major(robot: RobotStruct, qM: torch.Tensor, link_idx: int):
    """World position [3, M] of link `link_idx` for dof-major configs qM
    [D, M], differentiable w.r.t. qM: the `"kernel"` engine's FK (K1, its
    backward K2). For a robot whose tensors require grad it takes the
    plain differentiable scalar FK instead (`fk_link_position_dof_first`),
    decided here before any launch, as the JAX package's FK wrapper routes
    a traced robot: the robot's gradient then flows by autograd."""
    if robot.requires_grad:
        return fk_link_position_dof_first(robot, qM, link_idx)
    return FkPositionDofMajor.apply(qM, robot, link_idx)
