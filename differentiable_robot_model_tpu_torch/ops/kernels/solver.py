"""Whole MPC solves in one launch: kernel K3 `kin_solve` (csrc/kin_solve.cu,
kinematic Adam), kernel K9 `dyn_solve` with its prologue `dyn_prologue`
(csrc/dyn_solve.cu, torque-space Adam) and kernel K10 `mppi_solve`
(csrc/mppi_solve.cu, sampling MPC), their plain PyTorch versions, and the
wrappers. The dynamic half is described at `dynamic_adam_solve`, the MPPI
one at `mppi_solve`.

K3 replaces the JAX package's ops/pallas/solver.py `_kin_solve_kernel` and
its wrapper `kinematic_adam_solve_fused`: per scenario, n_iters times,
the clamp-affine rollout q' = clip(q + a), the ee FK of every stage, the
cost cgoal_w * sum |p - goal|^2, the adjoint (J^T gpe of each stage by the
geometric-Jacobian identity, chained back through the clip), and the
optax-style Adam update of every stage.

Bound on the H100: the function needs about (H-1) (n_iters+1) chain sweeps
per scenario (each one sincos and a few dozen FP32 operations per revolute
link once the robot's zero and unit constants are folded) over only ~12 MB
of inputs and outputs at iiwa H=50 B=4096, so FP32 throughput bounds it.
The kernel spreads each scenario's stages over a warp (one sweep a stage
and iteration) and walks only the two elementwise recursions
in order; csrc/kin_solve.cu gives the design.

On a CUDA tensor the wrapper launches the kernel or raises; it takes the
plain version only for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ...models.structs import RobotStruct
from ...trajopt.rollout import _clip, _effort_bound
from ..dynamics_scalar import ldl_solve_scalar, mass_matrix_scalar, rnea_scalar
from . import build, rng
from .fk import (
    CHAIN_CTYPES,
    MAX_CHAIN,
    MAX_DOF,
    _check_cuda,
    _suffix,
    chain_constants,
    chain_struct,
    chain_sweep,
    chain_to,
    check_unit_axes,
    joint_vjp,
)
from .rollout import (
    SERIAL_SHAPES,
    TREE_CTYPES,
    VARIANTS,
    StepFlags,
    _check_variants,
    _clip_grad,
    _states_before,
    check_constant_robot,
    check_same,
    dyn_rollout_ee_fwd_reference,
    ee_jacobian_t,
    kernel_variant,
    pull_stage,
    replay_reference,
    tree_struct,
    variant_code,
)

_B1 = 0.9
_B2 = 0.999

_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


class _KinSolveParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("n_iters", ctypes.c_int),
        ("cgoal_w", ctypes.c_float), ("gpe_w", ctypes.c_float),
        ("b1", ctypes.c_float), ("b2", ctypes.c_float),
        ("omb1", ctypes.c_float), ("omb2", ctypes.c_float),
        ("eps", ctypes.c_float), ("eps_root", ctypes.c_float),
        ("lo", ctypes.c_float * MAX_DOF), ("hi", ctypes.c_float * MAX_DOF),
    ]


def solve_constants(dtype: torch.dtype, H: int, n_iters: int, lr: float,
                    goal_weight: float, eps: float, eps_root: float,
                    effort_weight: float = 0.0, D: int = 1) -> dict:
    """The solve's scalars rounded to `dtype` as solver.py:129-136 and
    :438-443 do (the effort terms only matter to the dynamic solve), and the
    bias-correction table of solver.py:311-317 (computed in f64, then cast):
    bc[2t] = lr / (1 - b1^(t+1)), bc[2t+1] = 1 / (1 - b2^(t+1))."""
    nd = _NP_DTYPE[dtype]
    r = lambda x: float(nd(x))
    gw2 = r(r(goal_weight) * r(goal_weight))
    cgoal_w = r(gw2 / (3.0 * H))
    ceff_w = r(r(effort_weight) / (H * D))
    tgrid = np.arange(1, n_iters + 1, dtype=np.float64)
    alpha = nd(lr) / (1.0 - np.float64(_B1) ** tgrid)
    ibc2 = 1.0 / (1.0 - np.float64(_B2) ** tgrid)
    bc = np.empty(2 * n_iters, nd)
    bc[0::2] = alpha.astype(nd)
    bc[1::2] = ibc2.astype(nd)
    return dict(
        cgoal_w=cgoal_w, gpe_w=r(2.0 * cgoal_w), ceff_w=ceff_w, geff_w=r(2.0 * ceff_w),
        b1=r(_B1), b2=r(_B2), omb1=r(1.0 - _B1), omb2=r(1.0 - _B2),
        eps=r(eps), eps_root=r(eps_root), bc=bc,
    )


def _validate(robot, q0T, goalT, aT0, n_iters):
    if aT0.dim() != 3:
        raise ValueError(f"aT0 must be [H, D, B], got {tuple(aT0.shape)}")
    H, D, B = aT0.shape
    if H < 2:
        raise ValueError("the whole-solve needs horizon >= 2 (one action step)")
    if n_iters < 1:
        raise ValueError("the whole-solve needs n_iters >= 1")
    if D == 0 or D != robot.n_dofs:
        raise ValueError(f"aT0 has {D} dofs; the robot has {robot.n_dofs} (and needs >= 1)")
    for name, x, shape in (("q0T", q0T, (D, B)), ("goalT", goalT, (3, B))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
    for name, x in (("q0T", q0T), ("goalT", goalT), ("aT0", aT0)):
        if x.dtype != robot.dtype or x.device != robot.device:
            raise ValueError(
                f"{name} is {x.dtype} on {x.device}; the robot is "
                f"{robot.dtype} on {robot.device}"
            )
    return H, D, B


def kinematic_adam_solve_reference(
    robot: RobotStruct,
    q0T: torch.Tensor,
    goalT: torch.Tensor,
    aT0: torch.Tensor,
    ee_link_idx: int,
    n_iters: int,
    lr: float,
    goal_weight: float,
    eps: float,
    eps_root: float = 1e-8,
):
    """Plain version of K3: returns (a [H, D, B] optimized action deltas,
    costs [n_iters+1, B]); q0T [D, B] is already clipped.

    The kernel's four steps an iteration, each batched over the stages: the
    clamp scan q'_h = clip(q'_{h-1} + a_h) in stage order; one chain sweep
    of every stage (on [H-1, B] lanes) for p_h, the cost and, from the same
    sweep's joint axes and origins, J(q'_h)^T gpe_h; the adjoint scan from
    the last stage, through the clip's factor at q'_{h-1} + a_h; and Adam on
    every stage. a_h is read before its own update, so the adjoint needs no
    replay of the forward.
    """
    H, D, B = _validate(robot, q0T, goalT, aT0, n_iters)
    consts = chain_constants(robot, ee_link_idx)
    c = solve_constants(robot.dtype, H, n_iters, lr, goal_weight, eps, eps_root)
    lo, hi = robot.limit_lower[:, None], robot.limit_upper[:, None]
    a = aT0.clone()
    m = torch.zeros_like(a)
    v = torch.zeros_like(a)

    pe0 = chain_sweep(consts, lambda d: q0T[d], q0T[0])
    cg0 = torch.zeros_like(q0T[0])
    for j in range(3):
        diff = pe0[j] - goalT[j]
        cg0 = cg0 + diff * diff

    costs = []
    for t in range(n_iters + 1):
        # 1. the clamp scan
        q, qs = q0T, []
        for h in range(H - 1):
            q = _clip(q + a[h], lo, hi)
            qs.append(q)
        qs = torch.stack(qs)  # [H-1, D, B]
        # 2. one sweep of every stage, keeping each joint's z and o
        joints = []
        ps = chain_sweep(consts, lambda d: qs[:, d], qs[:, 0],
                         lambda jt, dof, z, o: joints.append((jt, dof, z, o)))  # 3 x [H-1, B]
        cg = cg0
        for h in range(H - 1):
            for j in range(3):
                diff = ps[j][h] - goalT[j]
                cg = cg + diff * diff
        costs.append(c["cgoal_w"] * cg)
        if t == n_iters:
            break
        gpe = [c["gpe_w"] * (ps[j] - goalT[j]) for j in range(3)]
        rows = [torch.zeros_like(qs[:, 0]) for _ in range(D)]
        for jt, dof, z, o in joints:
            rows[dof] = joint_vjp(jt, z, o, ps, gpe)
        jtg = torch.stack(rows, dim=1)  # [H-1, D, B]
        # 3. the adjoint scan; d clip / dx at x_h = q'_{h-1} + a_h by
        # autograd of max-then-min
        with torch.enable_grad():
            x = (torch.cat([q0T[None], qs[:-1]]) + a[: H - 1]).requires_grad_(True)
            (clip_grad,) = torch.autograd.grad(_clip(x, lo, hi), x, torch.ones_like(x))
        gq = torch.zeros_like(q0T)
        da = torch.empty_like(jtg)
        for h in range(H - 2, -1, -1):
            gq = (gq + jtg[h]) * clip_grad[h]  # da_h, and the cotangent of q'_{h-1}
            da[h] = gq
        # 4. Adam
        alpha, ibc2 = float(c["bc"][2 * t]), float(c["bc"][2 * t + 1])
        S = H - 1
        m[:S] = c["b1"] * m[:S] + c["omb1"] * da
        v[:S] = c["b2"] * v[:S] + c["omb2"] * (da * da)
        a[:S] = a[:S] - alpha * m[:S] / (torch.sqrt(v[:S] * ibc2 + c["eps_root"]) + c["eps"])
    return a, torch.stack(costs)


# K3's launch shape: threads a block at most (one warp a scenario), and the
# most dynamic shared memory a block of the H100 may take (227 KB); past it
# a scenario's rows go to a global scratch (lowering KIN_SHARED_CAP_BYTES
# forces that path).
KIN_THREADS = 128
KIN_SHARED_CAP_BYTES = 232448


def kin_scenario_floats(S: int, D: int) -> int:
    """The floats K3 keeps per scenario with S action stages and D dofs:
    a, m, v, q' and the rows J^T gpe (then da), each [S, D | 1], and the
    cost's differences [S, 3] (csrc/kin_solve.cu `scenario_floats`)."""
    return S * (5 * (D | 1) + 3)


def kin_launch_shape(H: int, D: int):
    """(scenarios a block, rows in shared memory) of a K3 launch:
    KIN_THREADS // 32 scenarios, halved while their rows exceed
    KIN_SHARED_CAP_BYTES; past one scenario the rows go to global scratch."""
    per = 4 * kin_scenario_floats(H - 1, D)
    n = KIN_THREADS // 32
    while n > 1 and n * per > KIN_SHARED_CAP_BYTES:
        n //= 2
    return n, n * per <= KIN_SHARED_CAP_BYTES


def _configure(lib: ctypes.CDLL) -> None:
    sizes = (ctypes.c_int64 * 6)()
    lib.kin_solve_layout.argtypes = [ctypes.c_void_p]
    lib.kin_solve_layout.restype = None
    lib.kin_solve_layout(sizes)
    expect = (
        ctypes.sizeof(CHAIN_CTYPES[torch.float32]),
        ctypes.sizeof(_KinSolveParams),
        MAX_CHAIN,
        MAX_DOF,
        kin_scenario_floats(49, 7),
        KIN_THREADS,
    )
    if tuple(sizes) != expect:
        raise RuntimeError(f"csrc/kin_solve.cu layout {tuple(sizes)} != Python's {expect}")
    p = ctypes.c_void_p
    lib.kin_solve_f32.argtypes = [p] * 9 + [ctypes.c_int, ctypes.c_int64, p]
    lib.kin_solve_f32.restype = ctypes.c_int


def _kin_constants(robot, H, n_iters, lr, goal_weight, eps, eps_root, dev):
    """K3's by-value parameters and its bias-correction table on `dev`,
    built once per robot, device and solve setting (the host's share of a
    launch)."""
    D = robot.n_dofs
    c = solve_constants(robot.dtype, H, n_iters, lr, goal_weight, eps, eps_root)
    host = robot.numpy()
    params = _KinSolveParams(
        H=H, n_iters=n_iters, cgoal_w=c["cgoal_w"], gpe_w=c["gpe_w"],
        b1=c["b1"], b2=c["b2"], omb1=c["omb1"], omb2=c["omb2"],
        eps=c["eps"], eps_root=c["eps_root"],
    )
    params.lo[:D] = host["limit_lower"].tolist()
    params.hi[:D] = host["limit_upper"].tolist()
    return params, torch.from_numpy(c["bc"]).to(dev)


def kinematic_adam_solve(
    robot: RobotStruct,
    q0T: torch.Tensor,
    goalT: torch.Tensor,
    aT0: torch.Tensor,
    ee_link_idx: int,
    n_iters: int,
    lr: float,
    goal_weight: float,
    eps: float,
    eps_root: float = 1e-8,
):
    """K3: the whole kinematic Adam solve. q0T [D, B] start configs, already
    clipped; goalT [3, B]; aT0 [H, D, B] initial action deltas. Returns
    (a [H, D, B], costs [n_iters+1, B]): costs[t] is the cost before update
    t and costs[n_iters] the final one. Raises for H < 2, n_iters < 1, a
    robot without dofs, a revolute joint on the chain whose axis is not of
    unit length, or (on CUDA) input that is not float32."""
    H, D, B = _validate(robot, q0T, goalT, aT0, n_iters)
    for f in ("limit_lower", "limit_upper"):
        if getattr(robot, f).requires_grad:
            raise ValueError(f"robot.{f} requires grad: use fk_impl='scalar'")
    check_unit_axes(robot, chain_to(robot, ee_link_idx), "kin_solve")
    if q0T.device.type == "cpu":
        return kinematic_adam_solve_reference(
            robot, q0T, goalT, aT0, ee_link_idx, n_iters, lr, goal_weight, eps, eps_root
        )
    if q0T.device.type != "cuda":
        raise ValueError(f"kin_solve takes CUDA or CPU tensors, not {q0T.device}")
    if robot.dtype != torch.float32:
        raise TypeError(f"kin_solve is float32 only; got {robot.dtype}")
    for name, x in (("q0T", q0T), ("goalT", goalT), ("aT0", aT0)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    ch = chain_struct(robot, ee_link_idx)
    dev = q0T.device
    key = ("kin_solve", H, n_iters, float(lr), float(goal_weight), float(eps), float(eps_root), dev)
    params, bc = robot.memo(key, lambda: _kin_constants(robot, H, n_iters, lr, goal_weight, eps,
                                                        eps_root, dev))
    a = torch.empty((H, D, B), dtype=torch.float32, device=dev)
    costs = torch.empty((n_iters + 1, B), dtype=torch.float32, device=dev)
    if B == 0:
        return a, costs
    lib = build.load("kin_solve", _configure)
    per_block, shared = kin_launch_shape(H, D)
    work = None
    if not shared:
        groups = -(-B // per_block) * per_block
        work = torch.empty((groups, kin_scenario_floats(H - 1, D)), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kin_solve_f32(
            ctypes.byref(ch), ctypes.byref(params),
            q0T.data_ptr(), goalT.data_ptr(), aT0.data_ptr(), bc.data_ptr(),
            a.data_ptr(), costs.data_ptr(), None if work is None else work.data_ptr(),
            per_block, B, stream,
        )
    if rc != 0:
        raise RuntimeError(f"kin_solve: CUDA error {rc} at launch")
    kinematic_adam_solve.launches += 1
    return a, costs


kinematic_adam_solve.launches = 0


# ---------------------------------------------------------------------------
# The dynamic whole solve: kernel K9 `dyn_solve` and its prologue.
# ---------------------------------------------------------------------------

class _DynSolveParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("n_iters", ctypes.c_int),
        ("precond", ctypes.c_int), ("effort", ctypes.c_int),
        ("cgoal_w", ctypes.c_float), ("ceff_w", ctypes.c_float),
        ("gpe_w", ctypes.c_float), ("geff_w", ctypes.c_float),
        ("b1", ctypes.c_float), ("b2", ctypes.c_float),
        ("omb1", ctypes.c_float), ("omb2", ctypes.c_float),
        ("eps", ctypes.c_float), ("eps_root", ctypes.c_float),
    ]


def _configure_dyn(lib: ctypes.CDLL) -> None:
    sizes = (ctypes.c_int64 * (4 + 2 * len(SERIAL_SHAPES)))()
    lib.dyn_solve_layout.argtypes = [ctypes.c_void_p]
    lib.dyn_solve_layout.restype = None
    lib.dyn_solve_layout(sizes)
    expect = (
        ctypes.sizeof(TREE_CTYPES[torch.float32]),
        ctypes.sizeof(TREE_CTYPES[torch.float64]),
        ctypes.sizeof(CHAIN_CTYPES[torch.float32]),
        ctypes.sizeof(_DynSolveParams),
    )
    if tuple(sizes[:4]) != expect:
        raise RuntimeError(f"csrc/dyn_solve.cu layout {tuple(sizes[:4])} != Python's {expect}")
    _check_variants(sizes, 4, "csrc/dyn_solve.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for fn in ("dyn_prologue_f32", "dyn_prologue_f64"):
        getattr(lib, fn).argtypes = [i] + [p] * 6 + [i, i, ctypes.c_int64, p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.dyn_solve_f32.argtypes = [i] + [p] * 20 + [ctypes.c_int64, p]
    lib.dyn_solve_f32.restype = ctypes.c_int


def _launch_dyn(name, args, dev):
    lib = build.load("dyn_solve", _configure_dyn)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def dyn_prologue_reference(robot: RobotStruct, q0T, init_tauT, horizon: int,
                           precondition: bool = True):
    """Plain version of `dyn_prologue`: (tau_refT [D, B] gravity
    compensation, H0 [D, D, B] mass matrix or None, aT0 [H, D, B] initial
    action deltas), the eager code of solvers.py:424-425 and :487-506."""
    D, B = q0T.shape
    zeros = torch.zeros_like(q0T)
    tau_refT = rnea_scalar(robot, q0T, zeros, zeros)
    H0 = mass_matrix_scalar(robot, q0T) if precondition else None
    if init_tauT is None:
        return tau_refT, H0, torch.zeros((horizon, D, B), dtype=q0T.dtype, device=q0T.device)
    dtau0 = init_tauT - tau_refT[None]
    if H0 is None:
        return tau_refT, None, dtau0
    return tau_refT, H0, ldl_solve_scalar(H0, dtau0.transpose(0, 1)).transpose(0, 1)


def _prologue_launch(robot, q0T, init_tauT, horizon, precondition, outs):
    """Launch the prologue on the build `kernel_variant` picks for the robot:
    the entry takes that build's code, the tree, the pointers of q0T,
    init_tauT (NULL for None), tau_refT, H0 (NULL without `precondition`)
    and aT0, then H, the `precondition` flag and B."""
    tau_refT, H0, aT0 = outs
    _launch_dyn(
        f"dyn_prologue_{_suffix(q0T.dtype)}",
        (variant_code(robot), ctypes.byref(tree_struct(robot, StepFlags())), q0T.data_ptr(),
         None if init_tauT is None else init_tauT.data_ptr(), tau_refT.data_ptr(),
         None if H0 is None else H0.data_ptr(), aT0.data_ptr(), horizon, int(precondition),
         q0T.shape[1]),
        q0T.device,
    )


def dyn_prologue(robot: RobotStruct, q0T, init_tauT, horizon: int, precondition: bool = True):
    """The dynamic solve's prologue in one launch: per scenario the gravity
    torques at q0 (tau_refT [D, B]), the mass matrix H0 [D, D, B] (with
    `precondition`, else None) and the warm start's absolute torques
    init_tauT [H, D, B] mapped back to action deltas through H0's LDL^T
    factor (aT0 [H, D, B]; zeros when init_tauT is None). It replaces eager
    code, not a TPU kernel: solvers.py:424-425 and :500-502."""
    D, B = q0T.shape
    if D == 0 or D != robot.n_dofs:
        raise ValueError(f"q0T has {D} dofs; the robot has {robot.n_dofs} (and needs >= 1)")
    named = [("q0T", q0T)]
    if init_tauT is not None:
        if tuple(init_tauT.shape) != (horizon, D, B):
            raise ValueError(f"init_tauT must be {[horizon, D, B]}, got {tuple(init_tauT.shape)}")
        named.append(("init_tauT", init_tauT))
    check_same(robot, named)
    if q0T.device.type == "cpu":
        return dyn_prologue_reference(robot, q0T, init_tauT, horizon, precondition)
    for name, x in named:
        _check_cuda(x, name)
    new = lambda *shape: torch.empty(shape, dtype=q0T.dtype, device=q0T.device)
    tau_refT, aT0 = new(D, B), new(horizon, D, B)
    H0 = new(D, D, B) if precondition else None
    if B:
        _prologue_launch(robot, q0T, init_tauT, horizon, precondition, (tau_refT, H0, aT0))
        dyn_prologue.launches += 1
    return tau_refT, H0, aT0


dyn_prologue.launches = 0


def _validate_dyn(robot, q0T, qd0T, goalT, tau_refT, H0, aT0, n_iters):
    if aT0.dim() != 3:
        raise ValueError(f"aT0 must be [H, D, B], got {tuple(aT0.shape)}")
    H, D, B = aT0.shape
    if H < 1 or n_iters < 1:
        raise ValueError("the dynamic whole-solve needs horizon >= 1 and n_iters >= 1")
    if D == 0 or D != robot.n_dofs:
        raise ValueError(f"aT0 has {D} dofs; the robot has {robot.n_dofs} (and needs >= 1)")
    named = [("q0T", q0T, (D, B)), ("qd0T", qd0T, (D, B)), ("goalT", goalT, (3, B)),
             ("tau_refT", tau_refT, (D, B)), ("aT0", aT0, (H, D, B))]
    if H0 is not None:
        named.append(("H0", H0, (D, D, B)))
    for name, x, shape in named:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
    check_same(robot, [(n, x) for n, x, _ in named])
    return H, D, B, [(n, x) for n, x, _ in named]


def dynamic_adam_solve_reference(
    robot: RobotStruct, q0T, qd0T, goalT, tau_refT, H0, aT0, ee_link_idx: int,
    n_iters: int, dt: float, lr: float, goal_weight: float, effort_weight: float,
    eps: float, use_damping: bool = True, respect_effort_limits: bool = False,
    eps_root: float = 1e-8,
):
    """Plain version of K9 `dyn_solve`: the kernel's arithmetic per Adam
    iteration from the plain rollout pieces (`dyn_rollout_ee_fwd_reference`
    forward, `replay_reference` and `pull_stage` backward), the effort box inside the
    step, the cost gradient chained through H0ᵀ, and the optax-form Adam
    update applied to each stage during the reverse sweep, as
    ops/pallas/solver.py:231-243 applies it."""
    H, D, B, _ = _validate_dyn(robot, q0T, qd0T, goalT, tau_refT, H0, aT0, n_iters)
    c = solve_constants(robot.dtype, H, n_iters, lr, goal_weight, eps, eps_root, effort_weight, D)
    flags = StepFlags(dt, use_damping)
    emax = _effort_bound(robot, 1) if respect_effort_limits else None
    box = (lambda x: x) if emax is None else (lambda x: _clip(x, -emax, emax))
    a = aT0.clone()
    m, v = torch.zeros_like(a), torch.zeros_like(a)

    def forward():
        dtau = a if H0 is None else torch.einsum("deb,heb->hdb", H0, a)
        tau = tau_refT + dtau
        qs, qds, ps = dyn_rollout_ee_fwd_reference(
            robot, q0T, qd0T, box(tau), dt, ee_link_idx, use_damping
        )
        diff = ps - goalT
        cost = c["cgoal_w"] * (diff * diff).sum((0, 1)) + c["ceff_w"] * (dtau * dtau).sum((0, 1))
        return cost, tau, qs, qds, ps

    costs = []
    for t in range(n_iters):
        cost, tau, qs, qds, ps = forward()
        costs.append(cost)
        alpha, ibc2 = float(c["bc"][2 * t]), float(c["bc"][2 * t + 1])
        jtg = ee_jacobian_t(robot, qs, ps, c["gpe_w"] * (ps - goalT), ee_link_idx)
        mask = None if emax is None else _clip_grad(tau, -emax, emax)
        scr = replay_reference(robot, _states_before(q0T, qs), _states_before(qd0T, qds), box(tau),
                               flags)
        gq, gqd = torch.zeros_like(q0T), torch.zeros_like(q0T)
        for h in range(H - 1, -1, -1):
            lam, gq, gqd = pull_stage(scr[h], D, dt, gq + jtg[h], gqd)
            gt = (lam if mask is None else lam * mask[h]) + c["geff_w"] * (tau[h] - tau_refT)
            ga = gt if H0 is None else torch.einsum("deb,db->eb", H0, gt)
            m[h] = c["b1"] * m[h] + c["omb1"] * ga
            v[h] = c["b2"] * v[h] + c["omb2"] * (ga * ga)
            a[h] = a[h] - alpha * m[h] / (torch.sqrt(v[h] * ibc2 + c["eps_root"]) + c["eps"])
    cost, tau, *_ = forward()
    costs.append(cost)
    return box(tau), torch.stack(costs)


def dynamic_adam_solve(
    robot: RobotStruct, q0T, qd0T, goalT, tau_refT, H0, aT0, ee_link_idx: int,
    n_iters: int, dt: float, lr: float, goal_weight: float, effort_weight: float,
    eps: float, use_damping: bool = True, respect_effort_limits: bool = False,
    eps_root: float = 1e-8,
):
    """K9 `dyn_solve`: the whole torque-space Adam solve in one launch.

    Replaces the JAX package's ops/pallas/solver.py `_solve_kernel` (wrapper
    `adam_solve_fused`): per scenario, n_iters times, the rollout of
    tau = tau_ref + H0 a (effort box inside the step) with the ee
    trajectory, the goal + effort cost, the adjoint by replay (the
    implicit-function step adjoint of ops/kernels/rollout.py, the effort
    gradient on the unclipped tau - tau_ref, the H0ᵀ chain) and the
    optax-form Adam update of each stage during the reverse sweep. q0T,
    qd0T, tau_refT [D, B], goalT [3, B], H0 [D, D, B] or None (no
    preconditioning), aT0 [H, D, B]. Returns (tau [H, D, B] applied torques,
    costs [n_iters+1, B]): costs[t] before update t, costs[n_iters] final.
    Raises for a revolute joint whose axis is not of unit length.

    Bound on the H100: per scenario, stage and iteration one step and one
    chain FK with J^T g forward, and an LDL^T solve and an RNEA with one
    reverse sweep backward: thousands of FP32 operations over a few
    hundred bytes of inputs, so operations bound it; with one thread per
    scenario (one warp per SM at B=4096) each scenario's dependent chain
    sets the time, which csrc/dyn_solve.cu's design note addresses (for a
    serial chain, two warps share each scenario's work). Scratch a,
    m, v, tau_s, qs, qds, J^T gpe and the step factors (about 69 MB at iiwa
    H=50, B=4096) is batch-minor in global memory. The instantiation is
    `kernel_variant(robot)`'s.
    """
    H, D, B, named = _validate_dyn(robot, q0T, qd0T, goalT, tau_refT, H0, aT0, n_iters)
    check_unit_axes(robot, range(1, robot.n_links), "dyn_solve")
    if q0T.device.type == "cpu":
        return dynamic_adam_solve_reference(
            robot, q0T, qd0T, goalT, tau_refT, H0, aT0, ee_link_idx, n_iters, dt, lr,
            goal_weight, effort_weight, eps, use_damping, respect_effort_limits, eps_root,
        )
    if robot.dtype != torch.float32:
        raise TypeError(f"dyn_solve is float32 only; got {robot.dtype}")
    for name, x in named:
        _check_cuda(x, name)
    tree = tree_struct(robot, StepFlags(dt, use_damping))
    ch = chain_struct(robot, ee_link_idx)
    c = solve_constants(robot.dtype, H, n_iters, lr, goal_weight, eps, eps_root, effort_weight, D)
    params = _DynSolveParams(
        H=H, n_iters=n_iters, precond=int(H0 is not None), effort=int(respect_effort_limits),
        **{k: c[k] for k in ("cgoal_w", "ceff_w", "gpe_w", "geff_w", "b1", "b2", "omb1",
                             "omb2", "eps", "eps_root")},
    )
    variant = variant_code(robot)
    dev = q0T.device
    new = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    tau_out, a, m, v, tau_s, qs, qds, jtg = (new(H, D, B) for _ in range(8))
    fac = new(H, D * (D - 1) // 2 + 2 * D, B)  # per stage Ĥ's LDL^T factor and qdd*
    costs = new(n_iters + 1, B)
    if B:
        bc = torch.from_numpy(c["bc"]).to(dev)
        ptrs = (q0T, qd0T, tau_refT, goalT, aT0)
        _launch_dyn(
            "dyn_solve_f32",
            (variant, ctypes.byref(tree), ctypes.byref(ch), ctypes.byref(params),
             *(x.data_ptr() for x in ptrs), None if H0 is None else H0.data_ptr(),
             bc.data_ptr(), tau_out.data_ptr(), costs.data_ptr(),
             *(x.data_ptr() for x in (a, m, v, tau_s, qs, qds, jtg, fac)), B),
            dev,
        )
        dynamic_adam_solve.launches += 1
    return tau_out, costs


dynamic_adam_solve.launches = 0


# ---------------------------------------------------------------------------
# The MPPI whole solve: kernel K10 `mppi_solve`.
# ---------------------------------------------------------------------------

# One block per scenario and one thread per sample: a block has at most
# 1024 threads.
MAX_SAMPLES = 1024


class _MppiParams(ctypes.Structure):
    _fields_ = [
        ("H", ctypes.c_int), ("n_iters", ctypes.c_int), ("K", ctypes.c_int),
        ("precond", ctypes.c_int), ("effort", ctypes.c_int),
        ("key0", ctypes.c_uint32), ("key1", ctypes.c_uint32), ("keys", ctypes.c_void_p),
        ("cgoal_w", ctypes.c_double), ("ceff_w", ctypes.c_double),
        ("sigma", ctypes.c_double), ("temperature", ctypes.c_double),
    ]


def mppi_constants(dtype: torch.dtype, H: int, D: int, goal_weight: float, effort_weight: float,
                   noise_sigma: float, temperature: float) -> dict:
    """The MPPI solve's scalars rounded to `dtype`, as ops/pallas/solver.py
    :693-697 rounds them: cgoal_w = f(f(gw^2) / (3 H)), ceff_w = f(f(ew) /
    (H D)), sigma, temperature."""
    c = solve_constants(dtype, H, 0, 0.0, goal_weight, 0.0, 0.0, effort_weight, D)
    r = lambda x: float(_NP_DTYPE[dtype](x))
    return dict(cgoal_w=c["cgoal_w"], ceff_w=c["ceff_w"], sigma=r(noise_sigma),
                temperature=r(temperature))


def _validate_mppi(robot, q0T, qd0T, goalT, tau_refT, H0, aT0, key, n_iters, n_samples):
    if n_samples < 1 or n_samples > MAX_SAMPLES:
        raise ValueError(f"mppi_solve takes 1 to {MAX_SAMPLES} samples, got {n_samples}")
    if n_iters < 0:
        raise ValueError(f"n_iters must be >= 0, got {n_iters}")
    if aT0.dim() != 3 or aT0.shape[0] < 1:
        raise ValueError(f"aT0 must be [H >= 1, D, B], got {tuple(aT0.shape)}")
    H, D, B = aT0.shape
    if D == 0 or D != robot.n_dofs:
        raise ValueError(f"aT0 has {D} dofs; the robot has {robot.n_dofs} (and needs >= 1)")
    named = [("q0T", q0T, (D, B)), ("qd0T", qd0T, (D, B)), ("goalT", goalT, (3, B)),
             ("tau_refT", tau_refT, (D, B)), ("aT0", aT0, (H, D, B))]
    if H0 is not None:
        named.append(("H0", H0, (D, D, B)))
    for name, x, shape in named:
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(x.shape)}")
    if rng.per_scenario(key):
        rng.scenario_keys(key, B)
    else:
        rng.key_words(key)
    check_same(robot, [(n, x) for n, x, _ in named])
    check_constant_robot(robot)
    return H, D, B, [(n, x) for n, x, _ in named]


def mppi_solve_reference(
    robot: RobotStruct, q0T, qd0T, goalT, tau_refT, H0, aT0, key, ee_link_idx: int,
    n_iters: int, n_samples: int, dt: float, temperature: float, noise_sigma: float,
    goal_weight: float, effort_weight: float, use_damping: bool = True,
    respect_effort_limits: bool = False,
):
    """Plain version of K10 `mppi_solve`: the MPPI iterations of the plain
    solver (trajopt/solvers.py `_mppi_iterate`, without adaptation) on the
    same Philox stream (ops/kernels/rng.py; one key or per-scenario keys,
    as `mppi_solve` takes them), with the K samples of every
    scenario on [B K] lanes of the plain rollout `dyn_rollout_ee_fwd_reference`.
    Returns (tau [H, D, B] applied torques, costs [n_iters+1, B])."""
    from ...trajopt.solvers import _mppi_iterate  # trajopt.solvers imports this module

    H, D, B, _ = _validate_mppi(robot, q0T, qd0T, goalT, tau_refT, H0, aT0, key, n_iters,
                                n_samples)
    normals = lambda t: rng.mppi_normals(key, B, t, H, D, n_samples, q0T.dtype, q0T.device)
    ee_traj = lambda q, qd, tau: dyn_rollout_ee_fwd_reference(
        robot, q, qd, tau, dt, ee_link_idx, use_damping)[2]
    tau, final, history = _mppi_iterate(
        robot, q0T, qd0T, goalT, tau_refT, H0, aT0, normals, ee_traj, n_iters, n_samples,
        temperature, noise_sigma, goal_weight, effort_weight, respect_effort_limits,
        adapt_sigma=False, adapt_temperature=False, ess_target_frac=0.5,
    )
    return tau, torch.cat([history, final[None]])


def _configure_mppi(lib: ctypes.CDLL) -> None:
    sizes = (ctypes.c_int64 * (5 + 2 * len(SERIAL_SHAPES)))()
    lib.mppi_solve_layout.argtypes = [ctypes.c_void_p]
    lib.mppi_solve_layout.restype = None
    lib.mppi_solve_layout(sizes)
    expect = (
        ctypes.sizeof(TREE_CTYPES[torch.float32]),
        ctypes.sizeof(TREE_CTYPES[torch.float64]),
        ctypes.sizeof(CHAIN_CTYPES[torch.float32]),
        ctypes.sizeof(CHAIN_CTYPES[torch.float64]),
        ctypes.sizeof(_MppiParams),
    )
    if tuple(sizes[:5]) != expect:
        raise RuntimeError(f"csrc/mppi_solve.cu layout {tuple(sizes[:5])} != Python's {expect}")
    _check_variants(sizes, 5, "csrc/mppi_solve.cu")
    p = ctypes.c_void_p
    for fn in ("mppi_solve_f32", "mppi_solve_f64"):
        getattr(lib, fn).argtypes = [ctypes.c_int] + [p] * 11 + [ctypes.c_int64, p]
        getattr(lib, fn).restype = ctypes.c_int
    lib.mppi_rng_probe.argtypes = [p, ctypes.c_uint32, ctypes.c_uint32, p, p, p, ctypes.c_int64, p]
    lib.mppi_rng_probe.restype = ctypes.c_int


def _launch_mppi(name, args, dev):
    lib = build.load("mppi_solve", _configure_mppi)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def mppi_solve(
    robot: RobotStruct, q0T, qd0T, goalT, tau_refT, H0, aT0, key, ee_link_idx: int,
    n_iters: int, n_samples: int, dt: float, temperature: float, noise_sigma: float,
    goal_weight: float, effort_weight: float, use_damping: bool = True,
    respect_effort_limits: bool = False,
):
    """K10 `mppi_solve`: the whole MPPI solve in one launch.

    Replaces the JAX package's ops/pallas/solver.py `_mppi_solve_kernel`
    (wrapper `mppi_solve_fused`): per scenario, n_iters times, K =
    n_samples perturbed action sequences a + eps (eps = noise_sigma times
    Philox normals, rng.py's stream under `key`, an int or a key tensor;
    or keyed per scenario, `key` int64 [B, 2] (on the card or the host):
    scenario b draws under key[b] what a one-scenario solve under key[b]
    draws; sample 0 unperturbed), their rollouts of tau = tau_ref + H0 (a + eps)
    with the goal + effort cost, the softmax weights at `temperature`, and
    the nominal update. q0T, qd0T, tau_refT [D, B], goalT [3, B], H0
    [D, D, B] or None, aT0 [H, D, B] the nominal's start (acceleration
    units). Returns (tau [H, D, B] applied torques, costs [n_iters+1, B]):
    costs[t] the best sampled cost of iteration t, costs[n_iters] the final
    nominal's. float32 and float64; raises for K > 1024 or a robot that
    requires grad, on the CPU too.

    Bound on the H100: per scenario, iteration and sample, H folded FD steps
    with the ee FK (csrc/mppi_solve.cu says what the design does about
    it); the inputs and outputs are a few kilobytes per scenario. For
    K <= 256 the instantiation is `kernel_variant(robot)`'s.
    """
    H, D, B, named = _validate_mppi(robot, q0T, qd0T, goalT, tau_refT, H0, aT0, key, n_iters,
                                    n_samples)
    args = (robot, q0T, qd0T, goalT, tau_refT, H0, aT0, key, ee_link_idx, n_iters, n_samples, dt,
            temperature, noise_sigma, goal_weight, effort_weight, use_damping,
            respect_effort_limits)
    if q0T.device.type == "cpu":
        return mppi_solve_reference(*args)
    for name, x in named:
        _check_cuda(x, name)
    dtype, dev = q0T.dtype, q0T.device
    keys = None
    if rng.per_scenario(key):  # the low 32 bits of each word, read as uint32 on the card
        k0 = k1 = 0
        keys = key.to(device=dev).to(torch.int32).contiguous()
    else:
        k0, k1 = rng.key_words(key)
    tree = tree_struct(robot, StepFlags(dt, use_damping))
    ch = chain_struct(robot, ee_link_idx)
    c = mppi_constants(dtype, H, D, goal_weight, effort_weight, noise_sigma, temperature)
    params = _MppiParams(H=H, n_iters=n_iters, K=n_samples, precond=int(H0 is not None),
                         effort=int(respect_effort_limits), key0=k0, key1=k1,
                         keys=None if keys is None else keys.data_ptr(), **c)
    tau = torch.empty((H, D, B), dtype=dtype, device=dev)
    costs = torch.empty((n_iters + 1, B), dtype=dtype, device=dev)
    if B:
        ptrs = (q0T, qd0T, tau_refT, goalT)
        _launch_mppi(
            f"mppi_solve_{_suffix(dtype)}",
            (variant_code(robot), ctypes.byref(tree), ctypes.byref(ch),
             ctypes.byref(params),
             *(x.data_ptr() for x in ptrs), None if H0 is None else H0.data_ptr(),
             aT0.data_ptr(), tau.data_ptr(), costs.data_ptr(), B),
            dev,
        )
        mppi_solve.launches += 1
    return tau, costs


mppi_solve.launches = 0


def philox_probe(counter: torch.Tensor, key):
    """The device generator of csrc/philox.cuh on the counters [4, N] (int64
    words in [0, 2^32), on the card): its words [4, N] (int64) and the
    float32 and float64 normals of the pairs (0, 1) and (2, 3), each [2, N].
    A check of K10's generator against rng.py; no solver calls it."""
    _check_cuda(counter, "counter")
    N = counter.shape[1]
    k0, k1 = rng.key_words(key)
    ctr = counter.to(torch.int32).contiguous()  # the low 32 bits, read as uint32
    bits = torch.empty((4, N), dtype=torch.int32, device=counter.device)
    n32 = torch.empty((2, N), dtype=torch.float32, device=counter.device)
    n64 = torch.empty((2, N), dtype=torch.float64, device=counter.device)
    if N:
        _launch_mppi("mppi_rng_probe", (ctr.data_ptr(), k0, k1, bits.data_ptr(), n32.data_ptr(),
                                        n64.data_ptr(), N), counter.device)
    return bits.to(torch.int64) & rng.MASK32, n32, n64
