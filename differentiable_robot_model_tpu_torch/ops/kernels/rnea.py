"""Batched inverse dynamics: kernel K4 `rnea_fwd`, its VJP kernel `rnea_bwd`
(csrc/rnea.cu), their plain PyTorch versions, and the autograd entry `rnea`.

Replaces the JAX package's ops/pallas/rnea.py `_kernel` (both RNEA sweeps of
a scenario batch in one launch, with the gravity and damping flags). JAX
takes its VJP from XLA (reverse mode of the scalar path, `_scalar_vjp`);
here it is a kernel too: the RNEA and one reverse sweep of it give q̄ =
(∂τ/∂q)ᵀ ḡ, q̄d = (∂τ/∂qd)ᵀ ḡ and q̄dd = M(q) ḡ at once. Both kernels run
on the instantiation `kernel_variant` picks (a serial chain of a built
shape in registers, else the generic 16- or 32-link build).

Layout: batch-major [B, D] for every operand, as the model API holds them;
the kernels read each scenario's row in place (csrc/rnea.cu says why no
transpose is made). Bound on the H100: per scenario rnea_fwd moves 16 D
bytes (float32) and needs about a thousand FP32 operations for iiwa, so the
bytes and the operations bound it about equally; rnea_bwd needs a reverse
sweep more and is bound by operations. One thread per scenario.

On a CUDA tensor the wrappers launch the kernel or raise; they take the
plain version only for tensors on the CPU. `rnea_bwd` raises for a revolute
joint whose axis is not of unit length: the reverse sweep assumes unit axes
(ROADMAP W6).
"""

from __future__ import annotations

import ctypes

import torch

from ...models.structs import RobotStruct
from ..dynamics_scalar import GRAVITY, rnea_scalar, rnea_vjp_scalar
from . import build
from .fk import _check_cuda, _suffix, check_unit_axes
from .rollout import (
    MAX_LINKS,
    SERIAL_SHAPES,
    TREE_CTYPES,
    StepFlags,
    _check_variants,
    check_constant_robot,
    check_same,
    tree_struct,
    variant_code,
)


def _check_rnea(robot: RobotStruct, named):
    """Every operand is [B, D] for the robot's D, in its dtype and on its
    device. Returns (B, D)."""
    D = robot.n_dofs
    B = named[0][1].shape[0] if named[0][1].dim() == 2 else -1
    for name, x in named:
        if x.dim() != 2 or x.shape[1] != D or x.shape[0] != B:
            raise ValueError(f"{name} must be [B, {D}] like q, got {tuple(x.shape)}")
    check_same(robot, named)
    return B, D


# ---------------------------------------------------------------------------
# The plain PyTorch versions.
# ---------------------------------------------------------------------------


def rnea_fwd_reference(robot: RobotStruct, q, qd, qdd, use_damping=True, include_gravity=True,
                       gravity=GRAVITY):
    """Plain version of `rnea_fwd`: the scalar RNEA (`rnea_scalar`) on
    dof-major lanes, what the JAX package's scalar engine runs. [B, D] in
    and out."""
    _check_rnea(robot, (("q", q), ("qd", qd), ("qdd", qdd)))
    return rnea_scalar(robot, q.T, qd.T, qdd.T, include_gravity, use_damping, gravity).T


def rnea_bwd_reference(robot: RobotStruct, q, qd, qdd, g, use_damping=True, include_gravity=True,
                       gravity=GRAVITY):
    """Plain version of `rnea_bwd`: (q̄, q̄d, q̄dd) [B, D] each for the
    cotangent g [B, D] on τ, the three blocks of one reverse sweep
    (`rnea_vjp_scalar` with `with_qdd`), the arithmetic the kernel runs."""
    _check_rnea(robot, (("q", q), ("qd", qd), ("qdd", qdd), ("g", g)))
    D = robot.n_dofs
    jac = rnea_vjp_scalar(robot, q.T, qd.T, qdd.T, g.T, include_gravity, use_damping, gravity,
                          with_qdd=True)
    return jac[:D].T, jac[D:2 * D].T, jac[2 * D:].T


# ---------------------------------------------------------------------------
# The kernels.
# ---------------------------------------------------------------------------


def _configure(lib: ctypes.CDLL) -> None:
    sizes = (ctypes.c_int64 * (3 + 2 * len(SERIAL_SHAPES)))()
    lib.rnea_layout.argtypes = [ctypes.c_void_p]
    lib.rnea_layout.restype = None
    lib.rnea_layout(sizes)
    expect = (
        ctypes.sizeof(TREE_CTYPES[torch.float32]),
        ctypes.sizeof(TREE_CTYPES[torch.float64]),
        MAX_LINKS,
    )
    if tuple(sizes[:3]) != expect:
        raise RuntimeError(f"csrc/rnea.cu layout {tuple(sizes[:3])} != Python's {expect}")
    _check_variants(sizes, 3, "csrc/rnea.cu")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    for name, n in (("rnea_fwd", 5), ("rnea_bwd", 8)):
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = [i] + [p] * n + [i64, p]
            fn.restype = ctypes.c_int


def _launch(name, args, dev):
    lib = build.load("rnea", _configure)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")


def _rnea_launch(kernel, robot, flags, ins, outs):
    """Launch `kernel` ("rnea_fwd" or "rnea_bwd") on the build
    `kernel_variant` picks for the robot: the entry takes that build's code,
    the tree, the operands' and the outputs' pointers and B. Returns whether
    it launched (not for B = 0)."""
    B = ins[0][1].shape[0]
    if B == 0:
        return False
    args = (variant_code(robot), ctypes.byref(tree_struct(robot, flags)),
            *(x.data_ptr() for _, x in ins), *(y.data_ptr() for y in outs), B)
    _launch(f"{kernel}_{_suffix(robot.dtype)}", args, ins[0][1].device)
    return True


def rnea_fwd(robot: RobotStruct, q, qd, qdd, use_damping=True, include_gravity=True,
             gravity=GRAVITY):
    """K4: the torques τ [B, D] that give qdd [B, D] at (q, qd) [B, D]."""
    ins = (("q", q), ("qd", qd), ("qdd", qdd))
    _check_rnea(robot, ins)
    if q.device.type == "cpu":
        return rnea_fwd_reference(robot, q, qd, qdd, use_damping, include_gravity, gravity)
    for n, x in ins:
        _check_cuda(x, n)
    tau = torch.empty_like(q)
    if _rnea_launch("rnea_fwd", robot, StepFlags(0.0, use_damping, include_gravity, gravity), ins,
                    (tau,)):
        rnea_fwd.launches += 1
    return tau


rnea_fwd.launches = 0


def rnea_bwd(robot: RobotStruct, q, qd, qdd, g, use_damping=True, include_gravity=True,
             gravity=GRAVITY):
    """The VJP of K4 for the cotangent g [B, D] on τ: (q̄, q̄d, q̄dd) [B, D].
    Raises for a revolute joint whose axis is not of unit length."""
    ins = (("q", q), ("qd", qd), ("qdd", qdd), ("g", g))
    _check_rnea(robot, ins)
    check_unit_axes(robot, range(1, robot.n_links), "rnea_bwd")
    if q.device.type == "cpu":
        return rnea_bwd_reference(robot, q, qd, qdd, g, use_damping, include_gravity, gravity)
    for n, x in ins:
        _check_cuda(x, n)
    outs = (torch.empty_like(q), torch.empty_like(q), torch.empty_like(q))
    if _rnea_launch("rnea_bwd", robot, StepFlags(0.0, use_damping, include_gravity, gravity), ins,
                    outs):
        rnea_bwd.launches += 1
    return outs


rnea_bwd.launches = 0


class Rnea(torch.autograd.Function):
    """`rnea_fwd` forward, `rnea_bwd` backward, w.r.t. (q, qd, qdd); the robot
    is constant (robot gradients take the plain path, id_impl="scalar")."""

    @staticmethod
    def forward(ctx, q, qd, qdd, robot, flags):
        check_constant_robot(robot)
        ctx.save_for_backward(q, qd, qdd)
        ctx.args = (robot, flags)
        return rnea_fwd(robot, q, qd, qdd, flags.use_damping, flags.include_gravity, flags.gravity)

    @staticmethod
    def backward(ctx, g):
        robot, flags = ctx.args
        gq, gqd, gqdd = rnea_bwd(robot, *ctx.saved_tensors, g.contiguous(), flags.use_damping,
                                 flags.include_gravity, flags.gravity)
        return gq, gqd, gqdd, None, None


def rnea(robot: RobotStruct, q, qd, qdd, include_gravity: bool = True, use_damping: bool = True,
         gravity: float = GRAVITY):
    """Batched inverse dynamics [B, D] -> [B, D] on K4, differentiable w.r.t.
    (q, qd, qdd) through `rnea_bwd`: the counterpart of the JAX package's
    `rnea_pallas`. Raises if a robot tensor the kernels read requires grad."""
    return Rnea.apply(q, qd, qdd, robot, StepFlags(0.0, use_damping, include_gravity, gravity))
