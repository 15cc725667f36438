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

`rnea_fwd_learnable` and `rnea_bwd_learnable` are the same two kernels for
a robot whose link constants are tensors on the card that change from call
to call, learnable parameters under training (the model API's
id_impl="kernel" with learnables): the counterpart of the JAX package's
`rnea_pallas` on a traced robot, whose second `pallas_call` reads the link
constants as operands and whose VJP `_scalar_vjp` also gives the robot's
cotangent. The host sends only a template of the topology and the flags
(`tree_template`, cached per topology); each block builds the tree image
from the link tensors on the card once a launch, so a training step reads
nothing back. `rnea_bwd_learnable` sums the partials w.r.t. the link
constants over the scenarios on the card, in a fixed order (a warp's by
shuffles, a block's warps, then the blocks' rows in a second small launch):
the same bits on every run, and one row of the robot's cotangent a block of
traffic, not a value a scenario. It writes the cotangent in its fields'
layout (trans, rot_angles, mass, com, inertia_com with 0 on the three
entries the RNEA does not read, damping; `robot_cotangent` takes views of
it). `rnea_learnable` is their autograd entry, differentiable w.r.t. (q, qd,
qdd) and the robot's trans, rot_angles, mass, com, inertia_com and damping.
Their plain versions are `rnea_fwd_reference` and
`rnea_bwd_learnable_reference` (autograd through `rnea_scalar`).

On a CUDA tensor the wrappers launch the kernel or raise; they take the
plain version only for tensors on the CPU. `rnea_bwd` and
`rnea_bwd_learnable` raise for a revolute joint whose axis is not of unit
length: the reverse sweep assumes unit axes (ROADMAP W6).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from ...models.structs import RobotStruct
from ..dynamics_scalar import GRAVITY, rnea_scalar, rnea_vjp_scalar
from . import build
from .fk import MAX_DOF, _check_cuda, _suffix, check_unit_axes
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

# The robot tensors that `rnea_learnable` differentiates, in the order its
# autograd entry takes them; the kernels also read `axis` (constant).
ROBOT_FIELDS = ("trans", "rot_angles", "mass", "com", "inertia_com", "damping")
# The learnable kernels' link tensors, in the order of csrc/rnea.cu `RobotArrays`.
_LINK_TENSORS = ("trans", "rot_angles", "axis", "mass", "com", "inertia_com", "damping")


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


def rnea_bwd_learnable_reference(robot: RobotStruct, q, qd, qdd, g, use_damping=True,
                                 include_gravity=True, gravity=GRAVITY):
    """Plain version of `rnea_bwd_learnable`: (q̄, q̄d, q̄dd) [B, D] each and
    {field: cotangent} for ROBOT_FIELDS, by `torch.autograd.grad` through
    `rnea_scalar` w.r.t. the inputs and the robot's tensors. An inertia
    entry the RNEA does not read ((1,0), (2,0), (2,1)) gets exactly 0."""
    _check_rnea(robot, (("q", q), ("qd", qd), ("qdd", qdd), ("g", g)))
    with torch.enable_grad():
        leaves = {f: getattr(robot, f).detach().requires_grad_(True) for f in ROBOT_FIELDS}
        xs = [x.detach().requires_grad_(True) for x in (q, qd, qdd)]
        r = dataclasses.replace(robot, **leaves)
        tau = rnea_scalar(r, xs[0].T, xs[1].T, xs[2].T, include_gravity, use_damping, gravity).T
        wrt = [*xs, *leaves.values()]
        grads = torch.autograd.grad(tau, wrt, g, allow_unused=True)
    grads = [torch.zeros_like(x) if gr is None else gr for x, gr in zip(wrt, grads)]
    return (*grads[:3], dict(zip(ROBOT_FIELDS, grads[3:])))


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
    n_shapes = 3 + 2 * len(SERIAL_SHAPES)
    sizes = (ctypes.c_int64 * (n_shapes + 2))()
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
    _check_variants(sizes[:n_shapes], 3, "csrc/rnea.cu")
    p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    n_link = len(_LINK_TENSORS)
    for name, n in (("rnea_fwd", 5), ("rnea_bwd", 8), ("rnea_fwd_learnable", 5 + n_link),
                    ("rnea_bwd_learnable", 10 + n_link)):
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{name}_{sfx}")
            fn.argtypes = [i] + [p] * n + [i64, p]
            fn.restype = ctypes.c_int
    _LEARNABLE_LAYOUT[:] = sizes[n_shapes:]
    lib.rnea_learnable_one_thread_from.argtypes = []
    lib.rnea_learnable_one_thread_from.restype = i64


# The fewest scenarios a block of a learnable launch takes and its most
# blocks (the end of csrc/rnea.cu `rnea_layout`), read when the library loads.
_LEARNABLE_LAYOUT = [0, 0]


def learnable_rows(B: int) -> int:
    """The rows of `rnea_bwd_learnable`'s per-block scratch for B > 0
    scenarios: at least one a block of its grid, which is at most the most
    blocks and at most one a tile of the fewest scenarios."""
    fewest, most = _LEARNABLE_LAYOUT
    return min(-(-B // fewest), most)


def learnable_one_thread_from(device) -> int:
    """The least batch at which the learnable forms run one thread a
    scenario on a serial chain, on the CUDA `device`; below it each
    scenario runs on a group of lanes, one a link (csrc/rnea.cu)."""
    lib = build.load("rnea", _configure)
    with torch.cuda.device(device):
        return int(lib.rnea_learnable_one_thread_from())


def _image_offsets(dtype) -> list:
    """The ctypes mirror's offsets of what the learnable kernels' tree image
    writes over the template (csrc/rnea.cu `rnea_image_layout`)."""
    tree = TREE_CTYPES[dtype]
    link = dict(tree._fields_)["link"]._type_
    return [tree.damping.offset, tree.link.offset, link.F.offset, link.Fa.offset, link.I6.offset]


@functools.lru_cache(maxsize=None)
def _check_image(lib: ctypes.CDLL) -> None:
    out = (ctypes.c_int64 * 10)()
    lib.rnea_image_layout.argtypes = [ctypes.c_void_p]
    lib.rnea_image_layout.restype = None
    lib.rnea_image_layout(out)
    expect = _image_offsets(torch.float32) + _image_offsets(torch.float64)
    if list(out) != expect:
        raise RuntimeError(f"csrc/rnea.cu tree image layout {list(out)} != Python's {expect}")


def _launch(name, args, dev):
    lib = build.load("rnea", _configure)
    if "learnable" in name:
        _check_image(lib)
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
    is constant (robot gradients take `rnea_learnable`)."""

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


# ---------------------------------------------------------------------------
# The learnable forms: the link constants from the card on every launch.
# ---------------------------------------------------------------------------


def tree_template(robot: RobotStruct, flags: StepFlags):
    """The `Tree<T>` template of the learnable kernels: the topology (links'
    parents, joint types and dofs; dofs' links and ancestor masks) and the
    flags, with every link constant and damping 0 (the kernels fill them in
    from the tensors). Depends on the struct's static fields only, so no
    tensor is read; cached per topology, dtype and flags."""
    if robot.dtype not in TREE_CTYPES:
        raise TypeError(f"the dynamics kernels take float32 or float64 robots, not {robot.dtype}")
    return _tree_template(robot.parent, robot.joint_types, robot.dof_links, robot.dtype, flags)


@functools.lru_cache(maxsize=None)
def _tree_template(parent: tuple, joint_types: tuple, dof_links: tuple, dtype, flags: StepFlags):
    L, D = len(parent), len(dof_links)
    if L > MAX_LINKS or D > MAX_DOF:
        raise ValueError(f"{L} links and {D} dofs exceed the kernels' {MAX_LINKS} and {MAX_DOF}")
    ld = {l: d for d, l in enumerate(dof_links)}
    tr = TREE_CTYPES[dtype]()
    tr.n, tr.D, tr.use_damping = L, D, int(flags.use_damping)
    tr.dt = flags.dt
    tr.gravity = flags.gravity if flags.include_gravity else 0.0
    for l in range(L):
        k = tr.link[l]
        k.parent, k.type, k.dof = parent[l], joint_types[l], ld.get(l, -1)
    for d, l in enumerate(dof_links):
        tr.dof_link[d] = l
        anc, k = 0, l
        while k != 0:
            if k in ld:
                anc |= 1 << ld[k]
            k = parent[k]
        tr.anc[d] = anc
        tr.vmax[d] = tr.emax[d] = float("inf")
    return tr


def _learnable_launch(kernel, robot, flags, ins, outs):
    """Launch `kernel` ("rnea_fwd_learnable" or "rnea_bwd_learnable") on the
    robot's build: the entry takes that build's code, the template, the link
    tensors' pointers, the operands' and the outputs' pointers and B.
    Returns whether it launched (not for B = 0)."""
    B = ins[0][1].shape[0]
    if B == 0:
        return False
    links = [getattr(robot, f).detach().contiguous() for f in _LINK_TENSORS]
    args = (variant_code(robot), ctypes.byref(tree_template(robot, flags)),
            *(x.data_ptr() for x in links), *(x.data_ptr() for _, x in ins),
            *(y.data_ptr() for y in outs), B)
    _launch(f"{kernel}_{_suffix(robot.dtype)}", args, ins[0][1].device)
    return True


def _check_link_tensors(robot: RobotStruct):
    check_same(robot, [(f"robot.{f}", getattr(robot, f)) for f in _LINK_TENSORS])


def rnea_fwd_learnable(robot: RobotStruct, q, qd, qdd, use_damping=True, include_gravity=True,
                       gravity=GRAVITY):
    """K4's learnable form: the torques τ [B, D] that give qdd at (q, qd),
    with the link constants read from the robot's tensors on the card at
    every launch. Plain version: `rnea_fwd_reference`."""
    ins = (("q", q), ("qd", qd), ("qdd", qdd))
    _check_rnea(robot, ins)
    _check_link_tensors(robot)
    if q.device.type == "cpu":
        return rnea_fwd_reference(robot, q, qd, qdd, use_damping, include_gravity, gravity)
    for n, x in ins:
        _check_cuda(x, n)
    tau = torch.empty_like(q)
    if _learnable_launch("rnea_fwd_learnable", robot,
                         StepFlags(0.0, use_damping, include_gravity, gravity), ins, (tau,)):
        rnea_fwd_learnable.launches += 1
    return tau


rnea_fwd_learnable.launches = 0


def _cotangent_shapes(robot: RobotStruct) -> dict:
    L = robot.n_links
    return {"trans": (L, 3), "rot_angles": (L, 3), "mass": (L,), "com": (L, 3),
            "inertia_com": (L, 3, 3), "damping": (robot.n_dofs,)}


def robot_cotangent(robot: RobotStruct, flat: torch.Tensor) -> dict:
    """{field: cotangent} for ROBOT_FIELDS, views of the flat cotangent
    `rnea_bwd_learnable` writes: trans [L, 3], rot_angles [L, 3], mass [L],
    com [L, 3], inertia_com [L, 3, 3] (0 on the entries the RNEA does not
    read), damping [D], one after the other."""
    shapes = _cotangent_shapes(robot)
    parts = flat.split([math.prod(s) for s in shapes.values()])
    return {f: x.view(s) for (f, s), x in zip(shapes.items(), parts)}


def robot_cotangent_size(robot: RobotStruct) -> int:
    """The length of the flat robot cotangent, 19 L + D."""
    return sum(math.prod(s) for s in _cotangent_shapes(robot).values())


def rnea_bwd_learnable(robot: RobotStruct, q, qd, qdd, g, use_damping=True, include_gravity=True,
                       gravity=GRAVITY):
    """The VJP of K4's learnable form for the cotangent g [B, D] on τ:
    (q̄, q̄d, q̄dd) [B, D] each and the robot's cotangent {field: tensor} for
    ROBOT_FIELDS, from one kernel and the sum of its blocks' rows on the
    card. Raises for a revolute joint whose axis is not of unit length.
    Plain version: `rnea_bwd_learnable_reference`."""
    ins = (("q", q), ("qd", qd), ("qdd", qdd), ("g", g))
    _check_rnea(robot, ins)
    _check_link_tensors(robot)
    check_unit_axes(robot, range(1, robot.n_links), "rnea_bwd_learnable")
    if q.device.type == "cpu":
        return rnea_bwd_learnable_reference(robot, q, qd, qdd, g, use_damping, include_gravity,
                                            gravity)
    for n, x in ins:
        _check_cuda(x, n)
    outs = (torch.empty_like(q), torch.empty_like(q), torch.empty_like(q))
    B, cols = q.shape[0], robot_cotangent_size(robot)
    if B == 0:
        return (*outs, robot_cotangent(robot, torch.zeros(cols, dtype=q.dtype, device=q.device)))
    build.load("rnea", _configure)  # the layout that sizes the rows
    flat = torch.empty(cols, dtype=q.dtype, device=q.device)
    rows = torch.empty((learnable_rows(B), cols), dtype=q.dtype, device=q.device)
    _learnable_launch("rnea_bwd_learnable", robot,
                      StepFlags(0.0, use_damping, include_gravity, gravity), ins, (*outs, rows, flat))
    rnea_bwd_learnable.launches += 1
    return (*outs, robot_cotangent(robot, flat))


rnea_bwd_learnable.launches = 0


def _detached(robot: RobotStruct) -> RobotStruct:
    return dataclasses.replace(robot, **{f: getattr(robot, f).detach() for f in ROBOT_FIELDS})


class RneaLearnable(torch.autograd.Function):
    """`rnea_fwd_learnable` forward, `rnea_bwd_learnable` backward, w.r.t.
    (q, qd, qdd) and the robot's tensors ROBOT_FIELDS."""

    @staticmethod
    def forward(ctx, q, qd, qdd, trans, rot_angles, mass, com, inertia_com, damping, robot, flags):
        ctx.save_for_backward(q, qd, qdd)
        ctx.args = (robot, flags)
        return rnea_fwd_learnable(robot, q, qd, qdd, flags.use_damping, flags.include_gravity,
                                  flags.gravity)

    @staticmethod
    def backward(ctx, g):
        robot, flags = ctx.args
        gq, gqd, gqdd, rob = rnea_bwd_learnable(robot, *ctx.saved_tensors, g.contiguous(),
                                                flags.use_damping, flags.include_gravity,
                                                flags.gravity)
        return (gq, gqd, gqdd, *(rob[f] for f in ROBOT_FIELDS), None, None)


def rnea_learnable(robot: RobotStruct, q, qd, qdd, include_gravity: bool = True,
                   use_damping: bool = True, gravity: float = GRAVITY):
    """Batched inverse dynamics [B, D] -> [B, D] on K4's learnable form,
    differentiable w.r.t. (q, qd, qdd) and the robot's trans, rot_angles,
    mass, com, inertia_com and damping (`rnea_bwd_learnable`): the
    counterpart of the JAX package's `rnea_pallas` on a traced robot. The
    joint axes stay constant: raises if `robot.axis` requires grad."""
    if robot.axis.requires_grad:
        raise ValueError("robot.axis requires grad: the joint axes are not learnable")
    flags = StepFlags(0.0, use_damping, include_gravity, gravity)
    return RneaLearnable.apply(q, qd, qdd, *(getattr(robot, f) for f in ROBOT_FIELDS),
                               _detached(robot), flags)
