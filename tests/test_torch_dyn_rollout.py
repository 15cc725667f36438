"""The dynamic rollout kernels' plain versions against the JAX package.

`dyn_rollout_ee_fwd_reference` (the rollout with the ee trajectory) is held
against JAX's `dynamic_rollout_dof_major` + `fk_link_position_dof_first`,
and `dyn_rollout_ee_bwd_reference` (the hand-written implicit-function
adjoint the CUDA kernel transcribes) against `jax.vjp` of the same
function, for an ee cotangent: float64 to 1e-9 (relative to the largest
entry), float32 to 5e-5 on positions and 1e-3 of the largest entry on
gradients (JAX runs in float64 on the float32 cases' rounded inputs, one
compile per robot). Robots: iiwa; the planar 2-link, started near its velocity
limit and pushed past it so that the clamp's mask is exercised; and
panda_with_gripper (branched, prismatic fingers; forward only).

The state-only pair (K5/K6): `dyn_rollout_fwd_reference` against
`dynamic_rollout_dof_major`, and `dyn_rollout_bwd_reference` against its
`jax.vjp` with a cotangent on qs, on qds and on both, float64 at 1e-9; with
gravity off too (the 2-link robot, JAX op by op under `jax.disable_jit()`).
The autograd Functions are checked against `jax.vjp` with every cotangent
at once (qs, qds and the ee trajectory) and against the plain adjoints, and
the wrappers' refusals on the CPU.
"""

import functools
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.ops.kinematics import fk_link_position_dof_first
from differentiable_robot_model_tpu.trajopt.rollout import dynamic_rollout_dof_major
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as krollout

ROBOTS = {
    "iiwa": ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee"),
    "2link": ("2link_robot.urdf", None),  # the last link
    "panda_gripper": ("panda_with_gripper.urdf", "panda_hand"),
    # the 2-link arm turned into a vertical plane, where gravity acts
    "2link_vertical": ("2link_robot.urdf", None),
}
H, B, DT = 4, 5, 0.02
TOL = {"f64": (1e-9, 1e-9), "f32": (5e-5, 1e-3)}  # (trajectory abs, gradient rel)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _j_struct(robot):
    path = os.path.join(jdrm.robot_description_folder, ROBOTS[robot][0])
    if robot != "2link_vertical":
        return j_from_urdf(path, dtype=jnp.float64)
    with open(path) as f:
        text = f.read().replace('<axis xyz="0 0 1" />', '<axis xyz="0 1 0" />')
    with tempfile.TemporaryDirectory() as tmp:
        vertical = os.path.join(tmp, "2link_vertical.urdf")
        with open(vertical, "w") as f:
            f.write(text)
        return j_from_urdf(vertical, dtype=jnp.float64)


@functools.lru_cache(maxsize=None)
def _structs(robot, dtype):
    _, ee = ROBOTS[robot]
    js = _j_struct(robot)
    js = js.astype(jnp.float32 if dtype == "f32" else jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.link_index(ee) if ee else js.n_links - 1


def _inputs(robot, dtype, js):
    D = js.n_dofs
    rng = np.random.default_rng(43)
    q0 = rng.uniform(-0.5, 0.5, (D, B))
    qd0 = rng.uniform(-0.2, 0.2, (D, B))
    tau = rng.uniform(-3, 3, (H, D, B))
    if robot == "2link":  # near the 10 rad/s limit, pushed past it
        qd0 = rng.uniform(9.0, 9.9, (D, B)) * rng.choice([-1.0, 1.0], (D, B))
        tau = 200.0 * np.sign(qd0)[None] * rng.uniform(0.2, 1.0, (H, D, B))
    gps = rng.normal(size=(H, 3, B))
    gqs, gqds = rng.normal(size=(H, js.n_dofs, B)), rng.normal(size=(H, js.n_dofs, B))
    nd = np.float32 if dtype == "f32" else np.float64
    return tuple(x.astype(nd) for x in (q0, qd0, tau, gps, gqs, gqds))


@functools.lru_cache(maxsize=None)
def _jax_compiled(robot, with_vjp, include_gravity=True):
    """JAX's rollout + ee FK (and its VJP for cotangents on qs, qds and the
    ee trajectory) for the robot in float64, compiled once: the float32
    cases run it on their rounded inputs, which holds the port's float32
    path to JAX's float64 values."""
    js, _, ee = _structs(robot, "f64")
    D = js.n_dofs

    def f(q0, qd0, tau):
        qs, qds = dynamic_rollout_dof_major(js, q0, qd0, tau, DT, include_gravity=include_gravity)
        ps = fk_link_position_dof_first(js, qs.transpose(1, 0, 2).reshape(D, -1), ee)
        return qs, qds, ps.reshape(3, H, B).transpose(1, 0, 2)

    def f_vjp(q0, qd0, tau, gps, gqs, gqds):
        out, pull = jax.vjp(f, q0, qd0, tau)
        return out, pull((gqs, gqds, gps))

    shapes = [jax.ShapeDtypeStruct(s, jnp.float64)
              for s in ((D, B), (D, B), (H, D, B), (H, 3, B), (H, D, B), (H, D, B))]
    if with_vjp:
        return jax.jit(f_vjp).lower(*shapes).compile(compiler_options=FAST)
    return jax.jit(f).lower(*shapes[:3]).compile(compiler_options=FAST)


# Which cotangents reach JAX's VJP: (gps, gqs, gqds) each kept or zeroed.
PATTERNS = {"ee": (1, 0, 0), "qs": (0, 1, 0), "qds": (0, 0, 1), "qs+qds": (0, 1, 1),
            "qs+qds+ee": (1, 1, 1)}


def _jax_rollout(robot, dtype, with_vjp, pattern="ee", include_gravity=True):
    js, _, _ = _structs(robot, dtype)
    args = tuple(x.astype(np.float64) for x in _inputs(robot, dtype, js))
    if not with_vjp:
        return tuple(np.asarray(x) for x in _jax_compiled(robot, False, include_gravity)(*args[:3]))
    cot = tuple(c * keep for c, keep in zip(args[3:], PATTERNS[pattern]))
    out, grads = _jax_compiled(robot, True, include_gravity)(*args[:3], *cot)
    return tuple(np.asarray(x) for x in out), tuple(np.asarray(x) for x in grads)


def _port(robot, dtype):
    js, ts, ee = _structs(robot, dtype)
    q0, qd0, tau, gps, _, _ = (torch.from_numpy(x) for x in _inputs(robot, dtype, js))
    qs, qds, ps = krollout.dyn_rollout_ee_fwd_reference(ts, q0, qd0, tau, DT, ee)
    gtau, gq0, gqd0 = krollout.dyn_rollout_ee_bwd_reference(ts, q0, qd0, tau, qs, qds, ps, gps, DT, ee)
    return (qs, qds, ps), (gq0, gqd0, gtau)


@pytest.mark.parametrize(
    "robot,dtype", [("iiwa", "f64"), ("iiwa", "f32"), ("2link", "f64"), ("panda_gripper", "f64")]
)
def test_plain_forward_matches_jax(robot, dtype):
    out, _ = _port(robot, dtype)
    j = _jax_rollout(robot, dtype, robot != "panda_gripper")
    j_out = j if robot == "panda_gripper" else j[0]
    for name, t, jv in zip(("qs", "qds", "ps"), out, j_out):
        if name == "ps" or dtype == "f64":
            np.testing.assert_allclose(t.numpy(), jv, rtol=0, atol=TOL[dtype][0], err_msg=name)


@pytest.mark.parametrize("robot,dtype", [("iiwa", "f64"), ("iiwa", "f32"), ("2link", "f64")])
def test_plain_adjoint_matches_jax_vjp(robot, dtype):
    out, grads = _port(robot, dtype)
    _, j_grads = _jax_rollout(robot, dtype, True)
    for name, t, jv in zip(("gq0", "gqd0", "gtau"), grads, j_grads):
        scale = float(np.abs(jv).max())
        np.testing.assert_allclose(t.numpy(), jv, rtol=0, atol=TOL[dtype][1] * scale, err_msg=name)
    if robot == "2link":  # the velocity clamp was active, so its mask mattered
        js, _, _ = _structs(robot, dtype)
        assert np.any(np.abs(out[1].numpy()) == np.asarray(js.limit_velocity)[None, :, None])


def _close(t, j, tol=1e-9):
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=tol * scale)


def test_state_only_plain_forward_matches_jax():
    js, ts, _ = _structs("iiwa", "f64")
    q0, qd0, tau = (torch.from_numpy(x) for x in _inputs("iiwa", "f64", js)[:3])
    qs, qds = krollout.dyn_rollout_fwd(ts, q0, qd0, tau, DT)  # the plain version on the CPU
    j, _ = _jax_rollout("iiwa", "f64", True)
    _close(qs, j[0])
    _close(qds, j[1])


@pytest.mark.parametrize("pattern", ["qs", "qds", "qs+qds"])
@pytest.mark.parametrize("robot", ["iiwa", "2link"])
def test_state_only_plain_adjoint_matches_jax_vjp(robot, pattern):
    js, ts, _ = _structs(robot, "f64")
    q0, qd0, tau, _, gqs, gqds = (torch.from_numpy(x) for x in _inputs(robot, "f64", js))
    qs, qds = krollout.dyn_rollout_fwd_reference(ts, q0, qd0, tau, DT)
    keep = PATTERNS[pattern]
    got = krollout.dyn_rollout_bwd(
        ts, q0, qd0, tau, qs, qds, gqs if keep[1] else None, gqds if keep[2] else None, DT
    )
    _, j_grads = _jax_rollout(robot, "f64", True, pattern)
    for name, t, jv in zip(("gtau", "gq0", "gqd0"), got, (j_grads[2], j_grads[0], j_grads[1])):
        assert t.shape == jv.shape, name
        _close(t, jv)


def test_autograd_function_runs_the_plain_adjoint_and_refuses_state_cotangents():
    """Every cotangent at once through `dynamic_rollout_ee` (on qs, qds and
    the ee trajectory) against `jax.vjp` of JAX's scan twin, float64 at
    1e-9; and `dynamic_rollout` through qs and qds against the plain
    adjoint, element for element. The kernels refuse no cotangent: the name
    is kept from when the qs and qds cotangents were refused, so that the
    test stays traceable across versions; it now checks that they are taken."""
    js, ts, ee = _structs("iiwa", "f64")
    q0, qd0, tau, gps, gqs, gqds = (torch.from_numpy(x) for x in _inputs("iiwa", "f64", js))
    x = [t.clone().requires_grad_(True) for t in (q0, qd0, tau)]
    qs, qds, ps = krollout.dynamic_rollout_ee(ts, *x, DT, ee)
    grads = torch.autograd.grad((qs * gqs).sum() + (qds * gqds).sum() + (ps * gps).sum(), x)
    _, j_grads = _jax_rollout("iiwa", "f64", True, "qs+qds+ee")
    for name, t, jv in zip(("gq0", "gqd0", "gtau"), grads, j_grads):
        _close(t, jv)
    x = [t.clone().requires_grad_(True) for t in (q0, qd0, tau)]
    qs, qds = krollout.dynamic_rollout(ts, *x, DT)
    grads = torch.autograd.grad((qs * gqs).sum() + (qds * gqds).sum(), x)
    with torch.no_grad():
        gtau, gq0, gqd0 = krollout.dyn_rollout_bwd_reference(ts, q0, qd0, tau, qs, qds, gqs, gqds, DT)
    for a, b in zip(grads, (gq0, gqd0, gtau)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_state_only_rollout_without_gravity_matches_jax():
    """R2: the kernels' gravity flag, on the plain versions: the 2-link arm
    in a vertical plane without gravity, forward and VJP (cotangents on qs
    and qds) against JAX's `dynamic_rollout_dof_major(include_gravity=False)`."""
    js, ts, _ = _structs("2link_vertical", "f64")
    q0, qd0, tau, _, gqs, gqds = (torch.from_numpy(x) for x in _inputs("2link_vertical", "f64", js))
    j_out, j_grads = _jax_rollout("2link_vertical", "f64", True, "qs+qds", include_gravity=False)
    qs, qds = krollout.dyn_rollout_fwd(ts, q0, qd0, tau, DT, include_gravity=False)
    _close(qs, j_out[0])
    _close(qds, j_out[1])
    with_gravity = krollout.dyn_rollout_fwd_reference(ts, q0, qd0, tau, DT)[0]
    assert (with_gravity - qs).abs().max() > 1e-3  # gravity acts in this plane
    gtau, gq0, gqd0 = krollout.dyn_rollout_bwd(ts, q0, qd0, tau, qs, qds, gqs, gqds, DT,
                                               include_gravity=False)
    for got, jv in zip((gq0, gqd0, gtau), j_grads):
        _close(got, jv)


def test_rollout_wrappers_refuse_what_the_kernels_cannot_run():
    js, ts, ee = _structs("iiwa", "f32")
    q0, qd0 = torch.zeros(7, 3), torch.zeros(7, 3)
    with pytest.raises(ValueError, match="tauT must be"):
        krollout.dyn_rollout_ee_fwd(ts, q0, qd0, torch.zeros(7, 3), DT, ee)
    with pytest.raises(ValueError, match="dofs"):
        krollout.dyn_rollout_ee_fwd(ts, q0, qd0, torch.zeros(2, 6, 3), DT, ee)
    with pytest.raises(ValueError, match="float64"):
        krollout.dyn_rollout_ee_fwd(ts, q0.double(), qd0, torch.zeros(2, 7, 3), DT, ee)
    before = (krollout.dyn_rollout_ee_fwd.launches, krollout.dyn_rollout_ee_bwd.launches)
    qs, qds, ps = krollout.dyn_rollout_ee_fwd(ts, q0, qd0, torch.zeros(2, 7, 3), DT, ee)
    krollout.dyn_rollout_ee_bwd(ts, q0, qd0, torch.zeros(2, 7, 3), qs, qds, ps, torch.ones(2, 3, 3), DT, ee)
    assert qs.shape == (2, 7, 3) and ps.shape == (2, 3, 3)
    # the CPU runs the plain versions
    assert (krollout.dyn_rollout_ee_fwd.launches, krollout.dyn_rollout_ee_bwd.launches) == before
