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
panda_with_gripper (branched, prismatic fingers; forward only). The
autograd Function is checked against the plain adjoint, and the wrappers'
refusals on the CPU.
"""

import functools
import os

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
}
H, B, DT = 4, 5, 0.02
TOL = {"f64": (1e-9, 1e-9), "f32": (5e-5, 1e-3)}  # (trajectory abs, gradient rel)
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _structs(robot, dtype):
    urdf, ee = ROBOTS[robot]
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
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
    nd = np.float32 if dtype == "f32" else np.float64
    return tuple(x.astype(nd) for x in (q0, qd0, tau, gps))


@functools.lru_cache(maxsize=None)
def _jax_compiled(robot, with_vjp):
    """JAX's rollout + ee FK (and its VJP for an ee cotangent) for the robot
    in float64, compiled once: the float32 cases run it on their rounded
    inputs, which holds the port's float32 path to JAX's float64 values."""
    js, _, ee = _structs(robot, "f64")
    D = js.n_dofs

    def f(q0, qd0, tau):
        qs, qds = dynamic_rollout_dof_major(js, q0, qd0, tau, DT)
        ps = fk_link_position_dof_first(js, qs.transpose(1, 0, 2).reshape(D, -1), ee)
        return qs, qds, ps.reshape(3, H, B).transpose(1, 0, 2)

    def f_vjp(q0, qd0, tau, gps):
        out, pull = jax.vjp(f, q0, qd0, tau)
        zeros = jnp.zeros_like(out[0])
        return out, pull((zeros, zeros, gps))

    shapes = [jax.ShapeDtypeStruct(s, jnp.float64) for s in ((D, B), (D, B), (H, D, B), (H, 3, B))]
    if with_vjp:
        return jax.jit(f_vjp).lower(*shapes).compile(compiler_options=FAST)
    return jax.jit(f).lower(*shapes[:3]).compile(compiler_options=FAST)


def _jax_rollout(robot, dtype, with_vjp):
    js, _, _ = _structs(robot, dtype)
    args = tuple(x.astype(np.float64) for x in _inputs(robot, dtype, js))
    if not with_vjp:
        return tuple(np.asarray(x) for x in _jax_compiled(robot, False)(*args[:3]))
    out, grads = _jax_compiled(robot, True)(*args)
    return tuple(np.asarray(x) for x in out), tuple(np.asarray(x) for x in grads)


def _port(robot, dtype):
    js, ts, ee = _structs(robot, dtype)
    q0, qd0, tau, gps = (torch.from_numpy(x) for x in _inputs(robot, dtype, js))
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


def test_autograd_function_runs_the_plain_adjoint_and_refuses_state_cotangents():
    js, ts, ee = _structs("iiwa", "f64")
    q0, qd0, tau, gps = (torch.from_numpy(x) for x in _inputs("iiwa", "f64", js))
    tau = tau.clone().requires_grad_(True)
    qd0 = qd0.clone().requires_grad_(True)
    qs, qds, ps = krollout.dynamic_rollout_ee(ts, q0, qd0, tau, DT, ee)
    g_tau, g_qd0 = torch.autograd.grad(ps, (tau, qd0), gps)
    with torch.no_grad():
        ref = krollout.dyn_rollout_ee_bwd_reference(ts, q0, qd0, tau, qs, qds, ps, gps, DT, ee)
    np.testing.assert_array_equal(g_tau.numpy(), ref[0].numpy())
    np.testing.assert_array_equal(g_qd0.numpy(), ref[2].numpy())
    qs, qds, ps = krollout.dynamic_rollout_ee(ts, q0, qd0, tau, DT, ee)
    with pytest.raises(RuntimeError, match="ee trajectory only"):
        torch.autograd.grad(qs.sum() + ps.sum(), tau)


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
