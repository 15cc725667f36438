"""K4's plain version and the plain version of its VJP against the JAX package.

`rnea_fwd_reference` (what `rnea_fwd` computes on the card) is held to
`rnea_pallas` run in Pallas interpret mode, as tests/test_pallas.py runs it
(float32, atol 1e-4), and to `rnea_scalar` in float64 at 1e-9 (relative to
the largest torque) with gravity and damping each on and off, on iiwa,
panda_with_gripper (branched, prismatic fingers) and kuka_iiwa7_allegro
(29 links, the kernels' 32-link build). `rnea_bwd_reference` (the
hand-written VJP that `rnea_bwd` transcribes: RNEA partials by forward
tangents, M(q) g for qdd) is held to `jax.vjp` of `rnea_scalar` in float64
at 1e-9. The JAX scalar dynamics run op by op under `jax.disable_jit()`, on
dof-major lanes (the values of the vmapped per-sample function). The
autograd entry is checked against the plain VJP, and the wrappers'
refusals and the kernels' gravity flag on the CPU.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import differentiable_robot_model_tpu as jdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.ops.dynamics_scalar import rnea_scalar
from differentiable_robot_model_tpu.ops.pallas.rnea import rnea_pallas
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.kernels import rnea as krnea
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as krollout

ROBOTS = {
    "iiwa": "kuka_iiwa_iiwa7.urdf",
    "panda_gripper": "panda_with_gripper.urdf",
    "allegro_kuka": "kuka_iiwa7_allegro.urdf",
}
FLAGS = [(True, True), (True, False), (False, True), (False, False)]  # (gravity, damping)
FLAG_IDS = ["g1d1", "g1d0", "g0d1", "g0d0"]
B = 6


@functools.lru_cache(maxsize=None)
def _structs(robot, dtype="f64"):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, ROBOTS[robot]), dtype=jnp.float64)
    js = js.astype(jnp.float32 if dtype == "f32" else jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts


def _inputs(D, dtype=np.float64):
    rng = np.random.default_rng(11)
    return tuple(rng.uniform(-1.0, 1.0, (B, D)).astype(dtype) for _ in range(4))  # q, qd, qdd, g


def _close(t, j, tol=1e-9):
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else t
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("flags", [(True, True), (False, False)], ids=["g1d1", "g0d0"])
@pytest.mark.parametrize("robot", ["iiwa", "panda_gripper"])
def test_plain_matches_rnea_pallas_interpret(robot, flags):
    include_gravity, use_damping = flags
    js, ts = _structs(robot, "f32")
    q, qd, qdd, _ = _inputs(js.n_dofs, np.float32)
    with pltpu.force_tpu_interpret_mode():
        tau_j = rnea_pallas(js, jnp.asarray(q), jnp.asarray(qd), jnp.asarray(qdd),
                            include_gravity, use_damping)
    tau_t = krnea.rnea_fwd(ts, *(torch.from_numpy(x) for x in (q, qd, qdd)),
                           use_damping=use_damping, include_gravity=include_gravity)
    assert tau_t.dtype == torch.float32 and tau_t.shape == (B, js.n_dofs)
    np.testing.assert_allclose(tau_t.numpy(), np.asarray(tau_j), rtol=0, atol=1e-4)


@functools.lru_cache(maxsize=None)
def _jax_scalar(robot, flags, with_vjp):
    js, _ = _structs(robot)
    q, qd, qdd, g = (jnp.asarray(x.T) for x in _inputs(js.n_dofs))
    f = lambda a, b, c: rnea_scalar(js, a, b, c, *flags)
    with jax.disable_jit():
        if not with_vjp:
            return np.asarray(f(q, qd, qdd)).T
        _, pull = jax.vjp(f, q, qd, qdd)
        return tuple(np.asarray(x).T for x in pull(g))


@pytest.mark.parametrize("flags", FLAGS, ids=FLAG_IDS)
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_plain_matches_rnea_scalar_f64(robot, flags):
    include_gravity, use_damping = flags
    js, ts = _structs(robot)
    q, qd, qdd, _ = (torch.from_numpy(x) for x in _inputs(js.n_dofs))
    tau = krnea.rnea_fwd(ts, q, qd, qdd, use_damping=use_damping, include_gravity=include_gravity)
    _close(tau, _jax_scalar(robot, flags, False))


@pytest.mark.parametrize("robot,flags", [("iiwa", (True, True)), ("panda_gripper", (False, False))])
def test_plain_vjp_matches_jax_vjp_f64(robot, flags):
    include_gravity, use_damping = flags
    js, ts = _structs(robot)
    q, qd, qdd, g = (torch.from_numpy(x) for x in _inputs(js.n_dofs))
    got = krnea.rnea_bwd(ts, q, qd, qdd, g, use_damping=use_damping, include_gravity=include_gravity)
    for name, t, j in zip(("gq", "gqd", "gqdd"), got, _jax_scalar(robot, flags, True)):
        assert t.shape == (B, js.n_dofs), name
        _close(t, j)


def test_autograd_function_runs_the_plain_vjp():
    _, ts = _structs("iiwa")
    q, qd, qdd, g = (torch.from_numpy(x) for x in _inputs(7))
    x = [t.clone().requires_grad_(True) for t in (q, qd, qdd)]
    tau = krnea.rnea(ts, *x, include_gravity=False, use_damping=True)
    np.testing.assert_array_equal(
        tau.detach().numpy(), krnea.rnea_fwd_reference(ts, q, qd, qdd, True, False).numpy()
    )
    grads = torch.autograd.grad(tau, x, g)
    ref = krnea.rnea_bwd_reference(ts, q, qd, qdd, g, use_damping=True, include_gravity=False)
    for a, b in zip(grads, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    # robot gradients belong to the plain path: the kernel entry refuses them
    ts_grad = dataclasses.replace(ts, mass=ts.mass.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="requires grad"):
        krnea.rnea(ts_grad, q, qd, qdd)


def test_rnea_wrappers_refuse_what_the_kernels_cannot_run():
    _, ts = _structs("iiwa", "f32")
    q = torch.zeros(3, 7)
    with pytest.raises(ValueError, match=r"\[B, 7\]"):
        krnea.rnea_fwd(ts, q, q, torch.zeros(3, 6))
    with pytest.raises(ValueError, match=r"\[B, 7\]"):
        krnea.rnea_bwd(ts, q, q, q, torch.zeros(2, 7))
    with pytest.raises(ValueError, match="float64"):
        krnea.rnea_fwd(ts, q.double(), q, q)
    before = (krnea.rnea_fwd.launches, krnea.rnea_bwd.launches)
    krnea.rnea_fwd(ts, q, q, q)
    krnea.rnea_bwd(ts, q, q, q, q)
    assert (krnea.rnea_fwd.launches, krnea.rnea_bwd.launches) == before  # the CPU runs the plain versions


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tree_struct_carries_the_gravity_flag(dtype):
    _, ts = _structs("iiwa")
    ts = ts.to(dtype=dtype)
    nd = np.float32 if dtype == torch.float32 else np.float64
    on = krollout.tree_struct(ts, krollout.StepFlags(use_damping=False, gravity=3.7))
    off = krollout.tree_struct(ts, krollout.StepFlags(use_damping=False, include_gravity=False))
    assert on.gravity == float(nd(3.7)) and on.use_damping == 0
    assert off.gravity == 0.0
    assert krollout.tree_struct(ts, krollout.StepFlags()).gravity == float(nd(9.81))
