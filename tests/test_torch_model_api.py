"""The port's model API against the JAX package's `DifferentiableRobotModel`.

Both packages build the robot from their own byte-identical copy of the
URDF, in float64 (the struct route is checked too: the port's arrays equal
the JAX struct's). Every compute_* method, `update_kinematic_state` and the
`recursive=True` FK (held to the same JAX poses as the sweep) take the same
numpy inputs on iiwa, panda_with_gripper (two prismatic fingers on a branch)
and trifinger_edu (three branched fingers), with batch shapes (), (4,) and
(2, 3), and must agree to 1e-9 relative to each output's largest entry. Inverse dynamics runs on both
engines, "scalar" and "kernel" (the kernel's plain version on the CPU).
JAX runs op by op under `jax.disable_jit()` once per robot on six
configurations; each batch shape of the port is compared with the matching
rows. One float32 case holds the port to the same float64 JAX values at
tests/test_kinematics_dynamics.py `TestFloat32`'s tolerances, and the
probes check the errors: an unknown link, mismatched batch shapes, an
unknown `id_impl`.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu_torch.models.structs import ARRAY_FIELDS

ROBOTS = {
    "iiwa": ("DifferentiableKUKAiiwa", "iiwa_link_ee"),
    "panda_gripper": ("DifferentiablePandaWithGripper", "panda_leftfinger"),
    "trifinger": ("DifferentiableTrifingerEdu", None),  # the last link
}
BATCHES = [(), (4,), (2, 3)]
N = 6  # configurations given to JAX; each batch shape takes the first prod(shape)
QUANTITIES = ("fk", "fk_recursive", "fk_all_links", "kinematic_state", "jacobian",
              "id_scalar", "id_kernel", "id_kernel_no_gravity_damping", "nle", "mass",
              "fd_crb", "fd_old", "fd_aba")


@functools.lru_cache(maxsize=None)
def _models(robot):
    cls, ee = ROBOTS[robot]
    jm = getattr(jdrm, cls)(dtype=jnp.float64)
    tm = getattr(drt, cls)(dtype=torch.float64, device="cpu")
    return jm, tm, ee or jm.get_link_names()[-1]


def _inputs(D):
    rng = np.random.default_rng(21)
    return tuple(rng.uniform(-1.0, 1.0, (N, D)) for _ in range(3))  # q, qd, qdd/f


def _call(m, quantity, ee, q, qd, x, **engine):
    """One model-API call of either package (`engine` goes to the port only)."""
    if quantity == "fk":
        return m.compute_forward_kinematics(q, ee)
    if quantity == "fk_recursive":
        return m.compute_forward_kinematics(q, ee, recursive=True)
    if quantity == "fk_all_links":
        out = m.compute_forward_kinematics_all_links(q)
        return [out[k] for k in sorted(out)]
    if quantity == "kinematic_state":
        return tuple(m.update_kinematic_state(q, qd))
    if quantity == "jacobian":
        return m.compute_endeffector_jacobian(q, ee)
    if quantity in ("id_scalar", "id_kernel"):
        return m.compute_inverse_dynamics(q, qd, x, **engine)
    if quantity == "id_kernel_no_gravity_damping":
        return m.compute_inverse_dynamics(q, qd, x, include_gravity=False, use_damping=False, **engine)
    if quantity == "nle":
        return m.compute_non_linear_effects(q, qd)
    if quantity == "mass":
        return m.compute_lagrangian_inertia_matrix(q)
    if quantity == "fd_crb":  # damping on, as fd_old's default
        return m.compute_forward_dynamics(q, qd, x, use_damping=True)
    if quantity == "fd_old":
        return m.compute_forward_dynamics_old(q, qd, x)
    if quantity == "fd_aba":
        return m.compute_forward_dynamics(q, qd, x, method="aba")
    raise KeyError(quantity)


# The JAX side of each quantity: one call serves both FK routes (the ee
# link's poses among all links'), the two engines of ID and the two FD
# entries that agree by definition.
_JAX_CALL = {"fk": "fk_all_links", "fk_recursive": "fk_all_links", "id_kernel": "id_scalar",
             "fd_old": "fd_crb"}


def _flat(x):
    return [x] if not isinstance(x, (tuple, list)) else [y for e in x for y in _flat(e)]


@functools.lru_cache(maxsize=None)
def _jax(robot, quantity):
    jm, _, ee = _models(robot)
    q, qd, x = _inputs(jm.n_dofs)
    with jax.disable_jit():
        out = _flat(_call(jm, quantity, ee, q, qd, x))
    return [np.asarray(o) for o in out]


def _expected(robot, quantity):
    _, tm, ee = _models(robot)
    out = _jax(robot, _JAX_CALL.get(quantity, quantity))
    if quantity in ("fk", "fk_recursive"):  # the ee link's (position, quaternion)
        i = sorted(tm.get_link_names()).index(ee)
        out = out[2 * i: 2 * i + 2]
    return out


def test_struct_route_matches_the_jax_struct():
    for robot in ROBOTS:
        jm, tm, _ = _models(robot)
        for f in ARRAY_FIELDS:
            np.testing.assert_array_equal(getattr(tm.struct, f).numpy(), np.asarray(getattr(jm.struct, f)))


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_model_api_matches_jax_f64(robot, quantity):
    _, tm, ee = _models(robot)
    q, qd, x = _inputs(tm.n_dofs)
    engine = {"id_scalar": {"id_impl": "scalar"}}.get(quantity, {})
    if quantity.startswith("id_kernel"):
        engine = {"id_impl": "kernel"}
    expected = _expected(robot, quantity)
    for bs in BATCHES:
        n = int(np.prod(bs))
        args = [torch.from_numpy(a[:n].reshape(bs + (-1,))) for a in (q, qd, x)]
        got = _flat(_call(tm, quantity, ee, *args, **engine))
        assert len(got) == len(expected)
        for t, j in zip(got, expected):
            j = j[:n].reshape(bs + j.shape[1:])
            assert t.dtype == torch.float64 and tuple(t.shape) == j.shape, (bs, t.shape, j.shape)
            scale = max(1.0, float(np.abs(j).max()))
            np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=1e-9 * scale, err_msg=str(bs))


def test_float32_meets_the_reference_tolerances():
    """tests/test_kinematics_dynamics.py TestFloat32: FK 1e-5, ID rtol 2e-4
    / atol 5e-4 (on both engines), against JAX in float64."""
    _, _, ee = _models("iiwa")
    t32 = drt.DifferentiableKUKAiiwa(device="cpu")  # float32
    q, qd, qdd = _inputs(7)
    pos64, tau64 = _expected("iiwa", "fk")[0], _expected("iiwa", "id_scalar")[0]
    q32, qd32, qdd32 = (torch.from_numpy(x.astype(np.float32)) for x in (q, qd, qdd))
    pos32, _ = t32.compute_forward_kinematics(q32, ee)
    assert pos32.dtype == torch.float32
    np.testing.assert_allclose(pos32.numpy(), np.asarray(pos64), rtol=0, atol=1e-5)
    for impl in ("scalar", "kernel"):
        tau32 = t32.compute_inverse_dynamics(q32, qd32, qdd32, id_impl=impl)
        np.testing.assert_allclose(tau32.numpy(), np.asarray(tau64), rtol=2e-4, atol=5e-4)


def test_probes_raise_as_jax_does():
    jm, tm, ee = _models("iiwa")
    q = np.zeros((2, 7))
    for m in (jm, tm):
        with pytest.raises(KeyError, match="Unknown link"):
            m.compute_forward_kinematics(q, "no_such_link")
        with pytest.raises(AssertionError, match="Batch size mismatch"):
            m.compute_inverse_dynamics(q, np.zeros((3, 7)), q)
    with pytest.raises(ValueError, match="id_impl"):
        tm.compute_inverse_dynamics(q, q, q, id_impl="pallas")
    # inputs are cast to the model's dtype and moved to its device
    tau = tm.compute_non_linear_effects(q.astype(np.float32), [[0.0] * 7] * 2)
    assert tau.dtype == torch.float64 and tau.device.type == "cpu" and tau.shape == (2, 7)


def test_kernel_engine_gradients_match_the_scalar_engine():
    """The "kernel" engine's autograd (the plain `rnea_bwd` on the CPU)
    against autograd through the scalar RNEA, w.r.t. q, qd and qdd."""
    _, tm, _ = _models("panda_gripper")
    args = [torch.from_numpy(a[:4]) for a in _inputs(tm.n_dofs)]
    grads = {}
    for impl in ("scalar", "kernel"):
        x = [a.clone().requires_grad_(True) for a in args]
        tau = tm.compute_inverse_dynamics(*x, id_impl=impl)
        grads[impl] = torch.autograd.grad((tau * tau).sum(), x)
    for a, b in zip(grads["kernel"], grads["scalar"]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=1e-9 * float(b.abs().max()))
