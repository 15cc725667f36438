"""The port's lie, spatial, kinematics and dynamics functions, and the
unbatched dynamic rollout, against the JAX package's, in float64 at 1e-9
(relative to each output's largest entry).

The lie and spatial functions take the same batched numpy inputs in both
packages (rotations built by JAX's `exp_so3`, small angles included, so the
Taylor branches run). The kinematics and dynamics functions run on
panda_with_gripper (branched, with two prismatic fingers): JAX's per-sample
functions on each of two configurations, op by op under `jax.disable_jit()`,
the port's on both at once as a batch.
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
from differentiable_robot_model_tpu.ops import dynamics as jdyn
from differentiable_robot_model_tpu.ops import kinematics as jkin
from differentiable_robot_model_tpu.ops import lie as jlie
from differentiable_robot_model_tpu.ops import spatial as jsp
from differentiable_robot_model_tpu.trajopt import rollout as jroll
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops import dynamics as tdyn
from differentiable_robot_model_tpu_torch.ops import kinematics as tkin
from differentiable_robot_model_tpu_torch.ops import lie as tlie
from differentiable_robot_model_tpu_torch.ops import spatial as tsp
from differentiable_robot_model_tpu_torch.trajopt import rollout as troll


def _rng():
    return np.random.default_rng(5)


def _omegas(rng, n):
    """Rotation vectors with |omega| < pi, two of them tiny."""
    w = rng.uniform(-1.0, 1.0, (n, 3))
    w[0] *= 1e-6
    w[1] = 0.0
    return w


def _rotations(rng, n):
    return np.asarray(jlie.exp_so3(jnp.asarray(rng.uniform(-1.5, 1.5, (n, 3)))))


def _sym(rng, n):
    A = rng.uniform(-1.0, 1.0, (n, 3, 3))
    return A @ np.swapaxes(A, -1, -2) + np.eye(3)


def _lie_inputs(name):
    rng = _rng()
    u = lambda *s: rng.uniform(-1.0, 1.0, s)
    unit = lambda n: (lambda a: a / np.linalg.norm(a, axis=-1, keepdims=True))(u(n, 3))
    quat = lambda n: (lambda x: x / np.linalg.norm(x, axis=-1, keepdims=True))(u(n, 4))
    xi = np.concatenate([u(6, 3), _omegas(rng, 6)], -1)
    R = _rotations(rng, 5)
    return {
        "skew": (u(2, 3, 3),), "cross": (u(5, 3), u(5, 3)),
        "x_rot": (u(5),), "y_rot": (u(5),), "z_rot": (u(5),),
        "rpy_to_matrix": (u(5, 3),), "axis_angle_to_matrix": (unit(5), u(5)),
        "exp_so3": (_omegas(rng, 6),), "log_so3": (R,), "matrix_to_quaternion": (R,),
        "quaternion_to_matrix": (u(5, 4),), "quaternion_to_axis_angle": (quat(5),),
        "axis_angle_to_quaternion": (_omegas(rng, 6),),
        "integrate_axis_angle": (u(5, 3), u(5, 3), 0.1), "angular_error": (R, _rotations(rng, 5)),
        "hat_so3": (u(5, 3),), "vee_so3": (u(5, 3, 3),), "hat_se3": (u(5, 6),),
        "vee_se3": (u(5, 4, 4),), "homogeneous_matrix": (R, u(5, 3)),
        "homogeneous_inverse": (np.asarray(jlie.homogeneous_matrix(jnp.asarray(R), jnp.asarray(u(5, 3)))),),
        "exp_se3": (xi,), "log_se3": (R, u(5, 3)),
        # spatial
        "motion_cross_motion": (u(5, 6), u(5, 6)), "motion_cross_force": (u(5, 6), u(5, 6)),
        "spatial_inertia_matrix": (rng.uniform(0.5, 2.0, 5), u(5, 3), _sym(rng, 5)),
        "inertia_times_motion": (rng.uniform(0.5, 2.0, 5), u(5, 3), _sym(rng, 5), u(5, 6)),
        "motion_dot_force": (u(5, 6), u(5, 6)), "motion_to_world": (R, u(5, 3), u(5, 6)),
        "force_to_world": (R, u(5, 3), u(5, 6)), "force_at_point": (u(5, 6), u(5, 3)),
        "transform_compose": (R, u(5, 3), _rotations(rng, 5), u(5, 3)),
        "transform_inverse": (R, u(5, 3)), "transform_apply": (R, u(5, 3), u(5, 3)),
    }[name]


LIE = ("skew", "cross", "x_rot", "y_rot", "z_rot", "rpy_to_matrix", "axis_angle_to_matrix",
       "exp_so3", "log_so3", "matrix_to_quaternion", "quaternion_to_matrix",
       "quaternion_to_axis_angle", "axis_angle_to_quaternion", "integrate_axis_angle",
       "angular_error", "hat_so3", "vee_so3", "hat_se3", "vee_se3", "homogeneous_matrix",
       "homogeneous_inverse", "exp_se3", "log_se3")
SPATIAL = ("motion_cross_motion", "motion_cross_force", "spatial_inertia_matrix",
           "inertia_times_motion", "motion_dot_force", "motion_to_world", "force_to_world",
           "force_at_point", "transform_compose", "transform_inverse", "transform_apply")


def _flat(x):
    return [x] if not isinstance(x, (tuple, list)) else [y for e in x for y in _flat(e)]


def _assert_close(t_out, j_out):
    t_out, j_out = _flat(t_out), _flat(j_out)
    assert len(t_out) == len(j_out)
    for t, j in zip(t_out, j_out):
        t, j = t.detach().numpy(), np.asarray(j)
        assert t.shape == j.shape
        scale = max(1.0, float(np.abs(j).max()))
        np.testing.assert_allclose(t, j, rtol=0, atol=1e-9 * scale)


@pytest.mark.parametrize("name", LIE + SPATIAL)
def test_lie_and_spatial_match_jax_f64(name):
    jmod, tmod = (jlie, tlie) if name in LIE else (jsp, tsp)
    args = _lie_inputs(name)
    j = getattr(jmod, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args))
    t = getattr(tmod, name)(*(torch.from_numpy(np.array(a)) if isinstance(a, np.ndarray) else a for a in args))
    _assert_close(t, j)


@functools.lru_cache(maxsize=None)
def _robot():
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, "panda_with_gripper.urdf"),
                     dtype=jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts


def _state(D, n=2):
    rng = np.random.default_rng(9)
    return tuple(rng.uniform(-1.0, 1.0, (n, D)) for _ in range(3))


def _kin_case(name, K, s, q, qd, f):
    """One kinematics or dynamics function of module K (either package's)
    on one sample (JAX) or a batch (the port)."""
    ee = s.link_index("panda_hand")
    if name == "joint_local_transforms":
        return K.joint_local_transforms(s, q)
    if name == "fk_world":
        return K.fk_world(s, q)
    if name == "fk_world_sequential":
        return K.fk_world(s, q, sequential=True)
    if name == "fk_world_scalar":
        return K.fk_world_scalar(s, q)
    if name == "world_joint_subspaces":
        return K.world_joint_subspaces(s, *K.fk_world(s, q))
    if name == "body_velocities":
        return K.body_velocities(s, K.world_joint_subspaces(s, *K.fk_world(s, q)), qd)
    if name == "link_jacobian":
        return K.link_jacobian(s, q, ee)
    if name == "rnea":
        return K.rnea(s, q, qd, f)
    if name == "rnea_no_gravity_damping":
        return K.rnea(s, q, qd, f, include_gravity=False, use_damping=False)
    if name == "nonlinear_effects":
        return K.nonlinear_effects(s, q, qd)
    if name == "mass_matrix":
        return K.mass_matrix(s, q)
    if name == "forward_dynamics_crb":
        return K.forward_dynamics_crb(s, q, qd, f, use_damping=True)
    if name == "aba":
        return K.aba(s, q, qd, f, use_damping=True)
    if name == "aba_no_gravity":
        return K.aba(s, q, qd, f, include_gravity=False)
    raise KeyError(name)


KINEMATICS = ("joint_local_transforms", "fk_world", "fk_world_sequential", "fk_world_scalar",
              "world_joint_subspaces", "body_velocities", "link_jacobian")
DYNAMICS = ("rnea", "rnea_no_gravity_damping", "nonlinear_effects", "mass_matrix",
            "forward_dynamics_crb", "aba", "aba_no_gravity")


@pytest.mark.parametrize("name", KINEMATICS + DYNAMICS)
def test_kinematics_and_dynamics_match_jax_f64(name):
    js, ts = _robot()
    q, qd, f = _state(js.n_dofs)
    jmod, tmod = (jkin, tkin) if name in KINEMATICS else (jdyn, tdyn)
    with jax.disable_jit():
        per_sample = [
            _flat(_kin_case(name, jmod, js, *(jnp.asarray(x[b]) for x in (q, qd, f))))
            for b in range(q.shape[0])
        ]
    j = [np.stack([np.asarray(s[k]) for s in per_sample]) for k in range(len(per_sample[0]))]
    t = _kin_case(name, tmod, ts, *(torch.from_numpy(x) for x in (q, qd, f)))
    _assert_close(t, j)


def test_sym_solve_matches_jax_f64():
    rng = np.random.default_rng(3)
    A = rng.uniform(-1.0, 1.0, (4, 6, 6))
    H = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(6)
    rhs = rng.uniform(-1.0, 1.0, (4, 6))
    j = jdyn.jax_sym_solve(jnp.asarray(H), jnp.asarray(rhs))
    _assert_close(tdyn.sym_solve(torch.from_numpy(H), torch.from_numpy(rhs)), j)


def test_unbatched_dynamic_rollout_matches_jax_f64():
    js, ts = _robot()
    D, H = js.n_dofs, 3
    rng = np.random.default_rng(4)
    q0, qd0 = rng.uniform(-0.5, 0.5, D), rng.uniform(-0.2, 0.2, D)
    taus = rng.uniform(-3.0, 3.0, (H, D))
    ee = js.link_index("panda_hand")
    with jax.disable_jit():
        j = jroll.dynamic_rollout(js, jnp.asarray(q0), jnp.asarray(qd0), jnp.asarray(taus), 0.02, ee)
    t = troll.dynamic_rollout(ts, *(torch.from_numpy(x) for x in (q0, qd0, taus)), 0.02, ee)
    assert isinstance(t, troll.DynRolloutResult)
    _assert_close(tuple(t), tuple(j))
