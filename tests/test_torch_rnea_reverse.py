"""The reverse RNEA sweep and the choice of K9/K10 instantiation.

`rnea_vjp_scalar` (ops/dynamics_scalar.py, the plain version of
csrc/dyn_step.cuh `drm_rr_rnea_vjp` and `drm_rr_rnea_reverse`, which K9's
adjoint runs) is held in
float64 to 1e-10 (relative to the largest partial) against `jax.vjp` of the
JAX package's `rnea_scalar` and against the contraction of the port's
forward-mode `rnea_jacobians`, on iiwa, panda_with_gripper (a tree with
prismatic fingers), trifinger_edu (three fingers on fixed links) and the
2-link robot: against the tangents with each of gravity and damping on and
off, against JAX with one setting per robot, each flag on for two robots
and off for two (JAX's scalar dynamics run op by op under
`jax.disable_jit()` on dof-major lanes, seconds per call). Inputs are numpy
from a seed.

`kernel_variant` is checked over all 13 bundled URDFs: the serial
instantiations for iiwa, panda_no_gripper, fetch_arm (both damping
variants) and the 2-link robot, the generic 16- and 32-link builds for the
trees, and an error past 32 links or dofs.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.ops.dynamics_scalar import rnea_scalar
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.models.robot import robot_description_folder
from differentiable_robot_model_tpu_torch.models.urdf import robot_struct_from_urdf
from differentiable_robot_model_tpu_torch.ops.dynamics_scalar import rnea_vjp_scalar
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ksolver
from differentiable_robot_model_tpu_torch.ops.kernels.rollout import rnea_jacobians

ROBOTS = {
    "iiwa": "kuka_iiwa_iiwa7.urdf",
    "panda_gripper": "panda_with_gripper.urdf",
    "trifinger": "trifinger_edu.urdf",
    "2link": "2link_robot.urdf",
}
# (gravity, damping) of each robot's comparison with jax.vjp, so that each
# flag is on for two robots and off for two (JAX runs op by op: 2-9 s each)
JAX_FLAGS = {"iiwa": (True, True), "panda_gripper": (False, False), "trifinger": (True, False),
             "2link": (False, True)}
FLAGS = [(True, True), (False, False), (True, False), (False, True)]
B = 5
TOL = 1e-10


@functools.lru_cache(maxsize=None)
def _structs(robot):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, ROBOTS[robot]), dtype=jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts


def _inputs(D):
    rng = np.random.default_rng(17)
    return tuple(rng.uniform(-1.0, 1.0, (D, B)) for _ in range(4))  # q, qd, qdd, lam


def _sweep(robot, flags):
    _, ts = _structs(robot)
    q, qd, qdd, lam = _inputs(ts.n_dofs)
    got = rnea_vjp_scalar(ts, *(torch.from_numpy(x) for x in (q, qd, qdd, lam)),
                          include_gravity=flags[0], use_damping=flags[1]).numpy()
    assert got.shape == (2 * ts.n_dofs, B)
    return got, (q, qd, qdd, lam)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_reverse_sweep_matches_jax_vjp(robot):
    include_gravity, use_damping = JAX_FLAGS[robot]
    js, _ = _structs(robot)
    got, (q, qd, qdd, lam) = _sweep(robot, JAX_FLAGS[robot])
    f = lambda a, b: rnea_scalar(js, a, b, jnp.asarray(qdd), include_gravity, use_damping)
    with jax.disable_jit():
        _, pull = jax.vjp(f, jnp.asarray(q), jnp.asarray(qd))
        gq, gqd = (np.asarray(x) for x in pull(jnp.asarray(lam)))
    _close(got, np.concatenate([gq, gqd]))


@pytest.mark.parametrize("flags", FLAGS, ids=["g1d1", "g0d0", "g1d0", "g0d1"])
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_reverse_sweep_matches_forward_tangents(robot, flags):
    """Against λᵀ of the 2D forward-mode rows of `rnea_jacobians` (what
    `StepReplay`, K9's plain version, contracts)."""
    _, ts = _structs(robot)
    got, (q, qd, qdd, lam) = _sweep(robot, flags)
    rows = rnea_jacobians(ts, *(torch.from_numpy(x) for x in (q, qd, qdd)), flags[1], flags[0])
    _close(got, sum(torch.from_numpy(lam[d]) * rows[d] for d in range(ts.n_dofs)).numpy())


EXPECTED_VARIANT = {
    "2link_robot.urdf": "serial4x2",
    "kuka_iiwa_iiwa7.urdf": "serial9x7",
    "panda_no_gripper.urdf": "serial9x7",
    "fetch_arm_no_gripper.urdf": "serial9x7",
    "fetch_arm_no_gripper_small_damping.urdf": "serial9x7",
    "allegro_hand_left.urdf": "generic32",  # 21 links
    "allegro_hand_left_small_damping.urdf": "generic32",
    "fetch_full.urdf": "generic32",  # 25 links
    "kinova_jaco.urdf": "generic16",
    "kinova_jaco_full.urdf": "generic16",
    "kuka_iiwa7_allegro.urdf": "generic32",  # 29 links, 23 dofs
    "panda_with_gripper.urdf": "generic16",  # a tree with prismatic fingers
    "trifinger_edu.urdf": "generic32",  # 17 links
}


@pytest.mark.filterwarnings("ignore:No dynamics information")
@pytest.mark.parametrize("urdf", sorted(EXPECTED_VARIANT))
def test_kernel_variant_of_each_bundled_robot(urdf):
    assert sorted(EXPECTED_VARIANT) == sorted(
        f for f in os.listdir(robot_description_folder) if f.endswith(".urdf"))
    s = robot_struct_from_urdf(os.path.join(robot_description_folder, urdf), device="cpu")
    variant = ksolver.kernel_variant(s)
    assert variant == EXPECTED_VARIANT[urdf]
    assert variant in ksolver.VARIANTS


def test_kernel_variant_of_other_shapes():
    _, ts = _structs("iiwa")
    # a serial chain of a shape without a build of its own takes the generic one
    cut = dataclasses.replace(ts, parent=ts.parent[:8], joint_types=ts.joint_types[:8])
    assert ksolver.kernel_variant(cut) == "generic16"
    n = 33
    wide = dataclasses.replace(ts, parent=(0,) + tuple(range(n - 1)),
                               joint_types=(0,) + (1,) * (n - 1), dof_links=tuple(range(1, n)))
    with pytest.raises(ValueError, match="exceed"):
        ksolver.kernel_variant(wide)
