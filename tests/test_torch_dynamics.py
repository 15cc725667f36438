"""The port's scalar dynamics against the JAX package's, in float64.

`rnea_scalar` (with and without gravity and damping, batched and not),
`mass_matrix_scalar`, `ldl_solve_scalar`, `forward_dynamics_scalar` and the
rollout step `fd_step_implicit_damping` run on the same numpy inputs in both
packages, on iiwa (a serial arm), panda_with_gripper (branched, with two
prismatic fingers) and the planar 2-link robot, and must agree to 1e-9
relative to each quantity's scale. The kernels' `Tree` argument is checked
against the struct it is built from.
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
from differentiable_robot_model_tpu.ops import dynamics_scalar as jdyn
from differentiable_robot_model_tpu.trajopt import rollout as jroll
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops import dynamics_scalar as tdyn
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as krollout
from differentiable_robot_model_tpu_torch.trajopt import rollout as trollout

ROBOTS = {
    "iiwa": "kuka_iiwa_iiwa7.urdf",
    "panda_gripper": "panda_with_gripper.urdf",
    "2link": "2link_robot.urdf",
}
QUANTITIES = ("rnea", "rnea_plain", "rnea_unbatched", "mass", "ldl", "fd", "fd_step")
B, DT = 5, 0.02


def _eager(fn, *args):
    """JAX op by op: the unrolled tree sweeps take XLA 5-45 s to compile
    and a few seconds to dispatch eagerly, with the same numbers."""
    with jax.disable_jit():
        return fn(*args)


@functools.lru_cache(maxsize=None)
def _structs(robot, dtype=jnp.float64):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, ROBOTS[robot]), dtype=jnp.float64)
    js = js.astype(dtype)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts


def _port(ts, q, qd, qdd, tau):
    M = tdyn.mass_matrix_scalar(ts, q)
    return dict(
        rnea=tdyn.rnea_scalar(ts, q, qd, qdd),
        rnea_plain=tdyn.rnea_scalar(ts, q, qd, qdd, include_gravity=False, use_damping=False),
        rnea_unbatched=tdyn.rnea_scalar(ts, q[:, 0], qd[:, 0], qdd[:, 0]),
        mass=M,
        ldl=tdyn.ldl_solve_scalar(M, tau),
        fd=tdyn.forward_dynamics_scalar(ts, q, qd, tau),
        fd_step=trollout.fd_step_implicit_damping(ts, q, qd, tau, DT),
    )


@functools.lru_cache(maxsize=None)
def _case(robot):
    js, ts = _structs(robot)
    D = js.n_dofs
    rng = np.random.default_rng(7)
    q, qd, qdd, tau = (rng.uniform(-1.0, 1.0, (D, B)) for _ in range(4))

    def jax_fn(q, qd, qdd, tau):
        M = jdyn.mass_matrix_scalar(js, q)
        return dict(
            rnea=jdyn.rnea_scalar(js, q, qd, qdd),
            rnea_plain=jdyn.rnea_scalar(js, q, qd, qdd, include_gravity=False, use_damping=False),
            rnea_unbatched=jdyn.rnea_scalar(js, q[:, 0], qd[:, 0], qdd[:, 0]),
            mass=M,
            ldl=jdyn.ldl_solve_scalar(M, tau),
            fd=jdyn.forward_dynamics_scalar(js, q, qd, tau),
            fd_step=jroll.fd_step_implicit_damping(js, q, qd, tau, DT),
        )

    j = {k: np.asarray(v) for k, v in _eager(jax_fn, q, qd, qdd, tau).items()}
    t = {k: v.numpy() for k, v in _port(ts, *(torch.from_numpy(x) for x in (q, qd, qdd, tau))).items()}
    return t, j


@pytest.mark.parametrize("quantity", QUANTITIES)
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_scalar_dynamics_match_jax_f64(robot, quantity):
    t, j = _case(robot)
    assert t[quantity].shape == j[quantity].shape
    scale = max(1.0, float(np.abs(j[quantity]).max()))
    np.testing.assert_allclose(t[quantity], j[quantity], rtol=0, atol=1e-9 * scale)


def test_mass_matrix_is_symmetric_with_a_branch_block_of_zeros():
    """panda_with_gripper: the two finger joints are on different branches,
    so their mass-matrix entry is exactly 0 (not on each other's chain)."""
    t, _ = _case("panda_gripper")
    M = t["mass"]
    np.testing.assert_array_equal(M, np.swapaxes(M, 0, 1))
    assert np.all(M[7, 8] == 0.0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_tree_struct_carries_the_robot(dtype):
    """The kernels' by-value tree: topology, per-dof ancestor masks, and the
    constants rounded to the dtype (the implicit-damping diagonal rounded
    once more after the product, as the TPU kernel rounds it)."""
    _, ts = _structs("panda_gripper")
    ts = ts.to(dtype=dtype)
    flags = krollout.StepFlags(DT)
    tr = krollout.tree_struct(ts, flags)
    assert krollout.tree_struct(ts, flags) is tr  # built once per struct and flags
    assert (tr.n, tr.D, tr.use_damping) == (ts.n_links, ts.n_dofs, 1)
    nd = np.float32 if dtype == torch.float32 else np.float64
    host = ts.numpy()
    for d, l in enumerate(ts.dof_links):
        assert tr.dof_link[d] == l and tr.link[l].dof == d
        assert tr.dt_damping[d] == float(nd(nd(DT) * nd(host["damping"][d])))
    for l in range(ts.n_links):
        assert tr.link[l].parent == ts.parent[l]
        assert tr.link[l].mass == float(host["mass"][l])
    # fingers (dofs 7 and 8) hang off the hand: each has the arm's 7 dofs and itself
    assert tr.anc[7] == 0b011111111 and tr.anc[8] == 0b101111111
    assert tr.gravity == float(nd(9.81))
