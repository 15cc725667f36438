"""The plain version of `rnea_bwd` (K4's VJP) as the kernel now computes it:
one reverse RNEA sweep giving q̄, q̄d and q̄dd = M(q) ḡ at once
(`rnea_bwd_reference`, the three blocks of `rnea_vjp_scalar(with_qdd=True)`).

Each case holds the three outputs in float64 to 1e-9 (of the largest entry)
against `jax.vjp` of the JAX package's RNEA w.r.t. (q, qd, qdd), on iiwa,
panda_with_gripper (a tree with prismatic fingers) and kuka_iiwa7_allegro
(29 links, 23 dofs), with gravity and damping each on and off. The JAX side
is `ops/dynamics.py::rnea`, the reference library's formulation (both tree
sweeps as ancestor-mask products), mapped over the batch, all four
settings in one compiled function per robot: about 3 s a robot, where
JAX's scalar RNEA, whose arithmetic the port's reverse sweep follows,
takes 5-17 s a robot op by op and longer compiled. Inputs are numpy from a
seed.

A struct whose revolute axis is not of unit length (`struct_from_arrays`
takes axes as given) is refused by `rnea_bwd`: the reverse sweep's
identities hold only for unit axes (ROADMAP W6).
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
from differentiable_robot_model_tpu.ops.dynamics import rnea as j_rnea
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.dynamics_scalar import rnea_vjp_scalar
from differentiable_robot_model_tpu_torch.ops.kernels import rnea as kn

ROBOTS = {
    "iiwa": "kuka_iiwa_iiwa7.urdf",
    "panda_gripper": "panda_with_gripper.urdf",
    "allegro_kuka": "kuka_iiwa7_allegro.urdf",
}
FLAGS = [(True, True), (False, False), (True, False), (False, True)]  # (gravity, damping)
B = 4
TOL = 1e-9
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


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
    rng = np.random.default_rng(23)
    return tuple(rng.uniform(-1.0, 1.0, (D, B)) for _ in range(4))  # q, qd, qdd, g (dof-major)


@functools.lru_cache(maxsize=None)
def _jax_vjp(robot):
    """jax.vjp of the JAX package's RNEA w.r.t. (q, qd, qdd), mapped over the
    batch: {(gravity, damping): (q̄, q̄d, q̄dd) [D, B]}, from one compiled
    function."""
    js, _ = _structs(robot)
    x = [jnp.asarray(v.T) for v in _inputs(js.n_dofs)]  # [B, D]

    def vjps(q, qd, qdd, g):
        def one(flags, q, qd, qdd, g):
            _, pull = jax.vjp(lambda *s: j_rnea(js, *s, *flags), q, qd, qdd)
            return pull(g)

        return {flags: jax.vmap(functools.partial(one, flags))(q, qd, qdd, g) for flags in FLAGS}

    out = jax.jit(vjps).lower(*x).compile(FAST)(*x)
    return {flags: [np.asarray(o).T for o in outs] for flags, outs in out.items()}


@pytest.mark.parametrize("flags", FLAGS, ids=["g1d1", "g0d0", "g1d0", "g0d1"])
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_rnea_bwd_plain_matches_jax_vjp(robot, flags):
    include_gravity, use_damping = flags
    _, ts = _structs(robot)
    x = [torch.from_numpy(np.ascontiguousarray(v.T)) for v in _inputs(ts.n_dofs)]  # [B, D]
    got = kn.rnea_bwd(ts, *x, use_damping, include_gravity)  # the CPU runs the plain version
    for name, g, want in zip(("q", "qd", "qdd"), got, _jax_vjp(robot)[flags]):
        assert g.shape == (B, ts.n_dofs)
        np.testing.assert_allclose(g.numpy().T, want, rtol=0,
                                   atol=TOL * max(1.0, float(np.abs(want).max())), err_msg=name)


def test_with_qdd_keeps_the_two_block_output():
    """`with_qdd` appends the qdd block and leaves the q and qd blocks as they
    were; without it the output is today's [2D, B]."""
    _, ts = _structs("iiwa")
    x = [torch.from_numpy(v) for v in _inputs(ts.n_dofs)]
    two = rnea_vjp_scalar(ts, *x)
    three = rnea_vjp_scalar(ts, *x, with_qdd=True)
    assert two.shape == (2 * ts.n_dofs, B) and three.shape == (3 * ts.n_dofs, B)
    assert torch.equal(three[: 2 * ts.n_dofs], two)


def test_rnea_bwd_refuses_a_non_unit_axis():
    js, ts = _structs("iiwa")
    arrays = {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS}
    arrays["axis"] = arrays["axis"].copy()
    arrays["axis"][3] *= 2.0  # link 3 is revolute
    bad = struct_from_arrays(arrays, {f: getattr(js, f) for f in STATIC_FIELDS}, device="cpu")
    x = [torch.from_numpy(np.ascontiguousarray(v.T)) for v in _inputs(ts.n_dofs)]
    with pytest.raises(ValueError, match="unit joint axes"):
        kn.rnea_bwd(bad, *x)
    kn.rnea_bwd(ts, *x)  # the same robot with its unit axes runs
