"""The plain version of K3 (`kinematic_adam_solve_reference`) in the kernel's
four steps an iteration: the clamp scan, one chain sweep of every stage
(the cost and J^T gpe from the same sweep), the adjoint scan, and Adam.

It is held to the JAX package two ways, at B=5, H=6 (five action stages),
3 Adam iterations (lr 0.05, eps 1.0), on iiwa, panda_with_gripper's left
finger (a tree robot, with a prismatic joint on the chain and the right
finger's dof off it) and kuka_iiwa7_allegro's longest finger chain (13
links, 16 of its 23 dofs off it, whose actions Adam must leave as they
are):
- in float64, through `solve_kinematic_adam_batch(fk_impl="fused")`,
  against JAX's scalar engine to 1e-9, off clip ties (ROADMAP F1: the two
  JAX engines differ at exact ties);
- in float32 against JAX's own whole-solve kernel
  `kinematic_adam_solve_fused`, run in Pallas interpret mode as
  tests/test_pallas.py runs the Pallas kernels on the CPU, to the
  whole-solve tolerance 2e-3 (actions, absolute; costs, relative); iiwa's
  case starts its dof 1 clipped onto its lower limit from zero actions, so
  that its first clip steps are exact ties, where the kernel's step-by-step
  subgradient is the one K3 follows.
Inputs are numpy from a seed. One horizon and one interpret-mode case a
robot keep the file's time down: JAX traces its scalar solve anew for each
robot and horizon, and each interpret-mode call takes seconds.

`kinematic_adam_solve` refuses a chain with a revolute axis that is not of
unit length (ROADMAP W6).
"""

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
from differentiable_robot_model_tpu.ops.pallas.solver import kinematic_adam_solve_fused
from differentiable_robot_model_tpu.trajopt.solvers import solve_kinematic_adam_batch as j_solve
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.kernels import solver as tsolver
from differentiable_robot_model_tpu_torch.ops.kinematics import fk_link_position
from differentiable_robot_model_tpu_torch.trajopt.solvers import solve_kinematic_adam_batch as t_solve

ROBOTS = {  # urdf, end effector
    "iiwa": ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee"),
    "panda_gripper": ("panda_with_gripper.urdf", "panda_leftfinger"),
    "allegro_kuka": ("kuka_iiwa7_allegro.urdf", "link_7.0_tip"),
}
B, H, ITERS = 5, 6, 3
KW = dict(lr=0.05, goal_weight=100.0, eps=1.0)
F64_TOL, F32_TOL = 1e-9, 2e-3
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _structs(robot, dtype):
    urdf, ee = ROBOTS[robot]
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64).astype(dtype)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.link_index(ee)


def _problem(robot, H, np_dtype, tie=False):
    """q0 [B, D] inside the limits, reachable goals [B, 3], a warm start
    [B, H, D] (zeros for the tie case, whose dof 1 starts on its limit)."""
    js, ts, ee = _structs(robot, jnp.float64)
    D = js.n_dofs
    rng = np.random.default_rng(31)
    lo, hi = np.asarray(js.limit_lower), np.asarray(js.limit_upper)
    q0 = rng.uniform(0.5 * lo, 0.5 * hi, (B, D))
    goals = fk_link_position(ts, torch.from_numpy(rng.uniform(0.6 * lo, 0.6 * hi, (B, D))), ee).numpy()
    init = 0.02 * rng.uniform(-1, 1, (B, H, D))
    if tie:
        q0[:, 1] = lo[1]
        init[:] = 0.0
    return q0.astype(np_dtype), goals.astype(np_dtype), init.astype(np_dtype)


@pytest.mark.parametrize("H", [H])
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_plain_k3_f64_matches_jax_scalar_engine(robot, H):
    js, ts, ee = _structs(robot, jnp.float64)
    q0, goals, init = _problem(robot, H, np.float64)
    solve = lambda a, b, c: j_solve(js, a, b, ee, horizon=H, n_iters=ITERS, fk_impl="scalar",
                                    init_actions=c, **KW)
    want = jax.jit(solve).lower(q0, goals, init).compile(FAST)(q0, goals, init)
    got = t_solve(ts, torch.from_numpy(q0), torch.from_numpy(goals), ee, horizon=H, n_iters=ITERS,
                  fk_impl="fused", init_actions=torch.from_numpy(init), **KW)
    for name, g, w in zip(("actions", "cost", "cost_history"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=F64_TOL * max(1.0, float(np.abs(w).max())),
                                   err_msg=name)


def _fused_cases():  # iiwa's case is the clip tie
    return [(r, H, r == "iiwa") for r in sorted(ROBOTS)]


@pytest.mark.parametrize("robot,H,tie", _fused_cases(),
                         ids=[f"{r}-H{H}{'-tie' if t else ''}" for r, H, t in _fused_cases()])
def test_plain_k3_f32_matches_jax_fused_kernel(robot, H, tie):
    js, ts, ee = _structs(robot, jnp.float32)
    q0, goals, init = _problem(robot, H, np.float32, tie)
    lo, hi = np.asarray(js.limit_lower), np.asarray(js.limit_upper)
    q0T = np.ascontiguousarray(np.clip(q0, lo, hi).T)
    goalT, aT0 = np.ascontiguousarray(goals.T), np.ascontiguousarray(init.transpose(1, 2, 0))
    with pltpu.force_tpu_interpret_mode():
        want = kinematic_adam_solve_fused(js, jnp.asarray(q0T), jnp.asarray(goalT), jnp.asarray(aT0), ee,
                                          n_iters=ITERS, interpret=True, **KW)
    a, costs = tsolver.kinematic_adam_solve(ts, *(torch.from_numpy(x) for x in (q0T, goalT, aT0)), ee,
                                            n_iters=ITERS, **KW)
    np.testing.assert_allclose(a.numpy(), np.asarray(want[0]), rtol=0, atol=F32_TOL)
    np.testing.assert_allclose(costs.numpy(), np.asarray(want[1]), rtol=F32_TOL, atol=0)
    # dofs off the chain get no gradient: Adam leaves their actions as they were
    chain = set(tsolver.chain_to(ts, ee))
    off = [d for d, l in enumerate(ts.dof_links) if l not in chain]
    assert np.array_equal(a.numpy()[:, off], aT0[:, off])


def test_kin_solve_refuses_a_non_unit_axis():
    js, ts, ee = _structs("iiwa", jnp.float32)
    arrays = {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS}
    arrays["axis"] = arrays["axis"].copy()
    arrays["axis"][3] *= 2.0  # link 3 is revolute, on the chain to the end effector
    bad = struct_from_arrays(arrays, {f: getattr(js, f) for f in STATIC_FIELDS}, device="cpu")
    args = (torch.zeros(7, 2), torch.zeros(3, 2), torch.zeros(3, 7, 2), ee)
    with pytest.raises(ValueError, match="unit joint axes"):
        tsolver.kinematic_adam_solve(bad, *args, n_iters=1, **KW)
    tsolver.kinematic_adam_solve(ts, *args, n_iters=1, **KW)  # the same robot with its unit axes runs
