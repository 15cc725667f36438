"""The port's batched kinematic Adam solve against the JAX package's.

Every engine of `solve_kinematic_adam_batch` runs here on the CPU: "scalar"
(plain torch + autograd), "kernel" (the FK kernels' plain versions inside
the autograd Function) and "fused" (the whole-solve kernel's plain version,
with its hand-written adjoint). Each is held against JAX's
`solve_kinematic_adam_batch(fk_impl="scalar")`, cold and warm, at Adam eps
1e-8 and 1.0: in float64 at B=8, H=5, 3 iterations to 1e-9, and in float32
on iiwa to 2e-3 (the whole-solve tolerance of tests/test_pallas_tpu.py).
JAX's own fused kernel is never run here: it hangs in interpret mode.

One exception, at float32 with eps=1e-8 only: iiwa's last joint turns about
the axis through `iiwa_link_ee`, so its true gradient is zero and what each
engine computes for it is float32 rounding noise. With a tiny eps Adam
scales that noise up to steps of O(lr) (the JAX package documents this at
solve_kinematic_adam_batch, and it is why its benchmark uses eps=1.0), so
that dof's actions are compared only at eps=1.0; the costs, which it does
not move, are compared in every case.
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
from differentiable_robot_model_tpu.trajopt.solvers import solve_kinematic_adam as j_solve_one
from differentiable_robot_model_tpu.trajopt.solvers import solve_kinematic_adam_batch as j_solve
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.kernels import solver as tsolver
from differentiable_robot_model_tpu_torch.ops.kinematics import fk_link_position_dof_first as t_fk_dof_first
from differentiable_robot_model_tpu_torch.trajopt import rollout as trollout
from differentiable_robot_model_tpu_torch.trajopt.solvers import solve_kinematic_adam as t_solve_one
from differentiable_robot_model_tpu_torch.trajopt.solvers import solve_kinematic_adam_batch as t_solve

SIZES = {"f64": (jnp.float64, 8, 5, 3, 1e-9), "f32": (jnp.float32, 16, 12, 6, 2e-3)}
NULL_SPACE_DOF = 6  # iiwa joint 7: its axis passes through iiwa_link_ee


@functools.lru_cache(maxsize=None)
def _structs(dtype):
    js = j_from_urdf(
        os.path.join(jdrm.robot_description_folder, "kuka_iiwa_iiwa7.urdf"), dtype=jnp.float64
    ).astype(dtype)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.link_index("iiwa_link_ee")


def _problem(js, ee, B, H, warm, np_dtype, tie=False):
    rng = np.random.default_rng(11)
    lo, hi = np.asarray(js.limit_lower), np.asarray(js.limit_upper)
    q0 = rng.uniform(0.5 * lo, 0.5 * hi, (B, 7))
    if tie:  # start beyond a limit: clipped onto it, so the first steps tie
        q0[:, 1] = lo[1] - 0.1
    q_goal = rng.uniform(0.6 * lo, 0.6 * hi, (B, 7))
    goals = np.asarray(fk_link_position_dof_first(js.astype(jnp.float64), jnp.asarray(q_goal.T), ee)).T
    init = 0.02 * rng.uniform(-1, 1, (B, 1, 7)) * np.ones((1, H, 1)) if warm else None
    cast = lambda x: None if x is None else x.astype(np_dtype)
    return cast(q0), cast(goals), cast(init)


@functools.lru_cache(maxsize=None)
def _jax_solve(size, warm, eps, tie=False):
    dtype, B, H, iters, _ = SIZES[size]
    js, _, ee = _structs(dtype)
    q0, goals, init = _problem(js, ee, B, H, warm, np.dtype(dtype), tie)
    r = jax.jit(
        lambda a, b, c: j_solve(js, a, b, ee, horizon=H, n_iters=iters, lr=0.05,
                                fk_impl="scalar", eps=eps, init_actions=c)
    )(q0, goals, init)
    return tuple(np.asarray(x) for x in r)


def _port_solve(size, warm, eps, engine, tie=False):
    dtype, B, H, iters, _ = SIZES[size]
    js, ts, ee = _structs(dtype)
    q0, goals, init = _problem(js, ee, B, H, warm, np.dtype(dtype), tie)
    r = t_solve(
        ts, torch.from_numpy(q0), torch.from_numpy(goals), ee, horizon=H, n_iters=iters,
        lr=0.05, fk_impl=engine, eps=eps,
        init_actions=None if init is None else torch.from_numpy(init),
    )
    return tuple(x.numpy() for x in r)


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("eps", [1e-8, 1.0])
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("engine", ["scalar", "kernel", "fused"])
def test_engines_match_jax_scalar(engine, warm, eps, size):
    tol = SIZES[size][4]
    actions, cost, history = _port_solve(size, warm, eps, engine)
    j_actions, j_cost, j_history = _jax_solve(size, warm, eps)
    if size == "f32" and eps == 1e-8:
        actions, j_actions = (np.delete(x, NULL_SPACE_DOF, axis=-1) for x in (actions, j_actions))
    np.testing.assert_allclose(actions, j_actions, atol=tol, rtol=0)
    # costs are O(1e2): hold them relatively.
    np.testing.assert_allclose(cost, j_cost, rtol=tol, atol=0)
    np.testing.assert_allclose(history, j_history, rtol=tol, atol=0)
    assert np.all(cost < history[0])


@pytest.mark.parametrize("detach", [False, True], ids=["scan", "detached_steps"])
def test_single_scenario_solve_matches_jax_f64(detach):
    js, ts, ee = _structs(jnp.float64)
    q0, goals, init = _problem(js, ee, 1, 5, True, np.float64)
    kw = dict(horizon=5, n_iters=3, lr=0.05, stop_gradient_between_steps=detach)
    j = jax.jit(lambda a, b, c: j_solve_one(js, a, b, ee, init_actions=c, **kw))(q0[0], goals[0], init[0])
    t = t_solve_one(ts, torch.from_numpy(q0[0]), torch.from_numpy(goals[0]), ee,
                    init_actions=torch.from_numpy(init[0]), **kw)
    for name, tv, jv in zip(j._fields, t, j):
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-9, rtol=1e-12, err_msg=name)


@pytest.mark.parametrize("engine", ["scalar", "kernel"])
def test_clip_ties_follow_jax_subgradient(engine):
    """A start state clipped exactly onto a limit makes the first clip steps
    exact ties; the clamp-affine scan must pass JAX's 0.5 there (W1)."""
    actions, _, history = _port_solve("f64", False, 1e-8, engine, tie=True)
    j_actions, _, j_history = _jax_solve("f64", False, 1e-8, tie=True)
    np.testing.assert_allclose(actions, j_actions, atol=1e-9, rtol=0)
    np.testing.assert_allclose(history, j_history, rtol=1e-9, atol=0)


def test_null_space_dof_does_not_move_the_end_effector():
    _, ts, ee = _structs(jnp.float64)
    q = torch.from_numpy(np.random.default_rng(2).uniform(-1, 1, (7, 5)))
    J = torch.autograd.functional.jacobian(
        lambda x: t_fk_dof_first(ts, x, ee), q
    )  # [3, 5, 7, 5]
    assert J[:, :, NULL_SPACE_DOF].abs().max().item() < 1e-12


def test_clip_gradient_at_ties_is_half():
    _, ts, _ = _structs(jnp.float64)
    q = ts.limit_lower.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(trollout.clip_to_limits(ts, q).sum(), q)
    assert torch.all(g == 0.5)


def test_whole_solve_wrapper_refuses_what_the_kernel_cannot_run():
    _, ts, ee = _structs(jnp.float32)
    q0T, goalT = torch.zeros(7, 4), torch.zeros(3, 4)
    with pytest.raises(ValueError, match="horizon >= 2"):
        tsolver.kinematic_adam_solve(ts, q0T, goalT, torch.zeros(1, 7, 4), ee, 3, 0.05, 100.0, 1.0)
    with pytest.raises(ValueError, match="n_iters >= 1"):
        tsolver.kinematic_adam_solve(ts, q0T, goalT, torch.zeros(5, 7, 4), ee, 0, 0.05, 100.0, 1.0)
    with pytest.raises(ValueError, match="dtype|float64"):
        tsolver.kinematic_adam_solve(
            ts, q0T.double(), goalT, torch.zeros(5, 7, 4), ee, 3, 0.05, 100.0, 1.0
        )
    before = tsolver.kinematic_adam_solve.launches
    a, costs = tsolver.kinematic_adam_solve(ts, q0T, goalT, torch.zeros(5, 7, 4), ee, 2, 0.05, 100.0, 1.0)
    assert a.shape == (5, 7, 4) and costs.shape == (3, 4)
    assert tsolver.kinematic_adam_solve.launches == before  # the CPU runs the plain version
