"""The port's torque-space Adam solve against the JAX package's.

Every engine of `solve_dynamic_adam_batch` runs here on the CPU: "scan"
(plain torch with autograd), "kernel" (the rollout kernels' plain versions
inside the autograd Function) and "fused" (the whole-solve kernel's plain
version, with the hand-written adjoint). Each is held against JAX's
`rollout_impl="scan"` (JAX's own fused kernel declines off the TPU), cold
and warm, at B=8, H=10, 3 iterations, lr 0.5, eps 0.1: iiwa in float64 to
1e-9 and in float32 to 5e-3 (the dynamic whole-solve tolerance of
tests/test_pallas_tpu.py), both relative to the largest torque, and the
2-link robot with the effort box on, lowered to 2 Nm so that it binds, in
float64 to 1e-9.
JAX runs each robot once, in float64, compiled once; the float32 case feeds
it the float32 inputs. A cold start is JAX's warm start from the
hold-still plan, which maps to zero action deltas.
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
from differentiable_robot_model_tpu.ops.kinematics import fk_link_position_dof_first
from differentiable_robot_model_tpu.trajopt.solvers import solve_dynamic_adam_batch as j_solve
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.dynamics_scalar import rnea_scalar
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ksolver
from differentiable_robot_model_tpu_torch.trajopt.solvers import solve_dynamic_adam_batch as t_solve

B, H, ITERS = 8, 10, 3
KW = dict(horizon=H, n_iters=ITERS, lr=0.5, eps=1e-1)
# The 2-link robot's URDF effort limits (20 Nm) are far above what these
# solves ask for; the effort case lowers them to 2 Nm in both packages.
EFFORT_2LINK = 2.0
CASES = {  # name: (urdf, ee link, dtype, effort box, tolerance)
    "iiwa_f64": ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee", torch.float64, False, 1e-9),
    "iiwa_f32": ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee", torch.float32, False, 5e-3),
    "2link_effort_f64": ("2link_robot.urdf", None, torch.float64, True, 1e-9),
}
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@functools.lru_cache(maxsize=None)
def _structs(urdf):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    if urdf.startswith("2link"):
        js = dataclasses.replace(js, limit_effort=jnp.full_like(js.limit_effort, EFFORT_2LINK))
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts


def _problem(case, warm):
    urdf, ee_name, dtype, _, _ = CASES[case]
    js, ts = _structs(urdf)
    ts = ts.to(dtype=dtype)
    ee = js.link_index(ee_name) if ee_name else js.n_links - 1
    D = js.n_dofs
    rng = np.random.default_rng(5)
    q0 = rng.uniform(-0.5, 0.5, (B, D))
    qd0 = rng.uniform(-0.2, 0.2, (B, D))
    q_goal = rng.uniform(-1.0, 1.0, (B, D))
    goals = np.asarray(fk_link_position_dof_first(js, jnp.asarray(q_goal.T), ee)).T
    noise = rng.uniform(-1.0, 1.0, (B, H, D)) if warm else 0.0
    q0, qd0, goals = (torch.tensor(x, dtype=dtype) for x in (q0, qd0, goals))
    qT = q0.T
    hold = rnea_scalar(ts, qT, torch.zeros_like(qT), torch.zeros_like(qT)).T  # [B, D]
    init = hold[:, None, :] + torch.from_numpy(np.asarray(noise)).to(dtype)
    return js, ts, ee, q0, qd0, goals, init.expand(B, H, D).contiguous()


@functools.lru_cache(maxsize=None)
def _jax_compiled(urdf, ee, effort):
    js, _ = _structs(urdf)
    D = js.n_dofs
    shapes = [jax.ShapeDtypeStruct(s, jnp.float64) for s in ((B, D), (B, D), (B, 3), (B, H, D))]
    fn = lambda q, qd, g, init: j_solve(js, q, qd, g, ee, init_actions=init,
                                        respect_effort_limits=effort, **KW)
    return jax.jit(fn).lower(*shapes).compile(compiler_options=FAST)


@functools.lru_cache(maxsize=None)
def _jax_solve(case, warm):
    urdf, _, _, effort, _ = CASES[case]
    _, _, ee, q0, qd0, goals, init = _problem(case, warm)
    r = _jax_compiled(urdf, ee, effort)(*(x.double().numpy() for x in (q0, qd0, goals, init)))
    return tuple(np.asarray(x) for x in r)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
@pytest.mark.parametrize("engine", ["scan", "kernel", "fused"])
def test_engines_match_jax_scan(engine, warm, case):
    _, ts, ee, q0, qd0, goals, init = _problem(case, warm)
    effort, tol = CASES[case][3:]
    r = t_solve(ts, q0, qd0, goals, ee, init_actions=init if warm else None,
                respect_effort_limits=effort, rollout_impl=engine, **KW)
    actions, cost, history = (x.double().numpy() for x in r)
    j_actions, j_cost, j_history = _jax_solve(case, warm)
    scale = float(np.abs(j_actions).max())
    np.testing.assert_allclose(actions, j_actions, rtol=0, atol=tol * scale)
    np.testing.assert_allclose(cost, j_cost, rtol=tol, atol=0)
    np.testing.assert_allclose(history, j_history, rtol=tol, atol=0)
    assert np.all(cost < history[0])
    if effort:  # the box binds: some torque sits on it, none beyond it
        emax = ts.limit_effort.double().numpy()
        assert np.all(np.abs(actions) <= emax) and np.any(np.abs(actions) == emax)


def test_prologue_and_whole_solve_refuse_what_the_kernels_cannot_run():
    _, ts, ee, q0, qd0, goals, init = _problem("iiwa_f32", True)
    q0T, qd0T, goalT = q0.T.contiguous(), qd0.T.contiguous(), goals.T.contiguous()
    with pytest.raises(ValueError, match="init_tauT must be"):
        ksolver.dyn_prologue(ts, q0T, torch.zeros(H, 7, B + 1), H)
    tau_ref, H0, a0 = ksolver.dyn_prologue(ts, q0T, init.permute(1, 2, 0).contiguous(), H)
    assert H0.shape == (7, 7, B) and a0.shape == (H, 7, B)
    assert ksolver.dyn_prologue(ts, q0T, None, H, precondition=False)[1] is None
    kw = dict(dt=0.02, lr=0.5, goal_weight=10.0, effort_weight=1e-4, eps=0.1)
    with pytest.raises(ValueError, match="n_iters >= 1"):
        ksolver.dynamic_adam_solve(ts, q0T, qd0T, goalT, tau_ref, H0, a0, ee, n_iters=0, **kw)
    with pytest.raises(ValueError, match="H0 must be"):
        ksolver.dynamic_adam_solve(ts, q0T, qd0T, goalT, tau_ref, H0[:, :6], a0, ee, n_iters=1, **kw)
    before = (ksolver.dynamic_adam_solve.launches, ksolver.dyn_prologue.launches)
    tau, costs = ksolver.dynamic_adam_solve(ts, q0T, qd0T, goalT, tau_ref, H0, a0, ee, n_iters=1, **kw)
    assert tau.shape == (H, 7, B) and costs.shape == (2, B)
    # the CPU runs the plain versions
    assert (ksolver.dynamic_adam_solve.launches, ksolver.dyn_prologue.launches) == before
