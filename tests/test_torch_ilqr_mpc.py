"""The port's iLQR MPC driver and the rest of the ported slices' surface
against the JAX package, in float64 on the CPU.

- `make_ilqr_mpc_step` on the 2-link robot for 3 ticks at H=5, 2 iLQR
  iterations, from a moving start (qd0 != 0), against JAX's jitted step
  tick by tick: q, qd, the plan and the metrics to 1e-8 of max(1, max |x|),
  with each engine: Gauss-Newton with the IFT dynamics Jacobians (the rollout
  adjoint's phase A, its plain version here), Gauss-Newton with forward-mode
  Jacobians, and the exact autodiff linearization (`torch.func`);
- `run_mpc` (kinematic, 2-link, 3 ticks), the four cost helpers of
  trajopt/costs.py and the unbatched `solve_dynamic_adam` (2-link, warm,
  with its effort box lowered to 2 N m so that it binds) against JAX, to
  1e-9;
- the example twins in differentiable_robot_model_tpu_torch/examples/ with
  the assertions of tests/test_examples.py at its sizes: the kinematic
  trajectory optimization (30 iterations, playback) lowers its cost, and
  the torque MPC (8 ticks, H=10) closes on its goal with Adam and MPPI, and
  with iLQR, which the port's twin adds.
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
from differentiable_robot_model_tpu.trajopt import costs as jcosts
from differentiable_robot_model_tpu.trajopt import mpc as jmpc
from differentiable_robot_model_tpu.trajopt.solvers import solve_dynamic_adam as j_solve_dynamic_adam
from differentiable_robot_model_tpu_torch.examples import run_kinematic_trajectory_opt, run_torque_mpc
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.trajopt import costs as tcosts
from differentiable_robot_model_tpu_torch.trajopt import mpc as tmpc
from differentiable_robot_model_tpu_torch.trajopt.solvers import solve_dynamic_adam as t_solve_dynamic_adam

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
EFFORT_2LINK = 2.0  # N m: the 2-link robot's URDF box (20) is far above what these solves ask


@functools.lru_cache(maxsize=None)
def _structs(effort=None):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, "2link_robot.urdf"),
                     dtype=jnp.float64)
    if effort is not None:
        js = dataclasses.replace(js, limit_effort=jnp.full_like(js.limit_effort, effort))
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.n_links - 1


def _close(t, j, tol, what):
    j = np.asarray(j)
    np.testing.assert_allclose(np.asarray(t), j, rtol=0, atol=tol * max(1.0, np.abs(j).max()),
                               err_msg=what)


# ---- the iLQR MPC driver -----------------------------------------------------

ENGINES = {
    "gauss_newton_ift": dict(linearization="gauss_newton", dynamics_jacobians="ift"),
    "gauss_newton_autodiff": dict(linearization="gauss_newton", dynamics_jacobians="autodiff"),
    "exact": dict(linearization="exact"),
}
TICKS = 3
Q0, QD0, GOAL = np.array([0.4, -0.7]), np.array([0.5, -0.3]), np.array([0.9, 0.6, 0.0])


def _ilqr_config(engine):
    return jmpc.ILQRMPCConfig(horizon=5, iters_per_step=2, **ENGINES[engine])


@functools.lru_cache(maxsize=None)
def _jax_ilqr_ticks(engine):
    js, _, ee = _structs()
    cfg = _ilqr_config(engine)
    state = jmpc.ilqr_mpc_init(js, jnp.asarray(Q0), jnp.asarray(QD0), cfg)
    step = jax.jit(jmpc.make_ilqr_mpc_step(js, ee, cfg)).lower(state, jnp.asarray(GOAL)).compile(
        compiler_options=FAST)
    out = []
    for _ in range(TICKS):
        state, metrics = step(state, jnp.asarray(GOAL))
        out.append(jax.tree_util.tree_map(np.asarray, (state, metrics)))
    return out


@pytest.mark.parametrize("engine", sorted(ENGINES))
def test_ilqr_mpc_ticks_match_jax(engine):
    _, ts, ee = _structs()
    cfg = tmpc.ILQRMPCConfig(**dataclasses.asdict(_ilqr_config(engine)))
    step = tmpc.make_ilqr_mpc_step(ts, ee, cfg)
    state = tmpc.ilqr_mpc_init(ts, torch.tensor(Q0), torch.tensor(QD0), cfg)
    for tick, (j_state, j_metrics) in enumerate(_jax_ilqr_ticks(engine)):
        state, metrics = step(state, torch.tensor(GOAL))
        for name in ("q", "qd", "plan"):
            _close(getattr(state, name).numpy(), getattr(j_state, name), 1e-8, f"{name}, tick {tick}")
        for name in metrics._fields:
            _close(getattr(metrics, name).numpy(), getattr(j_metrics, name), 1e-8,
                   f"{name}, tick {tick}")
        assert metrics.cost <= metrics.cost_initial
    assert int(state.step_count) == TICKS


# ---- run_mpc, the cost helpers, solve_dynamic_adam ---------------------------


def test_run_mpc_matches_jax():
    js, ts, ee = _structs()
    cfg = jmpc.MPCConfig(horizon=5, iters_per_step=3, lr=0.05)
    ref = jax.jit(lambda: jmpc.run_mpc(js, jnp.asarray(Q0), jnp.asarray(GOAL), ee, cfg, 3)).lower(
    ).compile(compiler_options=FAST)()
    out = tmpc.run_mpc(ts, torch.tensor(Q0), torch.tensor(GOAL), ee,
                       tmpc.MPCConfig(**dataclasses.asdict(cfg)), 3)
    for t, j, what in ((out[0].q, ref[0].q, "final q"), (out[0].plan, ref[0].plan, "final plan"),
                       (out[2], ref[2], "q trajectory")):
        _close(t.numpy(), j, 1e-9, what)
    for name in out[1]._fields:
        _close(getattr(out[1], name).numpy(), getattr(ref[1], name), 1e-9, name)
    assert out[0].step_count == 3


@pytest.mark.parametrize("helper", ["terminal_goal_cost", "action_effort_cost",
                                    "joint_limit_barrier", "velocity_cost"])
def test_cost_helpers_match_jax(helper):
    js, ts, _ = _structs()
    rng = np.random.default_rng(2)
    traj = rng.uniform(-4.0, 4.0, (3, 6, 2))  # past the 2-link limits (+-2.967) in places
    goal = rng.normal(size=2)
    args = {
        "terminal_goal_cost": lambda m, g: (g(goal), g(traj), 7.0),
        "action_effort_cost": lambda m, g: (g(traj), 0.3),
        "joint_limit_barrier": lambda m, g: (m, g(traj), 2.0, 0.1),
        "velocity_cost": lambda m, g: (g(traj), 0.5),
    }[helper]
    j = getattr(jcosts, helper)(*args(js, jnp.asarray))
    t = getattr(tcosts, helper)(*args(ts, torch.tensor))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-9, atol=0)


def test_solve_dynamic_adam_matches_jax():
    """Warm-started (absolute torques, mapped back through H(q0)) with the
    effort box on, lowered so that it binds."""
    js, ts, ee = _structs(EFFORT_2LINK)
    init = np.random.default_rng(9).uniform(-3.0, 3.0, (6, 2))
    kw = dict(horizon=6, n_iters=3, lr=0.5, eps=0.1, respect_effort_limits=True)
    solve = lambda init: j_solve_dynamic_adam(js, jnp.asarray(Q0), jnp.asarray(QD0),
                                              jnp.asarray(GOAL), ee, init_actions=init, **kw)
    ref = jax.jit(solve).lower(jnp.asarray(init)).compile(compiler_options=FAST)(jnp.asarray(init))
    out = t_solve_dynamic_adam(ts, torch.tensor(Q0), torch.tensor(QD0), torch.tensor(GOAL), ee,
                               init_actions=torch.tensor(init), **kw)
    _close(out.actions.numpy(), ref.actions, 1e-9, "actions")
    np.testing.assert_allclose(out.cost.numpy(), np.asarray(ref.cost), rtol=1e-9, atol=0)
    np.testing.assert_allclose(out.cost_history.numpy(), np.asarray(ref.cost_history), rtol=1e-9,
                               atol=0)
    assert out.cost < out.cost_history[0]
    a = out.actions.abs().numpy()  # the box binds: some torque sits on it, none beyond it
    assert np.all(a <= EFFORT_2LINK) and np.any(a == EFFORT_2LINK)


# ---- the example twins -------------------------------------------------------


def test_kinematic_trajectory_opt_example():
    result = run_kinematic_trajectory_opt.run(n_iters=30, playback=True, device="cpu")
    hist = result.cost_history.numpy()
    assert np.isfinite(hist).all()
    assert hist[-1] < hist[0]


@pytest.mark.parametrize("solver", ["adam", "mppi", "ilqr"])
def test_torque_mpc_example(solver):
    d = run_torque_mpc.run(n_steps=8, solver=solver, horizon=10, device="cpu")
    assert np.all(np.isfinite(d))
    assert d[-1] < d[0]
