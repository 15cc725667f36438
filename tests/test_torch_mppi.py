"""The port's MPPI (sampling) torque-space MPC against the JAX package's.

The noise streams cannot match (ROADMAP W4): JAX draws threefry normals,
the port Philox ones (ops/kernels/rng.py). So the solves are held to JAX
with JAX's own normals injected into the port's iteration loop
(`solvers._mppi_dof_major(normals=...)`, the test seam): for the
unbatched solve `jax.random.normal(k_t, (H, D, K))` for k_t in
`jax.random.split(key, n_iters)`, as solvers.py:719-726 draws them, and for
the batch the same per scenario under `jax.random.split(key, B)`. The port
scales them by sigma and zeroes sample 0 itself. In float64 to 1e-9
(relative to the largest torque; costs relative), over precondition on and
off, a warm start, a binding 5 N m effort box (iiwa, as
tests/test_trajopt.py:930-949), adapt_sigma and adapt_temperature, on the
"scan" and "kernel" engines (the rollout kernel's plain version on the CPU).

On one Philox key the kernel's plain twin `mppi_solve_reference` and every
engine agree to 1e-9; at sigma = 0 the plain twin equals JAX's batch solve
(tests/test_pallas_tpu.py:376-415 holds the TPU kernel so). "auto"
resolves to "scan" on the CPU, and an explicit "fused" that K10 cannot run
raises. Shapes: the 2-link arm and
iiwa, B <= 3, K <= 8, H <= 4, 3 iterations; each JAX function compiles once
per module. The MPC steps are in test_torch_mppi_mpc.py.
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
from differentiable_robot_model_tpu.trajopt.solvers import (
    solve_dynamic_mppi as j_mppi,
    solve_dynamic_mppi_batch as j_mppi_batch,
)
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.dynamics_scalar import rnea_scalar
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ksolver
from differentiable_robot_model_tpu_torch.trajopt import mpc as tmpc
from differentiable_robot_model_tpu_torch.trajopt import solvers as tsolvers

B, H, K, ITERS = 3, 4, 8, 3
TOL = 1e-9
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BOX = 5.0  # N m: iiwa's gravity torques alone need more, so the box binds
URDF = {"iiwa": ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee"), "2link": ("2link_robot.urdf", None)}
# name: (robot, precondition, effort box, warm start, adapt_sigma, adapt_temperature)
CASES = {
    "iiwa_warm": ("iiwa", True, False, True, False, False),
    "iiwa_effort_box": ("iiwa", True, True, False, False, False),
    "2link_no_precondition_warm": ("2link", False, False, True, False, False),
    "2link_adapt_sigma": ("2link", True, False, True, True, False),
    "2link_adapt_temperature": ("2link", True, False, True, False, True),
}
SOLVE_KW = dict(dt=0.02, temperature=0.01, goal_weight=10.0, effort_weight=1e-4,
                use_damping=True, ess_target_frac=0.5)


@functools.lru_cache(maxsize=None)
def _structs(robot, box=False):
    urdf, ee_name = URDF[robot]
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    if box:
        js = dataclasses.replace(js, limit_effort=jnp.full_like(js.limit_effort, BOX))
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.link_index(ee_name) if ee_name else js.n_links - 1


@functools.lru_cache(maxsize=None)
def _problem(robot, n=B, seed=11):
    """q0, qd0, goals [n, .] and a warm start [n, H, D] (the hold-still plan
    plus uniform torques in [-2, 2])."""
    js, ts, ee = _structs(robot)
    D = js.n_dofs
    rng = np.random.default_rng(seed)
    q0 = rng.uniform(-0.5, 0.5, (n, D))
    qd0 = rng.uniform(-0.2, 0.2, (n, D))
    goals = np.asarray(fk_link_position_dof_first(js, jnp.asarray(rng.uniform(-1, 1, (n, D)).T), ee)).T
    qT = torch.from_numpy(q0).T
    hold = rnea_scalar(ts, qT, torch.zeros_like(qT), torch.zeros_like(qT)).T.numpy()
    warm = hold[:, None, :] + rng.uniform(-2.0, 2.0, (n, H, D))
    return q0, qd0, goals, warm


def _injected(key, D, n_scenarios=None):
    """JAX's normals as the port's loop takes them, t -> [H, D, B, K]: per
    scenario key `jax.random.normal(k_t, (H, D, K))` for k_t in
    `jax.random.split(k, n_iters)`; B = 1 for the unbatched solve, else the
    scenario keys are `jax.random.split(key, B)`."""
    def per_key(k):  # [n_iters, H, D, K]
        return np.stack([np.asarray(jax.random.normal(kt, (H, D, K), jnp.float64))
                         for kt in jax.random.split(k, ITERS)])

    if n_scenarios is None:
        z = per_key(key)[:, :, :, None, :]
    else:
        z = np.stack([per_key(kb) for kb in jax.random.split(key, n_scenarios)], axis=3)
    z = torch.from_numpy(z)
    return lambda t: z[t]


@functools.lru_cache(maxsize=None)
def _jax_unbatched(case):
    robot, precond, box, warm, adapt_s, adapt_t = CASES[case]
    js, _, ee = _structs(robot, box)
    D = js.n_dofs

    def fn(q, qd, g, init, key):
        return j_mppi(js, q, qd, g, ee, H, key, n_samples=K, n_iters=ITERS, noise_sigma=5.0,
                      precondition=precond, respect_effort_limits=box,
                      init_actions=init if warm else None, adapt_sigma=adapt_s,
                      adapt_temperature=adapt_t, **SOLVE_KW)

    shapes = [jax.ShapeDtypeStruct(s, jnp.float64) for s in ((D,), (D,), (3,), (H, D))]
    return jax.jit(fn).lower(*shapes, jax.random.PRNGKey(0)).compile(compiler_options=FAST)


def _port_solve(ts, ee, q0, qd0, goals, init, normals, engine="scan", precondition=True,
                box=False, adapt_sigma=False, adapt_temperature=False):
    return tsolvers._mppi_dof_major(
        ts, q0, qd0, goals, ee, H, key=None, init_actions=init, engine=engine, n_samples=K,
        n_iters=ITERS, noise_sigma=5.0, precondition=precondition,
        respect_effort_limits=box, adapt_sigma=adapt_sigma, adapt_temperature=adapt_temperature,
        normals=normals, **SOLVE_KW,
    )


def _assert_solve(actions, cost, history, j_actions, j_cost, j_history):
    scale = float(np.abs(j_actions).max())
    np.testing.assert_allclose(actions, j_actions, rtol=0, atol=TOL * scale)
    np.testing.assert_allclose(cost, j_cost, rtol=TOL, atol=0)
    np.testing.assert_allclose(history, j_history, rtol=TOL, atol=0)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("engine", ["scan", "kernel"])
def test_unbatched_solve_matches_jax_with_its_normals(engine, case):
    robot, precond, box, warm, adapt_s, adapt_t = CASES[case]
    js, ts, ee = _structs(robot, box)
    q0, qd0, goals, init = (x[0] for x in _problem(robot))
    key = jax.random.PRNGKey(17)
    j = _jax_unbatched(case)(q0, qd0, goals, init, key)
    t = lambda x: torch.from_numpy(np.asarray(x))[None]
    tau, cost, history = _port_solve(
        ts, ee, t(q0), t(qd0), t(goals), t(init) if warm else None, _injected(key, js.n_dofs),
        engine=engine, precondition=precond, box=box, adapt_sigma=adapt_s, adapt_temperature=adapt_t,
    )
    _assert_solve(tau[:, :, 0].numpy(), cost[0].numpy(), history[:, 0].numpy(),
                  *(np.asarray(x) for x in j))
    assert np.all(np.isfinite(np.asarray(j.cost_history)))
    if box:  # the box binds: some torque sits on it, none beyond it
        a = tau.numpy()
        assert np.all(np.abs(a) <= BOX) and np.any(np.abs(a) == BOX)


@functools.lru_cache(maxsize=None)
def _jax_batch():
    """JAX's vmapped batch solve on the 2-link arm, warm-started, with sigma
    an argument (the batch and the sigma = 0 tests share one compile)."""
    js, _, ee = _structs("2link")
    D = js.n_dofs

    def fn(q, qd, g, init, key, sigma):
        return j_mppi_batch(js, q, qd, g, ee, H, key, init_actions=init, n_samples=K,
                            n_iters=ITERS, noise_sigma=sigma, rollout_impl="scan", **SOLVE_KW)

    shapes = [jax.ShapeDtypeStruct(s, jnp.float64) for s in ((B, D), (B, D), (B, 3), (B, H, D))]
    return jax.jit(fn).lower(*shapes, jax.random.PRNGKey(0), 0.0).compile(compiler_options=FAST)


def test_batched_solve_matches_jax_with_its_per_scenario_normals():
    js, ts, ee = _structs("2link")
    q0, qd0, goals, init = _problem("2link")
    key = jax.random.PRNGKey(23)
    j = _jax_batch()(q0, qd0, goals, init, key, 5.0)
    t = torch.from_numpy
    tau, cost, history = _port_solve(ts, ee, t(q0), t(qd0), t(goals), t(init),
                                     _injected(key, js.n_dofs, B))
    _assert_solve(tau.permute(2, 0, 1).numpy(), cost.numpy(), history.T.numpy(),
                  *(np.asarray(x) for x in j))
    assert j.actions.shape == (B, H, js.n_dofs) and j.cost_history.shape == (B, ITERS)


def test_kernel_plain_twin_matches_jax_at_zero_sigma():
    """At sigma = 0 every sample is the nominal: `mppi_solve_reference` must
    give back the warm start and its cost as JAX's batch solve does."""
    js, ts, ee = _structs("2link")
    q0, qd0, goals, init = _problem("2link")
    j = _jax_batch()(q0, qd0, goals, init, jax.random.PRNGKey(3), 0.0)
    t = lambda x: torch.from_numpy(x).T.contiguous()
    tau_ref, H0, a0 = ksolver.dyn_prologue_reference(
        ts, t(q0), torch.from_numpy(init).permute(1, 2, 0).contiguous(), H)
    tau, costs = ksolver.mppi_solve_reference(
        ts, t(q0), t(qd0), t(goals), tau_ref, H0, a0, 3, ee, n_iters=ITERS, n_samples=K,
        noise_sigma=0.0, dt=0.02, temperature=0.01, goal_weight=10.0, effort_weight=1e-4)
    _assert_solve(tau.permute(2, 0, 1).numpy(), costs[-1].numpy(), costs[:-1].T.numpy(),
                  *(np.asarray(x) for x in j))
    np.testing.assert_allclose(tau.permute(2, 0, 1).numpy(), init, rtol=0, atol=1e-12)


@pytest.mark.parametrize("effort, precondition", [(False, True), (True, False)],
                         ids=["precondition", "effort_box_no_precondition"])
def test_engines_and_kernel_twin_draw_one_philox_stream(effort, precondition):
    """On one key `mppi_solve_reference` (K10's plain version), the batch
    engines and the unbatched solve of scenario 0 agree to 1e-9 in float64:
    they draw the same noise (ops/kernels/rng.py)."""
    js, ts, ee = _structs("iiwa", effort)
    q0, qd0, goals, init = (torch.from_numpy(x) for x in _problem("iiwa"))
    key, kw = 0xC0FFEE, dict(n_samples=K, n_iters=ITERS, noise_sigma=5.0, dt=0.02,
                             temperature=0.01, goal_weight=10.0, effort_weight=1e-4)
    opts = dict(precondition=precondition, respect_effort_limits=effort)
    runs = {e: tsolvers.solve_dynamic_mppi_batch(ts, q0, qd0, goals, ee, H, key, init_actions=init,
                                                 rollout_impl=e, **opts, **kw)
            for e in ("scan", "kernel", "fused")}
    qT, qdT, gT = (x.T.contiguous() for x in (q0, qd0, goals))
    tau_ref, H0, a0 = ksolver.dyn_prologue_reference(ts, qT, init.permute(1, 2, 0).contiguous(), H,
                                                     precondition)
    tau, costs = ksolver.mppi_solve_reference(ts, qT, qdT, gT, tau_ref, H0, a0, key, ee,
                                              respect_effort_limits=effort, **kw)
    twin = (tau.permute(2, 0, 1), costs[-1], costs[:-1].T)
    one = tsolvers.solve_dynamic_mppi(ts, q0[0], qd0[0], goals[0], ee, H, key,
                                      init_actions=init[0], **opts, **kw)
    for r in (*runs.values(), twin):
        _assert_solve(*(x.numpy() for x in r), *(x.numpy() for x in runs["scan"]))
    _assert_solve(*(x.numpy() for x in one), *(x[0].numpy() for x in runs["scan"]))
    assert torch.all(runs["scan"].cost <= runs["scan"].cost_history[:, 0] + 1e-12)
    other = tsolvers.solve_dynamic_mppi_batch(ts, q0, qd0, goals, ee, H, key + 1, init_actions=init,
                                              **opts, **kw)
    assert not torch.allclose(other.actions, runs["scan"].actions)


def test_engine_resolution_and_refusals():
    _, ts, ee = _structs("iiwa")
    assert tsolvers.resolve_mppi_engine("auto", ts, 128, False, batched=True) == "scan"
    assert tsolvers.resolve_mppi_engine("auto", ts, 128, True, batched=False) == "scan"
    assert tmpc.MPPIMPCConfig().rollout_impl == "auto"
    q0, qd0, goals, _ = (torch.from_numpy(x) for x in _problem("iiwa"))
    args = (ts, q0, qd0, goals, ee, H, 0)
    with pytest.raises(ValueError, match="adaptation"):
        tsolvers.solve_dynamic_mppi_batch(*args, rollout_impl="fused", adapt_sigma=True)
    with pytest.raises(ValueError, match="adaptation"):
        tsolvers.solve_dynamic_mppi_batch(*args, rollout_impl="fused", adapt_temperature=True)
    with pytest.raises(ValueError, match="at most 1024"):
        tsolvers.solve_dynamic_mppi_batch(*args, rollout_impl="fused", n_samples=1025)
    with pytest.raises(ValueError, match="rollout_impl"):
        tsolvers.solve_dynamic_mppi(ts, q0[0], qd0[0], goals[0], ee, H, 0, rollout_impl="fused")
    with pytest.raises(TypeError, match="unexpected"):
        tsolvers.solve_dynamic_mppi_batch(*args, rollout_impl="fused", noise_sgima=1.0)
    qT, qdT, gT = (x.T.contiguous() for x in (q0, qd0, goals))
    tau_ref, H0, a0 = ksolver.dyn_prologue_reference(ts, qT, None, H)
    kw = dict(n_iters=1, dt=0.02, temperature=0.01, noise_sigma=5.0, goal_weight=10.0,
              effort_weight=1e-4)
    with pytest.raises(ValueError, match="1 to 1024 samples"):
        ksolver.mppi_solve(ts, qT, qdT, gT, tau_ref, H0, a0, 0, ee, n_samples=2048, **kw)
    grad_robot = dataclasses.replace(ts, mass=ts.mass.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="requires grad"):
        ksolver.mppi_solve(grad_robot, qT, qdT, gT, tau_ref, H0, a0, 0, ee, n_samples=K, **kw)
    before = ksolver.mppi_solve.launches
    tau, costs = ksolver.mppi_solve(ts, qT, qdT, gT, tau_ref, H0, a0, 0, ee, n_samples=K, **kw)
    assert tau.shape == (H, 7, B) and costs.shape == (2, B)
    assert ksolver.mppi_solve.launches == before  # the CPU runs the plain version
