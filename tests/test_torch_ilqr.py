"""The port's iLQR against the JAX package's, in float64 on the CPU.

- `_ldl_solve_small` on indefinite and near-singular blocks, to 1e-12,
  and the sign-preserving clamp of a pivot under 1e-30;
- `riccati_combine` and `riccati_stage_elements` on a random LQ problem
  (n=4, m=2, H=8) and the gains of the sequential recursion (the port's
  `_backward_pass`) and of the parallel associative scan, against each
  other and against JAX's parallel gains, to 1e-9;
- `make_ift_f_AB` (the rollout adjoint's phase A, here its plain version,
  then the back-substitutions) against JAX's on the 2-link robot and on
  iiwa (H=3, B=2), with a stage whose velocity clamp binds, to 1e-9;
- `make_gn_reach_linearize` with per-scenario goals and reference torques
  against JAX's per scenario, to 1e-9;
- `ilqr_batch` with the Gauss-Newton + IFT engine on the torque plant
  (bench.py's `gn_ift`) against `jax.vmap(ilqr)` on the 2-link robot (B=2,
  H=5, 3 iterations): `us` to 1e-8 of max(1, max |us|), `cost_history` to
  1e-9 relative, the `diagnostics=True` dict likewise; sequential and
  parallel, each with and without a binding effort box as
  `control_bounds`. iiwa is left out: JAX traces its solve for over a
  minute here;
- the double integrator of tests/test_trajopt.py through the generic
  autodiff linearization (`torch.func`), against JAX's `ilqr` and with
  that test's assertions.

The inputs come from numpy seeds; JAX's solves compile with
`xla_backend_optimization_level=0`.
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
from differentiable_robot_model_tpu.ops import kinematics as JK
from differentiable_robot_model_tpu.ops.dynamics_scalar import rnea_scalar as j_rnea
from differentiable_robot_model_tpu.trajopt import solvers as js
from differentiable_robot_model_tpu.trajopt.rollout import (
    _velocity_bound as j_vbound,
    fd_step_implicit_damping as j_fd_step,
)
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops import kinematics as TK
from differentiable_robot_model_tpu_torch.trajopt import solvers as ts

DT = 0.02
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
T64 = dict(dtype=torch.float64)


@functools.lru_cache(maxsize=None)
def _structs(urdf):
    jst = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    tst = struct_from_arrays(
        {f: np.asarray(getattr(jst, f)) for f in ARRAY_FIELDS},
        {f: getattr(jst, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return jst, tst


def _t(x):
    return torch.tensor(np.asarray(x, np.float64))


def _jax_run(fn, *args):
    """fn(*args), compiled by XLA with FAST."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


# ---- the unrolled solve ------------------------------------------------------


def _blocks(kind, rng):
    m, n = 4, 5
    Q = np.linalg.qr(rng.normal(size=(n, m, m)))[0]
    if kind == "indefinite":
        ev = rng.uniform(0.5, 2.0, (n, m)) * np.array([1.0, -1.0, 1.0, -1.0])
    else:  # near-singular: one eigenvalue 1e-13 of the largest
        ev = rng.uniform(0.5, 2.0, (n, m)) * np.array([1.0, 1.0, 1.0, 1e-13])
    A = Q @ (ev[..., None] * np.swapaxes(Q, -1, -2))
    return 0.5 * (A + np.swapaxes(A, -1, -2)), rng.normal(size=(n, m, 3))


@pytest.mark.parametrize("kind", ["indefinite", "near_singular", "clamped_pivot"])
def test_ldl_solve_small_matches_jax(kind):
    A, b = _blocks("indefinite" if kind == "clamped_pivot" else kind, np.random.default_rng(3))
    if kind == "clamped_pivot":
        # a first pivot under 1e-30 in magnitude is replaced by +-1e-30, its
        # sign kept (+ for an exact 0); the gains that follow are ~1e30, so
        # they are held to the solve with that pivot, not to JAX's rounding
        for a0, clamped in ((0.0, 1e-30), (-1e-40, -1e-30), (3e-31, 1e-30)):
            A[:, 0, 0] = a0
            x = ts._ldl_solve_small(_t(A), _t(b))
            A[:, 0, 0] = clamped
            assert torch.isfinite(x).all() and torch.equal(x, ts._ldl_solve_small(_t(A), _t(b)))
        return
    x_j = np.asarray(js._ldl_solve_small(jnp.asarray(A), jnp.asarray(b)))
    x_t = ts._ldl_solve_small(_t(A), _t(b)).numpy()
    np.testing.assert_allclose(x_t, x_j, rtol=1e-12, atol=1e-12 * np.abs(x_j).max())


# ---- the Riccati blocks ------------------------------------------------------


def _lq_problem(seed=4, n=4, m=2, H=8):
    rng = np.random.default_rng(seed)
    A = np.eye(n) + 0.1 * rng.normal(size=(H, n, n))
    B = 0.1 * rng.normal(size=(H, n, m))
    sym = lambda X: X @ np.swapaxes(X, -1, -2)
    lxx = sym(rng.normal(size=(H, n, n))) + np.eye(n)
    luu = sym(rng.normal(size=(H, m, m))) + np.eye(m)
    lux = 0.1 * rng.normal(size=(H, m, n))
    lx, lu = rng.normal(size=(H, n)), rng.normal(size=(H, m))
    Vx, Vxx = rng.normal(size=n), sym(rng.normal(size=(n, n))) + np.eye(n)
    return A, B, lx, lu, lxx, luu, lux, Vx, Vxx


@pytest.mark.parametrize("part", ["combine", "stage_elements", "gains"])
def test_riccati_blocks_match_jax(part):
    prob = _lq_problem()
    jp, tp = [jnp.asarray(x) for x in prob], [_t(x) for x in prob]
    if part == "stage_elements":
        pairs = zip(ts.riccati_stage_elements(*tp), js.riccati_stage_elements(*jp))
    elif part == "combine":
        tel, jel = ts.riccati_stage_elements(*tp), js.riccati_stage_elements(*jp)
        n = prob[0].shape[-1]
        pairs = zip(ts.riccati_combine(tuple(e[4:] for e in tel), tuple(e[:5] for e in tel),
                                       torch.eye(n, **T64)),
                    js.riccati_combine(tuple(e[4:] for e in jel), tuple(e[:5] for e in jel),
                                       jnp.eye(n)))
    else:
        par = ts._parallel_riccati_gains(*tp)
        # the sequential recursion at lam = 0 on the same linearization, batch of 1
        batched = [x[:, None] for x in tp[:7]] + [tp[7][None], tp[8][None]]
        seq = ts._backward_pass(lambda xs, us: batched, "sequential", None,
                                torch.zeros((len(prob[0]), 1, 2), **T64), torch.zeros(1, **T64))
        for s, p in zip(seq, par):
            np.testing.assert_allclose(s[:, 0].numpy(), p.numpy(), rtol=0,
                                       atol=1e-9 * float(p.abs().max()))
        pairs = zip(par, _jax_run(js._parallel_riccati_gains, *jp))
    for t, j in pairs:
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-9 * max(1.0, np.abs(j).max()))


# ---- the linearization -------------------------------------------------------


def _trajectory(urdf="2link_robot.urdf", H=3, B=2, seed=6):
    """Stage states and torques of a robot; stage 1 of scenario 0 starts at
    1.5x its velocity bound, so that its clamp binds there."""
    jst, tst = _structs(urdf)
    D = jst.n_dofs
    rng = np.random.default_rng(seed)
    vmax = np.asarray(jst.limit_velocity)
    xs = np.concatenate([rng.uniform(-1.0, 1.0, (H, B, D)), rng.uniform(-2.0, 2.0, (H, B, D))], -1)
    xs[1, 0, D:] = 1.5 * vmax
    us = rng.uniform(-5.0, 5.0, (H, B, D))
    return jst, tst, xs, us


@pytest.mark.parametrize("urdf", ["2link_robot.urdf", "kuka_iiwa_iiwa7.urdf"])
def test_ift_f_AB_matches_jax_with_a_binding_clamp(urdf):
    jst, tst, xs, us = _trajectory(urdf)
    H, B, n = xs.shape
    D = n // 2
    A_j, B_j = _jax_run(js.make_ift_f_AB(jst, DT, vmax=j_vbound(jst, 0)),
                        jnp.asarray(xs.reshape(H * B, n)), jnp.asarray(us.reshape(H * B, D)))
    A_t, B_t = ts.make_ift_f_AB(tst, DT)(_t(xs), _t(us))
    # the clamp binds at the bound stage (its velocity rows of A are exactly
    # 0): on both of the 2-link robot's joints; on some of iiwa's, while the
    # others' dt qdd takes them back inside, so that c mixes 0 and 1 there
    clamped = np.all(np.asarray(A_j).reshape(H, B, n, n)[1, 0, D:] == 0.0, axis=-1)
    assert clamped.all() if D == 2 else clamped.any() and not clamped.all()
    for t, j in ((A_t, A_j), (B_t, B_j)):
        j = np.asarray(j).reshape(t.shape)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-9 * np.abs(j).max())


def test_gn_reach_linearize_matches_jax():
    jst, tst, xs, us = _trajectory(H=4)
    H, B, n = xs.shape
    ee = jst.n_links - 1
    rng = np.random.default_rng(7)
    goals, u_ref = rng.uniform(-1.0, 1.0, (B, 3)), rng.uniform(-3.0, 3.0, (B, 2))
    kw = dict(stage_goal_w=10.0, effort_w=1e-3, final_goal_w=100.0)
    # the dynamics Jacobians are test_ift_f_AB_matches_jax_with_a_binding_clamp's:
    # a stand-in here, so that JAX's eager linearization stays short
    AB = rng.normal(size=(H - 1, B, n, n)), rng.normal(size=(H - 1, B, n, 2))
    lin_t = ts.make_gn_reach_linearize(tst, ee, None, _t(goals), u_ref=_t(u_ref),
                                       f_AB=lambda xs, us: tuple(map(_t, AB)), **kw)
    out_t = lin_t(_t(xs), _t(us[:-1]))

    def lin_j(xs_b, us_b, goal, u_ref_b, A_b, B_b):
        return js.make_gn_reach_linearize(jst, ee, None, goal, u_ref=u_ref_b,
                                          f_AB=lambda xs, us: (A_b, B_b), **kw)(xs_b, us_b)

    out_j = _jax_run(jax.vmap(lin_j, (1, 1, 0, 0, 1, 1)),
                     *(jnp.asarray(x) for x in (xs, us[:-1], goals, u_ref) + AB))
    for k, (t, j) in enumerate(zip(out_t, out_j)):
        j = np.asarray(j) if k >= 7 else np.swapaxes(np.asarray(j), 0, 1)
        np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=1e-9 * max(1.0, np.abs(j).max()),
                                   err_msg=f"output {k}")


# ---- whole solves ------------------------------------------------------------

# JAX's solve (it traces for ~10 s here): the sequential recursion with
# diagnostics, its effort box an argument, so that one program serves the
# box of 6 N m (it binds) and the box at +-inf (jnp.clip then changes
# nothing). The port runs both recursions against it: the JAX tests pin
# sequential == parallel to 1e-8, and test_riccati_blocks_match_jax holds
# the parallel gains to JAX's own.
B_SOLVE, H_SOLVE, ITERS_SOLVE, BOX = 2, 5, 3, 6.0
PORT_SOLVES = {  # case: (riccati, effort box)
    "sequential_box": ("sequential", True),
    "parallel_box": ("parallel", True),
    "sequential": ("sequential", False),
    "parallel": ("parallel", False),
}


def _solve_inputs():
    jst, tst = _structs("2link_robot.urdf")
    ee, D, B, H = jst.n_links - 1, jst.n_dofs, B_SOLVE, H_SOLVE
    rng = np.random.default_rng(11)
    lo, hi = np.asarray(jst.limit_lower), np.asarray(jst.limit_upper)
    q0 = rng.uniform(0.3 * lo, 0.3 * hi, (B, D))
    q_goal = rng.uniform(0.5 * lo, 0.5 * hi, (B, D))
    goals = np.asarray(jax.vmap(lambda q: JK.fk_link_position(jst, q, ee))(jnp.asarray(q_goal)))
    x0 = np.concatenate([q0, np.zeros_like(q0)], -1)
    z = jnp.zeros((D, B))
    tau_ref = np.asarray(j_rnea(jst, jnp.asarray(q0.T), z, z)).T
    us0 = np.tile(tau_ref[:, None], (1, H, 1))  # the gravity-compensation warm start
    return jst, tst, ee, x0, us0, goals


@functools.lru_cache(maxsize=None)
def _jax_solver():
    jst, _, ee, x0, us0, goals = _solve_inputs()
    D = jst.n_dofs
    vmax = j_vbound(jst, 0)
    f_AB = js.make_ift_f_AB(jst, DT, vmax=vmax)

    def dynamics(x, u):
        q, qd = x[:D], x[D:]
        qd2 = jnp.clip(qd + DT * j_fd_step(jst, q, qd, u, DT), -vmax, vmax)
        return jnp.concatenate([q + DT * qd2, qd2])

    def solve_one(x0, us0, goal, box):
        tau_ref = us0[0]
        p = lambda x: JK.fk_link_position(jst, x[:D], ee)
        cost = lambda x, u: 10.0 * jnp.sum((p(x) - goal) ** 2) + 1e-4 * jnp.sum((u - tau_ref) ** 2)
        final_cost = lambda x: 100.0 * jnp.sum((p(x) - goal) ** 2)
        lin = js.make_gn_reach_linearize(jst, ee, dynamics, goal, stage_goal_w=10.0, effort_w=1e-4,
                                         u_ref=tau_ref, final_goal_w=100.0, f_AB=f_AB)
        return js.ilqr(dynamics, cost, final_cost, x0, us0, n_iters=ITERS_SOLVE, linearize=lin,
                       control_bounds=(-box, box), diagnostics=True)

    args = [jnp.asarray(x) for x in (x0, us0, goals)] + [jnp.asarray(BOX)]
    return jax.jit(jax.vmap(solve_one, (0, 0, 0, None))).lower(*args).compile(
        compiler_options=FAST)


@functools.lru_cache(maxsize=None)
def _jax_solve(box):
    _, _, _, x0, us0, goals = _solve_inputs()
    args = [jnp.asarray(x) for x in (x0, us0, goals)] + [jnp.asarray(BOX if box else np.inf)]
    return jax.tree_util.tree_map(np.asarray, _jax_solver()(*args))


@pytest.mark.parametrize("case", sorted(PORT_SOLVES))
def test_ilqr_batch_gn_ift_matches_jax(case):
    riccati, box = PORT_SOLVES[case]
    _, tst, ee, x0, us0, goals = _solve_inputs()
    goal_t, tau_ref = _t(goals), _t(us0[:, 0])
    p = lambda x: TK.fk_link_position(tst, x[..., :tst.n_dofs], ee)
    cost = lambda x, u: (10.0 * torch.sum((p(x) - goal_t) ** 2, -1)
                         + 1e-4 * torch.sum((u - tau_ref) ** 2, -1))
    final_cost = lambda x: 100.0 * torch.sum((p(x) - goal_t) ** 2, -1)
    dynamics = ts.make_plant_dynamics(tst, DT)
    lin = ts.make_gn_reach_linearize(tst, ee, dynamics, goal_t, stage_goal_w=10.0, effort_w=1e-4,
                                     u_ref=tau_ref, final_goal_w=100.0,
                                     f_AB=ts.make_ift_f_AB(tst, DT))
    out, diag = ts.ilqr_batch(dynamics, cost, final_cost, _t(x0), _t(us0), n_iters=ITERS_SOLVE,
                              linearize=lin, riccati=riccati,
                              control_bounds=(-BOX, BOX) if box else None, diagnostics=True)
    ref, diag_j = _jax_solve(box)
    assert set(diag) == set(diag_j)
    for k in ("alpha_idx", "improved"):
        np.testing.assert_array_equal(diag[k].numpy(), diag_j[k], err_msg=k)
    for k in ("lam", "ls_costs", "k_norm", "us_iter"):
        np.testing.assert_allclose(diag[k].numpy(), diag_j[k], rtol=1e-8,
                                   atol=1e-8 * max(1.0, np.abs(diag_j[k]).max()), err_msg=k)
    us, hist = out.us.numpy(), out.cost_history.numpy()
    scale = max(1.0, np.abs(ref.us).max())
    np.testing.assert_allclose(us, ref.us, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(out.xs.numpy(), ref.xs, rtol=0, atol=1e-8 * scale)
    np.testing.assert_allclose(hist, ref.cost_history, rtol=1e-9, atol=0)
    np.testing.assert_allclose(out.cost.numpy(), ref.cost, rtol=1e-9, atol=0)
    assert np.all(np.diff(hist, axis=1) <= 0) and np.all(hist[:, -1] < hist[:, 0])
    if box:  # the box binds: some torque sits on it, none beyond it
        assert np.all(np.abs(us) <= BOX) and np.any(np.abs(us) == BOX)


def test_double_integrator_autodiff_linearize_matches_jax():
    dt = 0.1
    goal = np.array([1.0, -0.5, 0.0, 0.0])

    def dyn_j(x, u):
        vel2 = x[2:] + dt * u
        return jnp.concatenate([x[:2] + dt * vel2, vel2])

    def dyn_t(x, u):
        vel2 = x[..., 2:] + dt * u
        return torch.cat([x[..., :2] + dt * vel2, vel2], dim=-1)

    cost_j = lambda x, u: 0.1 * jnp.sum(u * u) + jnp.sum((x - goal) ** 2) + 0.05 * x[0] * u[1]
    final_j = lambda x: 100.0 * jnp.sum((x - goal) ** 2)
    g_t = _t(goal)
    cost_t = lambda x, u: (0.1 * torch.sum(u * u, -1) + torch.sum((x - g_t) ** 2, -1)
                           + 0.05 * x[..., 0] * u[..., 1])
    final_t = lambda x: 100.0 * torch.sum((x - g_t) ** 2, -1)
    ref = _jax_run(lambda: js.ilqr(dyn_j, cost_j, final_j, jnp.zeros(4), jnp.zeros((30, 2)),
                                   n_iters=10))
    res = ts.ilqr(dyn_t, cost_t, final_t, torch.zeros(4, **T64), torch.zeros((30, 2), **T64),
                  n_iters=10)
    np.testing.assert_allclose(res.us.numpy(), np.asarray(ref.us), rtol=0, atol=1e-8)
    np.testing.assert_allclose(res.cost_history.numpy(), np.asarray(ref.cost_history), rtol=1e-9)
    hist = res.cost_history.numpy()
    assert hist[-1] < hist[0] * 0.2
    assert np.linalg.norm(res.xs[-1, :2].numpy() - goal[:2]) < 0.05
