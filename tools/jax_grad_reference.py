"""The JAX package's gradients that tests/test_torch_solve_grad.py holds the
port's MPPI, iLQR and torque-solve gradients to.

`jax.grad` (with the value) of the JAX package's solves, in float64 on
inputs drawn from fixed numpy seeds, written with the inputs to
tests/data/torch_solve_grad_jax.npz:

- mppi/*: `solve_dynamic_mppi`'s final cost (and the summed costs of
  `solve_dynamic_mppi_batch`) w.r.t. the warm start, q0 and the goal, on
  the 2-link robot and on iiwa (one case with a binding 5 N m effort box),
  with the threefry normals each solve draws stored beside them (the port
  draws Philox noise; the test injects these);
- ilqr_di/*: `ilqr` and `ilqr_batch` on the double integrator of
  tests/test_trajopt.py (H=5, 3 iterations), the final cost w.r.t. x0 and
  us_init, with the sequential and the parallel Riccati;
- ilqr_reach/*: `ilqr_batch`'s solve (a vmap of `ilqr`) on the 2-link
  robot's torque plant with `make_gn_reach_linearize` and `make_ift_f_AB`
  (H=3, 2 iterations), the summed cost w.r.t. x0, us_init and the goals;
- ift/*: `make_ift_f_AB`'s A and B contracted with fixed weights, w.r.t.
  the states and torques, with one stage's velocity clamp binding;
- remat/*: `dynamic_rollout_dof_major(unroll=2, remat=True)` contracted with
  fixed weights w.r.t. q0, qd0 and the torques, and
  `solve_dynamic_adam_batch(rollout_unroll=4, rollout_remat=True)`'s
  summed cost w.r.t. the goals, q0 and the warm start (the 2-link robot).

Tracing and compiling these gradients takes minutes on the CPU (MPPI's on
iiwa and the torque solve's take the longest), far past the test's budget.

    python tools/jax_grad_reference.py          # write the file
    python tools/jax_grad_reference.py --check  # recompute, compare with the file

The JAX package is the fixed reference: rerun this only where the test's
cases change.
"""

import argparse
import dataclasses
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_disable_hlo_passes=fusion").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import differentiable_robot_model_tpu as jdrm  # noqa: E402
from differentiable_robot_model_tpu.ops import kinematics as JK  # noqa: E402
from differentiable_robot_model_tpu.ops.dynamics_scalar import rnea_scalar  # noqa: E402
from differentiable_robot_model_tpu.trajopt import solvers as js  # noqa: E402
from differentiable_robot_model_tpu.trajopt.rollout import (  # noqa: E402
    _velocity_bound,
    dynamic_rollout_dof_major,
    fd_step_implicit_damping,
)

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "torch_solve_grad_jax.npz")
F64 = jnp.float64
DT = 0.02
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
BOX = 5.0  # N m: iiwa's gravity torques alone need more, so the box binds


def _compiled(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=FAST)(*args)


def _robot(name, box=False):
    if name == "iiwa":
        s = jdrm.DifferentiableKUKAiiwa(dtype=F64).struct
        ee = s.link_index("iiwa_link_ee")
    else:
        s = jdrm.DifferentiableTwoLinkRobot(dtype=F64).struct
        ee = s.link_index("endEffector")
    if box:
        s = dataclasses.replace(s, limit_effort=jnp.full_like(s.limit_effort, BOX))
    return s, ee


def _two_link_goals(rng, n):
    """n goals the 2-link arm can reach (its ee moves in the plane z = 0.2)."""
    return np.stack([rng.uniform(0.5, 1.0, n), rng.uniform(0.2, 0.6, n), np.full(n, 0.2)], -1)


# name: (robot, effort box, batch (None: the unbatched solve), H, K, iterations, seed)
MPPI_CASES = {
    "2link": ("2link", False, None, 3, 8, 2, 1),
    "2link_batch": ("2link", False, 2, 3, 8, 2, 2),
    "iiwa": ("iiwa", False, None, 4, 8, 3, 3),
    "iiwa_effort_box": ("iiwa", True, None, 4, 8, 2, 4),
}
MPPI_KW = dict(temperature=0.01, noise_sigma=5.0, goal_weight=10.0, effort_weight=1e-4, dt=DT)


def _normals(key, H, D, K, T):
    """[T, H, D, K]: the normals `solve_dynamic_mppi` draws under key."""
    return np.stack([np.asarray(jax.random.normal(kt, (H, D, K), F64))
                     for kt in jax.random.split(key, T)])


def mppi(out):
    for name, (robot, box, B, H, K, T, seed) in MPPI_CASES.items():
        s, ee = _robot(robot, box)
        D = s.n_dofs
        rng = np.random.default_rng(seed)
        n = 1 if B is None else B
        q0 = rng.uniform(-0.5, 0.5, (n, D))
        goal = (_two_link_goals(rng, n) if robot == "2link"
                else rng.uniform(0.3, 0.6, (n, 3)))
        tau_ref = np.asarray(rnea_scalar(s, jnp.asarray(q0.T), jnp.zeros((D, n)),
                                         jnp.zeros((D, n)))).T
        init = tau_ref[:, None] + rng.normal(0.0, 1.0, (n, H, D))
        key = jax.random.PRNGKey(seed)
        kw = dict(n_samples=K, n_iters=T, respect_effort_limits=box, **MPPI_KW)
        qd0 = jnp.zeros((n, D), F64)
        if B is None:
            normals = _normals(key, H, D, K, T)[:, :, :, None]  # [T, H, D, 1, K]

            def f(a, q, g):
                r = js.solve_dynamic_mppi(s, q[0], qd0[0], g[0], ee, H, key, init_actions=a[0], **kw)
                return r.cost, r.actions
        else:
            normals = np.stack([_normals(kb, H, D, K, T) for kb in jax.random.split(key, B)], 3)

            def f(a, q, g):
                r = js.solve_dynamic_mppi_batch(s, q, qd0, g, ee, H, key, init_actions=a,
                                                rollout_impl="scan", **kw)
                return jnp.sum(r.cost), r.actions
        args = tuple(jnp.asarray(x) for x in (init, q0, goal))
        (cost, actions), grads = _compiled(jax.value_and_grad(f, argnums=(0, 1, 2), has_aux=True),
                                           *args)
        out.update({f"mppi/{name}/init": init, f"mppi/{name}/q0": q0, f"mppi/{name}/goal": goal,
                    f"mppi/{name}/normals": normals, f"mppi/{name}/cost": cost,
                    f"mppi/{name}/actions": actions})
        for arg, g in zip(("init", "q0", "goal"), grads):
            out[f"mppi/{name}/grad_{arg}"] = g
        print("mppi", name, "done", flush=True)


DI_DT, DI_H, DI_ITERS, DI_B = 0.1, 5, 3, 2
DI_GOAL = np.array([1.0, -0.5, 0.0, 0.0])


def _di_problem():
    """The double integrator of tests/test_trajopt.py::test_ilqr_double_integrator."""
    goal = jnp.asarray(DI_GOAL)

    def dynamics(x, u):
        vel2 = x[2:] + DI_DT * u
        return jnp.concatenate([x[:2] + DI_DT * vel2, vel2])

    def cost(x, u):
        return 0.1 * jnp.sum(u * u) + jnp.sum((x - goal) ** 2)

    def final_cost(x):
        return 100.0 * jnp.sum((x - goal) ** 2)

    return dynamics, cost, final_cost


def ilqr_di(out):
    dynamics, cost, final_cost = _di_problem()
    rng = np.random.default_rng(31)
    x0s = DI_GOAL + rng.normal(0.0, 0.3, (DI_B, 4))
    us0 = rng.normal(0.0, 0.1, (DI_B, DI_H, 2))
    out.update({"ilqr_di/x0s": x0s, "ilqr_di/us0": us0})
    for riccati in ("sequential", "parallel"):
        def one(x, u):
            return js.ilqr(dynamics, cost, final_cost, x[0], u[0], n_iters=DI_ITERS,
                           riccati=riccati).cost

        def batch(x, u):
            return jnp.sum(js.ilqr_batch(dynamics, cost, final_cost, x, u, n_iters=DI_ITERS,
                                         riccati=riccati).cost)

        for form, f in (("ilqr", one), ("batch", batch)):
            cost_v, (gx, gu) = _compiled(jax.value_and_grad(f, argnums=(0, 1)), jnp.asarray(x0s),
                                         jnp.asarray(us0))
            pre = f"ilqr_di/{form}_{riccati}"
            out.update({f"{pre}/cost": cost_v, f"{pre}/grad_x0": gx, f"{pre}/grad_us": gu})
    print("ilqr_di done", flush=True)


REACH_B, REACH_H, REACH_ITERS = 2, 3, 2
REACH_W = dict(stage_goal_w=10.0, effort_w=1e-4, final_goal_w=100.0)


def _plant(s):
    D = s.n_dofs
    vmax = _velocity_bound(s, 0)

    def dynamics(x, u):
        q, qd = x[:D], x[D:]
        qd2 = jnp.clip(qd + DT * fd_step_implicit_damping(s, q, qd, u, DT), -vmax, vmax)
        return jnp.concatenate([q + DT * qd2, qd2])

    return dynamics, vmax


def ilqr_reach(out):
    s, ee = _robot("2link")
    D = s.n_dofs
    rng = np.random.default_rng(41)
    q0 = rng.uniform(-0.5, 0.5, (REACH_B, D))
    x0s = np.concatenate([q0, rng.normal(0.0, 0.3, (REACH_B, D))], -1)
    goals = _two_link_goals(rng, REACH_B)
    tau_ref = np.asarray(rnea_scalar(s, jnp.asarray(q0.T), jnp.zeros((D, REACH_B)),
                                     jnp.zeros((D, REACH_B)))).T
    us0 = tau_ref[:, None] + rng.normal(0.0, 0.5, (REACH_B, REACH_H, D))
    dynamics, vmax = _plant(s)
    f_AB = js.make_ift_f_AB(s, DT, vmax=vmax)

    def solve_one(x0, u0, goal, u_ref):
        p = lambda x: JK.fk_link_position(s, x[:D], ee)
        cost = lambda x, u: (REACH_W["stage_goal_w"] * jnp.sum((p(x) - goal) ** 2)
                             + REACH_W["effort_w"] * jnp.sum((u - u_ref) ** 2))
        final = lambda x: REACH_W["final_goal_w"] * jnp.sum((p(x) - goal) ** 2)
        lin = js.make_gn_reach_linearize(s, ee, dynamics, goal, u_ref=u_ref, f_AB=f_AB, **REACH_W)
        return js.ilqr(dynamics, cost, final, x0, u0, n_iters=REACH_ITERS, linearize=lin).cost

    def f(x0, u0, g):
        return jnp.sum(jax.vmap(solve_one)(x0, u0, g, jnp.asarray(tau_ref)))

    cost_v, grads = _compiled(jax.value_and_grad(f, argnums=(0, 1, 2)),
                              *(jnp.asarray(x) for x in (x0s, us0, goals)))
    out.update({"ilqr_reach/x0s": x0s, "ilqr_reach/us0": us0, "ilqr_reach/goals": goals,
                "ilqr_reach/tau_ref": tau_ref, "ilqr_reach/cost": cost_v})
    for arg, g in zip(("x0", "us", "goal"), grads):
        out[f"ilqr_reach/grad_{arg}"] = g
    print("ilqr_reach done", flush=True)


def ift(out):
    """make_ift_f_AB's A, B contracted with fixed weights, on the 2-link
    robot's stages [H=3, B=2]; stage 1 of scenario 0 starts at 1.5x its
    velocity bound, so that its clamp binds there."""
    s, _ = _robot("2link")
    D, H, B = s.n_dofs, 3, 2
    rng = np.random.default_rng(51)
    vmax = np.asarray(s.limit_velocity)
    xs = np.concatenate([rng.uniform(-1.0, 1.0, (H, B, D)), rng.uniform(-2.0, 2.0, (H, B, D))], -1)
    xs[1, 0, D:] = 1.5 * vmax
    us = rng.uniform(-5.0, 5.0, (H, B, D))
    wA, wB = rng.normal(size=(H, B, 2 * D, 2 * D)), rng.normal(size=(H, B, 2 * D, D))
    f_AB = js.make_ift_f_AB(s, DT, vmax=_velocity_bound(s, 0))

    def f(x, u):
        A, Bm = f_AB(x.reshape(H * B, 2 * D), u.reshape(H * B, D))
        return jnp.sum(A.reshape(wA.shape) * wA) + jnp.sum(Bm.reshape(wB.shape) * wB)

    val, (gx, gu) = _compiled(jax.value_and_grad(f, argnums=(0, 1)), jnp.asarray(xs), jnp.asarray(us))
    out.update({"ift/xs": xs, "ift/us": us, "ift/wA": wA, "ift/wB": wB, "ift/value": val,
                "ift/grad_xs": gx, "ift/grad_us": gu})
    print("ift done", flush=True)


REMAT_B, REMAT_H, REMAT_ITERS = 2, 3, 2
REMAT_DYN = dict(horizon=REMAT_H, n_iters=REMAT_ITERS, lr=0.3, eps=1e-1)


def remat(out):
    s, ee = _robot("2link")
    D = s.n_dofs
    rng = np.random.default_rng(61)
    q0 = rng.uniform(-0.5, 0.5, (REMAT_B, D))
    qd0 = rng.normal(0.0, 0.5, (REMAT_B, D))
    taus = rng.normal(0.0, 2.0, (5, D, REMAT_B))
    wq, wqd = rng.normal(size=taus.shape), rng.normal(size=taus.shape)

    def roll(a, b, t):
        qs, qds = dynamic_rollout_dof_major(s, a, b, t, DT, unroll=2, remat=True)
        return jnp.sum(qs * wq) + jnp.sum(qds * wqd)

    val, grads = _compiled(jax.value_and_grad(roll, argnums=(0, 1, 2)),
                           *(jnp.asarray(x) for x in (q0.T, qd0.T, taus)))
    out.update({"remat/rollout/q0": q0, "remat/rollout/qd0": qd0, "remat/rollout/taus": taus,
                "remat/rollout/wq": wq, "remat/rollout/wqd": wqd, "remat/rollout/value": val})
    for arg, g in zip(("q0", "qd0", "taus"), grads):
        out[f"remat/rollout/grad_{arg}"] = g
    goal = _two_link_goals(rng, REMAT_B)
    init = rng.normal(0.0, 1.0, (REMAT_B, REMAT_H, D))

    def solve(g, q, a):
        r = js.solve_dynamic_adam_batch(s, q, jnp.zeros_like(q), g, ee, init_actions=a,
                                        rollout_unroll=4, rollout_remat=True, rollout_impl="scan",
                                        **REMAT_DYN)
        return jnp.sum(r.cost), r.actions

    (cost_v, actions), grads = _compiled(jax.value_and_grad(solve, argnums=(0, 1, 2), has_aux=True),
                                         *(jnp.asarray(x) for x in (goal, q0, init)))
    out.update({"remat/solve/goal": goal, "remat/solve/q0": q0, "remat/solve/init": init,
                "remat/solve/cost": cost_v, "remat/solve/actions": actions})
    for arg, g in zip(("goal", "q0", "init"), grads):
        out[f"remat/solve/grad_{arg}"] = g
    print("remat done", flush=True)


def compute() -> dict:
    out = {}
    for case in (ilqr_di, ift, remat, ilqr_reach, mppi):
        case(out)
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="recompute and compare with the file instead of writing it")
    args = ap.parse_args()
    out = compute()
    if not args.check:
        os.makedirs(os.path.dirname(OUT), exist_ok=True)
        np.savez_compressed(OUT, **out)
        print("wrote", OUT, len(out), "arrays")
        return
    old = np.load(OUT)
    bad = [k for k in out if k not in old or old[k].shape != out[k].shape
           or not np.allclose(old[k], out[k], rtol=1e-12, atol=1e-12)]
    print("mismatch:", bad or "none")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()
