"""The JAX package's outputs that tests/test_torch_parallel.py holds the
port's sharding, horizon-sharded Riccati and solve gradients to.

Runs the JAX package's sharded functions (`parallel/mesh.py`,
`parallel/horizon.py`, `ilqr(riccati="horizon_sharded")`, `ilqr_batch(mesh=)`)
on a 4-device virtual CPU mesh, the horizon-sharded Riccati also on 3
devices and on the "horizon" axis of a 2x2 mesh, and `jax.grad` of its
solves and of the horizon-sharded Riccati and iLQR (under `jit`: eager
`shard_map` gradients take minutes), in float64
on inputs drawn from fixed numpy seeds, and writes inputs and outputs to
tests/data/torch_parallel_jax.npz. The test reads them: tracing and
compiling these JAX programs takes minutes on the CPU (the gradient
through one torque-space solve 40-50 s even for the 2-link robot), far
past the test's budget.

    python tools/jax_parallel_reference.py          # write the file
    python tools/jax_parallel_reference.py --check  # recompute, compare with the file

Both print how the recomputed entries compare with those in the file.

The JAX package is the fixed reference: rerun this only where the test's
cases change.
"""

import argparse
import dataclasses
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8"
                           + " --xla_disable_hlo_passes=fusion").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import differentiable_robot_model_tpu as jdrm  # noqa: E402
from differentiable_robot_model_tpu.models import fleet as jfleet  # noqa: E402
from differentiable_robot_model_tpu.models.parametrizations import PositiveScalar  # noqa: E402
from differentiable_robot_model_tpu.ops import kinematics as JK  # noqa: E402
from differentiable_robot_model_tpu.ops.dynamics_scalar import rnea_scalar  # noqa: E402
from differentiable_robot_model_tpu.parallel import mesh as jm  # noqa: E402
from differentiable_robot_model_tpu.parallel.horizon import riccati_gains_horizon_sharded  # noqa: E402
from differentiable_robot_model_tpu.trajopt import solvers as js  # noqa: E402
from differentiable_robot_model_tpu.trajopt.rollout import (  # noqa: E402
    _velocity_bound,
    fd_step_implicit_damping,
)

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "data", "torch_parallel_jax.npz")
N_DEV = 4
B = 8
F64 = jnp.float64


def _iiwa():
    s = jdrm.DifferentiableKUKAiiwa(dtype=F64).struct
    return s, s.link_index("iiwa_link_ee")


def _two_link():
    s = jdrm.DifferentiableTwoLinkRobot(dtype=F64).struct
    return s, s.link_index("endEffector")


def _two_link_goals(rng, n):
    """n goals the 2-link arm can reach (its ee moves in the plane z = 0.2)."""
    return np.stack([rng.uniform(0.5, 1.0, n), rng.uniform(0.2, 0.6, n), np.full(n, 0.2)], -1)


def batch_solver(mesh, out):
    """sharded_batch_solver over the unbatched kinematic solve (the 2-link robot)."""
    s, ee = _two_link()
    rng = np.random.default_rng(0)
    q0, goal = rng.uniform(-0.5, 0.5, (B, 2)), _two_link_goals(rng, B)

    def solve_one(sc):
        return js.solve_kinematic_adam(s, sc["q0"], sc["goal"], ee, horizon=5, n_iters=5,
                                       lr=0.05).actions

    acts = jm.sharded_batch_solver(mesh, solve_one)(
        jm.shard_scenarios(mesh, {"q0": jnp.asarray(q0), "goal": jnp.asarray(goal)}))
    out.update({"batch_solver/q0": q0, "batch_solver/goal": goal, "batch_solver/actions": acts})


def kinematic_mpc(mesh, out):
    s, ee = _iiwa()
    rng = np.random.default_rng(2)
    q0, goal = rng.uniform(-0.5, 0.5, (B, 7)), rng.uniform(0.2, 0.6, (B, 3))
    solve = jm.sharded_kinematic_mpc(mesh, s, ee, horizon=6, n_iters=5, lr=0.02, fk_impl="scalar",
                                     eps=1e-3)
    acts, cost = solve(*jm.shard_scenarios(mesh, (jnp.asarray(q0), jnp.asarray(goal))))
    out.update({"kin_mpc/q0": q0, "kin_mpc/goal": goal, "kin_mpc/actions": acts,
                "kin_mpc/cost": cost})


def train_step(mesh, out):
    """Two data-parallel identification steps (the 2-link robot, arm1's
    mass learnable; tests/test_parallel.py:94-131 on iiwa)."""
    model = jdrm.DifferentiableTwoLinkRobot(dtype=F64)
    model.make_link_param_learnable("arm1", "mass", PositiveScalar(init_param=2.0))
    params = model.parameters()
    rng = np.random.default_rng(1)
    batches = [{k: rng.normal(size=(B, 2)) for k in ("q", "qd", "qdd", "tau")} for _ in range(2)]

    def loss_fn(p, b):
        pred = model.compute_inverse_dynamics(b["q"], b["qd"], b["qdd"], params=p)
        return jnp.mean((pred - b["tau"]) ** 2)

    opt = optax.adam(1e-2)
    step = jm.make_data_parallel_train_step(mesh, loss_fn, opt)
    p, state = jm.replicate(mesh, params), opt.init(params)
    for k, v in params.items():
        out[f"train/init/{k}"] = v
    for i, b in enumerate(batches):
        p, state, loss = step(p, state, jm.shard_scenarios(mesh, {k: jnp.asarray(v) for k, v in b.items()}))
        for k, v in b.items():
            out[f"train/batch{i}/{k}"] = v
        out[f"train/loss{i}"] = loss
        for k, v in p.items():
            out[f"train/params{i}/{k}"] = v


def _lqr_problem(H, n, m, seed, lead=()):
    rng = np.random.default_rng(seed)

    def spd(shape, d):
        Q = rng.normal(size=shape + (d, d))
        return Q @ np.swapaxes(Q, -1, -2) + 2 * d * np.eye(d)

    return dict(
        A=rng.normal(size=(H,) + lead + (n, n)) * 0.3 + np.eye(n),
        B=rng.normal(size=(H,) + lead + (n, m)),
        lx=rng.normal(size=(H,) + lead + (n,)),
        lu=rng.normal(size=(H,) + lead + (m,)),
        lxx=spd((H,) + lead, n),
        luu=spd((H,) + lead, m),
        lux=rng.normal(size=(H,) + lead + (m, n)) * 0.1,
        Vx=rng.normal(size=lead + (n,)),
        Vxx=spd(lead, n),
    )


RICCATI_ORDER = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "Vx", "Vxx")


def riccati(mesh, out):
    """H = 21: H + 1 = 22 stage elements do not divide 4 ranks (padding)."""
    prob = _lqr_problem(21, 4, 2, 0)
    ks, Ks = riccati_gains_horizon_sharded(mesh, *(jnp.asarray(prob[k]) for k in RICCATI_ORDER),
                                           axis_name="scenario")
    out.update({f"riccati/{k}": v for k, v in prob.items()})
    out.update({"riccati/ks": ks, "riccati/Ks": Ks})


def _dist(a, b):
    """max |a - b| relative to the largest entry of b, over a pytree."""
    return max(float(jnp.max(jnp.abs(x - y)) / jnp.max(jnp.abs(y)))
               for x, y in zip(jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)))


def riccati_grad(out):
    """jax.grad of the weighted gains sum(ks wk) + sum(Ks wK) w.r.t. the nine
    stage arrays of the riccati/* problem, horizon-sharded on 4 and on 3
    devices, and on the "horizon" axis of a 2x2 ("scenario", "horizon")
    mesh (with its gains). Weights from seed 17."""
    prob = tuple(jnp.asarray(out[f"riccati/{k}"]) for k in RICCATI_ORDER)
    rng = np.random.default_rng(17)
    wk, wK = rng.normal(size=out["riccati/ks"].shape), rng.normal(size=out["riccati/Ks"].shape)
    out.update({"riccati_grad/wk": wk, "riccati_grad/wK": wK})
    weighted = lambda g: jnp.sum(g[0] * wk) + jnp.sum(g[1] * wK)
    devs = jax.devices()
    meshes = {"4": (jm.make_mesh(devs[:4]), "scenario"), "3": (jm.make_mesh(devs[:3]), "scenario"),
              "2x2": (Mesh(np.array(devs[:4]).reshape(2, 2), ("scenario", "horizon")), "horizon")}
    par = jax.jit(jax.grad(lambda *a: weighted(js._parallel_riccati_gains(*a)),
                           argnums=tuple(range(9))))(*prob)
    for name, (mesh, axis) in meshes.items():
        gains = lambda *a, mesh=mesh, axis=axis: riccati_gains_horizon_sharded(mesh, *a,
                                                                               axis_name=axis)
        grads = jax.jit(jax.grad(lambda *a: weighted(gains(*a)), argnums=tuple(range(9))))(*prob)
        for k, g in zip(RICCATI_ORDER, grads):
            out[f"riccati_grad/{name}/{k}"] = g
        if name == "2x2":
            out["riccati_grad/2x2/ks"], out["riccati_grad/2x2/Ks"] = jax.jit(gains)(*prob)
        print(f"riccati_grad {name}: horizon-sharded against parallel, per array:",
              " ".join(f"{k} {_dist(g, p):.1e}" for k, g, p in zip(RICCATI_ORDER, grads, par)))


DI_DT = 0.1
DI_GOAL = np.array([1.0, -0.5, 0.0, 0.0])


def _di_problem():
    goal = jnp.asarray(DI_GOAL)

    def dynamics(x, u):
        pos, vel = x[:2], x[2:]
        vel2 = vel + DI_DT * u
        return jnp.concatenate([pos + DI_DT * vel2, vel2])

    def cost(x, u):
        return 0.1 * jnp.sum(u * u) + jnp.sum((x - goal) ** 2) + 0.05 * x[0] * u[1]

    def final_cost(x):
        return 100.0 * jnp.sum((x - goal) ** 2)

    return dynamics, cost, final_cost


def ilqr_horizon(mesh, out):
    dynamics, cost, final_cost = _di_problem()
    x0 = np.array([0.2, -0.1, 0.3, 0.05])
    us0 = np.random.default_rng(5).normal(0, 0.1, (21, 2))
    r = js.ilqr(dynamics, cost, final_cost, jnp.asarray(x0), jnp.asarray(us0), n_iters=6,
                riccati="horizon_sharded", riccati_mesh=mesh)
    out.update({"ilqr_hs/x0": x0, "ilqr_hs/us0": us0, "ilqr_hs/us": r.us, "ilqr_hs/xs": r.xs,
                "ilqr_hs/cost_history": r.cost_history})


HS_GRAD_ITERS = 3


def ilqr_horizon_grad(mesh, out):
    """jax.grad of ilqr(riccati="horizon_sharded")'s cost w.r.t. x0 and
    us_init on the double integrator, 3 iterations: H=5 (4 devices hold 6
    elements padded to 8, the last device none of the stages) and H=21
    (the inputs of ilqr_hs)."""
    dynamics, cost, final_cost = _di_problem()
    rng = np.random.default_rng(23)
    cases = {"h5": (np.array([0.1, 0.3, -0.2, 0.1]), rng.normal(0, 0.1, (5, 2))),
             "h21": (out["ilqr_hs/x0"], out["ilqr_hs/us0"])}
    for name, (x0, us0) in cases.items():
        def f(x, u, riccati):
            kw = dict(riccati_mesh=mesh) if riccati == "horizon_sharded" else {}
            return js.ilqr(dynamics, cost, final_cost, x, u, n_iters=HS_GRAD_ITERS, riccati=riccati,
                           **kw).cost

        args = (jnp.asarray(x0), jnp.asarray(us0))
        cost_v, grads = jax.jit(jax.value_and_grad(lambda x, u: f(x, u, "horizon_sharded"),
                                                   argnums=(0, 1)))(*args)
        par = jax.jit(jax.grad(lambda x, u: f(x, u, "parallel"), argnums=(0, 1)))(*args)
        out.update({f"ilqr_hs_grad/{name}/x0": x0, f"ilqr_hs_grad/{name}/us0": us0,
                    f"ilqr_hs_grad/{name}/cost": cost_v, f"ilqr_hs_grad/{name}/grad_x0": grads[0],
                    f"ilqr_hs_grad/{name}/grad_us": grads[1]})
        print(f"ilqr_hs_grad {name}: horizon-sharded against parallel: x0 {_dist(grads[0], par[0]):.1e}"
              f" us_init {float(jnp.max(jnp.abs(grads[1] - par[1]))) / float(jnp.max(jnp.abs(par[0]))):.1e}"
              " (of the x0 gradient's largest entry)")


REACH_DT, REACH_H, REACH_ITERS = 0.02, 3, 2
REACH_W = dict(stage_goal_w=10.0, effort_w=1e-4, final_goal_w=100.0)


def ilqr_reach_horizon(mesh, out):
    """jax.grad of ilqr(riccati="horizon_sharded")'s cost w.r.t. x0, us_init
    and the goal on the 2-link robot's torque plant with
    make_gn_reach_linearize and make_ift_f_AB (H=3, 2 iterations: 4 devices
    hold one element each, the last one no stage), as
    tools/jax_grad_reference.py's ilqr_reach solves each scenario."""
    s, ee = _two_link()
    D = s.n_dofs
    rng = np.random.default_rng(29)
    q0 = rng.uniform(-0.5, 0.5, D)
    x0 = np.concatenate([q0, rng.normal(0.0, 0.3, D)])
    goal = _two_link_goals(rng, 1)[0]
    tau_ref = np.asarray(rnea_scalar(s, jnp.asarray(q0[:, None]), jnp.zeros((D, 1)),
                                     jnp.zeros((D, 1))))[:, 0]
    us0 = tau_ref + rng.normal(0.0, 0.5, (REACH_H, D))
    vmax = _velocity_bound(s, 0)

    def dynamics(x, u):
        q, qd = x[:D], x[D:]
        qd2 = jnp.clip(qd + REACH_DT * fd_step_implicit_damping(s, q, qd, u, REACH_DT), -vmax, vmax)
        return jnp.concatenate([q + REACH_DT * qd2, qd2])

    f_AB = js.make_ift_f_AB(s, REACH_DT, vmax=vmax)
    u_ref = jnp.asarray(tau_ref)

    def f(x, u, g, riccati):
        p = lambda x: JK.fk_link_position(s, x[:D], ee)
        cost = lambda x, u: (REACH_W["stage_goal_w"] * jnp.sum((p(x) - g) ** 2)
                             + REACH_W["effort_w"] * jnp.sum((u - u_ref) ** 2))
        final = lambda x: REACH_W["final_goal_w"] * jnp.sum((p(x) - g) ** 2)
        lin = js.make_gn_reach_linearize(s, ee, dynamics, g, u_ref=u_ref, f_AB=f_AB, **REACH_W)
        kw = dict(riccati_mesh=mesh) if riccati == "horizon_sharded" else {}
        return js.ilqr(dynamics, cost, final, x, u, n_iters=REACH_ITERS, linearize=lin,
                       riccati=riccati, **kw).cost

    args = tuple(jnp.asarray(a) for a in (x0, us0, goal))
    cost_v, grads = jax.jit(jax.value_and_grad(lambda *a: f(*a, "horizon_sharded"),
                                               argnums=(0, 1, 2)))(*args)
    par = jax.jit(jax.grad(lambda *a: f(*a, "parallel"), argnums=(0, 1, 2)))(*args)
    out.update({"ilqr_reach_hs/x0": x0, "ilqr_reach_hs/us0": us0, "ilqr_reach_hs/goal": goal,
                "ilqr_reach_hs/tau_ref": tau_ref, "ilqr_reach_hs/cost": cost_v})
    for arg, g in zip(("x0", "us", "goal"), grads):
        out[f"ilqr_reach_hs/grad_{arg}"] = g
    print("ilqr_reach_hs: horizon-sharded against parallel:",
          " ".join(f"{a} {_dist(g, p):.1e}" for a, g, p in zip(("x0", "us", "goal"), grads, par)))


def ilqr_batch(mesh, out):
    dynamics, cost, final_cost = _di_problem()
    rng = np.random.default_rng(2)
    x0s, us0 = rng.normal(0, 0.3, (B, 4)), rng.normal(0, 0.1, (B, 15, 2))
    r = js.ilqr_batch(dynamics, cost, final_cost, jnp.asarray(x0s), jnp.asarray(us0), n_iters=5,
                      riccati="parallel", mesh=mesh)
    out.update({"ilqr_batch/x0s": x0s, "ilqr_batch/us0": us0, "ilqr_batch/us": r.us,
                "ilqr_batch/xs": r.xs, "ilqr_batch/cost": r.cost,
                "ilqr_batch/cost_history": r.cost_history})


def grad_sharded(mesh, out):
    """jax.grad of the mean solve cost w.r.t. the sharded goals
    (tests/test_parallel.py:262-278 in float64, the 2-link robot)."""
    s, ee = _two_link()
    q0 = jnp.zeros((B, 2), F64)
    goal = _two_link_goals(np.random.default_rng(3), B)

    def mean_cost(goals):
        one = lambda q, g: js.solve_kinematic_adam(s, q, g, ee, horizon=3, n_iters=2).cost
        return jnp.mean(jax.vmap(one)(q0, goals))

    out["grad_sharded/goal"] = goal
    out["grad_sharded/grad"] = jax.jit(jax.grad(mean_cost))(jm.shard_scenarios(mesh, jnp.asarray(goal)))


BOX = 0.5


def dynamic_mpc(mesh, out):
    """sharded_dynamic_mpc with respect_effort_limits on a tight box (the
    2-link robot)."""
    s, ee = _two_link()
    s = dataclasses.replace(s, limit_effort=jnp.full((2,), BOX, F64))
    rng = np.random.default_rng(5)
    q0, goal = rng.uniform(-0.4, 0.4, (B, 2)), _two_link_goals(rng, B)
    kw = dict(horizon=4, n_iters=3, lr=0.5, eps=1e-1, respect_effort_limits=True)
    solve = jm.sharded_dynamic_mpc(mesh, s, ee, **kw)
    acts, cost = solve(*jm.shard_scenarios(mesh, (jnp.asarray(q0), jnp.zeros((B, 2), F64),
                                                  jnp.asarray(goal))))
    out.update({"dyn_mpc/q0": q0, "dyn_mpc/goal": goal, "dyn_mpc/actions": acts,
                "dyn_mpc/cost": cost})


MPPI = dict(horizon=4, n_samples=8, n_iters=2)


def mppi(mesh, out):
    """sharded_mppi with keys split per scenario, and the normals each
    scenario's key draws (as solve_dynamic_mppi draws them: one key a
    iteration from jax.random.split(key, n_iters)); also at sigma = 0 (the
    2-link robot)."""
    s, ee = _two_link()
    rng = np.random.default_rng(11)
    q0, goal = rng.uniform(-0.3, 0.3, (B, 2)), _two_link_goals(rng, B)
    keys = jax.random.split(jax.random.key(7), B)
    H, K, T = MPPI["horizon"], MPPI["n_samples"], MPPI["n_iters"]
    normals = np.stack([np.stack([np.asarray(jax.random.normal(kt, (H, 2, K), F64))
                                  for kt in jax.random.split(kb, T)]) for kb in keys])
    args = jm.shard_scenarios(mesh, (jnp.asarray(q0), jnp.zeros((B, 2), F64), jnp.asarray(goal),
                                     keys))
    acts, cost = jm.sharded_mppi(mesh, s, ee, **MPPI)(*args)
    acts0, cost0 = jm.sharded_mppi(mesh, s, ee, noise_sigma=0.0, **MPPI)(*args)
    out.update({"mppi/q0": q0, "mppi/goal": goal, "mppi/normals": normals, "mppi/actions": acts,
                "mppi/cost": cost, "mppi/actions_sigma0": acts0, "mppi/cost_sigma0": cost0})


def fleet(mesh, out):
    """The padded fleet (2-link, iiwa) with its scenario axis sharded."""
    structs = [_two_link()[0], _iiwa()[0]]
    f = jfleet.build_fleet(structs, ["endEffector", "iiwa_link_ee"], dtype=F64)
    Dmax = f.damping.shape[-1]
    rng = np.random.default_rng(13)
    q0 = np.zeros((2, B, Dmax))
    for r, s in enumerate(structs):
        q0[r, :, : s.n_dofs] = rng.uniform(-0.3, 0.3, (B, s.n_dofs))
    goal = rng.uniform(0.2, 0.4, (2, B, 3))
    solve = jm.sharded_fleet_dynamic_mpc(mesh, f, horizon=4, n_iters=3, lr=0.5, eps=1e-1)
    acts, cost = solve(jnp.asarray(q0), jnp.zeros_like(jnp.asarray(q0)), jnp.asarray(goal))
    out.update({"fleet/q0": q0, "fleet/goal": goal, "fleet/actions": acts, "fleet/cost": cost})


GRAD_H, GRAD_ITERS = 3, 2


def solve_gradients(out):
    """jax.grad of each solve's (summed) final cost w.r.t. the goals, q0 and
    the warm start, the 2-link robot (B2 of the port)."""
    s, ee = _two_link()
    rng = np.random.default_rng(21)
    q0 = rng.uniform(-0.5, 0.5, (2, 2))
    goal = np.stack([rng.uniform(0.5, 1.0, 2), rng.uniform(0.2, 0.6, 2), np.full(2, 0.15)], -1)
    kin_init = rng.normal(0.0, 0.1, (2, GRAD_H, 2))
    dyn_init = rng.normal(0.0, 1.0, (2, GRAD_H, 2))
    out.update({"grads/q0": q0, "grads/goal": goal, "grads/kin_init": kin_init,
                "grads/dyn_init": dyn_init})
    kin = dict(horizon=GRAD_H, n_iters=GRAD_ITERS, lr=0.05, eps=1e-3)
    dyn = dict(horizon=GRAD_H, n_iters=GRAD_ITERS, lr=0.3, eps=1e-1)
    qd0 = jnp.zeros((2, 2), F64)
    solves = {
        "kinematic": lambda g, q, a: js.solve_kinematic_adam(s, q[0], g[0], ee, init_actions=a[0],
                                                             **kin).cost,
        "dynamic": lambda g, q, a: js.solve_dynamic_adam(s, q[0], qd0[0], g[0], ee,
                                                         init_actions=a[0], **dyn).cost,
        "kinematic_batch": lambda g, q, a: jnp.sum(js.solve_kinematic_adam_batch(
            s, q, g, ee, init_actions=a, fk_impl="scalar", **kin).cost),
        "dynamic_batch": lambda g, q, a: jnp.sum(js.solve_dynamic_adam_batch(
            s, q, qd0, g, ee, init_actions=a, rollout_impl="scan", **dyn).cost),
    }
    for name, f in solves.items():
        a = kin_init if name.startswith("kinematic") else dyn_init
        args = (jnp.asarray(goal), jnp.asarray(q0), jnp.asarray(a))
        cost, grads = jax.jit(jax.value_and_grad(f, argnums=(0, 1, 2)))(*args)
        out[f"grads/{name}/cost"] = cost
        for arg, g in zip(("goal", "q0", "init"), grads):
            out[f"grads/{name}/{arg}"] = g
        print(name, "done", flush=True)


def compute() -> dict:
    mesh = jm.make_mesh(jax.devices()[:N_DEV])
    out = {}
    for case in (batch_solver, kinematic_mpc, train_step, riccati, ilqr_horizon, ilqr_batch,
                 grad_sharded, dynamic_mpc, mppi, fleet, ilqr_horizon_grad, ilqr_reach_horizon):
        case(mesh, out)
        print(case.__name__, "done", flush=True)
    riccati_grad(out)
    solve_gradients(out)
    return {k: np.asarray(v) for k, v in out.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--check", action="store_true",
                    help="recompute and compare with the file instead of writing it")
    args = ap.parse_args()
    out = compute()
    old = dict(np.load(OUT)) if os.path.exists(OUT) else {}
    bad = [k for k in out if k in old and (old[k].shape != out[k].shape
                                           or not np.allclose(old[k], out[k], rtol=1e-12, atol=1e-12))]
    new = [k for k in out if k not in old]
    same = sum(k in old and old[k].shape == out[k].shape and np.array_equal(old[k], out[k])
               for k in out)
    print("mismatch:", bad or "none", "| bitwise equal:", same, "of", len(old), "in the file",
          "| not in the file:", new or "none")
    if args.check:
        sys.exit(1 if bad or new else 0)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **out)
    print("wrote", OUT, len(out), "arrays")


if __name__ == "__main__":
    main()
