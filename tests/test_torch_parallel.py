"""The port's scenario sharding (`parallel/mesh.py`), horizon-sharded
Riccati (`parallel/horizon.py`), K10's per-scenario keys and the gradients
of its solves w.r.t. their inputs, against the JAX package.

The multi-rank cases run in one module-scoped spawn of 4 gloo ranks (CPU
processes, float64), which meet at a `file://` rendezvous under the test's
tmp directory (no port, so xdist workers never clash); each rank writes its
results to an npz that the parent reads. The 3-rank Riccati case runs on a
sub-mesh of the same ranks. A spawned rank re-imports this module, which
therefore imports no JAX.

The JAX side is tests/data/torch_parallel_jax.npz, written by
tools/jax_parallel_reference.py: the JAX package's sharded functions on a
4-device virtual CPU mesh, and `jax.grad` of its solves, on the inputs
stored beside their outputs, which the port solves here. Tracing and
compiling those JAX programs takes ~80 s, and `jax.grad` through one
torque-space solve 40-50 s even for the 2-link robot, past this file's
budget. Each sharded entry point is held to its JAX counterpart at 1e-9
(relative to the largest entry) and to the port's own unsharded call at
1e-12. MPPI's noise streams differ (threefry against Philox): JAX's
normals for each scenario's key go into the port's loop through
`solvers.mppi_normals`, keyed by the port's per-scenario keys, and the
Philox noise itself is held at sigma = 0.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from torch.distributed.device_mesh import DeviceMesh

import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu_torch.models.fleet import build_fleet
from differentiable_robot_model_tpu_torch.models.parametrizations import PositiveScalar
from differentiable_robot_model_tpu_torch.ops import kinematics as TK
from differentiable_robot_model_tpu_torch.ops.kernels import rng
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ksolver
from differentiable_robot_model_tpu_torch.parallel import mesh as pm
from differentiable_robot_model_tpu_torch.parallel.horizon import riccati_gains_horizon_sharded
from differentiable_robot_model_tpu_torch.trajopt import solvers as ts

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_parallel_jax.npz")
N_RANKS = 4
B = 8
TOL = 1e-9  # against JAX, relative to the largest entry
SELF_TOL = 1e-12  # against the port's unsharded call
# iLQR's controls and states at a converged solve (each cost flat to 1e-16
# over its last four iterations) move by ~1e-9 with the rounding of the
# Riccati pass: the port's parallel and sequential passes sit 1.5e-9 and
# 2.4e-9 from JAX's horizon-sharded solve, the unsharded batch 1.9e-9 from
# JAX's and from the sharded batch (2 scenarios a rank: the batched linear
# algebra rounds by batch size). So they are held as tests/test_parallel.py
# :224-229 holds JAX's horizon-sharded solve to its sequential one, at
# 1e-8; the costs at TOL and SELF_TOL.
ILQR_US_TOL = 1e-8
RICCATI_ORDER = ("A", "B", "lx", "lu", "lxx", "luu", "lux", "Vx", "Vxx")
SYMMETRIC = ("lxx", "luu", "Vxx")
MPPI = dict(n_samples=8, n_iters=2, rollout_impl="scan")
F64 = torch.float64


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=F64)


def _iiwa():
    s = drt.DifferentiableKUKAiiwa(dtype=F64, device="cpu").struct
    return s, s.link_index("iiwa_link_ee")


def _two_link():
    s = drt.DifferentiableTwoLinkRobot(dtype=F64, device="cpu").struct
    return s, s.link_index("endEffector")


def _di_problem():
    """The double integrator of tests/test_parallel.py on the batch contract."""
    dt, goal = 0.1, torch.tensor([1.0, -0.5, 0.0, 0.0], dtype=F64)

    def dynamics(x, u):
        vel2 = x[..., 2:] + dt * u
        return torch.cat([x[..., :2] + dt * vel2, vel2], dim=-1)

    def cost(x, u):
        return (0.1 * torch.sum(u * u, -1) + torch.sum((x - goal) ** 2, -1)
                + 0.05 * x[..., 0] * u[..., 1])

    def final_cost(x):
        return 100.0 * torch.sum((x - goal) ** 2, -1)

    return dynamics, cost, final_cost


# --- the ranks: each case writes "case/name" arrays; rank 0 also the unsharded call's


def _batch_solver(mesh, ref, out, rank):
    r, ee = _two_link()
    q0, goal = _t(ref["batch_solver/q0"]), _t(ref["batch_solver/goal"])

    def solve_one(sc):
        return ts.solve_kinematic_adam(r, sc["q0"], sc["goal"], ee, horizon=5, n_iters=5,
                                       lr=0.05).actions

    acts = pm.sharded_batch_solver(mesh, solve_one)(pm.shard_scenarios(mesh, {"q0": q0, "goal": goal}))
    out["batch_solver/local_rows"] = acts.to_local().shape[0]
    out["batch_solver/actions"] = acts.full_tensor()
    if rank == 0:
        out["batch_solver/unsharded/actions"] = torch.stack(
            [solve_one({"q0": q0[b], "goal": goal[b]}) for b in range(B)])


def _kin_mpc(mesh, ref, out, rank):
    r, ee = _iiwa()
    q0, goal = _t(ref["kin_mpc/q0"]), _t(ref["kin_mpc/goal"])
    kw = dict(horizon=6, n_iters=5, lr=0.02, fk_impl="scalar", eps=1e-3)
    acts, cost = pm.sharded_kinematic_mpc(mesh, r, ee, **kw)(*pm.shard_scenarios(mesh, (q0, goal)))
    out["kin_mpc/local_rows"] = acts.to_local().shape[0]
    out["kin_mpc/actions"], out["kin_mpc/cost"] = acts.full_tensor(), cost.full_tensor()
    if rank == 0:
        res = ts.solve_kinematic_adam_batch(r, q0, goal, ee, **kw)
        out["kin_mpc/unsharded/actions"], out["kin_mpc/unsharded/cost"] = res.actions, res.cost


def _identification_model(ref):
    model = drt.DifferentiableTwoLinkRobot(dtype=F64, device="cpu")
    model.make_link_param_learnable("arm1", "mass", PositiveScalar(init_param=2.0))
    model.set_parameters({k[len("train/init/"):]: ref[k] for k in ref.files
                          if k.startswith("train/init/")})
    loss_fn = lambda b: torch.mean((model.compute_inverse_dynamics(b["q"], b["qd"], b["qdd"])
                                    - b["tau"]) ** 2)
    return model, loss_fn, torch.optim.Adam(model.parameters(), lr=1e-2)


def _train(mesh, ref, out, rank):
    batches = [{k: _t(ref[f"train/batch{i}/{k}"]) for k in ("q", "qd", "qdd", "tau")}
               for i in range(2)]
    model, loss_fn, opt = _identification_model(ref)
    step = pm.make_data_parallel_train_step(mesh, loss_fn, opt)
    for i, b in enumerate(batches):
        out[f"train/loss{i}"] = step(pm.shard_scenarios(mesh, b))
        for k, v in model.learnable_parameters().items():
            out[f"train/params{i}/{k}"] = v.detach().clone()
    if rank == 0:
        model, loss_fn, opt = _identification_model(ref)
        for i, b in enumerate(batches):
            opt.zero_grad()
            loss = loss_fn(b)
            loss.backward()
            opt.step()
            out[f"train/unsharded/loss{i}"] = loss.detach()
            for k, v in model.learnable_parameters().items():
                out[f"train/unsharded/params{i}/{k}"] = v.detach().clone()


def _riccati(mesh, ref, out, rank):
    prob = [_t(ref[f"riccati/{k}"]) for k in RICCATI_ORDER]
    out["riccati/ks"], out["riccati/Ks"] = riccati_gains_horizon_sharded(mesh, *prob)
    sub = pm.make_mesh([0, 1, 2], device_type="cpu")  # every rank takes part in making it
    if rank < 3:
        out["riccati/ks3"], out["riccati/Ks3"] = riccati_gains_horizon_sharded(sub, *prob)
    # with the port's scenario axis: [H, 2, ...]
    g = np.random.default_rng(4)
    lead = [_t(ref[f"riccati/{k}"]) for k in RICCATI_ORDER]
    batched = [torch.stack([x, x + 0.01 * _t(g.normal(size=x.shape)) * (k not in ("lxx", "luu", "Vxx"))],
                           dim=1 if k not in ("Vx", "Vxx") else 0)
               for k, x in zip(RICCATI_ORDER, lead)]
    out["riccati/batched_ks"], out["riccati/batched_Ks"] = riccati_gains_horizon_sharded(mesh, *batched)
    if rank == 0:
        out["riccati/unsharded/ks"], out["riccati/unsharded/Ks"] = ts._parallel_riccati_gains(*prob)
        out["riccati/unsharded/batched_ks"], out["riccati/unsharded/batched_Ks"] = \
            ts._parallel_riccati_gains(*batched)


def _ilqr_hs(mesh, ref, out, rank):
    dynamics, cost, final_cost = _di_problem()
    x0, us0 = _t(ref["ilqr_hs/x0"]), _t(ref["ilqr_hs/us0"])
    r = ts.ilqr(dynamics, cost, final_cost, x0, us0, n_iters=6, riccati="horizon_sharded",
                riccati_mesh=mesh)
    out["ilqr_hs/us"], out["ilqr_hs/xs"], out["ilqr_hs/cost_history"] = r.us, r.xs, r.cost_history
    if rank == 0:
        for riccati in ("parallel", "sequential"):
            r = ts.ilqr(dynamics, cost, final_cost, x0, us0, n_iters=6, riccati=riccati)
            out[f"ilqr_hs/{riccati}/us"] = r.us
            out[f"ilqr_hs/{riccati}/cost_history"] = r.cost_history


def _weighted_gains_grad(gains, prob, wk, wK):
    """The gradient of sum(ks wk) + sum(Ks wK) w.r.t. the nine stage arrays."""
    leaves = [x.clone().requires_grad_() for x in prob]
    ks, Ks = gains(*leaves)
    return torch.autograd.grad(torch.sum(ks * wk) + torch.sum(Ks * wK), leaves)


def _put_grads(out, prefix, grads):
    for k, g in zip(RICCATI_ORDER, grads):
        out[f"{prefix}/{k}"] = g


def _riccati_grad(mesh, ref, out, rank):
    """(a): the weighted gains' gradient on 4 ranks and on the 3-rank
    sub-mesh, and with the scenario axis ([H, 2, ...], weights from seed
    5); rank 0 adds the port's unsharded parallel form's."""
    prob = [_t(ref[f"riccati/{k}"]) for k in RICCATI_ORDER]
    w = _t(ref["riccati_grad/wk"]), _t(ref["riccati_grad/wK"])
    sharded = lambda m: (lambda *a: riccati_gains_horizon_sharded(m, *a))
    _put_grads(out, "riccati_grad/4", _weighted_gains_grad(sharded(mesh), prob, *w))
    sub = pm.make_mesh([0, 1, 2], device_type="cpu")
    if rank < 3:
        _put_grads(out, "riccati_grad/3", _weighted_gains_grad(sharded(sub), prob, *w))
    g = np.random.default_rng(4)
    batched = [torch.stack([x, x + 0.01 * _t(g.normal(size=x.shape)) * (k not in SYMMETRIC)],
                           dim=1 if k not in ("Vx", "Vxx") else 0)
               for k, x in zip(RICCATI_ORDER, prob)]
    g = np.random.default_rng(5)
    wb = _t(g.normal(size=(21, 2, 2))), _t(g.normal(size=(21, 2, 2, 4)))
    _put_grads(out, "riccati_grad/batched", _weighted_gains_grad(sharded(mesh), batched, *wb))
    if rank == 0:
        _put_grads(out, "riccati_grad/parallel", _weighted_gains_grad(ts._parallel_riccati_gains,
                                                                      prob, *w))
        _put_grads(out, "riccati_grad/batched_parallel",
                   _weighted_gains_grad(ts._parallel_riccati_gains, batched, *wb))


def _mesh2d(mesh, ref, out, rank):
    """(d): the gains and their gradient on the "horizon" axis of a 2x2
    ("scenario", "horizon") mesh; a 2-D mesh without the axis asked for."""
    prob = [_t(ref[f"riccati/{k}"]) for k in RICCATI_ORDER]
    mesh2 = DeviceMesh("cpu", torch.arange(N_RANKS).reshape(2, 2),
                       mesh_dim_names=("scenario", "horizon"))
    gains = lambda *a: riccati_gains_horizon_sharded(mesh2, *a)
    out["mesh2d/ks"], out["mesh2d/Ks"] = gains(*prob)
    _put_grads(out, "mesh2d/grad", _weighted_gains_grad(gains, prob, _t(ref["riccati_grad/wk"]),
                                                        _t(ref["riccati_grad/wK"])))
    try:
        riccati_gains_horizon_sharded(mesh2, *prob, axis_name="time")
        out["mesh2d/refused"] = False
    except KeyError as e:  # it names the mesh's axes
        out["mesh2d/refused"] = "'scenario', 'horizon'" in str(e)


def _ilqr_hs_grad(mesh, ref, out, rank):
    """(b): the cost's gradient w.r.t. x0 and us_init of
    ilqr(riccati="horizon_sharded") on the double integrator, H=5 (rank
    3's block lies past H) and H=21, 3 iterations."""
    for name in ("h5", "h21"):
        x0, us0 = (_t(ref[f"ilqr_hs_grad/{name}/{k}"]).requires_grad_() for k in ("x0", "us0"))
        r = ts.ilqr(*_di_problem(), x0, us0, n_iters=3, riccati="horizon_sharded", riccati_mesh=mesh)
        out[f"ilqr_hs_grad/{name}/cost"] = r.cost
        out[f"ilqr_hs_grad/{name}/grad_x0"], out[f"ilqr_hs_grad/{name}/grad_us"] = \
            torch.autograd.grad(r.cost, (x0, us0))


REACH_DT, REACH_ITERS = 0.02, 2
REACH_W = dict(stage_goal_w=10.0, effort_w=1e-4, final_goal_w=100.0)


def _ilqr_reach_hs(mesh, ref, out, rank):
    """(c): the 2-link reach problem (plain plant, Gauss-Newton
    linearization, `make_ift_f_AB`), H=3 (one element a rank, the last
    rank no stage), 2 iterations: the gradient w.r.t. x0, us_init, goal."""
    s, ee = _two_link()
    x0, us0, goal = (_t(ref[f"ilqr_reach_hs/{k}"]).requires_grad_() for k in ("x0", "us0", "goal"))
    tau_ref = _t(ref["ilqr_reach_hs/tau_ref"])
    dyn = ts.make_plant_dynamics(s, REACH_DT, plain=True)
    p = lambda x: TK.fk_link_position(s, x[..., :s.n_dofs], ee)
    cost = lambda x, u: (REACH_W["stage_goal_w"] * torch.sum((p(x) - goal) ** 2, -1)
                         + REACH_W["effort_w"] * torch.sum((u - tau_ref) ** 2, -1))
    final = lambda x: REACH_W["final_goal_w"] * torch.sum((p(x) - goal) ** 2, -1)
    lin = ts.make_gn_reach_linearize(s, ee, dyn, goal, u_ref=tau_ref,
                                     f_AB=ts.make_ift_f_AB(s, REACH_DT), **REACH_W)
    r = ts.ilqr(dyn, cost, final, x0, us0, n_iters=REACH_ITERS, linearize=lin,
                riccati="horizon_sharded", riccati_mesh=mesh)
    out["ilqr_reach_hs/cost"] = r.cost
    for k, g in zip(("x0", "us", "goal"), torch.autograd.grad(r.cost, (x0, us0, goal))):
        out[f"ilqr_reach_hs/grad_{k}"] = g


def _ilqr_batch(mesh, ref, out, rank):
    dynamics, cost, final_cost = _di_problem()
    x0s, us0 = _t(ref["ilqr_batch/x0s"]), _t(ref["ilqr_batch/us0"])
    kw = dict(n_iters=5, riccati="parallel")
    r = ts.ilqr_batch(dynamics, cost, final_cost, x0s, us0, mesh=mesh, **kw)
    out["ilqr_batch/local_rows"] = r.us.to_local().shape[0]
    for k in ("xs", "us", "cost", "cost_history"):
        out[f"ilqr_batch/{k}"] = getattr(r, k).full_tensor()
    if rank == 0:
        r = ts.ilqr_batch(dynamics, cost, final_cost, x0s, us0, **kw)
        for k in ("xs", "us", "cost", "cost_history"):
            out[f"ilqr_batch/unsharded/{k}"] = getattr(r, k)


def _grad_sharded(mesh, ref, out, rank):
    r, ee = _two_link()
    solve_one = lambda sc: ts.solve_kinematic_adam(r, sc["q0"], sc["goal"], ee, horizon=3,
                                                   n_iters=2).cost
    goal = _t(ref["grad_sharded/goal"])
    q0 = torch.zeros((B, 2), dtype=F64)
    g = pm.shard_scenarios(mesh, goal).requires_grad_()
    pm.sharded_batch_solver(mesh, solve_one)({"q0": pm.shard_scenarios(mesh, q0), "goal": g}).mean().backward()
    out["grad_sharded/grad"] = g.grad.full_tensor()
    if rank == 0:
        g = goal.clone().requires_grad_()
        torch.stack([solve_one({"q0": q0[b], "goal": g[b]}) for b in range(B)]).mean().backward()
        out["grad_sharded/unsharded/grad"] = g.grad


BOX = 0.5  # N m: binds the 2-link robot's torques


def _dyn_mpc(mesh, ref, out, rank):
    r, ee = _two_link()
    r = r.with_arrays(limit_effort=torch.full((2,), BOX, dtype=F64))
    q0, goal = _t(ref["dyn_mpc/q0"]), _t(ref["dyn_mpc/goal"])
    kw = dict(horizon=4, n_iters=3, lr=0.5, eps=1e-1, respect_effort_limits=True)
    acts, cost = pm.sharded_dynamic_mpc(mesh, r, ee, **kw)(
        *pm.shard_scenarios(mesh, (q0, torch.zeros_like(q0), goal)))
    out["dyn_mpc/local_rows"] = acts.to_local().shape[0]
    out["dyn_mpc/actions"], out["dyn_mpc/cost"] = acts.full_tensor(), cost.full_tensor()
    if rank == 0:
        res = ts.solve_dynamic_adam_batch(r, q0, torch.zeros_like(q0), goal, ee, **kw)
        out["dyn_mpc/unsharded/actions"], out["dyn_mpc/unsharded/cost"] = res.actions, res.cost


def _mppi(mesh, ref, out, rank):
    r, ee = _two_link()
    q0, goal = _t(ref["mppi/q0"]), _t(ref["mppi/goal"])
    keys = rng.split_key(rng.prng_key(7), B)
    args = pm.shard_scenarios(mesh, (q0, torch.zeros_like(q0), goal, keys))
    solve = lambda **kw: [x.full_tensor() for x in pm.sharded_mppi(mesh, r, ee, 4, **MPPI, **kw)(*args)]
    row = {tuple(k.tolist()): b for b, k in enumerate(keys)}
    jax_normals = torch.from_numpy(ref["mppi/normals"])  # [B, iters, H, D, K]

    def injected(key, n, t, H, D, K, dtype, device=None):  # JAX's normals of each key's scenario
        rows = [row[tuple(k.tolist())] for k in key]
        return jax_normals[rows, t].permute(1, 2, 0, 3).to(dtype)

    philox = ts.mppi_normals
    ts.mppi_normals = injected
    try:
        out["mppi/actions"], out["mppi/cost"] = solve()
    finally:
        ts.mppi_normals = philox
    out["mppi/actions_sigma0"], out["mppi/cost_sigma0"] = solve(noise_sigma=0.0)
    out["mppi/philox/actions"], out["mppi/philox/cost"] = solve()
    if rank == 0:
        res = ts.solve_dynamic_mppi_batch(r, q0, torch.zeros_like(q0), goal, ee, 4, keys, **MPPI)
        out["mppi/unsharded/actions"], out["mppi/unsharded/cost"] = res.actions, res.cost


def _fleet(mesh, ref, out, rank):
    fleet = build_fleet([_two_link()[0], _iiwa()[0]], ["endEffector", "iiwa_link_ee"], dtype=F64)
    q0, goal = _t(ref["fleet/q0"]), _t(ref["fleet/goal"])
    kw = dict(horizon=4, n_iters=3, lr=0.5, eps=1e-1)
    acts, cost = pm.sharded_fleet_dynamic_mpc(mesh, fleet, **kw)(q0, torch.zeros_like(q0), goal)
    out["fleet/local_rows"] = acts.to_local().shape[1]
    out["fleet/actions"], out["fleet/cost"] = acts.full_tensor(), cost.full_tensor()
    if rank == 0:
        from differentiable_robot_model_tpu_torch.models.fleet import solve_fleet_dynamic_adam

        res = solve_fleet_dynamic_adam(fleet, q0, torch.zeros_like(q0), goal, **kw)
        out["fleet/unsharded/actions"], out["fleet/unsharded/cost"] = res.actions, res.cost


def _placement(mesh, ref, out, rank):
    """`replicate` is rank 0's tensor on every rank; `shard_scenarios`
    gives each rank its contiguous block and refuses a batch that does not
    divide over the ranks."""
    out["placement/replicated"] = pm.replicate(mesh, torch.full((3,), float(rank))).to_local()
    out["placement/block"] = pm.shard_scenarios(mesh, torch.arange(8.0)).to_local()
    try:
        pm.shard_scenarios(mesh, torch.zeros(6, 2))
        out["placement/refused"] = False
    except ValueError:
        out["placement/refused"] = True


CASES = (_placement, _batch_solver, _kin_mpc, _train, _riccati, _ilqr_hs, _ilqr_batch, _grad_sharded,
         _dyn_mpc, _mppi, _fleet, _riccati_grad, _mesh2d, _ilqr_hs_grad, _ilqr_reach_hs)


def _rank_main(rank, rendezvous, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + rendezvous, world_size=N_RANKS,
                            rank=rank)
    try:
        ref = np.load(REF)
        mesh = pm.make_mesh(device_type="cpu")
        out = {}
        for case in CASES:
            case(mesh, ref, out, rank)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
                 **{k: torch.as_tensor(v).detach().numpy() for k, v in out.items()})
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ref():
    return np.load(REF)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    mp.spawn(_rank_main, args=(str(d / "rendezvous"), str(d)), nprocs=N_RANKS, join=True)
    return [dict(np.load(d / f"rank{r}.npz")) for r in range(N_RANKS)]


def _close(got, want, tol=TOL, scale=None):
    """got to tol of `scale`, by default the largest entry of want or 1."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(1.0, float(np.max(np.abs(want)))) if scale is None else scale
    assert np.max(np.abs(got - want)) <= tol * scale, np.max(np.abs(got - want)) / scale


def _check(ranks, ref, case, names, local_rows=B // N_RANKS):
    """Every rank gathered the same result; it equals JAX's and the port's
    unsharded one; each rank held B / 4 scenarios."""
    r0 = ranks[0]
    for name in names:
        key = f"{case}/{name}"
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[key], r0[key])
        _close(r0[key], ref[key])
        _close(r0[key], r0[f"{case}/unsharded/{name}"], SELF_TOL)
    if f"{case}/local_rows" in r0:
        assert all(int(r[f"{case}/local_rows"]) == local_rows for r in ranks)


def test_placement(ranks):
    for rank, r in enumerate(ranks):
        np.testing.assert_array_equal(r["placement/replicated"], np.zeros(3))
        np.testing.assert_array_equal(r["placement/block"], [2.0 * rank, 2.0 * rank + 1])
        assert bool(r["placement/refused"])


def test_sharded_batch_solver(ranks, ref):
    _check(ranks, ref, "batch_solver", ["actions"])


def test_sharded_kinematic_mpc(ranks, ref):
    _check(ranks, ref, "kin_mpc", ["actions", "cost"])


def test_data_parallel_train_step(ranks, ref):
    names = [f"loss{i}" for i in range(2)] + [k.split("/", 1)[1] for k in ref.files
                                              if k.startswith("train/params")]
    _check(ranks, ref, "train", names)


def _sequential_gains(prob):
    """The sequential Riccati recursion of `ilqr_batch` (lam = 0) on one
    scenario's stage arrays."""
    stage = [x[:, None] for x in prob[:7]] + [prob[7][None], prob[8][None]]
    us = torch.zeros(stage[3].shape, dtype=F64)
    ks, Ks = ts._backward_pass(lambda xs, us: stage, "sequential", None, us, torch.zeros(1, dtype=F64))
    return ks[:, 0], Ks[:, 0]


def test_riccati_horizon_sharded(ranks, ref):
    """H = 21 on 4 ranks (22 elements: padded) and on a 3-rank sub-mesh,
    against JAX's sharded Riccati, the sequential recursion and the
    port's unsharded parallel form; and with a scenario axis."""
    _check(ranks, ref, "riccati", ["ks", "Ks"])
    seq = _sequential_gains([_t(ref[f"riccati/{k}"]) for k in RICCATI_ORDER])
    for r in ranks:
        _close(r["riccati/ks"], seq[0])
        _close(r["riccati/Ks"], seq[1])
    for r in ranks[:3]:
        _close(r["riccati/ks3"], ref["riccati/ks"])
        _close(r["riccati/Ks3"], ref["riccati/Ks"])
        _close(r["riccati/ks3"], ranks[0]["riccati/unsharded/ks"], SELF_TOL)
    assert "riccati/ks3" not in ranks[3]
    for name in ("batched_ks", "batched_Ks"):
        _close(ranks[0][f"riccati/{name}"], ranks[0][f"riccati/unsharded/{name}"], SELF_TOL)
    _close(ranks[0]["riccati/batched_ks"][:, 0], ref["riccati/ks"])


def test_ilqr_horizon_sharded(ranks, ref):
    """ilqr(riccati="horizon_sharded") on 4 ranks against JAX's, the
    unsharded parallel Riccati and the sequential one (iterate for
    iterate, as tests/test_parallel.py holds JAX's)."""
    r0 = ranks[0]
    for name, tol in (("us", ILQR_US_TOL), ("xs", ILQR_US_TOL), ("cost_history", TOL)):
        _close(r0[f"ilqr_hs/{name}"], ref[f"ilqr_hs/{name}"], tol)
    _close(r0["ilqr_hs/us"], r0["ilqr_hs/parallel/us"], ILQR_US_TOL)
    _close(r0["ilqr_hs/cost_history"], r0["ilqr_hs/parallel/cost_history"], SELF_TOL)
    _close(r0["ilqr_hs/us"], r0["ilqr_hs/sequential/us"], ILQR_US_TOL)
    _close(r0["ilqr_hs/cost_history"], r0["ilqr_hs/sequential/cost_history"], TOL)
    for r in ranks[1:]:
        np.testing.assert_array_equal(r["ilqr_hs/us"], r0["ilqr_hs/us"])


def _grad_close(got, want, tol=TOL, scale=None):
    """A gradient to tol of `scale`, by default its largest entry."""
    _close(got, want, tol, np.abs(want).max() if scale is None else scale)


def _sym(x):
    return 0.5 * (x + np.swapaxes(x, -1, -2))


def _riccati_grads_close(r, prefix, want, tol, symmetric_parts=False):
    """Every array's gradient against `want[array]`: whole, or with
    `symmetric_parts` (against the port's parallel form) only the
    symmetric part of lxx, luu and Vxx, since the antisymmetric part of a
    gradient w.r.t. a symmetric input depends on the order in which the
    compositions read its elements."""
    for k in RICCATI_ORDER:
        got, w = r[f"{prefix}/{k}"], want[k]
        if symmetric_parts and k in SYMMETRIC:
            got, w = _sym(got), _sym(w)
        _grad_close(got, w, tol)


def _grads(d, prefix):
    return {k: d[f"{prefix}/{k}"] for k in RICCATI_ORDER}


def test_riccati_horizon_sharded_gradient(ranks, ref):
    """(a) The weighted gains' gradient w.r.t. all nine stage arrays, H=21
    on 4 ranks (padded) and on the 3-rank sub-mesh: against `jax.grad` of
    JAX's horizon-sharded function, whole; against the port's unsharded
    parallel form; bitwise equal on every rank. With the scenario axis,
    against the port's parallel form."""
    r0 = ranks[0]
    for n in ("4", "3"):
        pre = f"riccati_grad/{n}"
        for r in ranks[1:int(n)]:
            for k in RICCATI_ORDER:
                np.testing.assert_array_equal(r[f"{pre}/{k}"], r0[f"{pre}/{k}"])
        _riccati_grads_close(r0, pre, _grads(ref, pre), TOL)
        _riccati_grads_close(r0, pre, _grads(r0, "riccati_grad/parallel"),
                             SELF_TOL, symmetric_parts=True)
    assert "riccati_grad/3/A" not in ranks[3]
    _riccati_grads_close(r0, "riccati_grad/batched", _grads(r0, "riccati_grad/batched_parallel"),
                         SELF_TOL, symmetric_parts=True)


@pytest.mark.parametrize("case", ["h5", "h21"])
def test_ilqr_horizon_sharded_gradient(case, ranks, ref):
    """(b) ilqr(riccati="horizon_sharded") on the double integrator: the
    cost's gradient w.r.t. x0 and us_init against `jax.grad` of JAX's, on
    every rank the same. The problem is linear-quadratic, so the gradient
    w.r.t. us_init is zero to rounding: it is held at TOL of the x0
    gradient's scale."""
    pre = f"ilqr_hs_grad/{case}"
    r0 = ranks[0]
    _close(r0[f"{pre}/cost"], ref[f"{pre}/cost"])
    _grad_close(r0[f"{pre}/grad_x0"], ref[f"{pre}/grad_x0"])
    _grad_close(r0[f"{pre}/grad_us"], ref[f"{pre}/grad_us"],
                scale=np.abs(ref[f"{pre}/grad_x0"]).max())
    assert np.abs(ref[f"{pre}/grad_x0"]).max() > 1.0
    for r in ranks[1:]:
        for k in ("grad_x0", "grad_us"):
            np.testing.assert_array_equal(r[f"{pre}/{k}"], r0[f"{pre}/{k}"])


def test_ilqr_reach_horizon_sharded_gradient(ranks, ref):
    """(c) The 2-link reach problem at H=3 on 4 ranks: the gradient w.r.t.
    x0, us_init and the goal against `jax.grad` of JAX's
    ilqr(riccati="horizon_sharded"), none of them zero."""
    r0 = ranks[0]
    _close(r0["ilqr_reach_hs/cost"], ref["ilqr_reach_hs/cost"])
    for k in ("x0", "us", "goal"):
        want = ref[f"ilqr_reach_hs/grad_{k}"]
        assert np.abs(want).max() > 1e-3, k
        _grad_close(r0[f"ilqr_reach_hs/grad_{k}"], want)
        for r in ranks[1:]:
            np.testing.assert_array_equal(r[f"ilqr_reach_hs/grad_{k}"], r0[f"ilqr_reach_hs/grad_{k}"])


def test_riccati_on_a_2d_mesh(ranks, ref):
    """(d) On the "horizon" axis of a 2x2 ("scenario", "horizon") mesh the
    gains and their gradient match JAX's on a 2x2 mesh, and the port's
    unsharded call, on all four ranks; a 2-D mesh without the axis asked
    for raises KeyError naming its axes."""
    r0 = ranks[0]
    for r in ranks:
        for k in ["ks", "Ks"] + [f"grad/{a}" for a in RICCATI_ORDER]:
            np.testing.assert_array_equal(r[f"mesh2d/{k}"], r0[f"mesh2d/{k}"])
        assert bool(r["mesh2d/refused"])
    for k in ("ks", "Ks"):
        _close(r0[f"mesh2d/{k}"], ref[f"riccati_grad/2x2/{k}"])
        _close(r0[f"mesh2d/{k}"], r0[f"riccati/unsharded/{k}"], SELF_TOL)
    _riccati_grads_close(r0, "mesh2d/grad", _grads(ref, "riccati_grad/2x2"), TOL)
    _riccati_grads_close(r0, "mesh2d/grad", _grads(r0, "riccati_grad/parallel"),
                         SELF_TOL, symmetric_parts=True)


def test_ilqr_batch_mesh(ranks, ref):
    _check(ranks, ref, "ilqr_batch", ["cost", "cost_history"])
    r0 = ranks[0]
    for name in ("xs", "us"):
        _close(r0[f"ilqr_batch/{name}"], ref[f"ilqr_batch/{name}"], ILQR_US_TOL)
        _close(r0[f"ilqr_batch/{name}"], r0[f"ilqr_batch/unsharded/{name}"], ILQR_US_TOL)


def test_grad_through_sharded_solve(ranks, ref):
    """The mean solve cost's gradient w.r.t. the sharded goals, through
    `to_local`, the solves and `from_local` (B2): tests/test_parallel.py:262-278."""
    _check(ranks, ref, "grad_sharded", ["grad"])
    assert np.abs(ranks[0]["grad_sharded/grad"]).max() > 0


def test_sharded_dynamic_mpc_forwards_kwargs(ranks, ref):
    """respect_effort_limits reaches the solver: the box holds and binds."""
    _check(ranks, ref, "dyn_mpc", ["actions", "cost"])
    assert np.abs(ranks[0]["dyn_mpc/actions"]).max() == BOX


def test_sharded_mppi(ranks, ref):
    """JAX's normals per scenario key, and the Philox noise at sigma = 0,
    against JAX's sharded_mppi; the per-scenario Philox keys against the
    port's unsharded batch under the same keys."""
    r0 = ranks[0]
    for name in ("actions", "cost", "actions_sigma0", "cost_sigma0"):
        _close(r0[f"mppi/{name}"], ref[f"mppi/{name}"])
    for name in ("actions", "cost"):
        _close(r0[f"mppi/philox/{name}"], r0[f"mppi/unsharded/{name}"], SELF_TOL)
    assert np.abs(r0["mppi/philox/actions"] - r0["mppi/actions_sigma0"]).max() > 1e-3


def test_sharded_fleet_dynamic_mpc(ranks, ref):
    _check(ranks, ref, "fleet", ["actions", "cost"])


# --- single process


def test_make_mesh_needs_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        pm.make_mesh(device_type="cpu")


@pytest.mark.skipif(torch.cuda.is_available(), reason="checks the refusal where CUDA is absent")
def test_make_mesh_refuses_cuda_without_a_card(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
                            rank=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA"):
            pm.make_mesh()
        assert pm.make_mesh(device_type="cpu").size() == 1
    finally:
        dist.destroy_process_group()


def test_ilqr_horizon_sharded_refusals():
    dynamics, cost, final_cost = _di_problem()
    with pytest.raises(ValueError, match="riccati_mesh"):
        ts.ilqr(dynamics, cost, final_cost, torch.zeros(4, dtype=F64),
                torch.zeros((5, 2), dtype=F64), riccati="horizon_sharded")
    with pytest.raises(ValueError, match="horizon_sharded"):
        ts.ilqr_batch(dynamics, cost, final_cost, torch.zeros((2, 4), dtype=F64),
                      torch.zeros((2, 5, 2), dtype=F64), riccati="horizon_sharded")


def test_per_scenario_keys():
    """With keys [B, 2], scenario b draws (`mppi_normals`) and solves
    (`mppi_solve_reference`, K10's plain version) as a one-scenario call
    under keys[b] does; the one-key form is the stream at scenario word b."""
    keys = rng.split_key(rng.prng_key(3), 3)
    z = rng.mppi_normals(keys, 3, 1, 4, 2, 8, F64)
    one = rng.mppi_normals(rng.prng_key(3), 3, 1, 4, 2, 8, F64)
    for b in range(3):
        torch.testing.assert_close(z[:, :, b], rng.mppi_normals(keys[b], 1, 1, 4, 2, 8, F64)[:, :, 0],
                                   rtol=0, atol=0)
    k0, k1 = rng.key_words(rng.prng_key(3))
    w = rng.philox4x32((2, 1, 0, 5), (k0, k1))  # scenario 2, iteration 1, entries 0-1, sample 5
    torch.testing.assert_close(one[0, :, 2, 5], torch.stack([rng.box_muller(w[0], w[1], F64),
                                                             rng.box_muller(w[2], w[3], F64)]),
                               rtol=0, atol=0)

    r, ee = _two_link()
    g = np.random.default_rng(0)
    q0T, goalT = _t(g.uniform(-0.5, 0.5, (2, 3))), _t(g.uniform(0.3, 0.9, (3, 3)))
    tau_refT, H0, aT0 = ksolver.dyn_prologue_reference(r, q0T, None, 4)
    kw = dict(n_iters=2, n_samples=8, dt=0.02, temperature=0.01, noise_sigma=5.0, goal_weight=10.0,
              effort_weight=1e-4)
    tau, costs = ksolver.mppi_solve_reference(r, q0T, torch.zeros_like(q0T), goalT, tau_refT, H0,
                                              aT0, keys, ee, **kw)
    for b in range(3):
        sl = slice(b, b + 1)
        tb, cb = ksolver.mppi_solve_reference(r, q0T[:, sl], torch.zeros_like(q0T[:, sl]),
                                              goalT[:, sl], tau_refT[:, sl], H0[..., sl],
                                              aT0[..., sl], keys[b], ee, **kw)
        torch.testing.assert_close(tau[..., sl], tb, rtol=0, atol=SELF_TOL)
        torch.testing.assert_close(costs[:, sl], cb, rtol=SELF_TOL, atol=0)
    with pytest.raises(ValueError, match="per-scenario keys"):
        rng.mppi_normals(keys[:2], 3, 0, 4, 2, 8, F64)


GRAD_SOLVES = {
    "kinematic": None, "dynamic": None, "kinematic_batch": "fused", "dynamic_batch": "fused",
}


@pytest.mark.parametrize("name", list(GRAD_SOLVES))
def test_solve_gradients_match_jax(name, ref, monkeypatch):
    """B2: the gradient of the final cost w.r.t. the goals, q0 and the warm
    start, of the unbatched solves and of the batch solves asked for
    their kernel engine (which must take the plain one, before any
    launch), against `jax.grad` of the JAX package's solves."""
    r, ee = _two_link()
    goal, q0 = _t(ref["grads/goal"]).requires_grad_(), _t(ref["grads/q0"]).requires_grad_()
    init = _t(ref[f"grads/{'kin' if name.startswith('kinematic') else 'dyn'}_init"]).requires_grad_()
    for kernel in ("kinematic_adam_solve", "dynamic_adam_solve", "dyn_prologue"):
        monkeypatch.setattr(ts, kernel, lambda *a, **k: pytest.fail("a kernel wrapper was called"))
    kin = dict(horizon=3, n_iters=2, lr=0.05, eps=1e-3)
    dyn = dict(horizon=3, n_iters=2, lr=0.3, eps=1e-1)
    qd0 = torch.zeros((2, 2), dtype=F64)
    if name == "kinematic":
        cost = ts.solve_kinematic_adam(r, q0[0], goal[0], ee, init_actions=init[0], **kin).cost
    elif name == "dynamic":
        cost = ts.solve_dynamic_adam(r, q0[0], qd0[0], goal[0], ee, init_actions=init[0], **dyn).cost
    elif name == "kinematic_batch":
        cost = ts.solve_kinematic_adam_batch(r, q0, goal, ee, init_actions=init,
                                             fk_impl=GRAD_SOLVES[name], **kin).cost.sum()
    else:
        cost = ts.solve_dynamic_adam_batch(r, q0, qd0, goal, ee, init_actions=init,
                                           rollout_impl=GRAD_SOLVES[name], **dyn).cost.sum()
    _close(cost.detach(), ref[f"grads/{name}/cost"])
    grads = torch.autograd.grad(cost, (goal, q0, init))
    for arg, g in zip(("goal", "q0", "init"), grads):
        _close(g, ref[f"grads/{name}/{arg}"])
