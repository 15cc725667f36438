"""Gradients through the port's MPPI and iLQR solves, and the torque
solve's `rollout_unroll` / `rollout_remat`, against the JAX package's
`jax.grad`, in float64 on the CPU.

The JAX side is tests/data/torch_solve_grad_jax.npz, written by
tools/jax_grad_reference.py (tracing and compiling those gradients takes
minutes); each case's inputs are stored beside its outputs. Every
gradient is held to JAX's at 1e-9 relative to its largest entry, every
cost at 1e-9 relative:

- MPPI: `solve_dynamic_mppi`'s cost and `solve_dynamic_mppi_batch`'s summed
  costs w.r.t. the warm start, q0 and the goal (the 2-link robot and iiwa,
  one case with a binding effort box). The noise streams differ (threefry
  against Philox), so JAX's normals go into the port's loop through
  `solvers.mppi_normals`. The engine asked for is "auto".
- iLQR on the double integrator of tests/test_trajopt.py: `ilqr` and
  `ilqr_batch` w.r.t. x0 and us_init, sequential and parallel Riccati,
  through the generic `torch.func` linearization (the gradient w.r.t.
  us_init is zero to rounding on this linear-quadratic problem, so it is
  held to 1e-9 of the x0 gradient's scale).
- iLQR on the 2-link robot's torque plant with `make_gn_reach_linearize`
  and `make_ift_f_AB`, w.r.t. x0, us_init and the goals: with the plain
  plant, and with the kernel plant, whose graph-keeping calls go through
  the rollout kernels' autograd entry (K5 forward, K6 backward: their
  plain versions on the CPU); `make_ift_f_AB`'s own gradient.
- `dynamic_rollout_dof_major(unroll, remat)` and `solve_dynamic_adam_batch(
  rollout_unroll, rollout_remat)`: the same values and gradients as the
  defaults, and JAX's; the sharded dynamic MPC forwards both.

The engine choices are spied on: a graph-keeping call reaches no kernel
wrapper that autograd cannot differentiate, a call that keeps no graph
reaches the same wrappers as before.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu_torch.ops import kinematics as TK
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr
from differentiable_robot_model_tpu_torch.parallel import mesh as pm
from differentiable_robot_model_tpu_torch.parallel.horizon import riccati_gains_horizon_sharded
from differentiable_robot_model_tpu_torch.trajopt import rollout as trollout
from differentiable_robot_model_tpu_torch.trajopt import solvers as ts

REF = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_solve_grad_jax.npz")
TOL = 1e-9
F64 = torch.float64
DT = 0.02
BOX = 5.0
MPPI_KW = dict(temperature=0.01, noise_sigma=5.0, goal_weight=10.0, effort_weight=1e-4, dt=DT)
MPPI_CASES = {  # name: (robot, effort box, batched)
    "2link": ("2link", False, False),
    "2link_batch": ("2link", False, True),
    "iiwa": ("iiwa", False, False),
    "iiwa_effort_box": ("iiwa", True, False),
}
DI_DT, DI_ITERS = 0.1, 3
DI_GOAL = (1.0, -0.5, 0.0, 0.0)
REACH_ITERS = 2
REACH_W = dict(stage_goal_w=10.0, effort_w=1e-4, final_goal_w=100.0)
REMAT_DYN = dict(horizon=3, n_iters=2, lr=0.3, eps=1e-1)


@pytest.fixture(scope="module")
def ref():
    with np.load(REF) as f:
        return {k: f[k] for k in f.files}


def _case(ref, prefix):
    return {k[len(prefix) + 1:]: v for k, v in ref.items() if k.startswith(prefix + "/")}


def _close(t, j, what="", scale=None):
    """t to TOL of `scale`, by default the largest entry of JAX's j."""
    j = np.asarray(j)
    scale = np.abs(j).max() if scale is None else scale
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=0, atol=TOL * max(scale, 1e-300),
                               err_msg=what)


def _robot(name, box=False):
    if name == "iiwa":
        s = drt.DifferentiableKUKAiiwa(dtype=F64, device="cpu").struct
        ee = s.link_index("iiwa_link_ee")
    else:
        s = drt.DifferentiableTwoLinkRobot(dtype=F64, device="cpu").struct
        ee = s.link_index("endEffector")
    if box:
        s = s.with_arrays(limit_effort=torch.full_like(s.limit_effort, BOX))
    return s, ee


def _leaves(r, *names):
    return [torch.tensor(r[n], requires_grad=True) for n in names]


def _spy(monkeypatch, calls, targets):
    """Record every call of the named functions (module, name)."""
    for mod, name in targets:
        fn = getattr(mod, name)

        def wrapped(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)


MPPI_WRAPPERS = ((ts, "mppi_solve"), (ts, "dyn_prologue"), (ts, "dyn_rollout_ee_fwd"),
                 (ts, "dynamic_rollout_ee"))


# ---- MPPI (B3) ---------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(MPPI_CASES))
def test_mppi_gradient_matches_jax(case, ref, monkeypatch):
    robot, box, batched = MPPI_CASES[case]
    r = _case(ref, f"mppi/{case}")
    z = torch.from_numpy(r["normals"])  # [T, H, D, n, K]
    T, H, _, _, K = z.shape
    monkeypatch.setattr(ts, "mppi_normals", lambda key, B, t, *args: z[t])
    calls = []
    _spy(monkeypatch, calls, MPPI_WRAPPERS)
    s, ee = _robot(robot, box)
    init, q0, goal = _leaves(r, "init", "q0", "goal")
    qd0 = torch.zeros(q0.shape, dtype=F64)
    kw = dict(n_samples=K, n_iters=T, respect_effort_limits=box, rollout_impl="auto", **MPPI_KW)
    if batched:
        res = ts.solve_dynamic_mppi_batch(s, q0, qd0, goal, ee, H, 0, init_actions=init, **kw)
        total = res.cost.sum()
    else:
        res = ts.solve_dynamic_mppi(s, q0[0], qd0[0], goal[0], ee, H, 0, init_actions=init[0], **kw)
        total = res.cost
    grads = torch.autograd.grad(total, (init, q0, goal))
    assert calls == []
    _close(total, r["cost"], "cost")
    _close(res.actions, r["actions"], "actions")
    for name, g in zip(("init", "q0", "goal"), grads):
        assert np.abs(r[f"grad_{name}"]).max() > 1e-6, name
        _close(g, r[f"grad_{name}"], name)


@pytest.mark.parametrize("batched", [False, True])
def test_mppi_grad_takes_scan_for_every_engine(batched):
    s, _ = _robot("2link")
    engines = ts.MPPI_BATCH_ENGINES if batched else ts.MPPI_ENGINES
    for engine in engines:
        assert ts.resolve_mppi_engine(engine, s, 64, False, batched, grad=True) == "scan"
        want = "scan" if engine == "auto" else engine  # a CPU robot
        assert ts.resolve_mppi_engine(engine, s, 64, False, batched) == want
    if batched:  # an explicit "fused" that K10 cannot run raises first, grad or not
        with pytest.raises(ValueError, match="adaptation"):
            ts.resolve_mppi_engine("fused", s, 64, True, True, grad=True)
        with pytest.raises(ValueError, match="at most"):
            ts.resolve_mppi_engine("fused", s, ts.MAX_SAMPLES + 1, False, True, grad=True)


@pytest.mark.parametrize("engine", ["kernel", "fused"])
def test_mppi_grad_call_reaches_no_kernel_wrapper(engine, monkeypatch):
    s, ee = _robot("2link")
    rng = np.random.default_rng(3)
    q0 = torch.tensor(rng.uniform(-0.5, 0.5, (2, 2)))
    goal = torch.tensor([[0.7, 0.3, 0.2], [0.8, 0.4, 0.2]], dtype=F64, requires_grad=True)
    calls = []
    _spy(monkeypatch, calls, MPPI_WRAPPERS)
    kw = dict(n_samples=4, n_iters=1, rollout_impl=engine)
    res = ts.solve_dynamic_mppi_batch(s, q0, torch.zeros_like(q0), goal, ee, 2, 7, **kw)
    assert calls == [] and res.cost.requires_grad
    with torch.no_grad():
        ts.solve_dynamic_mppi_batch(s, q0, torch.zeros_like(q0), goal.detach(), ee, 2, 7, **kw)
    assert "dyn_prologue" in calls  # a constant problem keeps the engine named


# ---- iLQR (B4) ---------------------------------------------------------------


def _di():
    goal = torch.tensor(DI_GOAL, dtype=F64)

    def dynamics(x, u):
        vel2 = x[..., 2:] + DI_DT * u
        return torch.cat([x[..., :2] + DI_DT * vel2, vel2], dim=-1)

    def cost(x, u):
        return 0.1 * torch.sum(u * u, -1) + torch.sum((x - goal) ** 2, -1)

    def final_cost(x):
        return 100.0 * torch.sum((x - goal) ** 2, -1)

    return dynamics, cost, final_cost


@pytest.mark.parametrize("form", ["ilqr", "batch"])
@pytest.mark.parametrize("riccati", ["sequential", "parallel"])
def test_ilqr_double_integrator_gradient_matches_jax(form, riccati, ref):
    r = _case(ref, f"ilqr_di/{form}_{riccati}")
    x0s, us0 = _leaves(_case(ref, "ilqr_di"), "x0s", "us0")
    args = _di()
    if form == "ilqr":
        res = ts.ilqr(*args, x0s[0], us0[0], n_iters=DI_ITERS, riccati=riccati)
        total = res.cost
    else:
        res = ts.ilqr_batch(*args, x0s, us0, n_iters=DI_ITERS, riccati=riccati)
        total = res.cost.sum()
    gx, gu = torch.autograd.grad(total, (x0s, us0))
    _close(total, r["cost"], "cost")
    _close(gx, r["grad_x0"], "x0")
    # linear dynamics and a quadratic cost: the first iteration's step lands
    # where us_init no longer matters, so both gradients w.r.t. it are zero
    # to rounding (~1e-17); they are held at TOL of the x0 gradient's scale
    # (the reach case holds a gradient w.r.t. us_init that is not zero)
    _close(gu, r["grad_us"], "us_init", scale=np.abs(r["grad_x0"]).max())
    assert np.abs(r["grad_x0"]).max() > 1.0 and np.abs(r["grad_us"]).max() < 1e-12


def test_ilqr_keeps_no_graph_where_nothing_requires_grad():
    x0s, us0 = torch.zeros((2, 4), dtype=F64), torch.zeros((2, 5, 2), dtype=F64)
    res = ts.ilqr_batch(*_di(), x0s, us0, n_iters=2)
    assert not any(t.requires_grad for t in res)


def _reach(ref, plain):
    r = _case(ref, "ilqr_reach")
    s, ee = _robot("2link")
    x0s, us0, goals = _leaves(r, "x0s", "us0", "goals")
    tau_ref = torch.tensor(r["tau_ref"])
    dyn = ts.make_plant_dynamics(s, DT, plain=plain)
    p = lambda x: TK.fk_link_position(s, x[..., :s.n_dofs], ee)
    cost = lambda x, u: (REACH_W["stage_goal_w"] * torch.sum((p(x) - goals) ** 2, -1)
                         + REACH_W["effort_w"] * torch.sum((u - tau_ref) ** 2, -1))
    final = lambda x: REACH_W["final_goal_w"] * torch.sum((p(x) - goals) ** 2, -1)
    lin = ts.make_gn_reach_linearize(s, ee, dyn, goals, u_ref=tau_ref, f_AB=ts.make_ift_f_AB(s, DT),
                                     **REACH_W)
    return r, (x0s, us0, goals), lambda: ts.ilqr_batch(dyn, cost, final, x0s, us0,
                                                       n_iters=REACH_ITERS, linearize=lin)


ILQR_WRAPPERS = ((ts, "dyn_rollout_fwd"), (ts, "dyn_rollout_replay"), (kr, "dyn_rollout_fwd"),
                 (kr, "dyn_rollout_bwd"))


@pytest.mark.parametrize("plant", ["plain", "kernel"])
def test_ilqr_reach_gradient_matches_jax(plant, ref, monkeypatch):
    r, leaves, solve = _reach(ref, plain=plant == "plain")
    calls = []
    _spy(monkeypatch, calls, ILQR_WRAPPERS)
    total = solve().cost.sum()
    grads = torch.autograd.grad(total, leaves)
    _close(total, r["cost"], "cost")
    for name, g in zip(("x0", "us", "goal"), grads):
        assert np.abs(r[f"grad_{name}"]).max() > 1e-3, name
        _close(g, r[f"grad_{name}"], name)
    # a graph-keeping solve never reaches the replay kernel's wrapper; its
    # kernel plant runs K5 forward and K6 backward (their plain versions here)
    assert "dyn_rollout_replay" not in calls
    assert set(calls) == (set() if plant == "plain" else {"dyn_rollout_fwd", "dyn_rollout_bwd"})


def test_ilqr_without_grad_reaches_the_kernel_wrappers(ref, monkeypatch):
    _, leaves, solve = _reach(ref, plain=False)
    calls = []
    _spy(monkeypatch, calls, ILQR_WRAPPERS)
    with torch.no_grad():
        res = solve()
    assert not res.cost.requires_grad
    # K5 for each plant step (the initial rollout's 3 and 3 a line search),
    # the replay once an iteration; no backward
    assert calls.count("dyn_rollout_fwd") == 3 * (REACH_ITERS + 1)
    assert calls.count("dyn_rollout_replay") == REACH_ITERS
    assert "dyn_rollout_bwd" not in calls


def test_ift_f_AB_gradient_matches_jax(ref):
    r = _case(ref, "ift")
    s, _ = _robot("2link")
    xs, us = _leaves(r, "xs", "us")
    A, B = ts.make_ift_f_AB(s, DT)(xs, us)
    val = torch.sum(A * torch.tensor(r["wA"])) + torch.sum(B * torch.tensor(r["wB"]))
    gx, gu = torch.autograd.grad(val, (xs, us))
    _close(val, r["value"], "value")
    _close(gx, r["grad_xs"], "xs")
    _close(gu, r["grad_us"], "us")


# ---- rollout_unroll / rollout_remat ------------------------------------------


def test_rollout_remat_matches_default_and_jax(ref):
    r = _case(ref, "remat/rollout")
    s, _ = _robot("2link")
    q0, qd0, taus = (torch.tensor(r[k]) for k in ("q0", "qd0", "taus"))
    wq, wqd = torch.tensor(r["wq"]), torch.tensor(r["wqd"])
    out = {}
    for kw in ({}, {"unroll": 2, "remat": True}):
        leaves = [x.clone().requires_grad_(True) for x in (q0.T, qd0.T, taus)]
        qs, qds = trollout.dynamic_rollout_dof_major(s, *leaves, DT, **kw)
        val = torch.sum(qs * wq) + torch.sum(qds * wqd)
        out[bool(kw)] = (val, *torch.autograd.grad(val, leaves))
    for a, b in zip(out[False], out[True]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _close(out[True][0], r["value"], "value")
    for name, g in zip(("q0", "qd0", "taus"), out[True][1:]):
        _close(g, r[f"grad_{name}"], name)
    with pytest.raises(ValueError, match="unroll"):
        trollout.dynamic_rollout_dof_major(s, q0.T, qd0.T, taus, DT, unroll=0)


def _remat_solve(r, s, ee, **kw):
    goal, q0, init = _leaves(r, "goal", "q0", "init")
    res = ts.solve_dynamic_adam_batch(s, q0, torch.zeros_like(q0), goal, ee, init_actions=init,
                                      rollout_impl="scan", **REMAT_DYN, **kw)
    total = res.cost.sum()
    return res.actions, total, torch.autograd.grad(total, (goal, q0, init))


def test_dynamic_solve_remat_and_unroll_match_default_and_jax(ref):
    r = _case(ref, "remat/solve")
    s, ee = _robot("2link")
    acts, total, grads = _remat_solve(r, s, ee, rollout_remat=True, rollout_unroll=4)
    acts0, total0, grads0 = _remat_solve(r, s, ee)
    for a, b in zip((acts, total, *grads), (acts0, total0, *grads0)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    _close(total, r["cost"], "cost")
    _close(acts, r["actions"], "actions")
    for name, g in zip(("goal", "q0", "init"), grads):
        _close(g, r[f"grad_{name}"], name)
    with pytest.raises(ValueError, match="rollout_unroll"):
        ts.solve_dynamic_adam_batch(s, torch.zeros((1, 2), dtype=F64), torch.zeros((1, 2), dtype=F64),
                                    torch.zeros((1, 3), dtype=F64), ee, 2, rollout_unroll=0)


def test_sharded_dynamic_mpc_forwards_remat_and_unroll(ref, tmp_path):
    r = _case(ref, "remat/solve")
    s, ee = _robot("2link")
    goal, q0 = torch.tensor(r["goal"]), torch.tensor(r["q0"])
    kw = dict(n_iters=REMAT_DYN["n_iters"], lr=REMAT_DYN["lr"], eps=REMAT_DYN["eps"],
              rollout_impl="scan", rollout_remat=True, rollout_unroll=4)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
                            rank=0)
    try:
        mesh = pm.make_mesh(device_type="cpu")
        solve = pm.sharded_dynamic_mpc(mesh, s, ee, REMAT_DYN["horizon"], **kw)
        acts, cost = solve(q0, torch.zeros_like(q0), goal)
        ref_res = ts.solve_dynamic_adam_batch(s, q0, torch.zeros_like(q0), goal, ee,
                                              REMAT_DYN["horizon"], **kw)
        torch.testing.assert_close(acts.full_tensor(), ref_res.actions, rtol=0, atol=0)
        torch.testing.assert_close(cost.full_tensor(), ref_res.cost, rtol=0, atol=0)
        with pytest.raises(ValueError, match="rollout_unroll"):
            pm.sharded_dynamic_mpc(mesh, s, ee, 2, rollout_unroll=0)(q0, torch.zeros_like(q0), goal)
    finally:
        dist.destroy_process_group()


def test_horizon_sharded_riccati_keeps_a_graph(tmp_path):
    """At world size 1 a graph-keeping horizon-sharded solve differentiates
    as the parallel form does; its backward refuses create_graph=True; a
    solve that keeps no graph runs as before."""
    args = _di()
    x0 = torch.tensor([0.2, -0.1, 0.3, 0.05], dtype=F64)
    us0 = torch.tensor(np.random.default_rng(7).normal(0.0, 0.1, (5, 2)))
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'rendezvous'}", world_size=1,
                            rank=0)
    try:
        mesh = pm.make_mesh(device_type="cpu")
        kw = dict(n_iters=2, riccati="horizon_sharded", riccati_mesh=mesh)
        grads = []
        for form in (kw, dict(n_iters=2, riccati="parallel")):
            x, u = x0.clone().requires_grad_(True), us0.clone().requires_grad_(True)
            grads.append(torch.autograd.grad(ts.ilqr(*args, x, u, **form).cost, (x, u)))
        scale = grads[1][0].abs().max()
        assert scale > 1.0
        for got, want in zip(*grads):
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12 * scale)
        g = np.random.default_rng(8)
        stage = [torch.tensor(g.normal(size=(3,) + shape)) for shape in
                 ((2, 2), (2, 1), (2,), (1,), (2, 2), (1, 1), (1, 2))]
        stage[4] = stage[4] @ stage[4].mT + torch.eye(2, dtype=F64)
        stage[5] = stage[5] @ stage[5].mT + 1.0
        lx = stage[2].requires_grad_(True)
        ks, _ = riccati_gains_horizon_sharded(mesh, *stage, torch.zeros(2, dtype=F64),
                                              torch.eye(2, dtype=F64))
        with pytest.raises(RuntimeError, match="create_graph"):
            torch.autograd.grad(ks.sum(), lx, create_graph=True)
        assert torch.autograd.grad(ks.sum(), lx)[0].abs().max() > 0
        res = ts.ilqr(*args, x0, us0, **kw)
        assert not res.us.requires_grad
        ref = ts.ilqr(*args, x0, us0, n_iters=2, riccati="parallel")
        torch.testing.assert_close(res.us, ref.us, rtol=0, atol=1e-12)
    finally:
        dist.destroy_process_group()
