"""Gradients through the port's batch solvers, and the engines' choice for
a robot whose tensors require grad.

The gradient of `solve_kinematic_adam_batch`'s and
`solve_dynamic_adam_batch`'s summed final cost w.r.t. one link translation
(the 2-link robot, float64, B=2) goes through every Adam step, the final
cost and, for the torque solve, the preconditioner H0, tau_ref and the warm
start. The kinematic one must equal `jax.grad` of the JAX package's batch
solve to 1e-8 relative. JAX takes ~55 s to trace and compile the torque
solve's gradient even for the 2-link robot, so that one is held to central
differences of the port's own solve. An explicit "kernel" or "fused"
engine given such a robot runs the plain engine, decided before any kernel
wrapper is called (JAX's kernel engines run their plain path for a traced
robot); a constant robot keeps its kernel wrappers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu.trajopt import solvers as js
from differentiable_robot_model_tpu_torch.ops.kernels import fk as kfk
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ksolver
from differentiable_robot_model_tpu_torch.trajopt import solvers as ts

REL = 1e-8
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
LINK, AXIS = 2, 0  # arm2's x translation (1.0 in the URDF: no zero hint hides it)
B, H, ITERS = 2, 4, 4
EE = 3
KIN = dict(horizon=H, n_iters=ITERS, lr=0.05, goal_weight=100.0, eps=1e-3)
DYN = dict(horizon=H, n_iters=ITERS, lr=0.3, eps=1e-1, dt=0.02)


def _inputs():
    rng = np.random.default_rng(5)
    q0 = rng.uniform(-0.5, 0.5, (B, 2))
    goals = np.stack([rng.uniform(0.5, 1.0, B), rng.uniform(0.2, 0.6, B), np.full(B, 0.15)], -1)
    init = rng.normal(0.0, 1.0, (B, H, 2))
    return q0, goals, init


def _compiled(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=FAST)(*args)


@pytest.fixture(scope="module")
def jax_kinematic_grad():
    """d(sum of final costs)/d(delta) of JAX's kinematic batch solve,
    trans[LINK, AXIS] += delta."""
    s = jdrm.DifferentiableTwoLinkRobot(dtype=jnp.float64).struct
    q0, goals, _ = (jnp.asarray(x) for x in _inputs())

    def kin(delta):
        robot = dataclasses.replace(s, trans=s.trans.at[LINK, AXIS].add(delta))
        return jnp.sum(js.solve_kinematic_adam_batch(robot, q0, goals, EE, fk_impl="scalar", **KIN).cost)

    return float(_compiled(jax.grad(kin), jnp.asarray(0.0)))


def _grad_robot():
    s = drt.DifferentiableTwoLinkRobot(dtype=torch.float64, device="cpu").struct
    delta = torch.zeros((), dtype=torch.float64, requires_grad=True)
    bump = torch.zeros_like(s.trans)
    bump[LINK, AXIS] = 1.0
    return s.with_arrays(trans=s.trans + bump * delta), delta


def _port_solve(kind, robot, engine):
    q0, goals, init = (torch.tensor(x) for x in _inputs())
    if kind == "kinematic":
        return ts.solve_kinematic_adam_batch(robot, q0, goals, EE, fk_impl=engine, **KIN)
    return ts.solve_dynamic_adam_batch(robot, q0, torch.zeros_like(q0), goals, EE, init_actions=init,
                                       rollout_impl=engine, **DYN)


PLAIN = {"kinematic": "scalar", "dynamic": "scan"}


def _port_grad(kind, engine):
    robot, delta = _grad_robot()
    res = _port_solve(kind, robot, engine)
    assert res.cost.requires_grad and res.actions.requires_grad
    (g,) = torch.autograd.grad(res.cost.sum(), delta)
    return res, float(g)


def test_kinematic_batch_solve_gradient_matches_jax(jax_kinematic_grad):
    _, g = _port_grad("kinematic", "scalar")
    assert abs(jax_kinematic_grad) > 1e-6
    assert abs(g - jax_kinematic_grad) <= REL * abs(jax_kinematic_grad), (g, jax_kinematic_grad)


def test_dynamic_batch_solve_gradient_matches_differences():
    _, g = _port_grad("dynamic", "scan")
    s = drt.DifferentiableTwoLinkRobot(dtype=torch.float64, device="cpu").struct

    def cost(delta):
        trans = s.trans.clone()
        trans[LINK, AXIS] += delta
        return float(_port_solve("dynamic", s.with_arrays(trans=trans), "scan").cost.sum())

    h = 1e-6
    fd = (cost(h) - cost(-h)) / (2 * h)
    assert abs(fd) > 1e-6
    np.testing.assert_allclose(g, fd, rtol=1e-6)


def _spy(monkeypatch, calls):
    """Record every call of the kernel wrappers the solvers' kernel engines
    reach (on the CPU they run their plain versions)."""
    for mod, name in ((ksolver, "kinematic_adam_solve"), (ksolver, "dynamic_adam_solve"),
                      (ksolver, "dyn_prologue"), (ts, "kinematic_adam_solve"),
                      (ts, "dynamic_adam_solve"), (ts, "dyn_prologue")):
        fn = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _f=fn, _n=name, **k: calls.append(_n) or _f(*a, **k))
    for cls in (kfk.FkPositionDofMajor, kr.DynamicRolloutEE):
        fn = cls.apply
        monkeypatch.setattr(cls, "apply", lambda *a, _f=fn, _n=cls.__name__: calls.append(_n) or _f(*a))


@pytest.mark.parametrize("kind", ["kinematic", "dynamic"])
@pytest.mark.parametrize("engine", ["kernel", "fused"])
def test_kernel_engines_take_the_plain_path_for_a_grad_robot(kind, engine, monkeypatch):
    counters = (kfk.fk_fwd, kfk.fk_bwd, ksolver.kinematic_adam_solve, ksolver.dynamic_adam_solve,
                ksolver.dyn_prologue, kr.dyn_rollout_ee_fwd, kr.dyn_rollout_ee_bwd)
    before = [c.launches for c in counters]
    calls = []
    _spy(monkeypatch, calls)
    res, g = _port_grad(kind, engine)
    assert calls == []
    assert [c.launches for c in counters] == before
    plain, g_plain = _port_grad(kind, PLAIN[kind])
    np.testing.assert_array_equal(res.actions.detach().numpy(), plain.actions.detach().numpy())
    assert g == g_plain
    # a constant robot keeps the kernel wrappers (on the CPU their plain versions)
    _port_solve(kind, drt.DifferentiableTwoLinkRobot(dtype=torch.float64, device="cpu").struct, engine)
    assert calls


def test_kernel_wrappers_take_the_plain_version_for_a_grad_robot(monkeypatch):
    calls = []
    _spy(monkeypatch, calls)
    robot, delta = _grad_robot()
    rng = np.random.default_rng(2)
    qM = torch.tensor(rng.uniform(-1, 1, (2, 6)))
    p = kfk.fk_position_dof_major(robot, qM, EE)
    q0T, qd0T = (torch.tensor(rng.uniform(-0.3, 0.3, (2, 3))) for _ in range(2))
    tauT = torch.tensor(rng.normal(0, 1, (4, 2, 3)))
    qs, qds, ps = kr.dynamic_rollout_ee(robot, q0T, qd0T, tauT, 0.02, EE)
    qs2, qds2 = kr.dynamic_rollout(robot, q0T, qd0T, tauT, 0.02)
    assert calls == []
    g = torch.autograd.grad(p.sum() + ps.sum() + qs2.sum(), delta)[0]
    assert float(g) != 0.0
    const = drt.DifferentiableTwoLinkRobot(dtype=torch.float64, device="cpu").struct
    np.testing.assert_allclose(p.detach().numpy(), kfk.fk_position_dof_major(const, qM, EE).numpy(),
                               rtol=0, atol=1e-12)
    ref = kr.dyn_rollout_ee_fwd_reference(const, q0T, qd0T, tauT, 0.02, EE)
    for a, b in zip((qs, qds, ps), ref):
        np.testing.assert_allclose(a.detach().numpy(), b.numpy(), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(qs2.detach().numpy(), qs.detach().numpy())
    assert calls == ["FkPositionDofMajor"]
