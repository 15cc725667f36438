"""Identification through the port's model API against the JAX package's.

The 2-link robot (the cheapest robot to compile in JAX) gets every learnable
field on both arm links, from the same numpy generator in both packages:
trans and rot_angles (UnconstrainedTensor; arm1's URDF rpy and arm2's are
zero), mass and joint_damping (PositiveScalar), com (UnconstrainedTensor)
and inertia_mat (TriangParam3DInertiaMatrix on arm1,
CovParameterized3DInertiaMatrix on arm2). With the same `params=` every
compute_* output, and the gradient of the torques' normalized MSE w.r.t.
every unconstrained value, must agree in float64 to 1e-9 relative to the
largest entry: the port's inverse dynamics on "scalar" and on "kernel" (K4's
learnable form, whose plain versions run on the CPU), JAX's on "scalar" and
on "pallas" (its traced-robot Pallas kernel in interpret mode, as
tests/test_pallas.py runs it). Also: the gradient of a kinematic and a
torque-space solve's final cost w.r.t. a link parameter through the whole
Adam loop, the datasets, a checkpoint carried JAX -> port -> JAX, and the
example twins (their losses fall, as tests/test_examples.py asserts).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import differentiable_robot_model_tpu as jdrm
import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu.models import parametrizations as jp
from differentiable_robot_model_tpu.utils import checkpoint as jck
from differentiable_robot_model_tpu.utils import data as jdata
from differentiable_robot_model_tpu_torch.models import parametrizations as tp
from differentiable_robot_model_tpu_torch.utils import checkpoint as tck
from differentiable_robot_model_tpu_torch.utils import data as tdata

TOL = 1e-9
B = 5
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _register(model, P):
    """Every learnable field on arm1 and arm2, drawn from one generator."""
    rng = np.random.default_rng(7)
    for link, inertia in (("arm1", P.TriangParam3DInertiaMatrix), ("arm2", P.CovParameterized3DInertiaMatrix)):
        model.make_link_param_learnable(link, "trans", P.UnconstrainedTensor((3,), init_std=0.1, rng=rng))
        model.make_link_param_learnable(link, "rot_angles", P.UnconstrainedTensor((3,), init_std=0.2, rng=rng))
        model.make_link_param_learnable(link, "mass", P.PositiveScalar(init_param_std=1.0, rng=rng))
        model.make_link_param_learnable(link, "com", P.UnconstrainedTensor((3,), init_std=0.05, rng=rng))
        kw = {"bias": 1e-3} if inertia is P.TriangParam3DInertiaMatrix else {}
        model.make_link_param_learnable(link, "inertia_mat", inertia(init_param_std=0.2, rng=rng, **kw))
        model.make_link_param_learnable(link, "joint_damping", P.PositiveScalar(init_param_std=0.5, rng=rng))


@functools.lru_cache(maxsize=None)
def _models():
    jm = jdrm.DifferentiableTwoLinkRobot(dtype=jnp.float64)
    tm = drt.DifferentiableTwoLinkRobot(dtype=torch.float64, device="cpu")
    _register(jm, jp)
    _register(tm, tp)
    return jm, tm


def _params_np():
    """The stored values, moved off them so that no default hides a bug."""
    jm, _ = _models()
    rng = np.random.default_rng(3)
    return jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float64) + rng.uniform(-0.05, 0.05, np.shape(v)), jm.parameters())


def _jparams():
    return jax.tree_util.tree_map(jnp.asarray, _params_np())


def _tparams(requires_grad=False):
    return jax.tree_util.tree_map(
        lambda v: torch.tensor(v, dtype=torch.float64, requires_grad=requires_grad), _params_np())


def _inputs(D=2):
    rng = np.random.default_rng(11)
    return tuple(rng.uniform(-1.0, 1.0, (B, D)) for _ in range(4))  # q, qd, qdd/f, tau target


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    scale = max(np.abs(b).max(), 1e-30)
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


def test_initial_values_match_jax():
    jm, tm = _models()
    jv, tv = jm.parameters(), tm.learnable_parameters()
    assert list(jv) == list(tv)
    for k in jv:
        for a, b in zip(jax.tree_util.tree_leaves(jv[k]), jax.tree_util.tree_leaves(
                {j: x.detach().numpy() for j, x in tv[k].items()} if isinstance(tv[k], dict)
                else tv[k].detach().numpy())):
            np.testing.assert_array_equal(np.asarray(a), b)


QUANTITIES = ("fk", "jacobian", "kinematic_state", "id_scalar", "id_kernel", "nle", "mass",
              "fd_crb", "fd_aba")


def _call(m, quantity, params, q, qd, x, **engine):
    if quantity == "fk":
        return m.compute_forward_kinematics(q, "endEffector", params=params)
    if quantity == "jacobian":
        return m.compute_endeffector_jacobian(q, "endEffector", params=params)
    if quantity == "kinematic_state":
        return tuple(m.update_kinematic_state(q, qd, params=params))
    if quantity.startswith("id_"):
        return m.compute_inverse_dynamics(q, qd, x, params=params, **engine)
    if quantity == "nle":
        return m.compute_non_linear_effects(q, qd, params=params)
    if quantity == "mass":
        return m.compute_lagrangian_inertia_matrix(q, params=params)
    if quantity == "fd_crb":
        return m.compute_forward_dynamics(q, qd, x, use_damping=True, params=params)
    if quantity == "fd_aba":
        return m.compute_forward_dynamics(q, qd, x, method="aba", params=params)
    raise KeyError(quantity)


def _flat(x):
    return [x] if not isinstance(x, (tuple, list)) else [y for e in x for y in _flat(e)]


def _jax_nmse(jm, p, id_impl):
    q, qd, qdd, tau = _inputs()
    pred = jm.compute_inverse_dynamics(q, qd, qdd, params=p, id_impl=id_impl)
    var = jnp.var(tau, axis=0) + 1e-12
    return jnp.mean(jnp.mean((pred - tau) ** 2, axis=0) / var)


def _compiled(f, *args):
    return jax.jit(f).lower(*args).compile(compiler_options=FAST)(*args)


@functools.lru_cache(maxsize=None)
def _jax_results():
    """Every quantity with params= and the scalar path's NMSE gradient,
    from one compiled JAX function; the gradient through JAX's traced-robot
    Pallas kernel in interpret mode from another."""
    jm, _ = _models()
    q, qd, x, _ = _inputs()

    def f(p):
        out = {k: _flat(_call(jm, k, p, q, qd, x)) for k in QUANTITIES if k != "id_kernel"}
        out["grad_scalar"] = jax.grad(lambda pp: _jax_nmse(jm, pp, "scalar"))(p)
        return out

    out = _compiled(f, _jparams())
    with pltpu.force_tpu_interpret_mode():
        out["grad_pallas"] = _compiled(jax.grad(lambda p: _jax_nmse(jm, p, "pallas")), _jparams())
    return out


@pytest.mark.parametrize("quantity", QUANTITIES)
def test_params_outputs_match_jax(quantity):
    _, tm = _models()
    q, qd, x, _ = _inputs()
    engine = {"id_impl": "kernel"} if quantity == "id_kernel" else {}
    want = _jax_results()["id_scalar" if quantity == "id_kernel" else quantity]
    got = _flat(_call(tm, quantity, _tparams(), q, qd, x, **engine))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _close(g.detach().numpy(), w)


@pytest.mark.parametrize("jax_impl", ["scalar", "pallas"])
@pytest.mark.parametrize("id_impl", ["scalar", "kernel"])
def test_nmse_gradient_matches_jax(id_impl, jax_impl):
    _, tm = _models()
    q, qd, qdd, tau = (torch.tensor(x) for x in _inputs())
    p = _tparams(requires_grad=True)
    pred = tm.compute_inverse_dynamics(q, qd, qdd, params=p, id_impl=id_impl)
    var = torch.var(tau, dim=0, unbiased=False) + 1e-12
    loss = torch.mean(torch.mean((pred - tau) ** 2, dim=0) / var)
    leaves = jax.tree_util.tree_leaves(p)
    grads = torch.autograd.grad(loss, leaves)
    want = jax.tree_util.tree_leaves(_jax_results()[f"grad_{jax_impl}"])
    assert len(grads) == len(want) == 6 * 2 + 3  # TriangParam holds four leaves
    for g, w in zip(grads, want):
        _close(g.numpy(), w)


def test_module_parameters_train_through_the_kernel_path():
    """Without params=, the struct applies the model's own parameters, so
    autograd reaches `model.parameters()` through K4's learnable form (its
    plain versions here) as through the scalar path."""
    _, tm = _models()
    q, qd, qdd, _ = (torch.tensor(x) for x in _inputs())
    grads = {}
    for impl in ("scalar", "kernel"):
        tm.zero_grad()
        tm.compute_inverse_dynamics(q, qd, qdd, id_impl=impl).square().sum().backward()
        grads[impl] = [p.grad.clone() for p in tm.parameters()]
    assert len(grads["kernel"]) == 15
    for a, b in zip(grads["kernel"], grads["scalar"]):
        _close(a.numpy(), b.numpy())
    tm.zero_grad()


H_SOLVE, ITERS_SOLVE = 3, 3


def _solve_model(pkg, P, **kw):
    m = pkg.DifferentiableTwoLinkRobot(**kw)
    m.make_link_param_learnable("arm2", "trans", P.UnconstrainedTensor((3,), init_tensor=[1.0, 0.0, 0.0]))
    m.make_link_param_learnable("arm2", "mass", P.PositiveScalar(init_param=1.0))
    return m


Q0, GOAL = [0.3, -0.2], [0.8, 0.6, 0.15]


def test_gradient_through_the_kinematic_solve_matches_jax():
    """The gradient of `solve_kinematic_adam`'s final cost w.r.t. arm2's
    translation (and its mass, which the kinematics do not read) through
    the whole Adam loop."""
    from differentiable_robot_model_tpu.trajopt import solvers as js
    from differentiable_robot_model_tpu_torch.trajopt import solvers as ts

    jm = _solve_model(jdrm, jp, dtype=jnp.float64)

    def cost(p):
        s = jm._learnables.apply(p)
        return js.solve_kinematic_adam(s, jnp.asarray(Q0), jnp.asarray(GOAL), 3, horizon=H_SOLVE,
                                       n_iters=ITERS_SOLVE, lr=0.05, eps=1e-3).cost

    want = _compiled(jax.grad(cost), jm.parameters())
    tm = _solve_model(drt, tp, dtype=torch.float64, device="cpu")
    s = tm.struct
    assert s.requires_grad
    t = lambda x: torch.tensor(x, dtype=torch.float64)
    cost_t = ts.solve_kinematic_adam(s, t(Q0), t(GOAL), 3, horizon=H_SOLVE, n_iters=ITERS_SOLVE,
                                     lr=0.05, eps=1e-3).cost
    own = tm.learnable_parameters()
    g_trans, g_mass = torch.autograd.grad(cost_t, [own["arm2.trans"], own["arm2.mass"]],
                                          allow_unused=True)
    assert np.abs(g_trans.numpy()).max() > 0 and g_mass is None
    _close(g_trans.numpy(), want["arm2.trans"])
    assert float(want["arm2.mass"]) == 0.0


def test_gradient_through_the_torque_solve_matches_differences():
    """The gradient of `solve_dynamic_adam`'s final cost w.r.t. arm2's
    translation and mass through the whole Adam loop (the forward-dynamics
    rollout, the preconditioner, the FK cost) against central differences
    of the port's own solve in float64, as the JAX package's
    tests/test_learnable.py holds its own (JAX needs over a minute to compile
    this second-order graph even for the 2-link robot)."""
    from differentiable_robot_model_tpu_torch.trajopt import solvers as ts

    tm = _solve_model(drt, tp, dtype=torch.float64, device="cpu")
    t = lambda x: torch.tensor(x, dtype=torch.float64)

    def cost(params=None):
        return ts.solve_dynamic_adam(tm._resolved(params), t(Q0), torch.zeros(2, dtype=torch.float64),
                                     t(GOAL), 3, horizon=H_SOLVE, n_iters=ITERS_SOLVE, lr=0.3,
                                     eps=1e-1).cost

    own = tm.learnable_parameters()
    g = torch.autograd.grad(cost(), [own["arm2.trans"], own["arm2.mass"]])
    base = {k: v.detach().clone() for k, v in own.items()}
    h = 1e-6
    for key, grad in zip(("arm2.trans", "arm2.mass"), g):
        flat = grad.reshape(-1)
        assert np.abs(flat.numpy()).max() > 0
        for j in range(flat.numel()):
            step = torch.zeros_like(base[key]).reshape(-1)
            step[j] = h
            step = step.reshape(base[key].shape)
            with torch.no_grad():
                fd = (cost({**base, key: base[key] + step}) - cost({**base, key: base[key] - step})) / (2 * h)
            np.testing.assert_allclose(float(flat[j]), float(fd), rtol=1e-5, atol=1e-8)


def test_datasets_match_jax():
    jm = jdrm.DifferentiableTwoLinkRobot(dtype=jnp.float64)
    tm = drt.DifferentiableTwoLinkRobot(dtype=torch.float64, device="cpu")
    pairs = [
        (jdata.generate_random_forward_kinematics_data(jm, 9, "endEffector", seed=2),
         tdata.generate_random_forward_kinematics_data(tm, 9, "endEffector", seed=2)),
        (jdata.generate_random_inverse_dynamics_data(jm, 9, seed=2),
         tdata.generate_random_inverse_dynamics_data(tm, 9, seed=2)),
        (jdata.generate_sine_motion_inverse_dynamics_data(jm, 9),
         tdata.generate_sine_motion_inverse_dynamics_data(tm, 9)),
        (jdata.generate_sine_motion_forward_dynamics_data(jm, 9, dt=1.0 / 210.0),
         tdata.generate_sine_motion_forward_dynamics_data(tm, 9, dt=1.0 / 210.0)),
    ]
    for jd, td in pairs:
        assert list(jd) == list(td)
        for k in jd:
            _close(td[k].numpy(), jd[k])
    ds = tdata.ForwardDynamicsDataset(pairs[2][1])
    _close(ds.var().numpy(), jdata.ForwardDynamicsDataset(pairs[2][0]).var())
    assert len(ds) == 9 and len(ds[3]) == 4
    batches = list(tdata.minibatches(pairs[2][1], 4, torch.Generator().manual_seed(0)))
    assert len(batches) == 2 and batches[0]["q"].shape == (4, 2)


def test_checkpoint_carries_jax_parameters_to_the_port_and_back(tmp_path):
    jm, tm = _models()
    jparams = _jparams()
    jck.save_pytree(str(tmp_path / "jax.npz"), jparams)
    loaded = tck.load_pytree(str(tmp_path / "jax.npz"), tm.learnable_parameters())
    tm2 = drt.DifferentiableTwoLinkRobot(dtype=torch.float64, device="cpu")
    _register(tm2, tp)
    tm2.set_parameters(loaded)
    q, qd, qdd, _ = _inputs()
    want, = _jax_results()["id_scalar"]
    _close(tm2.compute_inverse_dynamics(q, qd, qdd).detach().numpy(), want)
    tck.save_pytree(str(tmp_path / "port.npz"), tm2.learnable_parameters())
    with np.load(tmp_path / "jax.npz") as a, np.load(tmp_path / "port.npz") as b:
        assert sorted(a) == sorted(b)
        assert "arm1.inertia_mat/ori" in a
    back = jck.load_pytree(str(tmp_path / "port.npz"), jparams)
    for x, y in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_examples_learn():
    from differentiable_robot_model_tpu_torch.examples import (
        learn_dynamics_iiwa,
        learn_forward_dynamics_iiwa,
        learn_kinematics_of_iiwa,
        learn_kinematics_of_toy,
    )
    from differentiable_robot_model_tpu_torch.experiments import l4dc_structured_vs_mlp

    for ex in (learn_kinematics_of_toy, learn_kinematics_of_iiwa):
        losses = ex.run(n_epochs=50, n_data=250, device="cpu")
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for ex in (learn_dynamics_iiwa, learn_forward_dynamics_iiwa):
        losses = ex.run(n_epochs=2, n_data=250, device="cpu")
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    losses = learn_dynamics_iiwa.run(n_epochs=2, n_data=250, device="cpu", id_impl="kernel")
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    out = l4dc_structured_vs_mlp.run(n_epochs=3, n_train=120, n_test=60, device="cpu")
    assert set(out) == {"mlp", "structured_unconstrained", "structured_constrained"}
    for v in out.values():
        assert np.isfinite(v).all()
