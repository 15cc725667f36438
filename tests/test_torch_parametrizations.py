"""The port's parametrizations against the JAX package's.

Each of the seven classes, from a random draw and from a given value (the
SVD, Cholesky and log-map constructors): the same numpy generator gives the
same initial unconstrained values, bit for bit, and the module's
`nn.Parameter`s hold them; at values moved off the initial ones, `apply`
and its gradient (of a random weighting of the constrained value) agree
with JAX's in float64 to 1e-12 relative to the largest entry, and
`forward()` is `apply` of the module's own parameters.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from differentiable_robot_model_tpu.models import parametrizations as jp
from differentiable_robot_model_tpu_torch.models import parametrizations as tp

FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
SAMPLE_INERTIA = np.array([[0.05, 0.001, 0.002], [0.001, 0.06, 0.003], [0.002, 0.003, 0.03]])

# class: (keywords for a random draw, keywords from a value)
CASES = {
    "UnconstrainedScalar": ({}, {"init_val": 1.25}),
    "PositiveScalar": ({"min_val": 0.1, "init_param_std": 0.7}, {"min_val": 0.1, "init_param": 2.5}),
    "UnconstrainedTensor": ({"shape": (3, 3), "init_std": 0.2},
                            {"shape": (3, 3), "init_tensor": SAMPLE_INERTIA}),
    "Symm3DInertiaMatrix": ({"init_param_std": 0.1}, {"init_param": SAMPLE_INERTIA}),
    "SymmPosDef3DInertiaMatrix": ({"init_param_std": 0.1}, {"init_param": SAMPLE_INERTIA}),
    "TriangParam3DInertiaMatrix": ({"bias": 1e-3, "init_param_std": 0.1},
                                   {"bias": 1e-4, "init_param": SAMPLE_INERTIA}),
    "CovParameterized3DInertiaMatrix": ({"init_param_std": 0.1}, {"init_param": SAMPLE_INERTIA}),
}


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= tol * max(np.abs(b).max(), 1e-300), (a, b)


@pytest.mark.parametrize("mode", ["random", "value"])
@pytest.mark.parametrize("cls", sorted(CASES))
def test_matches_jax(cls, mode):
    kw = CASES[cls][mode == "value"]
    jpz = getattr(jp, cls)(rng=np.random.default_rng(5), **kw)
    tpz = getattr(tp, cls)(rng=np.random.default_rng(5), **kw)

    init_j, init_t = jpz.init_value(), tpz.init_value()
    for a, b in zip(_leaves(init_j), _leaves(init_t)):
        np.testing.assert_array_equal(np.asarray(a), b)
    own = tpz.unconstrained()
    own = own if isinstance(own, dict) else {"": own}
    assert all(isinstance(p, torch.nn.Parameter) and p.dtype == torch.float64 for p in own.values())
    assert sorted(n for n, _ in tpz.named_parameters())  # registered on the module
    for a, b in zip(_leaves(init_j), _leaves({k: v.detach().numpy() for k, v in own.items()})):
        np.testing.assert_array_equal(np.asarray(a), b)

    rng = np.random.default_rng(9)
    raw = jax.tree_util.tree_map(
        lambda v: np.asarray(v, np.float64) + rng.uniform(-0.1, 0.1, np.shape(v)), init_j)
    raw_t = jax.tree_util.tree_map(lambda v: torch.tensor(v, requires_grad=True), raw)
    value_t = tpz.apply(raw_t)
    W = rng.uniform(-1.0, 1.0, tuple(value_t.shape))
    g_t = torch.autograd.grad((torch.tensor(W) * value_t).sum(), _leaves(raw_t))

    def value_and_grad(r):
        return jpz.apply(r), jax.grad(lambda rr: jnp.sum(W * jpz.apply(rr)))(r)

    args = [jax.tree_util.tree_map(jnp.asarray, x) for x in (raw, init_j)]
    f = jax.jit(value_and_grad).lower(args[0]).compile(compiler_options=FAST)
    (value_j, g_j), (value0_j, _) = f(args[0]), f(args[1])
    _close(value_t.detach().numpy(), value_j)
    for a, b in zip(g_t, _leaves(g_j)):
        _close(a.numpy(), b)

    _close(tpz().detach().numpy(), tpz.apply(tpz.unconstrained()).detach().numpy(), 0.0)
    _close(tpz().detach().numpy(), value0_j)


def test_move_to_float32():
    p = tp.TriangParam3DInertiaMatrix(bias=1e-4, init_param=SAMPLE_INERTIA).to(torch.float32)
    assert p().dtype == torch.float32
    np.testing.assert_allclose(p().detach().numpy(), SAMPLE_INERTIA, atol=1e-6)
