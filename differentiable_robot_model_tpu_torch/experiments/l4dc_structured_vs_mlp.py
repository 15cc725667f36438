"""The L4DC experiment: structured robot models against an MLP.

Twin of the JAX package's experiments/l4dc_structured_vs_mlp.py: learning
iiwa's inverse dynamics with (a) an unstructured MLP, (b) a structured model
whose links' mass and inertia are learnable without physical constraints,
and (c) the same with physically consistent parametrizations
(PositiveScalar mass, CovParameterized3DInertiaMatrix inertia). Returns
each model's test NMSE per epoch.

    python -m differentiable_robot_model_tpu_torch.experiments.l4dc_structured_vs_mlp
"""

import math

import numpy as np
import torch
from torch import nn

from differentiable_robot_model_tpu_torch import DifferentiableKUKAiiwa
from differentiable_robot_model_tpu_torch.models.parametrizations import (
    CovParameterized3DInertiaMatrix,
    PositiveScalar,
    Symm3DInertiaMatrix,
    UnconstrainedTensor,
)
from differentiable_robot_model_tpu_torch.utils.data import (
    generate_sine_motion_inverse_dynamics_data,
    minibatches,
)


def nmse(pred, target):
    var = torch.var(target, dim=0, unbiased=False) + 1e-12
    return torch.mean(torch.mean((pred - target) ** 2, dim=0) / var)


def train_mlp(train, test, n_epochs, lr=1e-3, width=256, seed=0):
    """Unstructured baseline: an MLP (q, qd, qdd) -> tau, He-normal weights."""
    D = train["q"].shape[-1]
    g = torch.Generator().manual_seed(seed)
    dims = [3 * D, width, width, D]
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        lin = nn.Linear(a, b, dtype=train["q"].dtype)
        with torch.no_grad():
            lin.weight.copy_(torch.randn((b, a), generator=g, dtype=lin.weight.dtype)
                             * math.sqrt(2.0 / a))
            lin.bias.zero_()
        layers += [lin, nn.ReLU()]
    mlp = nn.Sequential(*layers[:-1]).to(train["q"].device)

    def forward(batch):
        return mlp(torch.cat([batch["q"], batch["qd"], batch["qdd"]], dim=-1))

    opt = torch.optim.Adam(mlp.parameters(), lr=lr, eps=1e-8)
    curve = []
    gen = torch.Generator().manual_seed(seed + 1)
    for _ in range(n_epochs):
        for batch in minibatches(train, 250, gen):
            opt.zero_grad()
            nmse(forward(batch), batch["tau"]).backward()
            opt.step()
        with torch.no_grad():
            curve.append(float(nmse(forward(test), test["tau"])))
    return curve


def train_structured(train, test, n_epochs, constrained: bool, lr=1e-2, seed=0, device=None,
                     id_impl="auto"):
    """Structured model: the mass and inertia of every moving link learnable,
    with (L4DC's physically consistent) or without constraints."""
    learner = DifferentiableKUKAiiwa(device=device)
    rng = np.random.default_rng(seed)
    for link in [f"iiwa_link_{i}" for i in range(1, 8)]:
        if constrained:
            learner.make_link_param_learnable(
                link, "mass", PositiveScalar(init_param_std=0.5, rng=rng))
            learner.make_link_param_learnable(
                link, "inertia_mat", CovParameterized3DInertiaMatrix(init_param_std=0.05, rng=rng))
        else:
            learner.make_link_param_learnable(
                link, "mass", UnconstrainedTensor((), init_std=0.5, rng=rng))
            learner.make_link_param_learnable(
                link, "inertia_mat", Symm3DInertiaMatrix(init_param_std=0.05, rng=rng))

    def loss(batch):
        pred = learner.compute_inverse_dynamics(batch["q"], batch["qd"], batch["qdd"],
                                                id_impl=id_impl)
        return nmse(pred, batch["tau"])

    opt = torch.optim.Adam(learner.parameters(), lr=lr, eps=1e-8)
    curve = []
    gen = torch.Generator().manual_seed(seed + 1)
    for _ in range(n_epochs):
        for batch in minibatches(train, 250, gen):
            opt.zero_grad()
            loss(batch).backward()
            opt.step()
        with torch.no_grad():
            curve.append(float(loss(test)))
    return curve


def run(n_epochs: int = 60, n_train: int = 2000, n_test: int = 500, device=None):
    gt = DifferentiableKUKAiiwa(device=device)
    train = generate_sine_motion_inverse_dynamics_data(gt, n_train)
    test_data = generate_sine_motion_inverse_dynamics_data(gt, n_test, dt=1.0 / 210.0)

    curves = {
        "mlp": train_mlp(train, test_data, n_epochs),
        "structured_unconstrained": train_structured(train, test_data, n_epochs, False,
                                                     device=device),
        "structured_constrained": train_structured(train, test_data, n_epochs, True,
                                                   device=device),
    }
    print(f"{'epoch':>6} " + " ".join(f"{k:>26}" for k in curves))
    for e in range(n_epochs):
        print(f"{e:>6} " + " ".join(f"{curves[k][e]:>26.6f}" for k in curves))
    return curves


if __name__ == "__main__":
    run()
