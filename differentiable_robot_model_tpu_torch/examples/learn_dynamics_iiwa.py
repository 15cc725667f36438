"""Identify iiwa link dynamics (mass, inertia, joint-origin translation) from
inverse-dynamics data.

Twin of the JAX package's examples/learn_dynamics_iiwa.py: sine trajectories
from a ground-truth model, constrained learnable parameters on iiwa_link_3
(a PositiveScalar mass, an unconstrained 3x3 inertia and translation), the
normalized MSE on the torques, minibatched Adam (torch.optim.Adam with
optax's defaults). `id_impl="kernel"` trains through K4's learnable form
on a CUDA model.

    python -m differentiable_robot_model_tpu_torch.examples.learn_dynamics_iiwa
"""

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableKUKAiiwa
from differentiable_robot_model_tpu_torch.models.parametrizations import (
    PositiveScalar,
    UnconstrainedTensor,
)
from differentiable_robot_model_tpu_torch.utils.data import (
    generate_sine_motion_inverse_dynamics_data,
    minibatches,
)


def nmse_loss(pred, target):
    """Normalized MSE per output dim."""
    var = torch.var(target, dim=0, unbiased=False) + 1e-12
    return torch.mean(torch.mean((pred - target) ** 2, dim=0) / var)


def make_learner(seed: int = 0, device=None):
    """iiwa with iiwa_link_3's mass, inertia and translation learnable."""
    learner = DifferentiableKUKAiiwa(device=device)
    rng = np.random.default_rng(seed)
    learner.make_link_param_learnable(
        "iiwa_link_3", "mass", PositiveScalar(init_param_std=1.0, rng=rng)
    )
    learner.make_link_param_learnable(
        "iiwa_link_3", "inertia_mat", UnconstrainedTensor((3, 3), init_std=0.1, rng=rng)
    )
    learner.make_link_param_learnable(
        "iiwa_link_3", "trans", UnconstrainedTensor((3,), init_std=0.1, rng=rng)
    )
    return learner


def run(
    n_epochs: int = 30,
    n_data: int = 2000,
    lr: float = 1e-2,
    batch_size: int = 250,
    seed: int = 0,
    device=None,
    id_impl: str = "auto",
):
    gt_robot = DifferentiableKUKAiiwa(device=device)
    data = generate_sine_motion_inverse_dynamics_data(gt_robot, n_data)
    learner = make_learner(seed, device)
    opt = torch.optim.Adam(learner.parameters(), lr=lr, eps=1e-8)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for epoch in range(n_epochs):
        epoch_losses = []
        for batch in minibatches(data, batch_size, gen):
            opt.zero_grad()
            pred = learner.compute_inverse_dynamics(
                batch["q"], batch["qd"], batch["qdd"], id_impl=id_impl
            )
            loss = nmse_loss(pred, batch["tau"])
            loss.backward()
            opt.step()
            epoch_losses.append(loss.detach())
        losses.append(float(torch.stack(epoch_losses).mean()))
        if epoch % max(1, n_epochs // 10) == 0:
            print(f"epoch {epoch}: NMSE {losses[-1]:.6f}")
    return losses


if __name__ == "__main__":
    run()
