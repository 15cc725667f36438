"""Identify iiwa dynamics through the forward dynamics (qdd prediction).

Twin of the JAX package's examples/learn_forward_dynamics_iiwa.py: the setup
of learn_dynamics_iiwa with iiwa_link_5's mass and COM learnable, and the
loss on the accelerations that the (differentiable) mass-matrix solve
predicts from the torques.

    python -m differentiable_robot_model_tpu_torch.examples.learn_forward_dynamics_iiwa
"""

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableKUKAiiwa
from differentiable_robot_model_tpu_torch.examples.learn_dynamics_iiwa import nmse_loss
from differentiable_robot_model_tpu_torch.models.parametrizations import (
    PositiveScalar,
    UnconstrainedTensor,
)
from differentiable_robot_model_tpu_torch.utils.data import (
    generate_sine_motion_forward_dynamics_data,
    minibatches,
)


def run(
    n_epochs: int = 30,
    n_data: int = 2000,
    lr: float = 1e-2,
    batch_size: int = 250,
    seed: int = 0,
    device=None,
):
    gt_robot = DifferentiableKUKAiiwa(device=device)
    data = generate_sine_motion_forward_dynamics_data(gt_robot, n_data)

    learner = DifferentiableKUKAiiwa(device=device)
    rng = np.random.default_rng(seed)
    learner.make_link_param_learnable(
        "iiwa_link_5", "mass", PositiveScalar(init_param_std=1.0, rng=rng)
    )
    learner.make_link_param_learnable(
        "iiwa_link_5", "com", UnconstrainedTensor((3,), init_std=0.05, rng=rng)
    )
    opt = torch.optim.Adam(learner.parameters(), lr=lr, eps=1e-8)
    gen = torch.Generator().manual_seed(seed)
    losses = []
    for epoch in range(n_epochs):
        epoch_losses = []
        for batch in minibatches(data, batch_size, gen):
            opt.zero_grad()
            pred = learner.compute_forward_dynamics(
                batch["q"], batch["qd"], batch["tau"], use_damping=True
            )
            loss = nmse_loss(pred, batch["qdd"])
            loss.backward()
            opt.step()
            epoch_losses.append(loss.detach())
        losses.append(float(torch.stack(epoch_losses).mean()))
        if epoch % max(1, n_epochs // 10) == 0:
            print(f"epoch {epoch}: NMSE {losses[-1]:.6f}")
    return losses


if __name__ == "__main__":
    run()
