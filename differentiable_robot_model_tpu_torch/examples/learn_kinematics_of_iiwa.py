"""Learn one joint frame of the KUKA iiwa from end-effector FK data.

Twin of the JAX package's examples/learn_kinematics_of_iiwa.py: iiwa_link_4's
joint-origin translation learnable, full-batch Adam on the mean squared
end-effector error.

    python -m differentiable_robot_model_tpu_torch.examples.learn_kinematics_of_iiwa
"""

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableKUKAiiwa
from differentiable_robot_model_tpu_torch.models.parametrizations import UnconstrainedTensor
from differentiable_robot_model_tpu_torch.utils.data import (
    generate_random_forward_kinematics_data,
)

EE_NAME = "iiwa_link_ee"


def run(n_epochs: int = 300, n_data: int = 1000, lr: float = 1e-2, seed: int = 0, device=None):
    gt_robot = DifferentiableKUKAiiwa(device=device)
    data = generate_random_forward_kinematics_data(gt_robot, n_data, EE_NAME, seed=seed)

    learner = DifferentiableKUKAiiwa(device=device)
    rng = np.random.default_rng(seed)
    learner.make_link_param_learnable(
        "iiwa_link_4", "trans", UnconstrainedTensor((3,), init_std=0.1, rng=rng)
    )
    opt = torch.optim.Adam(learner.parameters(), lr=lr, eps=1e-8)
    losses = []
    for epoch in range(n_epochs):
        opt.zero_grad()
        pred, _ = learner.compute_forward_kinematics(data["q"], EE_NAME)
        loss = torch.mean((pred - data["ee_pos"]) ** 2)
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if epoch % max(1, n_epochs // 10) == 0:
            print(f"epoch {epoch}: loss {losses[-1]:.6f}")
    return losses


if __name__ == "__main__":
    run()
