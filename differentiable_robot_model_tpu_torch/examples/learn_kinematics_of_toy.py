"""Learn the kinematic parameters of the 2-link toy robot from FK data.

Twin of the JAX package's examples/learn_kinematics_of_toy.py: both arm
joints' translations and rpy angles learnable from random initial values,
with the freeze / unfreeze round trip, full-batch Adam on the mean squared
end-effector error.

    python -m differentiable_robot_model_tpu_torch.examples.learn_kinematics_of_toy
"""

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableTwoLinkRobot
from differentiable_robot_model_tpu_torch.models.parametrizations import UnconstrainedTensor
from differentiable_robot_model_tpu_torch.utils.data import (
    generate_random_forward_kinematics_data,
)

EE_NAME = "endEffector"


def run(n_epochs: int = 300, n_data: int = 1000, lr: float = 1e-2, seed: int = 0, device=None):
    gt_robot = DifferentiableTwoLinkRobot(device=device)
    data = generate_random_forward_kinematics_data(gt_robot, n_data, EE_NAME, seed=seed)

    learner = DifferentiableTwoLinkRobot(device=device)
    rng = np.random.default_rng(seed)
    for link in ("arm2", "endEffector"):
        learner.make_link_param_learnable(
            link, "trans", UnconstrainedTensor((3,), init_std=0.1, rng=rng)
        )
        learner.make_link_param_learnable(
            link, "rot_angles", UnconstrainedTensor((3,), init_std=0.1, rng=rng)
        )

    learner.freeze_learnable_link_param("arm2", "rot_angles")
    assert "arm2.rot_angles" not in learner.learnable_parameters()
    learner.unfreeze_learnable_link_param("arm2", "rot_angles")

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
