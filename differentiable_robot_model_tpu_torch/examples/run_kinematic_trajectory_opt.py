"""Optimize a joint-delta action sequence to reach an end-effector goal.

Twin of the JAX package's examples/run_kinematic_trajectory_opt.py, the
reference library's own workload: Franka Panda, H=20 action deltas, the
dense goal cost, Adam lr=1e-3, 100 iterations (`solve_kinematic_adam` with
the reference's detach between steps), then open-loop playback through the
PD-controlled dynamics sim.

    python -m differentiable_robot_model_tpu_torch.examples.run_kinematic_trajectory_opt
"""

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableFrankaPanda
from differentiable_robot_model_tpu_torch.examples.simple_sim_wrapper import (
    SimpleSimWrapperPositionControl,
)
from differentiable_robot_model_tpu_torch.trajopt.solvers import solve_kinematic_adam

EE_NAME = "panda_virtual_ee_link"
TIME_HORIZON = 20
N_DOFS = 7


def run(n_iters: int = 100, lr: float = 1e-3, playback: bool = True, device=None):
    model = DifferentiableFrankaPanda(device=device)
    struct = model.struct
    ee_idx = struct.link_index(EE_NAME)

    start_joint_config = torch.tensor([0.0, 0.0, 0.0, -1.5, 0.0, 1.6, 0.0], device=struct.device)
    with torch.no_grad():
        goal_ee_pose, _ = model.compute_forward_kinematics(np.zeros(N_DOFS), EE_NAME)

    result = solve_kinematic_adam(
        struct, start_joint_config, goal_ee_pose, ee_idx, horizon=TIME_HORIZON, n_iters=n_iters,
        lr=lr, stop_gradient_between_steps=True,  # the reference's detach per step
    )
    for c in result.cost_history.cpu().numpy():
        print(f"cost: {c}")

    if playback:
        # open-loop execution of the optimized deltas through the PD sim
        sim = SimpleSimWrapperPositionControl(model.urdf_path, device=device)
        sim.reset_joint_state(start_joint_config.cpu().numpy())
        des = start_joint_config.cpu().numpy()
        actions = result.actions.cpu().numpy()
        for i in range(TIME_HORIZON):
            des = des + actions[i]
            sim.step(des)
        ee_pos, _ = sim.get_link_state(EE_NAME)
        print("__________________________________________________")
        print(f"final dist to goal: {ee_pos - goal_ee_pose.cpu().numpy()}")
        print("__________________________________________________")

    return result


if __name__ == "__main__":
    run()
