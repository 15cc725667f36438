"""A minimal built-in simulator for executing trajectories.

Twin of the JAX package's examples/simple_sim_wrapper.py (itself standing
in for the reference's pybullet wrapper): it integrates the port's own
forward dynamics (semi-implicit Euler) under a stiff PD position
controller, with the same interface (reset_joint_state / step /
get_link_state).
"""

from __future__ import annotations

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableRobotModel


class SimpleSimWrapperPositionControl:
    """Position-controlled stepping of a robot by PD torque control, on
    `device` (CUDA unless the caller passes another)."""

    def __init__(
        self,
        urdf_path: str,
        controlled_joints=None,
        dt: float = 1.0 / 240.0,
        kp: float = 200.0,
        kd: float = 20.0,
        substeps: int = 8,
        device=None,
    ):
        self.model = DifferentiableRobotModel(urdf_path, device=device)
        self.dt = dt
        self.kp = kp
        self.kd = kd
        self.substeps = substeps
        self.q = np.zeros(self.model.n_dofs, np.float32)
        self.qd = np.zeros(self.model.n_dofs, np.float32)

    def reset_joint_state(self, q, qd=None):
        self.q = np.asarray(q, np.float32)
        self.qd = np.asarray(qd, np.float32) if qd is not None else np.zeros_like(self.q)

    def step(self, des_joint_state):
        """PD-track the desired joint position for one control period."""
        des = np.asarray(des_joint_state, np.float32)
        h = self.dt / self.substeps
        for _ in range(self.substeps):
            tau = self.kp * (des - self.q) - self.kd * self.qd
            with torch.no_grad():
                qdd = self.model.compute_forward_dynamics(self.q, self.qd, tau, use_damping=True)
            self.qd = self.qd + h * qdd.cpu().numpy()
            self.q = self.q + h * self.qd
        return self.q.copy()

    def get_link_state(self, link_name: str):
        with torch.no_grad():
            pos, quat = self.model.compute_forward_kinematics(self.q, link_name)
        return pos.cpu().numpy(), quat.cpu().numpy()
