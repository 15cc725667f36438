"""High-level robot model API (the forward-kinematics part so far).

PyTorch counterpart of the JAX package's `models/robot.py`:
`DifferentiableRobotModel` is an `nn.Module` whose buffers are the
RobotStruct's tensors, so `.to()` moves the whole robot. Methods accept
unbatched [D] or batched [..., D] inputs.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops.kinematics import fk_world_scalar
from ..ops.lie import matrix_to_quaternion
from .structs import ARRAY_FIELDS, RobotStruct, resolve_device
from .urdf import robot_struct_from_urdf

robot_description_folder = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "robot_data")
)


class DifferentiableRobotModel(nn.Module):
    """A URDF robot on `device` (CUDA unless the caller passes another)."""

    def __init__(self, urdf_path: str, name: str = "", dtype=torch.float32, device=None):
        super().__init__()
        struct = robot_struct_from_urdf(
            urdf_path, name=name, dtype=dtype, device=resolve_device(device)
        )
        self.name = name
        self.urdf_path = urdf_path
        self._static = struct.static()
        for f in ARRAY_FIELDS:
            self.register_buffer(f, getattr(struct, f))

    @property
    def struct(self) -> RobotStruct:
        """The robot as a RobotStruct over this module's current buffers."""
        return RobotStruct(**{f: getattr(self, f) for f in ARRAY_FIELDS}, **self._static)

    @property
    def n_dofs(self) -> int:
        return len(self._static["dof_links"])

    def compute_forward_kinematics(
        self, q, link_name: str
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """World position and orientation (quaternion x, y, z, w) of one link
        for q [..., D]."""
        s = self.struct
        idx = s.link_index(link_name)
        q = torch.as_tensor(q, dtype=s.dtype, device=s.device)
        R, p = fk_world_scalar(s, q)
        return p[..., idx, :], matrix_to_quaternion(R[..., idx, :, :])

    def get_joint_limits(self) -> List[Dict[str, float]]:
        host = self.struct.numpy()
        return [
            {
                "lower": float(host["limit_lower"][d]),
                "upper": float(host["limit_upper"][d]),
                "effort": float(host["limit_effort"][d]),
                "velocity": float(host["limit_velocity"][d]),
            }
            for d in range(self.n_dofs)
        ]

    def get_link_names(self) -> List[str]:
        return list(self._static["link_names"])


def _bundled(rel_path: str) -> str:
    return os.path.join(robot_description_folder, rel_path)


class DifferentiableKUKAiiwa(DifferentiableRobotModel):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("kuka_iiwa_iiwa7.urdf"), "differentiable_kuka_iiwa", dtype, device)


class DifferentiableFrankaPanda(DifferentiableRobotModel):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("panda_no_gripper.urdf"), "differentiable_franka_panda", dtype, device)


class DifferentiableTwoLinkRobot(DifferentiableRobotModel):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("2link_robot.urdf"), "diff_2d_robot", dtype, device)


class DifferentiableTrifingerEdu(DifferentiableRobotModel):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("trifinger_edu.urdf"), "trifinger_edu", dtype, device)


class DifferentiableAllegroHand(DifferentiableRobotModel):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("allegro_hand_left.urdf"), "differentiable_allegro_hand", dtype, device)


class DifferentiableFetchArm(DifferentiableRobotModel):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("fetch_arm_no_gripper.urdf"), "differentiable_fetch_arm", dtype, device)


class DifferentiableKinovaJaco(DifferentiableRobotModel):
    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("kinova_jaco.urdf"), "differentiable_kinova_jaco", dtype, device)


class DifferentiablePandaWithGripper(DifferentiableRobotModel):
    """Franka Panda with the two-finger gripper (9 dof: 7 revolute + 2 prismatic
    fingers)."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("panda_with_gripper.urdf"), "differentiable_panda_with_gripper", dtype, device)


class DifferentiableFetchFull(DifferentiableRobotModel):
    """Full Fetch mobile manipulator (14 dof over 3 branches: prismatic torso
    lift, head pan/tilt, 7-dof arm, prismatic gripper fingers)."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("fetch_full.urdf"), "differentiable_fetch_full", dtype, device)


class DifferentiableKukaIiwaAllegro(DifferentiableRobotModel):
    """KUKA iiwa7 arm with the Allegro hand mounted (23 dof: 7 arm + 16
    fingers over 4 branches)."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("kuka_iiwa7_allegro.urdf"), "differentiable_kuka_iiwa_allegro", dtype, device)


class DifferentiableKinovaJacoFull(DifferentiableRobotModel):
    """Full j2n6s300: 6-dof arm plus the 3-finger hand (12 dof, branched)."""

    def __init__(self, dtype=torch.float32, device=None):
        super().__init__(_bundled("kinova_jaco_full.urdf"), "differentiable_kinova_jaco_full", dtype, device)
