"""High-level robot model API.

PyTorch counterpart of the JAX package's `models/robot.py`:
`DifferentiableRobotModel` is an `nn.Module` whose buffers are the
RobotStruct's tensors, so `.to()` moves the whole robot. Every compute_*
method accepts unbatched [D] or batched [..., D] inputs (cast to the model's
dtype and moved to its device), runs on the flattened batch and restores
the batch shape.

Inverse dynamics (`compute_inverse_dynamics`, `compute_non_linear_effects`)
has two engines, `id_impl`: "kernel" runs the RNEA kernel K4
(ops/kernels/rnea.py; its gradient the kernel `rnea_bwd`) on a CUDA tensor
and its plain version on a CPU one, and with learnable parameters (or
`params=`) K4's learnable form, which reads the link constants from the card
and whose gradient kernel also gives the robot's (`rnea_learnable`);
"scalar" runs the scalar RNEA in torch ops, differentiable w.r.t. the robot
too; "auto" is "kernel" on CUDA, at any batch, for a robot without
learnable parameters or `params=`, and "scalar" otherwise, as the JAX
package routes it. The other methods run PyTorch ops on the model's device,
as the JAX package runs them in XLA: FK by the scalar topological sweep (or,
with `recursive=True`, by composing the local transforms), the Jacobian,
the CRB mass matrix, and forward dynamics by the CRB solve or the
articulated-body algorithm.

Learnable parameters: `make_link_param_learnable(link, name, parametrization)`
registers one of models/parametrizations.py's modules for trans,
rot_angles, mass, com, inertia_mat or joint_damping (models/learnable.py).
Its parameters are the model's own (`model.parameters()`, so
`torch.optim.Adam(model.parameters())` trains them), and every compute_*
call and `struct` apply them, differentiably. `learnable_parameters()` is
the JAX package's `parameters()`: {"link.param": unconstrained values} of
the unfrozen entries; `params=` on any compute_* call takes such a dict (of
tensors) in place of the stored values, and `set_parameters` copies values
(tensors or numpy, e.g. the JAX package's parameters) into them.
"""

from __future__ import annotations

import os
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.dynamics import aba, forward_dynamics_crb
from ..ops.dynamics_scalar import mass_matrix_scalar, rnea_scalar
from ..ops.kernels.rnea import rnea, rnea_learnable
from ..ops.kinematics import (
    body_velocities,
    fk_world,
    fk_world_scalar,
    link_jacobian,
    world_joint_subspaces,
)
from ..ops.lie import matrix_to_quaternion
from .learnable import LearnableSet
from .structs import ARRAY_FIELDS, RobotStruct, resolve_device
from .urdf import robot_struct_from_urdf

robot_description_folder = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "robot_data")
)

ID_IMPLS = ("auto", "scalar", "kernel")


def id_route(id_impl: str, learnable: bool, on_cuda: bool) -> str:
    """The inverse-dynamics engine a call takes: "kernel" (K4),
    "kernel_learnable" (K4's learnable form) or "scalar". An explicit
    "kernel" takes K4, or its learnable form for a model with learnable
    parameters or a call with `params=` (`learnable`); "auto" takes
    "scalar" whenever `learnable`, as the JAX package does, and K4 on CUDA
    at any batch otherwise."""
    if id_impl not in ID_IMPLS:
        raise ValueError(f"id_impl must be 'auto', 'scalar', or 'kernel'; got {id_impl!r}")
    if id_impl == "kernel" or (id_impl == "auto" and on_cuda and not learnable):
        return "kernel_learnable" if learnable else "kernel"
    return "scalar"


class KinematicState(NamedTuple):
    """World-frame kinematic state of all links (stacked over links)."""

    rot: torch.Tensor  # [..., L, 3, 3] link world rotations
    pos: torch.Tensor  # [..., L, 3] link world positions
    subspace: torch.Tensor  # [..., L, 6] world joint motion subspaces
    vel: torch.Tensor  # [..., L, 6] world-origin spatial velocities


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
        self._learnables = LearnableSet(self._static)

    def _base_struct(self) -> RobotStruct:
        """The robot as a RobotStruct over this module's current buffers: the
        same struct while the buffers stay the same tensors (`.to()` replaces
        them), so what the kernels derive from it on the host, read from the
        device once, is kept between calls until a buffer is written in place
        (`RobotStruct.memo`)."""
        arrays = {f: getattr(self, f) for f in ARRAY_FIELDS}
        cached = self.__dict__.get("_struct_cache")
        if cached is None or any(cached.arrays()[f] is not a for f, a in arrays.items()):
            cached = self.__dict__["_struct_cache"] = RobotStruct(**arrays, **self._static)
        return cached

    @property
    def struct(self) -> RobotStruct:
        """The robot as a RobotStruct, with the learnable parameters' current
        values written in (differentiably: autograd reaches the
        parametrizations' parameters). Without learnable parameters, the
        cached struct of `_base_struct`."""
        return self._learnables.apply(self._base_struct())

    def _resolved(self, params: Optional[dict]) -> RobotStruct:
        """The struct with the learnable entries applied from `params` where
        it names them, else from their stored values."""
        return self._learnables.apply(self._base_struct(), params)

    @property
    def n_dofs(self) -> int:
        return len(self._static["dof_links"])

    # -- input normalization --------------------------------------------
    def _norm(self, *arrays):
        """Each input as a tensor of the model's dtype on its device,
        flattened to [N, D]; the batch shapes must agree."""
        dtype, device = self.trans.dtype, self.trans.device
        arrs = [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]
        batch_shape = arrs[0].shape[:-1]
        for a in arrs:
            assert a.shape[:-1] == batch_shape, "Batch size mismatch between inputs."
        return [a.reshape(-1, a.shape[-1]) for a in arrs], batch_shape

    @staticmethod
    def _denorm(x, batch_shape):
        return x.reshape(batch_shape + x.shape[1:])

    # -- kinematics --------------------------------------------------------
    def update_kinematic_state(self, q, qd, params=None) -> KinematicState:
        """World poses, joint subspaces and spatial velocities of all links,
        returned rather than stored."""
        (q2, qd2), bs = self._norm(q, qd)
        s = self._resolved(params)
        R, p = fk_world_scalar(s, q2)
        S = world_joint_subspaces(s, R, p)
        V = body_velocities(s, S, qd2)
        return KinematicState(*(self._denorm(x, bs) for x in (R, p, S, V)))

    def compute_forward_kinematics(
        self, q, link_name: str, recursive: bool = False, params=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """World position and orientation (quaternion x, y, z, w) of one link.
        `recursive=True` composes the local transforms by pointer doubling
        instead of the scalar sweep; both give the same poses."""
        (q2,), bs = self._norm(q)
        s = self._resolved(params)
        idx = s.link_index(link_name)
        R, p = (fk_world if recursive else fk_world_scalar)(s, q2)
        return self._denorm(p[:, idx], bs), self._denorm(matrix_to_quaternion(R[:, idx]), bs)

    def compute_forward_kinematics_all_links(
        self, q, params=None
    ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
        """{link name: (position, quaternion)} for every link."""
        (q2,), bs = self._norm(q)
        s = self._resolved(params)
        R, p = fk_world_scalar(s, q2)
        quat = matrix_to_quaternion(R)
        return {
            ln: (self._denorm(p[:, i], bs), self._denorm(quat[:, i], bs))
            for i, ln in enumerate(s.link_names)
        }

    def compute_endeffector_jacobian(
        self, q, link_name: str, params=None
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Geometric Jacobian (linear, angular) of one link: [..., 3, D] each."""
        (q2,), bs = self._norm(q)
        s = self._resolved(params)
        lin, ang = link_jacobian(s, q2, s.link_index(link_name))
        return self._denorm(lin, bs), self._denorm(ang, bs)

    # -- dynamics ----------------------------------------------------------
    def compute_inverse_dynamics(
        self, q, qd, qdd_des, include_gravity: bool = True, use_damping: bool = True,
        params=None, id_impl: str = "auto",
    ) -> torch.Tensor:
        """RNEA torques [..., D]. `id_impl`: "kernel" (K4, and `rnea_bwd` for
        its gradient; with learnable parameters or `params=`, K4's learnable
        form, whose gradient covers the robot too; the plain versions on a
        CPU tensor), "scalar" (torch ops, differentiable w.r.t. the robot
        too) or "auto" ("kernel" on CUDA for a robot without learnable
        parameters or `params=`, else "scalar")."""
        (q2, qd2, qdd2), bs = self._norm(q, qd, qdd_des)
        route = id_route(id_impl, params is not None or bool(self._learnables),
                         q2.device.type == "cuda")
        s = self._resolved(params)
        if route != "scalar":
            tau = (rnea_learnable if route == "kernel_learnable" else rnea)(
                s, q2.contiguous(), qd2.contiguous(), qdd2.contiguous(), include_gravity,
                use_damping)
        else:
            tau = rnea_scalar(s, q2.T, qd2.T, qdd2.T, include_gravity, use_damping).T
        return self._denorm(tau, bs)

    def compute_non_linear_effects(
        self, q, qd, include_gravity: bool = True, use_damping: bool = True, params=None
    ) -> torch.Tensor:
        """Coriolis, centrifugal, gravity (and damping) torques: inverse
        dynamics at qdd = 0."""
        zeros = torch.zeros_like(torch.as_tensor(q, dtype=self.trans.dtype, device=self.trans.device))
        return self.compute_inverse_dynamics(q, qd, zeros, include_gravity, use_damping,
                                             params=params)

    def compute_lagrangian_inertia_matrix(
        self, q, include_gravity: bool = True, use_damping: bool = True, params=None
    ) -> torch.Tensor:
        """Joint-space mass matrix H(q) [..., D, D]. The flags are taken for
        the reference's signature; H depends on neither."""
        del include_gravity, use_damping
        (q2,), bs = self._norm(q)
        H = mass_matrix_scalar(self._resolved(params), q2.T)  # [D, D, N]
        return self._denorm(H.permute(2, 0, 1), bs)

    def compute_forward_dynamics(
        self, q, qd, f, include_gravity: bool = True, use_damping: bool = False,
        method: str = "crb", params=None,
    ) -> torch.Tensor:
        """Forward dynamics qdd [..., D] from applied torques f: method="crb"
        solves with the mass matrix, any other runs the articulated-body
        algorithm."""
        (q2, qd2, f2), bs = self._norm(q, qd, f)
        fn = forward_dynamics_crb if method == "crb" else aba
        return self._denorm(
            fn(self._resolved(params), q2, qd2, f2, include_gravity, use_damping), bs)

    def compute_forward_dynamics_old(
        self, q, qd, f, include_gravity: bool = True, use_damping: bool = True, params=None
    ) -> torch.Tensor:
        """The mass-matrix solve under its older name, whose use_damping
        default is True."""
        return self.compute_forward_dynamics(q, qd, f, include_gravity, use_damping, method="crb",
                                             params=params)

    # -- learnable parameters ---------------------------------------------
    def make_link_param_learnable(self, link_name: str, parameter_name: str,
                                  parametrization: nn.Module) -> None:
        """Make a link constant learnable through a constrained
        parametrization (models/parametrizations.py), moved to the model's
        device and dtype. Raises AttributeError for an unknown parameter
        name, KeyError for an unknown link, ValueError for joint_damping on
        a fixed joint."""
        self._learnables.register(
            link_name, parameter_name,
            parametrization.to(device=self.trans.device, dtype=self.trans.dtype))

    def freeze_learnable_link_param(self, link_name: str, parameter_name: str) -> None:
        """Stop training one entry (requires_grad=False); its value still applies."""
        self._learnables.freeze(link_name, parameter_name)

    def unfreeze_learnable_link_param(self, link_name: str, parameter_name: str) -> None:
        self._learnables.unfreeze(link_name, parameter_name)

    def learnable_parameters(self) -> dict:
        """{"link.param": unconstrained values} of the unfrozen learnable
        entries, the module's own parameters (a dict of them for
        TriangParam3DInertiaMatrix): the JAX package's `parameters()`. The
        PyTorch `parameters()` keeps its meaning (every parameter, frozen
        ones included, for an optimizer)."""
        return self._learnables.trainable()

    def set_parameters(self, params: dict) -> None:
        """Copy unconstrained values (tensors or numpy) into the learnable
        entries `params` names."""
        self._learnables.set_parameters(params)

    def print_learnable_params(self) -> None:
        for key, val in self.learnable_parameters().items():
            for sub, v in (val.items() if isinstance(val, dict) else [(None, val)]):
                path = f"['{key}']" + ("" if sub is None else f"['{sub}']")
                print(f"{path}: {v.detach().cpu().numpy()}")

    # -- misc --------------------------------------------------------------
    def get_joint_limits(self) -> List[Dict[str, float]]:
        host = self._base_struct().numpy()
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

    def print_link_names(self) -> None:
        for n in self.get_link_names():
            print(n)


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
