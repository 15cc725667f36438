"""Dataset generation for model learning.

PyTorch counterpart of the JAX package's `utils/data.py`. The inputs are
drawn (or, for the sine trajectories, computed) in numpy exactly as the
JAX package draws them, so both packages' arrays match for the same seed;
the targets come from the ground-truth model (inverse dynamics on its
default engine: K4 on a CUDA model without learnable parameters). A dataset
is a dict of tensors in the model's dtype on its device; `minibatches`
shuffles it with a `torch.Generator`.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _tensors(robot_model, **arrays) -> Dict[str, torch.Tensor]:
    dtype, device = robot_model.trans.dtype, robot_model.trans.device
    return {k: torch.as_tensor(v, dtype=dtype, device=device).detach() for k, v in arrays.items()}


def _limits(robot_model, key):
    return np.array([l[key] for l in robot_model.get_joint_limits()])


def generate_random_forward_kinematics_data(
    robot_model, n_data: int, ee_name: str, seed: int = 0
) -> Dict[str, torch.Tensor]:
    """Random q within the joint limits -> end-effector positions."""
    lo, hi = _limits(robot_model, "lower"), _limits(robot_model, "upper")
    rng = np.random.default_rng(seed)
    q = rng.uniform(lo, hi, (n_data, robot_model.n_dofs))
    with torch.no_grad():
        ee_pos, _ = robot_model.compute_forward_kinematics(q, ee_name)
    return _tensors(robot_model, q=q, ee_pos=ee_pos)


def generate_random_inverse_dynamics_data(
    robot_model, n_data: int, seed: int = 0
) -> Dict[str, torch.Tensor]:
    """Random (q, qd, qdd) within the limits -> torques."""
    lo, hi = _limits(robot_model, "lower"), _limits(robot_model, "upper")
    vel = _limits(robot_model, "velocity")
    rng = np.random.default_rng(seed)
    D = robot_model.n_dofs
    q = rng.uniform(lo, hi, (n_data, D))
    qd = rng.uniform(-vel, vel, (n_data, D))
    qdd = rng.uniform(-vel, vel, (n_data, D))
    with torch.no_grad():
        tau = robot_model.compute_inverse_dynamics(q, qd, qdd)
    return _tensors(robot_model, q=q, qd=qd, qdd=qdd, tau=tau)


def _sine_trajectories(n_data: int, n_dofs: int, dt: float = 1.0 / 250.0):
    """Per-dof sine sweeps q = A sin(2 pi t / T) with staggered amplitude and
    period, and their analytic qd, qdd."""
    t = np.arange(n_data) * dt
    q = np.zeros((n_data, n_dofs))
    qd = np.zeros((n_data, n_dofs))
    qdd = np.zeros((n_data, n_dofs))
    for j in range(n_dofs):
        A = 0.5 + 0.1 * j
        T = 2.0 + 0.3 * j
        w = 2.0 * np.pi / T
        q[:, j] = A * np.sin(w * t)
        qd[:, j] = A * w * np.cos(w * t)
        qdd[:, j] = -A * w * w * np.sin(w * t)
    return q, qd, qdd


def generate_sine_motion_inverse_dynamics_data(
    robot_model, n_data: int, dt: float = 1.0 / 250.0
) -> Dict[str, torch.Tensor]:
    """Sine trajectories -> torques."""
    q, qd, qdd = _sine_trajectories(n_data, robot_model.n_dofs, dt)
    with torch.no_grad():
        tau = robot_model.compute_inverse_dynamics(q, qd, qdd)
    return _tensors(robot_model, q=q, qd=qd, qdd=qdd, tau=tau)


def generate_sine_motion_forward_dynamics_data(
    robot_model, n_data: int, dt: float = 1.0 / 250.0
) -> Dict[str, torch.Tensor]:
    """Sine trajectories and their inverse-dynamics torques, for learning
    the accelerations back."""
    return generate_sine_motion_inverse_dynamics_data(robot_model, n_data, dt)


class InverseDynamicsDataset:
    """Indexable view over an inverse-dynamics dataset dict: index ->
    [q, qd, qdd, tau]; `var()` is the per-dof (population) variance of the
    target, what the NMSE losses divide by."""

    _target_key = "tau"

    def __init__(self, data: Dict[str, torch.Tensor]):
        self.data = data

    def __getitem__(self, index):
        d = self.data
        return [d["q"][index], d["qd"][index], d["qdd"][index], d["tau"][index]]

    def __len__(self) -> int:
        return int(self.data["q"].shape[0])

    def var(self) -> torch.Tensor:
        return torch.var(self.data[self._target_key], dim=0, unbiased=False)


class ForwardDynamicsDataset(InverseDynamicsDataset):
    """The same view, with `var()` over the accelerations."""

    _target_key = "qdd"


def minibatches(data: Dict[str, torch.Tensor], batch_size: int, generator: torch.Generator,
                keys=None):
    """Shuffled minibatches of a dict-of-tensors dataset (the last partial
    batch dropped), the permutation drawn from `generator` (a CPU
    `torch.Generator`)."""
    names = list(data.keys())
    n = data[names[0]].shape[0]
    perm = torch.randperm(n, generator=generator).to(data[names[0]].device)
    for start in range(0, n - batch_size + 1, batch_size):
        idx = perm[start : start + batch_size]
        yield {k: data[k][idx] for k in (keys or names)}
