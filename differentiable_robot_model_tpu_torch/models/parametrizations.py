"""Physically constrained reparametrizations of link parameters.

PyTorch counterpart of the JAX package's `models/parametrizations.py` (the
L4DC "encoding physical constraints" machinery). Each parametrization is an
`nn.Module` whose unconstrained values are `nn.Parameter`s:

    forward()   -> the constrained value from the module's own parameters
    apply(raw)  -> the same function of given unconstrained values (a tensor,
                   or for `TriangParam3DInertiaMatrix` a dict of tensors),
                   what `params=` on the model's compute_* methods passes
    init_value() -> the initial unconstrained values as numpy

Initialisation runs in numpy, draw for draw as the JAX package draws it, so
the same `np.random.Generator` state gives the same initial values in both
(the SVD, Cholesky and log-map constructors included). The parameters are
made in float64 on the CPU; `DifferentiableRobotModel.make_link_param_learnable`
moves them to the model's device and dtype.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn

from ..ops.lie import exp_so3

_DIAG3 = np.diag_indices(3)
_TRIL3 = np.tril_indices(3, k=-1)


def _vec6_from_mat(M: np.ndarray) -> np.ndarray:
    """[diag(3), lower triangle row major (1,0), (2,0), (2,1)]."""
    return np.concatenate([M[_DIAG3], M[_TRIL3]])


def _mat_from_vec6(l: torch.Tensor) -> torch.Tensor:
    """The lower-triangular 3x3 of the 6-vector layout above."""
    z = torch.zeros((), dtype=l.dtype, device=l.device)
    return torch.stack([
        torch.stack([l[0], z, z]),
        torch.stack([l[3], l[1], z]),
        torch.stack([l[4], l[5], l[2]]),
    ])


def _as_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def _param(value) -> nn.Parameter:
    return nn.Parameter(torch.as_tensor(np.asarray(value, np.float64)))


class _Parametrization(nn.Module):
    """One unconstrained tensor `raw`; subclasses define `apply`."""

    def __init__(self, init):
        super().__init__()
        self._init = init
        self.raw = _param(init)

    def init_value(self):
        return np.asarray(self._init)

    def unconstrained(self):
        """The module's own unconstrained values, in `apply`'s form."""
        return self.raw

    def forward(self) -> torch.Tensor:
        return self.apply(self.unconstrained())


class UnconstrainedScalar(_Parametrization):
    def __init__(self, init_val=None, rng: np.random.Generator | None = None):
        rng = rng or np.random.default_rng()
        super().__init__(float(init_val) if init_val is not None else float(rng.random()))

    def apply(self, params):
        return _as_tensor(params)


class PositiveScalar(_Parametrization):
    """value = l^2 + min_val."""

    def __init__(self, min_val=0.0, init_param_std=1.0, init_param=None, rng=None):
        rng = rng or np.random.default_rng()
        self.min_val = float(min_val)
        if init_param is None:
            init = float(rng.normal(0.0, init_param_std))
        else:
            assert init_param > self.min_val
            init = float(np.sqrt(float(init_param) - self.min_val))
        super().__init__(init)

    def apply(self, params):
        p = _as_tensor(params)
        return p * p + self.min_val


class UnconstrainedTensor(_Parametrization):
    def __init__(self, shape, init_tensor=None, init_std=0.1, rng=None):
        rng = rng or np.random.default_rng()
        self.shape = tuple(shape)
        if init_tensor is None:
            init = rng.normal(0.0, init_std, self.shape)
        else:
            init = np.asarray(init_tensor, dtype=np.float64).reshape(self.shape)
        super().__init__(init)

    def apply(self, params):
        return _as_tensor(params).reshape(self.shape)


class Symm3DInertiaMatrix(_Parametrization):
    """Symmetric (possibly indefinite) 3x3 from 6 free parameters."""

    def __init__(self, init_param_std=0.01, init_param=None, rng=None):
        rng = rng or np.random.default_rng()
        if init_param is None:
            init = rng.normal(0.0, init_param_std, (6,))
        else:
            init = _vec6_from_mat(np.asarray(init_param, dtype=np.float64))
        super().__init__(init)

    def apply(self, params):
        L = _mat_from_vec6(_as_tensor(params))
        return L + L.T - torch.diag(torch.diagonal(L))


class SymmPosDef3DInertiaMatrix(_Parametrization):
    """Symmetric positive definite 3x3 by Cholesky: M = L Lᵀ + bias I."""

    def __init__(self, bias=1e-7, init_param_std=0.01, init_param=None, rng=None):
        rng = rng or np.random.default_rng()
        self.bias = float(bias)
        if init_param is None:
            init = rng.normal(0.0, init_param_std, (6,))
        else:
            M = np.asarray(init_param, dtype=np.float64)
            init = _vec6_from_mat(np.linalg.cholesky(M - self.bias * np.eye(3)))
        super().__init__(init)

    def apply(self, params):
        L = _mat_from_vec6(_as_tensor(params))
        return L @ L.T + self.bias * torch.eye(3, dtype=L.dtype, device=L.device)


class TriangParam3DInertiaMatrix(_Parametrization):
    """Principal moments that satisfy the triangle inequality, and an SO(3)
    orientation: J1, J2 > bias (l^2 + bias), J3 = sqrt(J1^2 + J2^2 - 2 J1 J2
    cos(alpha)) with alpha = pi sigmoid(raw) in (0, pi), M = R diag(J) Rᵀ
    with R = exp_so3(ori). Its unconstrained values are the dict
    {"ori": [3], "j1": [], "j2": [], "alpha": []}."""

    KEYS = ("ori", "j1", "j2", "alpha")

    def __init__(self, bias, init_param_std=0.01, init_param=None, rng=None):
        nn.Module.__init__(self)
        rng = rng or np.random.default_rng()
        self.bias = float(bias)
        if init_param is None:
            init = {
                "ori": rng.normal(0.0, init_param_std, (3,)),
                "j1": float(rng.normal(0.0, 0.1)),
                "j2": float(rng.normal(0.0, 0.1)),
                "alpha": rng.normal(0.0, init_param_std, ()),
            }
        else:
            M = np.asarray(init_param, dtype=np.float64)
            R, J_diag, _ = np.linalg.svd(M, full_matrices=True)
            if np.linalg.det(R) < 0.0:
                R = R.copy()
                R[:, 0] = -R[:, 0]
            # the log map SO(3) -> rotation vector
            cos_t = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
            theta = np.arccos(cos_t)
            if theta < 1e-12:
                w = np.zeros(3)
            else:
                w = (
                    theta
                    / (2.0 * np.sin(theta))
                    * np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
                )
            J1, J2, J3 = J_diag[0], J_diag[1], J_diag[2]
            assert J1 > self.bias and J2 > self.bias, (
                f"principal moments ({J1:.3g}, {J2:.3g}) must exceed the "
                f"bias {self.bias:.3g}; lower `bias` for this inertia"
            )
            alpha = np.arccos(
                np.clip((J1 * J1 + J2 * J2 - J3 * J3) / (2.0 * J1 * J2), -1.0, 1.0)
            )
            a = np.clip(alpha / math.pi, 1e-9, 1 - 1e-9)
            init = {
                "ori": w,
                "j1": float(np.sqrt(J1 - self.bias)),
                "j2": float(np.sqrt(J2 - self.bias)),
                "alpha": np.asarray(np.log(a / (1.0 - a))),
            }
        self._init = init
        self.raw = nn.ParameterDict({k: _param(init[k]) for k in self.KEYS})

    def init_value(self):
        return {k: np.asarray(v) for k, v in self._init.items()}

    def unconstrained(self):
        return {k: self.raw[k] for k in self.KEYS}

    def apply(self, params):
        j1, j2 = _as_tensor(params["j1"]), _as_tensor(params["j2"])
        J1 = j1 * j1 + self.bias
        J2 = j2 * j2 + self.bias
        alpha = math.pi * (1.0 / (1.0 + torch.exp(-_as_tensor(params["alpha"]))))
        J3 = torch.sqrt(J1 * J1 + J2 * J2 - 2.0 * J1 * J2 * torch.cos(alpha))
        J = torch.diag(torch.stack([J1, J2, J3]))
        R = exp_so3(_as_tensor(params["ori"]))
        return R @ J @ R.T


class CovParameterized3DInertiaMatrix(_Parametrization):
    """Inertia from a density-weighted covariance (Wensing et al. 2017):
    Sigma = L Lᵀ + bias I, I_mat = trace(Sigma) I - Sigma."""

    def __init__(self, bias=1e-7, init_param_std=0.01, init_param=None, rng=None):
        rng = rng or np.random.default_rng()
        self.bias = float(bias)
        if init_param is None:
            init = rng.normal(0.0, init_param_std, (6,))
        else:
            M = np.asarray(init_param, dtype=np.float64)
            cov = 0.5 * np.trace(M) * np.eye(3) - M
            init = _vec6_from_mat(np.linalg.cholesky(cov - self.bias * np.eye(3)))
        super().__init__(init)

    def apply(self, params):
        L = _mat_from_vec6(_as_tensor(params))
        eye = torch.eye(3, dtype=L.dtype, device=L.device)
        cov = L @ L.T + self.bias * eye
        # diagonal().sum(), not torch.trace: trace's backward reads a value
        # back to the host (a synchronization on every training step)
        return torch.diagonal(cov).sum() * eye - cov
