"""Small batched tensor helpers, with the reference library's names.

PyTorch counterpart of the JAX package's `utils/tensor_utils.py`: the
reference's in-place fills become out-of-place functions, so that they
compose with autograd.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.lie import cross as cross_product
from ..ops.lie import exp_so3 as exp_map_so3
from ..ops.lie import skew as vector3_to_skew_symm_matrix

__all__ = [
    "cross_product",
    "exp_map_so3",
    "vector3_to_skew_symm_matrix",
    "bfill_lowertriangle",
    "bfill_diagonal",
    "convert_into_at_least_2d_pytorch_tensor",
    "convert_into_pytorch_tensor",
]


def bfill_lowertriangle(A: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """A copy of the batched square matrices A with the strict lower
    triangle filled from vec (row major: (1,0), (2,0), (2,1), ...)."""
    n = A.shape[-1]
    rows, cols = np.tril_indices(n, k=-1)
    out = A.clone()
    out[..., rows, cols] = vec[..., : len(rows)]
    return out


def bfill_diagonal(A: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """A copy of the batched square matrices A with the diagonal from vec."""
    n = A.shape[-1]
    idx = np.arange(n)
    out = A.clone()
    out[..., idx, idx] = vec[..., :n]
    return out


def convert_into_pytorch_tensor(x, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=dtype, device=device)


def convert_into_at_least_2d_pytorch_tensor(x, dtype=torch.float32, device=None) -> torch.Tensor:
    t = torch.as_tensor(x, dtype=dtype, device=device)
    return t[None] if t.dim() < 2 else t
