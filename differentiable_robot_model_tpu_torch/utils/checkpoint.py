"""Checkpoint and restore of parameter trees and robot structs.

PyTorch counterpart of the JAX package's `utils/checkpoint.py`, in the same
`.npz` layout: one array per leaf under its slash-joined key path (dict
keys in sorted order, sequence indices, a RobotStruct's field names). A
model's `learnable_parameters()` saves as {"link.param": array} and, for
TriangParam3DInertiaMatrix, "link.inertia_mat/ori" and so on, the same keys
the JAX package writes for its parameters, so a checkpoint of either
package loads into the other (`load_pytree`, then `set_parameters`).
"""

from __future__ import annotations

import os
from typing import Any

import numpy as np
import torch

from ..models.structs import RobotStruct


def _leaves(tree: Any, prefix: str = ""):
    """(key path, leaf) in the JAX package's flattening order."""
    if isinstance(tree, RobotStruct):
        tree = tree.arrays()
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}{i}/")
    else:
        yield prefix[:-1], tree


def _numpy(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_pytree(path: str, tree: Any) -> None:
    """Save a tree (dicts, lists, tuples, RobotStructs) of tensors or arrays
    to an .npz whose keys are slash-joined paths."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path, **{k: _numpy(v) for k, v in _leaves(tree)})


def _rebuild(like: Any, flat: dict, path: str, prefix: str = ""):
    if isinstance(like, RobotStruct):
        arrays = _rebuild(like.arrays(), flat, path, prefix)
        return RobotStruct(**arrays, **like.static())
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path, f"{prefix}{k}/") for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        out = [_rebuild(v, flat, path, f"{prefix}{i}/") for i, v in enumerate(like)]
        return type(like)(out) if isinstance(like, tuple) else out
    key = prefix[:-1]
    if key not in flat:
        raise KeyError(f"Checkpoint {path} is missing entry '{key}'")
    if isinstance(like, torch.Tensor):
        return torch.as_tensor(flat[key], dtype=like.dtype, device=like.device)
    return np.asarray(flat[key], getattr(like, "dtype", None))


def load_pytree(path: str, like: Any) -> Any:
    """Load what `save_pytree` saved into the structure of `like`: tensors
    in each leaf's dtype and device (numpy arrays where the leaf is not a
    tensor)."""
    with np.load(path) as data:
        flat = dict(data)
    return _rebuild(like, flat, path)
