"""Learnable-parameter overlays on the RobotStruct.

PyTorch counterpart of the JAX package's `models/learnable.py`. A
`LearnableSet` maps (link, parameter) keys, "link.param", to
parametrizations (models/parametrizations.py); `apply(struct, params)`
returns the struct with the constrained values written into its stacked
tensors, differentiable w.r.t. the parametrizations' own parameters, or
w.r.t. the unconstrained values given in `params` where it names an entry.
The set is an `nn.Module`: its parametrizations are submodules, so
`model.parameters()` holds their parameters and `.to()` moves them.
Freezing an entry sets `requires_grad=False` on its parameters and leaves it
out of `trainable()`; its stored value still applies.

The learnable parameter names: trans, rot_angles, mass, com, inertia_mat
(written into `inertia_com`) and joint_damping (indexed by dof).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from .structs import RobotStruct

# (struct field, per-link shape) for each public parameter name.
_PARAM_FIELDS = {
    "trans": ("trans", (3,)),
    "rot_angles": ("rot_angles", (3,)),
    "mass": ("mass", ()),
    "com": ("com", (3,)),
    "inertia_mat": ("inertia_com", (3, 3)),
    "joint_damping": ("damping", ()),  # indexed by dof, not link
}


def _key(link_name: str, parameter_name: str) -> str:
    return f"{link_name}.{parameter_name}"


class LearnableSet(nn.Module):
    """The learnable entries of one robot, whose link names and dof links
    (`static`, RobotStruct's static fields) it checks registrations against."""

    def __init__(self, static: dict):
        super().__init__()
        self._link_names = tuple(static["link_names"])
        self._dof_links = tuple(static["dof_links"])
        self._entries = nn.ModuleList()
        self._index: Dict[str, int] = {}

    def __bool__(self) -> bool:
        return bool(self._index)

    def register(self, link_name: str, parameter_name: str, parametrization: nn.Module) -> None:
        if parameter_name not in _PARAM_FIELDS:
            raise AttributeError(
                "Invalid parameter name. Accepted parameter names are: "
                "trans, rot_angles, joint_damping, mass, inertia_mat, com"
            )
        if link_name not in self._link_names:
            raise KeyError(f"Unknown link: {link_name}")
        if parameter_name == "joint_damping":
            if self._link_names.index(link_name) not in self._dof_links:
                raise ValueError(f"Link {link_name} has no actuated joint")
        k = _key(link_name, parameter_name)
        if k in self._index:
            self._entries[self._index[k]] = parametrization
        else:
            self._index[k] = len(self._entries)
            self._entries.append(parametrization)

    def _entry(self, link_name: str, parameter_name: str) -> nn.Module:
        k = _key(link_name, parameter_name)
        if k not in self._index:
            raise KeyError(f"{parameter_name} of {link_name} is not learnable.")
        return self._entries[self._index[k]]

    def freeze(self, link_name: str, parameter_name: str) -> None:
        self._entry(link_name, parameter_name).requires_grad_(False)

    def unfreeze(self, link_name: str, parameter_name: str) -> None:
        self._entry(link_name, parameter_name).requires_grad_(True)

    def items(self):
        return ((k, self._entries[i]) for k, i in self._index.items())

    def trainable(self) -> dict:
        """{key: unconstrained values} of the unfrozen entries: the module's
        own parameters (a dict of them for TriangParam3DInertiaMatrix)."""
        return {
            k: e.unconstrained() for k, e in self.items()
            if any(p.requires_grad for p in e.parameters())
        }

    def set_parameters(self, params: dict) -> None:
        """Copy unconstrained values (tensors or numpy, a dict of them for
        TriangParam3DInertiaMatrix) into the named entries' parameters."""
        with torch.no_grad():
            for k, v in params.items():
                own = self._entries[self._index[k]].unconstrained()
                pairs = [(own[j], v[j]) for j in own] if isinstance(own, dict) else [(own, v)]
                for p, x in pairs:
                    p.copy_(torch.as_tensor(x, dtype=p.dtype).reshape(p.shape))

    def apply(self, struct: RobotStruct, params: dict | None = None) -> RobotStruct:
        """`struct` with every entry's constrained value written in: from
        `params[key]` where given, else from the entry's own parameters."""
        if not self._index:
            return struct
        params = params or {}
        updates: Dict[str, torch.Tensor] = {}
        for k, e in self.items():
            link_name, parameter_name = k.rsplit(".", 1)
            raw = params[k] if k in params else e.unconstrained()
            value = e.apply(raw)
            field, shape = _PARAM_FIELDS[parameter_name]
            l = self._link_names.index(link_name)
            idx = self._dof_links.index(l) if parameter_name == "joint_damping" else l
            if field not in updates:
                updates[field] = getattr(struct, field).clone()
            leaf = updates[field]
            leaf[idx] = value.to(dtype=leaf.dtype, device=leaf.device).reshape(shape)
        return struct.with_arrays(**updates)
