"""RobotStruct: a robot as a frozen dataclass of stacked per-link tensors.

PyTorch counterpart of the JAX package's `models/structs.py`. The robot is one
dataclass:

- *Array fields* (tensors stacked over links L or dofs D): the kinematic and
  dynamic constants and the topology encodings (`anc_mask`, `dof_select`,
  `rev_mask`, `prism_mask`), all on one device in one floating dtype.
- *Static fields* (hashable tuples): topology, names, and the per-link
  specialization hints (`axis_code`, `rpy_zero`, `trans_zero`) computed from
  the URDF constants when the struct is built.

The kernels' host-side constant preparation reads the arrays from the device
once per struct and caches what it derives (`RobotStruct.numpy`,
`RobotStruct.memo`); an in-place write to an array drops that cache, so the
next kernel call reads the new values.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

JOINT_FIXED = 0
JOINT_REVOLUTE = 1  # includes URDF 'continuous'
JOINT_PRISMATIC = 2

_JOINT_TYPE_CODES = {
    "fixed": JOINT_FIXED,
    "revolute": JOINT_REVOLUTE,
    "continuous": JOINT_REVOLUTE,
    "prismatic": JOINT_PRISMATIC,
}

ARRAY_FIELDS = (
    "trans", "rot_angles", "axis", "mass", "com", "inertia_com", "damping",
    "limit_lower", "limit_upper", "limit_effort", "limit_velocity",
    "anc_mask", "dof_select", "rev_mask", "prism_mask",
)
STATIC_FIELDS = (
    "parent", "joint_types", "dof_links", "axis_code", "rpy_zero",
    "trans_zero", "link_names", "joint_names", "name",
)


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    Raises when CUDA is meant and no CUDA device exists; the port never
    carries on quietly on the CPU.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def joint_type_code(urdf_type: str) -> int:
    if urdf_type not in _JOINT_TYPE_CODES:
        raise NotImplementedError(f"Unsupported URDF joint type: {urdf_type}")
    return _JOINT_TYPE_CODES[urdf_type]


def _axis_codes_of(axis: np.ndarray) -> tuple:
    """(axis_index, sign) per link when the axis is exactly an axis-aligned
    unit vector, else None."""
    axis_np = np.asarray(axis, np.float64)
    codes = []
    for l in range(axis_np.shape[0]):
        code = None
        for i in range(3):
            for s in (1.0, -1.0):
                unit = np.zeros(3)
                unit[i] = s
                if np.array_equal(axis_np[l], unit):
                    code = (i, int(s))
        codes.append(code)
    return tuple(codes)


def _rpy_zero_of(rot_angles: np.ndarray) -> tuple:
    rpy_np = np.asarray(rot_angles, np.float64)
    return tuple(bool((rpy_np[l] == 0.0).all()) for l in range(rpy_np.shape[0]))


def _trans_zero_of(trans: np.ndarray) -> tuple:
    trans_np = np.asarray(trans, np.float64)
    return tuple(
        tuple(bool(trans_np[l, j] == 0.0) for j in range(3))
        for l in range(trans_np.shape[0])
    )


@dataclasses.dataclass(frozen=True)
class RobotStruct:
    # --- tensors, stacked over links (L) / dofs (D) ---
    trans: torch.Tensor  # [L, 3] joint origin xyz in the parent frame
    rot_angles: torch.Tensor  # [L, 3] joint origin rpy
    axis: torch.Tensor  # [L, 3] joint axis in the joint frame
    mass: torch.Tensor  # [L]
    com: torch.Tensor  # [L, 3] inertial origin xyz in the link frame
    inertia_com: torch.Tensor  # [L, 3, 3] about the COM, link frame
    damping: torch.Tensor  # [D]
    limit_lower: torch.Tensor  # [D]
    limit_upper: torch.Tensor  # [D]
    limit_effort: torch.Tensor  # [D]
    limit_velocity: torch.Tensor  # [D]
    anc_mask: torch.Tensor  # [L, L], 1 iff j is on the path root..l
    dof_select: torch.Tensor  # [L, D] one-hot link <-> dof scatter
    rev_mask: torch.Tensor  # [L], 1 where revolute/continuous
    prism_mask: torch.Tensor  # [L], 1 where prismatic
    # --- static topology, names and specialization hints ---
    parent: tuple
    joint_types: tuple
    dof_links: tuple  # per dof -> link index
    axis_code: tuple  # per link (axis_index, sign) or None
    rpy_zero: tuple  # per link: joint origin rpy exactly (0, 0, 0)
    trans_zero: tuple  # per link (bool, bool, bool): xyz components exactly 0
    link_names: tuple
    joint_names: tuple
    name: str
    # host-side values derived from the arrays, filled on first use
    _cache: dict = dataclasses.field(
        default_factory=dict, init=False, repr=False, compare=False
    )

    @property
    def n_links(self) -> int:
        return len(self.parent)

    @property
    def n_dofs(self) -> int:
        return len(self.dof_links)

    @property
    def dtype(self) -> torch.dtype:
        return self.trans.dtype

    @property
    def device(self) -> torch.device:
        return self.trans.device

    @property
    def requires_grad(self) -> bool:
        """Whether any array requires grad (learnable parameters applied)."""
        return any(a.requires_grad for a in self.arrays().values())

    def arrays(self) -> dict[str, torch.Tensor]:
        return {f: getattr(self, f) for f in ARRAY_FIELDS}

    def static(self) -> dict[str, Any]:
        return {f: getattr(self, f) for f in STATIC_FIELDS}

    def to(self, device=None, dtype=None) -> "RobotStruct":
        """A copy with every array moved to `device` and/or cast to `dtype`."""
        moved = {k: v.to(device=device, dtype=dtype) for k, v in self.arrays().items()}
        return RobotStruct(**moved, **self.static())

    def with_arrays(self, **updates) -> "RobotStruct":
        """A copy with the named arrays replaced, whose specialization hints
        follow the new arrays: an overlay on `axis`, `rot_angles` or `trans`
        recomputes `axis_code`, `rpy_zero` or `trans_zero` from its values,
        or clears them (no axis-aligned or zero entry claimed) where the new
        tensor requires grad, without reading it from the device."""
        arrays = {**self.arrays(), **updates}
        static = self.static()
        for field, hint, of, cleared in (
            ("axis", "axis_code", _axis_codes_of, lambda L: (None,) * L),
            ("rot_angles", "rpy_zero", _rpy_zero_of, lambda L: (False,) * L),
            ("trans", "trans_zero", _trans_zero_of, lambda L: ((False,) * 3,) * L),
        ):
            if field in updates:
                x = updates[field]
                static[hint] = (cleared(x.shape[0]) if x.requires_grad
                                else of(x.detach().cpu().numpy()))
        return RobotStruct(**arrays, **static)

    def memo(self, key, build):
        """`build()`, computed once per struct and key, and again after any
        array was written in place (`copy_`, `zero_`, `load_state_dict`) or
        given new storage: every cached value is keyed on the arrays'
        version counters and data pointers."""
        stamp = tuple((a._version, a.data_ptr()) for a in self.arrays().values())
        if self._cache.get("stamp") != stamp:
            self._cache.clear()
            self._cache["stamp"] = stamp
        if key not in self._cache:
            self._cache[key] = build()
        return self._cache[key]

    def numpy(self) -> dict[str, np.ndarray]:
        """numpy copies of the arrays (read from the device once per struct)."""
        return self.memo(
            "numpy",
            lambda: {k: v.detach().cpu().numpy() for k, v in self.arrays().items()},
        )

    def link_index(self, link_name: str) -> int:
        try:
            return self.link_names.index(link_name)
        except ValueError:
            raise KeyError(
                f"Unknown link '{link_name}' for robot '{self.name}'. "
                f"Available links: {list(self.link_names)}"
            ) from None


def build_struct(
    name: str,
    link_names: list,
    joint_names: list,
    parent: list,
    joint_types: list,
    trans: np.ndarray,
    rot_angles: np.ndarray,
    axis: np.ndarray,
    mass: np.ndarray,
    com: np.ndarray,
    inertia_com: np.ndarray,
    damping_per_link: np.ndarray,
    limits_per_link: np.ndarray,  # [L, 4] lower, upper, effort, velocity
    dtype=torch.float32,
    device=None,
) -> RobotStruct:
    """Assemble a RobotStruct from per-link numpy data (topo-ordered, root first)."""
    device = resolve_device(device)
    L = len(link_names)
    parent = list(parent)
    if parent[0] != 0:
        raise ValueError("root link must be index 0 with self-loop parent")
    for i in range(1, L):
        if not 0 <= parent[i] < i:
            raise ValueError("links must be topologically ordered")

    anc = np.zeros((L, L), dtype=np.float64)
    for l in range(L):
        j = l
        anc[l, j] = 1.0
        while j != 0:
            j = parent[j]
            anc[l, j] = 1.0

    dof_links = [l for l in range(L) if joint_types[l] != JOINT_FIXED]
    D = len(dof_links)
    dof_select = np.zeros((L, D), dtype=np.float64)
    for d, l in enumerate(dof_links):
        dof_select[l, d] = 1.0

    rev = np.array([1.0 if t == JOINT_REVOLUTE else 0.0 for t in joint_types])
    prism = np.array([1.0 if t == JOINT_PRISMATIC else 0.0 for t in joint_types])

    damping = damping_per_link[dof_links] if D else np.zeros((0,))
    limits = limits_per_link[dof_links] if D else np.zeros((0, 4))

    as_t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=dtype, device=device)
    return RobotStruct(
        trans=as_t(trans),
        rot_angles=as_t(rot_angles),
        axis=as_t(axis),
        mass=as_t(mass),
        com=as_t(com),
        inertia_com=as_t(inertia_com),
        damping=as_t(damping),
        limit_lower=as_t(limits[:, 0]),
        limit_upper=as_t(limits[:, 1]),
        limit_effort=as_t(limits[:, 2]),
        limit_velocity=as_t(limits[:, 3]),
        anc_mask=as_t(anc),
        dof_select=as_t(dof_select),
        rev_mask=as_t(rev),
        prism_mask=as_t(prism),
        parent=tuple(parent),
        joint_types=tuple(joint_types),
        dof_links=tuple(dof_links),
        axis_code=_axis_codes_of(axis),
        rpy_zero=_rpy_zero_of(rot_angles),
        trans_zero=_trans_zero_of(trans),
        link_names=tuple(link_names),
        joint_names=tuple(joint_names),
        name=name,
    )


def struct_from_arrays(
    arrays: dict[str, np.ndarray], static: dict, device=None
) -> RobotStruct:
    """The port's struct from another struct's arrays (numpy, dtype kept) and
    its static tuples, e.g. the JAX struct's leaves, so that both packages
    run the same robot."""
    device = resolve_device(device)
    missing = set(ARRAY_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"struct_from_arrays: missing arrays {sorted(missing)}")
    tensors = {
        k: torch.as_tensor(np.array(arrays[k]), device=device) for k in ARRAY_FIELDS
    }
    return RobotStruct(**tensors, **{k: static[k] for k in STATIC_FIELDS})
