"""URDF -> RobotStruct compiler (dependency-free xml.etree walk).

The port's own copy of the JAX package's `models/urdf.py` (numpy only; the
port imports nothing from that package). Parity notes:
- joint fused into the child link; joint frame at the link origin;
- links with no <inertial> get mass=1, com=0, I=eye(3) and a warning;
- joint damping defaults to 0 when <dynamics> is absent;
- arbitrary (normalized) joint axes and prismatic joints are supported;
- the <inertial> origin rpy is rotated into the link frame;
- missing <limit> tags (legal for 'continuous' joints) default to +-inf.
"""

from __future__ import annotations

import re
import warnings
import xml.etree.ElementTree as ET

import numpy as np
import torch

from .structs import JOINT_FIXED, RobotStruct, build_struct, joint_type_code


def parse_xml_lenient(path: str) -> ET.Element:
    """Parse XML tolerating undeclared namespace prefixes (gazebo/xacro tags).

    Real-world URDFs (e.g. fetch.urdf) embed `<sensor:camera>`-style gazebo
    tags with no xmlns declaration; inject dummy declarations so the document
    parses, then ignore those elements.
    """
    with open(path, "r") as f:
        text = f.read()
    prefixes = set(re.findall(r"<\s*([A-Za-z_][\w.-]*):", text)) - {"xml"}
    declared = set(re.findall(r"xmlns:([\w.-]+)\s*=", text))
    missing = prefixes - declared
    if missing:
        decls = " ".join(f'xmlns:{p}="urn:ignore:{p}"' for p in sorted(missing))
        text = re.sub(r"<robot\b", f"<robot {decls}", text, count=1)
    return ET.fromstring(text)


def _floats(s: str | None, default):
    if s is None:
        return np.array(default, dtype=np.float64)
    return np.array([float(x) for x in s.split()], dtype=np.float64)


def _rpy_matrix(rpy: np.ndarray) -> np.ndarray:
    r, p, y = rpy
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def parse_urdf(urdf_path: str):
    """Parse a URDF file into plain-python link/joint records (document order)."""
    root = parse_xml_lenient(urdf_path)
    if root.tag != "robot":
        raise ValueError(f"{urdf_path}: expected <robot> root element")

    links = {}
    link_order = []
    for el in root.findall("link"):
        lname = el.get("name")
        inertial = el.find("inertial")
        rec = {"name": lname, "mass": 1.0, "com": np.zeros(3), "inertia": np.eye(3)}
        if inertial is not None:
            origin = inertial.find("origin")
            com = _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0])
            rpy = _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0])
            mass_el = inertial.find("mass")
            mass = float(mass_el.get("value")) if mass_el is not None else 1.0
            in_el = inertial.find("inertia")
            if in_el is not None:
                g = lambda k: float(in_el.get(k, "0"))
                I = np.array(
                    [
                        [g("ixx"), g("ixy"), g("ixz")],
                        [g("ixy"), g("iyy"), g("iyz")],
                        [g("ixz"), g("iyz"), g("izz")],
                    ]
                )
            else:
                I = np.eye(3)
            # Fold the inertial-frame rotation into the link frame.
            R_in = _rpy_matrix(rpy)
            rec.update(mass=mass, com=com, inertia=R_in @ I @ R_in.T)
        else:
            warnings.warn(
                f"No dynamics information for link: {rec['name']}, "
                "setting all inertial properties to 1."
            )
        links[lname] = rec
        link_order.append(lname)

    joints = []
    for el in root.findall("joint"):
        origin = el.find("origin")
        axis_el = el.find("axis")
        limit = el.find("limit")
        dyn = el.find("dynamics")
        inf = float("inf")
        joints.append(
            {
                "name": el.get("name"),
                "type": el.get("type"),
                "parent": el.find("parent").get("link"),
                "child": el.find("child").get("link"),
                "xyz": _floats(origin.get("xyz") if origin is not None else None, [0, 0, 0]),
                "rpy": _floats(origin.get("rpy") if origin is not None else None, [0, 0, 0]),
                "axis": _floats(axis_el.get("xyz") if axis_el is not None else None, [1, 0, 0]),
                "damping": float(dyn.get("damping", "0")) if dyn is not None else 0.0,
                "limits": np.array(
                    [
                        float(limit.get("lower", -inf)) if limit is not None else -inf,
                        float(limit.get("upper", inf)) if limit is not None else inf,
                        float(limit.get("effort", inf)) if limit is not None else inf,
                        float(limit.get("velocity", inf)) if limit is not None else inf,
                    ]
                ),
            }
        )
    return root.get("name", "robot"), link_order, links, joints


def robot_struct_from_urdf(
    urdf_path: str, name: str = "", dtype=torch.float32, device=None
) -> RobotStruct:
    """Compile a URDF file into a RobotStruct on `device` (CUDA by default).

    Links are emitted in document order when that order is already
    topological (true for all bundled robots); otherwise they are stably
    topologically sorted.
    """
    robot_name, link_order, links, joints = parse_urdf(urdf_path)
    name = name or robot_name

    child_joint = {j["child"]: j for j in joints}
    roots = [l for l in link_order if l not in child_joint]
    if len(roots) != 1:
        raise ValueError(f"{urdf_path}: expected exactly 1 root link, got {roots}")

    order = []
    placed = set()
    pending = list(link_order)
    while pending:
        progressed = False
        rest = []
        for lname in pending:
            if lname == roots[0] or child_joint[lname]["parent"] in placed:
                order.append(lname)
                placed.add(lname)
                progressed = True
            else:
                rest.append(lname)
        if not progressed:
            raise ValueError(f"{urdf_path}: kinematic loop or dangling links: {rest}")
        pending = rest

    idx = {lname: i for i, lname in enumerate(order)}
    L = len(order)
    parent = [0] * L
    joint_types = [JOINT_FIXED] * L
    joint_names = ["base_joint"] + [""] * (L - 1)
    trans = np.zeros((L, 3))
    rot_angles = np.zeros((L, 3))
    axis = np.zeros((L, 3))
    mass = np.zeros(L)
    com = np.zeros((L, 3))
    inertia = np.zeros((L, 3, 3))
    damping = np.zeros(L)
    limits = np.zeros((L, 4))

    for i, lname in enumerate(order):
        rec = links[lname]
        mass[i] = rec["mass"]
        com[i] = rec["com"]
        inertia[i] = rec["inertia"]
        if i == 0:
            continue
        j = child_joint[lname]
        parent[i] = idx[j["parent"]]
        joint_types[i] = joint_type_code(j["type"])
        joint_names[i] = j["name"]
        trans[i] = j["xyz"]
        rot_angles[i] = j["rpy"]
        if joint_types[i] != JOINT_FIXED:
            a = j["axis"]
            n = np.linalg.norm(a)
            if n == 0:
                raise ValueError(f"{urdf_path}: joint {j['name']} has zero axis")
            axis[i] = a / n
            damping[i] = j["damping"]
            limits[i] = j["limits"]

    return build_struct(
        name=name,
        link_names=order,
        joint_names=joint_names,
        parent=parent,
        joint_types=joint_types,
        trans=trans,
        rot_angles=rot_angles,
        axis=axis,
        mass=mass,
        com=com,
        inertia_com=inertia,
        damping_per_link=damping,
        limits_per_link=limits,
        dtype=dtype,
        device=device,
    )
