"""The PyTorch port's robot description against the JAX package's.

Every bundled URDF compiles to the same struct in both packages (arrays
exact in float64, static tuples equal), the port's URDF copies are
byte-identical, the model API's FK agrees, the kernels' host-side constants
follow in-place writes to the robot's tensors, and the port stands alone: it
imports no JAX and names no module of the JAX package.
"""

import glob
import os
import re
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
import differentiable_robot_model_tpu_torch as tdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.ops import lie as jlie
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops import lie as tlie
from differentiable_robot_model_tpu_torch.ops.kernels.rollout import StepFlags, tree_struct

PORT_DIR = os.path.dirname(tdrm.__file__)
URDFS = sorted(os.path.basename(p) for p in glob.glob(os.path.join(jdrm.robot_description_folder, "*.urdf")))


def test_thirteen_urdfs_copied_byte_identical():
    assert len(URDFS) == 13
    port = sorted(os.listdir(tdrm.robot_description_folder))
    assert port == URDFS
    for name in URDFS:
        with open(os.path.join(jdrm.robot_description_folder, name), "rb") as a, open(
            os.path.join(tdrm.robot_description_folder, name), "rb"
        ) as b:
            assert a.read() == b.read(), name


@pytest.mark.filterwarnings("ignore:No dynamics information")
@pytest.mark.parametrize("urdf", URDFS)
def test_struct_equals_jax_struct_f64(urdf):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    ts = tdrm.robot_struct_from_urdf(
        os.path.join(tdrm.robot_description_folder, urdf), dtype=torch.float64, device="cpu"
    )
    for f in STATIC_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f
    for f in ARRAY_FIELDS:
        j, t = np.asarray(getattr(js, f)), getattr(ts, f).numpy()
        assert t.dtype == np.float64 and t.shape == j.shape, f
        np.testing.assert_array_equal(t, j, err_msg=f)
    # Carried across through struct_from_arrays: the same struct again.
    carried = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    assert carried.static() == ts.static()
    for f in ARRAY_FIELDS:
        assert torch.equal(getattr(carried, f), getattr(ts, f)), f


def test_lie_matches_jax_f64():
    rng = np.random.default_rng(0)
    rpy = rng.uniform(-3, 3, (16, 3))
    axis = rng.normal(size=(16, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    angle = rng.uniform(-3, 3, 16)
    R_t = tlie.rpy_to_matrix(torch.from_numpy(rpy))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(jlie.rpy_to_matrix(jnp.asarray(rpy))), atol=1e-12)
    Ra_t = tlie.axis_angle_to_matrix(torch.from_numpy(axis), torch.from_numpy(angle))
    Ra_j = jlie.axis_angle_to_matrix(jnp.asarray(axis), jnp.asarray(angle))
    np.testing.assert_allclose(Ra_t.numpy(), np.asarray(Ra_j), atol=1e-12)
    # All four quaternion branches: composite rotations near each axis flip.
    Rs = np.concatenate([R_t.numpy(), np.asarray(Ra_j), np.diag([1.0, -1, -1])[None],
                         np.diag([-1.0, 1, -1])[None], np.diag([-1.0, -1, 1])[None]])
    q_t = tlie.matrix_to_quaternion(torch.from_numpy(Rs)).numpy()
    q_j = np.asarray(jlie.matrix_to_quaternion(jnp.asarray(Rs)))
    np.testing.assert_allclose(q_t, q_j, atol=1e-12)


def test_model_fk_matches_jax_f64():
    jm = jdrm.DifferentiableFrankaPanda(dtype=jnp.float64)
    tm = tdrm.DifferentiableFrankaPanda(dtype=torch.float64, device="cpu")
    q = np.random.default_rng(1).uniform(-2, 2, (5, 7))
    for link in ("panda_link3", "panda_virtual_ee_link"):
        pj, qj = jm.compute_forward_kinematics(q, link)
        pt, qt = tm.compute_forward_kinematics(torch.from_numpy(q), link)
        np.testing.assert_allclose(pt.numpy(), np.asarray(pj), atol=1e-12)
        np.testing.assert_allclose(qt.numpy(), np.asarray(qj), atol=1e-12)
    assert tm.get_link_names() == jm.get_link_names()
    assert tm.get_joint_limits() == jm.get_joint_limits()
    assert tm.n_dofs == jm.n_dofs == 7
    with pytest.raises(KeyError):
        tm.compute_forward_kinematics(torch.zeros(7, dtype=torch.float64), "no_such_link")


def test_constructor_device_defaults_to_cuda():
    if torch.cuda.is_available():
        assert tdrm.DifferentiableKUKAiiwa().struct.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdrm.DifferentiableKUKAiiwa()
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tdrm.robot_struct_from_urdf(os.path.join(tdrm.robot_description_folder, URDFS[0]))
    m = tdrm.DifferentiableKUKAiiwa(device="cpu")
    assert m.struct.device.type == "cpu"
    assert m.to(torch.float64).struct.dtype == torch.float64


def test_kernel_constants_follow_in_place_writes_to_the_robot():
    m = tdrm.DifferentiableKUKAiiwa(dtype=torch.float64, device="cpu")
    flags = StepFlags()
    tree = tree_struct(m.struct, flags)
    assert tree_struct(m.struct, flags) is tree  # kept while nothing changes
    mass0 = [tree.link[l].mass for l in range(tree.n)]
    assert max(mass0) > 0
    m.mass.mul_(2.0)
    tree = tree_struct(m.struct, flags)
    assert [tree.link[l].mass for l in range(tree.n)] == [2.0 * x for x in mass0]
    m.damping.zero_()
    assert list(tree_struct(m.struct, flags).damping[: m.n_dofs]) == [0.0] * m.n_dofs
    state = m.state_dict()
    state["limit_effort"] = torch.full((m.n_dofs,), 1.5, dtype=torch.float64)
    m.load_state_dict(state)
    assert [j["effort"] for j in m.get_joint_limits()] == [1.5] * m.n_dofs
    assert list(tree_struct(m.struct, flags).emax[: m.n_dofs]) == [1.5] * m.n_dofs


def test_port_imports_no_jax_and_names_no_jax_module():
    code = (
        "import sys; import differentiable_robot_model_tpu_torch as p; "
        "import differentiable_robot_model_tpu_torch.trajopt.mpc; "
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
        "or m == 'differentiable_robot_model_tpu' or m.startswith('differentiable_robot_model_tpu.')]; "
        "print(bad); sys.exit(1 if bad else 0)"
    )
    run = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=os.path.dirname(PORT_DIR))
    assert run.returncode == 0, run.stdout + run.stderr
    jax_name = re.compile(r"differentiable_robot_model_tpu(?!_torch)")
    sources = [p for ext in ("py", "cu", "cuh")
               for p in glob.glob(os.path.join(PORT_DIR, "**", f"*.{ext}"), recursive=True)]
    assert len(sources) > 10
    for path in sources:
        with open(path) as f:
            text = f.read()
        assert not jax_name.search(text), path
        assert not re.search(r"^\s*(import|from)\s+jax\b", text, re.M), path
