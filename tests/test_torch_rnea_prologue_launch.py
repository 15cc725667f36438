"""K4 `rnea_fwd` and the `dyn_prologue` kernel: the launch routing, and the
prologue's plain version against the JAX package.

Both kernels run on the instantiation `kernel_variant` picks, as
`rnea_bwd` and K5-K10 do: serial chains of a built shape (iiwa,
panda_no_gripper, fetch_arm, the 2-link robot) on `DrmSerial`, every other
robot on the generic 16- or 32-link build. Their launch is checked for each
of the 13 bundled URDFs (the variant table of
tests/test_torch_rnea_reverse.py) without a card: the arguments the
wrappers hand the library (the variant's code, the by-value tree, the
pointers, H, the precondition flag and B) against the entries' declarations
in `_configure` and `_configure_dyn`.

The prologue's plain version `dyn_prologue_reference`, the CPU path and the
kernel's yardstick on the card, is held in float64 at 1e-9 to the JAX
functions the JAX solver's eager prologue runs (solvers.py:424-425 and
:500-502): `rnea_scalar` at qd = qdd = 0, `mass_matrix_scalar` (the plain
mass matrix, with no damping term on its diagonal) and `ldl_solve_scalar`,
on iiwa, the 2-link robot and a tree, with the preconditioner on and off
and the warm start given or not.
"""

import ctypes
import functools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rnea_reverse import EXPECTED_VARIANT

import differentiable_robot_model_tpu as jdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.ops.dynamics_scalar import (
    ldl_solve_scalar as j_ldl_solve,
    mass_matrix_scalar as j_mass_matrix,
    rnea_scalar as j_rnea,
)
from differentiable_robot_model_tpu_torch.models.robot import robot_description_folder
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.models.urdf import robot_struct_from_urdf
from differentiable_robot_model_tpu_torch.ops.kernels import rnea as kn
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ksolver

B, H = 6, 5


class _Entry:
    """An entry of a library: `_configure` sets its declaration; called as a
    layout query, it answers what Python expects, so that only the
    declarations are under test."""

    argtypes = restype = None

    def __init__(self, layout):
        self.layout = layout

    def __call__(self, sizes):
        sizes[:len(self.layout)] = self.layout


class _Library:
    """Stands in for a built csrc/*.cu."""

    def __init__(self, layout):
        self.layout = layout
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _Entry(self.layout))


@functools.lru_cache(maxsize=None)
def _declared(source):
    trees = [ctypes.sizeof(kr.TREE_CTYPES[t]) for t in (torch.float32, torch.float64)]
    shapes = [x for shape in kr.SERIAL_SHAPES for x in shape]
    if source == "rnea":
        lib = _Library(trees + [kr.MAX_LINKS] + shapes)
        kn._configure(lib)
    else:
        lib = _Library(trees + [ctypes.sizeof(kr.CHAIN_CTYPES[torch.float32]),
                                ctypes.sizeof(ksolver._DynSolveParams)] + shapes)
        ksolver._configure_dyn(lib)
    return lib.entries


def _check_declared(source, name, args, n_ptrs, ints_after):
    """args against the entry's declaration: the variant code (int), the
    tree (a pointer), n_ptrs pointers, the ints `ints_after`, B (int64) and
    the stream."""
    types = _declared(source)[name].argtypes
    assert len(types) == len(args) + 1 and types[-1] is ctypes.c_void_p
    assert types[0] is ctypes.c_int and isinstance(args[0], int)
    assert types[1:2 + n_ptrs] == [ctypes.c_void_p] * (1 + n_ptrs)
    assert types[2 + n_ptrs:-2] == [ctypes.c_int] * len(ints_after)
    assert types[-2] is ctypes.c_int64 and args[-1] == B
    assert args[2 + n_ptrs:-1] == ints_after


@pytest.mark.filterwarnings("ignore:No dynamics information")
@pytest.mark.parametrize("urdf", sorted(EXPECTED_VARIANT))
def test_launches_route_by_variant(urdf, monkeypatch):
    assert sorted(EXPECTED_VARIANT) == sorted(
        f for f in os.listdir(robot_description_folder) if f.endswith(".urdf"))
    s = robot_struct_from_urdf(os.path.join(robot_description_folder, urdf), device="cpu")
    D = s.n_dofs
    variant = kr.VARIANTS.index(EXPECTED_VARIANT[urdf])
    calls = []
    record = lambda name, args, dev: calls.append((name, args, dev))
    monkeypatch.setattr(kn, "_launch", record)
    monkeypatch.setattr(ksolver, "_launch_dyn", record)

    ins = tuple((n, torch.zeros((B, D))) for n in ("q", "qd", "qdd"))
    tau = torch.empty((B, D))
    assert kn._rnea_launch("rnea_fwd", s, kr.StepFlags(0.0), ins, (tau,))
    assert not kn._rnea_launch("rnea_fwd", s, kr.StepFlags(0.0), tuple((n, x[:0]) for n, x in ins),
                               (tau[:0],))
    (name, args, dev), = calls
    assert name == "rnea_fwd_f32" and args[0] == variant and dev == tau.device
    assert type(args[1]._obj) is kr.TREE_CTYPES[torch.float32]
    assert args[2:-1] == tuple(x.data_ptr() for x in (*(x for _, x in ins), tau))
    _check_declared("rnea", name, args, 4, ())

    q0T, init = torch.zeros((D, B), dtype=torch.float64), torch.zeros((H, D, B), dtype=torch.float64)
    s64 = s.to(dtype=torch.float64)
    for ini, pre in ((init, True), (None, False)):
        calls.clear()
        outs = (torch.empty((D, B), dtype=torch.float64),
                torch.empty((D, D, B), dtype=torch.float64) if pre else None,
                torch.empty((H, D, B), dtype=torch.float64))
        ksolver._prologue_launch(s64, q0T, ini, H, pre, outs)
        (name, args, dev), = calls
        assert name == "dyn_prologue_f64" and args[0] == variant and dev == q0T.device
        assert type(args[1]._obj) is kr.TREE_CTYPES[torch.float64]
        ptr = lambda x: None if x is None else x.data_ptr()
        assert args[2:7] == (q0T.data_ptr(), ptr(ini), *(ptr(x) for x in outs))
        _check_declared("dyn_solve", name, args, 5, (H, int(pre)))


@functools.lru_cache(maxsize=None)
def _structs(urdf):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts


def _jax_prologue(js, q0, init):
    """tau_ref, H0 and the preconditioned a0 as the JAX solver's eager
    prologue computes them (solvers.py:424-425, :500-502)."""
    z = jnp.zeros_like(q0)
    tau_ref = j_rnea(js, q0, z, z)
    H0 = j_mass_matrix(js, q0)
    a0 = j_ldl_solve(H0, (init - tau_ref[None]).transpose(1, 0, 2)).transpose(1, 0, 2)
    return np.asarray(tau_ref), np.asarray(H0), np.asarray(a0)


def _close(t, j, tol=1e-9):
    scale = max(1.0, float(np.abs(j).max()))
    np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=tol * scale)


@pytest.mark.parametrize("urdf", ["kuka_iiwa_iiwa7.urdf", "2link_robot.urdf", "panda_with_gripper.urdf"])
def test_plain_prologue_matches_jax_f64(urdf):
    js, ts = _structs(urdf)
    D = js.n_dofs
    rng = np.random.default_rng(13)
    q0 = rng.uniform(-0.5, 0.5, (D, B))
    init = rng.uniform(-5.0, 5.0, (H, D, B))
    j_tau, j_H0, j_a0 = _jax_prologue(js, jnp.asarray(q0), jnp.asarray(init))
    for pre in (True, False):
        for warm in (True, False):
            tau, H0, a0 = ksolver.dyn_prologue(ts, torch.tensor(q0), torch.tensor(init) if warm else None,
                                               H, precondition=pre)
            _close(tau, j_tau)
            if pre:
                _close(H0, j_H0)
            else:
                assert H0 is None
            want = (j_a0 if pre else init - j_tau[None]) if warm else np.zeros((H, D, B))
            _close(a0, want)


def test_prologue_mass_matrix_carries_no_damping():
    """H0 is M(q0) itself: iiwa's joints are damped (0.5 N m s/rad), and the
    step's Ĥ = M + dt diag(d) sits 0.01 off it on the diagonal at dt = 0.02,
    far past the 1e-9 the prologue is held to."""
    js, ts = _structs("kuka_iiwa_iiwa7.urdf")
    damping = ts.damping.numpy()
    assert np.all(damping > 0)
    q0 = np.random.default_rng(17).uniform(-0.5, 0.5, (js.n_dofs, B))
    _, H0, _ = ksolver.dyn_prologue(ts, torch.tensor(q0), None, H)
    M = np.asarray(j_mass_matrix(js, jnp.asarray(q0)))
    _close(H0, M)
    damped = M + 0.02 * np.einsum("ij,b->ijb", np.diag(damping), np.ones(B))
    assert np.abs(H0.numpy() - damped).max() > 1e-3
