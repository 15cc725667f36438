"""The port's learnable-parameter overlay, its routing and K4's learnable
launch, without a card.

The registrations and their errors, freezing, the dof-indexed damping and
the inertia written into `inertia_com` follow the JAX package's
`LearnableSet` (tests/test_learnable.py); `set_parameters` takes the JAX
package's parameters as numpy. `RobotStruct.with_arrays` recomputes the
zero and axis hints from an overlay's values, and clears them where the
overlay requires grad. Inverse dynamics routes as the JAX package routes it
(W5) and the solvers' "auto" engines take the plain engines for a robot
whose tensors require grad. K4's learnable launch sends the template of
the topology (built without reading a tensor: the struct's tensors here
are on the meta device) and the link tensors' pointers, in the order the
library declares; the robot VJP's per-block scratch holds a row a block of
its grid; the flat robot cotangent maps onto the fields.
"""

import ctypes
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu.models import parametrizations as jp
from differentiable_robot_model_tpu_torch.models import parametrizations as tp
from differentiable_robot_model_tpu_torch.models import robot as trobot
from differentiable_robot_model_tpu_torch.models.structs import ARRAY_FIELDS, RobotStruct
from differentiable_robot_model_tpu_torch.ops.kernels import rnea as kn
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr
from differentiable_robot_model_tpu_torch.trajopt import solvers as ts

M = np.array([[0.05, 0.001, 0.002], [0.001, 0.06, 0.003], [0.002, 0.003, 0.03]])


def _iiwa(dtype=torch.float64):
    return drt.DifferentiableKUKAiiwa(dtype=dtype, device="cpu")


def test_invalid_registrations():
    m = _iiwa()
    with pytest.raises(AttributeError, match="Invalid parameter name"):
        m.make_link_param_learnable("iiwa_link_3", "bogus", tp.PositiveScalar())
    with pytest.raises(KeyError, match="Unknown link"):
        m.make_link_param_learnable("no_link", "mass", tp.PositiveScalar())
    with pytest.raises(ValueError, match="no actuated joint"):
        m.make_link_param_learnable("iiwa_link_ee", "joint_damping", tp.PositiveScalar())
    with pytest.raises(KeyError, match="not learnable"):
        m.freeze_learnable_link_param("iiwa_link_3", "mass")


def test_freeze_unfreeze():
    m = _iiwa()
    m.make_link_param_learnable("iiwa_link_3", "mass", tp.PositiveScalar(init_param=2.0))
    m.make_link_param_learnable("iiwa_link_4", "com", tp.UnconstrainedTensor((3,), init_std=0.01))
    assert set(m.learnable_parameters()) == {"iiwa_link_3.mass", "iiwa_link_4.com"}
    m.freeze_learnable_link_param("iiwa_link_3", "mass")
    assert set(m.learnable_parameters()) == {"iiwa_link_4.com"}
    assert [p.requires_grad for p in m.parameters()] == [False, True]  # both stay registered
    l3 = m.get_link_names().index("iiwa_link_3")
    assert float(m.struct.mass[l3].detach()) == pytest.approx(2.0, abs=1e-12)  # a frozen value still applies
    m.unfreeze_learnable_link_param("iiwa_link_3", "mass")
    assert set(m.learnable_parameters()) == {"iiwa_link_3.mass", "iiwa_link_4.com"}
    assert all(p.requires_grad for p in m.parameters())


def test_damping_by_dof_and_inertia_into_inertia_com():
    m = _iiwa()
    m.make_link_param_learnable("iiwa_link_2", "joint_damping", tp.PositiveScalar(init_param=0.7))
    m.make_link_param_learnable("iiwa_link_5", "inertia_mat",
                                tp.TriangParam3DInertiaMatrix(bias=1e-4, init_param=M))
    s = m.struct
    names = m.get_link_names()
    assert float(s.damping[s.dof_links.index(names.index("iiwa_link_2"))].detach()) == pytest.approx(0.7)
    np.testing.assert_allclose(s.inertia_com[names.index("iiwa_link_5")].detach().numpy(), M,
                               atol=1e-12)
    assert s.damping.requires_grad and s.inertia_com.requires_grad and not s.mass.requires_grad


def test_set_parameters_takes_jax_parameters():
    """The carry-across: the JAX package's parameter dict, as numpy, goes
    into `set_parameters` and gives the same struct arrays."""
    jm = jdrm.DifferentiableKUKAiiwa(dtype=jnp.float64)
    tm = _iiwa()
    for m, P in ((jm, jp), (tm, tp)):
        rng = np.random.default_rng(1)
        m.make_link_param_learnable("iiwa_link_3", "mass", P.PositiveScalar(rng=rng))
        m.make_link_param_learnable("iiwa_link_3", "inertia_mat",
                                    P.TriangParam3DInertiaMatrix(bias=1e-4, rng=rng))
        m.make_link_param_learnable("iiwa_link_6", "rot_angles", P.UnconstrainedTensor((3,), rng=rng))
    rng = np.random.default_rng(2)
    new = jax.tree_util.tree_map(lambda v: np.asarray(v) + rng.uniform(-0.1, 0.1, np.shape(v)),
                                 jm.parameters())
    jm.set_parameters(new)
    tm.set_parameters(new)
    js, s = jm.struct, tm.struct
    for f in ("mass", "inertia_com", "rot_angles"):
        np.testing.assert_allclose(getattr(s, f).detach().numpy(), np.asarray(getattr(js, f)),
                                   rtol=1e-12, atol=1e-15)


def test_with_arrays_keeps_the_hints_true():
    s = _iiwa().struct
    assert s.trans_zero[1] == (True, True, False) and s.rpy_zero[1]
    trans = s.trans.clone()
    trans[1] = torch.tensor([0.1, 0.0, 0.0])
    rpy = s.rot_angles.clone()
    rpy[1, 2] = 0.3
    axis = s.axis.clone()
    axis[1] = torch.tensor([0.0, 1.0, 0.0])
    t = s.with_arrays(trans=trans, rot_angles=rpy, axis=axis)
    assert t.trans_zero[1] == (False, True, True) and not t.rpy_zero[1]
    assert t.axis_code[1] == (1, 1) and t.axis_code[2] == s.axis_code[2]
    assert t.mass is s.mass
    g = s.with_arrays(trans=s.trans.clone().requires_grad_(True),
                      rot_angles=s.rot_angles.clone().requires_grad_(True))
    assert g.trans_zero == ((False,) * 3,) * s.n_links and g.rpy_zero == (False,) * s.n_links
    assert g.axis_code == s.axis_code


@pytest.mark.parametrize("id_impl,learnable,on_cuda,route", [
    ("auto", False, True, "kernel"),
    ("auto", True, True, "scalar"),
    ("auto", False, False, "scalar"),
    ("auto", True, False, "scalar"),
    ("kernel", False, True, "kernel"),
    ("kernel", True, True, "kernel_learnable"),
    ("kernel", True, False, "kernel_learnable"),
    ("scalar", True, True, "scalar"),
    ("scalar", False, True, "scalar"),
])
def test_id_routes_as_jax(id_impl, learnable, on_cuda, route):
    assert trobot.id_route(id_impl, learnable, on_cuda) == route


def test_model_calls_the_routed_entry(monkeypatch):
    calls = []
    for name in ("rnea", "rnea_learnable"):
        monkeypatch.setattr(trobot, name, lambda s, *a, _n=name: calls.append(_n) or a[0] * 0)
    m = _iiwa()
    q = np.zeros((2, 7))
    m.compute_inverse_dynamics(q, q, q, id_impl="kernel")
    m.compute_inverse_dynamics(q, q, q, id_impl="kernel", params={})
    m.make_link_param_learnable("iiwa_link_3", "mass", tp.PositiveScalar(init_param=2.0))
    m.compute_inverse_dynamics(q, q, q, id_impl="kernel")
    m.compute_inverse_dynamics(q, q, q)  # auto, CPU
    assert calls == ["rnea", "rnea_learnable", "rnea_learnable"]
    with pytest.raises(ValueError, match="id_impl"):
        m.compute_inverse_dynamics(q, q, q, id_impl="pallas")


def test_solvers_auto_take_plain_engines_for_a_grad_robot():
    for grad, kin, dyn, mppi in ((False, "fused", "fused", "fused"), (True, "scalar", "scan", "scan")):
        robot = types.SimpleNamespace(device=torch.device("cuda"), dtype=torch.float32,
                                      requires_grad=grad)
        assert ts.resolve_engine("auto", robot, 10, 5) == kin
        assert ts.resolve_dynamic_engine("auto", robot, 5) == dyn
        assert ts.resolve_mppi_engine("auto", robot, 64, False, True) == mppi
        # explicit kernel engines take the plain path for a grad robot, as JAX's do (W7)
        for engine in ("kernel", "fused"):
            assert ts.resolve_engine(engine, robot, 10, 5) == (kin if grad else engine)
            assert ts.resolve_dynamic_engine(engine, robot, 5) == (dyn if grad else engine)
            assert ts.resolve_mppi_engine(engine, robot, 64, False, True) == (mppi if grad else engine)


def test_explicit_kernel_engines_refuse_a_grad_robot():
    m = _iiwa()
    m.make_link_param_learnable("iiwa_link_3", "mass", tp.PositiveScalar(init_param=2.0))
    with pytest.raises(ValueError, match="requires grad"):
        kr.tree_struct(m.struct, kr.StepFlags(0.02))
    s = m.struct
    with pytest.raises(ValueError, match="axis requires grad"):
        kn.rnea_learnable(s.with_arrays(axis=s.axis.clone().requires_grad_(True)),
                          *(torch.zeros((2, 7), dtype=torch.float64),) * 3)


def test_rnea_bwd_learnable_checks_unit_axes_first():
    s = _iiwa().struct
    axis = s.axis.clone()
    axis[3] = axis[3] * 1.5
    x = torch.zeros((2, 7), dtype=torch.float64)
    with pytest.raises(ValueError, match="unit joint axes"):
        kn.rnea_bwd_learnable(s.with_arrays(axis=axis), x, x, x, x)


def _meta(struct: RobotStruct) -> RobotStruct:
    return RobotStruct(**{f: torch.empty_like(getattr(struct, f), device="meta") for f in ARRAY_FIELDS},
                       **struct.static())


@pytest.mark.parametrize("cls", ["DifferentiableKUKAiiwa", "DifferentiablePandaWithGripper"])
def test_template_reads_no_tensor(cls):
    s = getattr(drt, cls)(device="cpu").struct
    flags = kr.StepFlags(0.0, use_damping=False, include_gravity=True)
    tmpl = kn.tree_template(_meta(s), flags)
    full = kr._tree_struct(s, flags)
    for f in ("n", "D", "use_damping", "dt", "gravity"):
        assert getattr(tmpl, f) == getattr(full, f)
    for d in range(s.n_dofs):
        assert (tmpl.dof_link[d], tmpl.anc[d]) == (full.dof_link[d], full.anc[d])
    for l in range(s.n_links):
        a, b = tmpl.link[l], full.link[l]
        assert (a.parent, a.type, a.dof) == (b.parent, b.type, b.dof)
        assert a.mass == 0.0 and list(a.F) == [0.0] * 9


class _Entry:
    argtypes = restype = None

    def __call__(self, sizes):
        layout = [ctypes.sizeof(kr.TREE_CTYPES[t]) for t in (torch.float32, torch.float64)]
        layout += [kr.MAX_LINKS] + [x for shape in kr.SERIAL_SHAPES for x in shape]
        layout += [16, 4096]  # a learnable launch's fewest scenarios a block, most blocks
        sizes[:len(layout)] = layout


class _Library:
    def __init__(self):
        self.entries = {}

    def __getattr__(self, name):
        return self.entries.setdefault(name, _Entry())


def test_learnable_launch_sends_the_link_tensors(monkeypatch):
    lib = _Library()
    kn._configure(lib)
    calls = []
    monkeypatch.setattr(kn, "_launch", lambda name, args, dev: calls.append((name, args)))
    s = drt.DifferentiablePandaWithGripper(device="cpu").struct
    B, D = 6, s.n_dofs
    ins = tuple((n, torch.zeros((B, D))) for n in ("q", "qd", "qdd", "g"))
    cols = kn.robot_cotangent_size(s)
    outs = tuple(torch.empty((B, D)) for _ in range(3)) + (
        torch.empty((kn.learnable_rows(B), cols)), torch.empty(cols))
    flags = kr.StepFlags(0.0)
    assert kn._learnable_launch("rnea_fwd_learnable", s, flags, ins[:3], outs[:1])
    assert kn._learnable_launch("rnea_bwd_learnable", s, flags, ins, outs)
    assert not kn._learnable_launch("rnea_fwd_learnable", s, flags,
                                    tuple((n, x[:0]) for n, x in ins[:3]), outs[:1])
    links = tuple(getattr(s, f).data_ptr() for f in
                  ("trans", "rot_angles", "axis", "mass", "com", "inertia_com", "damping"))
    for (name, args), n_in, n_out, kernel in zip(calls, (3, 4), (1, 5), ("fwd", "bwd")):
        assert name == f"rnea_{kernel}_learnable_f32"
        assert args[0] == kr.VARIANTS.index("generic16")
        assert args[1]._obj is kn.tree_template(s, flags)
        assert args[2:9] == links
        assert args[9:-1] == tuple(x.data_ptr() for _, x in ins[:n_in]) + tuple(
            y.data_ptr() for y in outs[:n_out])
        assert args[-1] == B
        types_ = lib.entries[name].argtypes
        assert len(types_) == len(args) + 1 and types_[-2:] == [ctypes.c_int64, ctypes.c_void_p]
    fn = lib.entries["rnea_learnable_one_thread_from"]
    assert fn.argtypes == [] and fn.restype is ctypes.c_int64


@pytest.mark.parametrize("B, rows", [(1, 1), (16, 1), (17, 2), (250, 16), (65536, 4096), (10**7, 4096)])
def test_learnable_rows_cover_the_grid(B, rows):
    # the library's layout: a block takes at least 16 scenarios, a grid at
    # most 4096 blocks; one row of the robot VJP's scratch a block
    kn._configure(_Library())
    assert kn.learnable_rows(B) == rows


def test_robot_cotangent_rows():
    # the flat cotangent the VJP's last launch writes, built from the plain
    # version's dict in its order, maps back onto the fields
    s = _iiwa().struct
    L, D = s.n_links, s.n_dofs
    rng = np.random.default_rng(0)
    x = [torch.from_numpy(rng.uniform(-1, 1, (4, D))) for _ in range(4)]
    ref = kn.rnea_bwd_learnable_reference(s, *x)[3]
    order = ("trans", "rot_angles", "mass", "com", "inertia_com", "damping")
    flat = torch.cat([ref[f].reshape(-1) for f in order])
    assert flat.numel() == kn.robot_cotangent_size(s) == 19 * L + D
    c = kn.robot_cotangent(s, flat)
    assert list(c) == list(kn.ROBOT_FIELDS)
    for f in kn.ROBOT_FIELDS:
        assert c[f].shape == ref[f].shape
        torch.testing.assert_close(c[f], ref[f], rtol=0, atol=0)
    np.testing.assert_array_equal(c["inertia_com"].numpy()[:, [1, 2, 2], [0, 0, 1]], 0.0)
