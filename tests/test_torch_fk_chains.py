"""K1/K2's host side and K2's plain version on every bundled chain.

- each chain link's axis kind (`ops/kernels/fk.py::axis_kind`, the `axis`
  field of csrc/chain.cuh's ChainLink) for iiwa, trifinger_edu,
  panda_with_gripper's right finger and iiwa with one unit general axis;
- the ctypes mirror of `Chain<T>` with that field, at the offsets and sizes
  the C struct has (the kernels' `fk_layout` checks the sizes on the card);
- the plain K2 (`fk_position_dof_major_vjp_reference`, one sweep with each
  revolute joint's w = g x z and b = o.w kept) against jax.vjp of the JAX
  package's `fk_link_position_dof_first` in float64 to 1e-9, on
  panda_with_gripper's right finger (a prismatic -y joint after the arm's
  +z ones) and on the general-axis struct's chain to iiwa_link_7 (a chain
  that ends on a revolute joint, whose row is 0). tests/test_torch_fk.py
  holds it so on iiwa, fetch_full's gripper (+-x, y, z and two prismatic
  joints) and trifinger_edu (-x); the other bundled chains take no other
  kind of joint or axis, and JAX's eager VJP costs 1-3 s a robot here;
- the plain K2 in float32 against the JAX package's Pallas kernel
  `_bwd_kernel` run in interpret mode, to the existing 1e-5, on the
  general-axis struct (the general rotation; iiwa's +z chain is held so in
  tests/test_torch_fk.py);
- `fk_bwd` refuses a revolute axis on the chain that is not of unit length
  (ROADMAP W6) and takes a unit general one.

The kernels themselves run only on a CUDA card: chip_smoke.py holds them
against these plain versions there.
"""

import ctypes
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import differentiable_robot_model_tpu as jdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.ops import kinematics as JK
from differentiable_robot_model_tpu.ops.pallas.fk import fk_position_dof_major as j_fk_dm
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.kernels import fk as tfk

GENERAL_AXIS = (0.6, 0.8, 0.0)  # iiwa's joint 4 (link 4) in the general-axis struct


def _pair(urdf, dtype, axis_of_link4=None):
    """The robot in both packages; with `axis_of_link4`, link 4's axis set to
    it (and its static axis code cleared) in both."""
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    if axis_of_link4 is not None:
        codes = list(js.axis_code)
        codes[4] = None
        js = dataclasses.replace(js, axis=js.axis.at[4].set(jnp.asarray(axis_of_link4)),
                                 axis_code=tuple(codes))
    js = js.astype(dtype)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts


@pytest.mark.filterwarnings("ignore:No dynamics information")
@pytest.mark.parametrize("urdf, link, kinds", [
    ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee", (3, 3, 3, 3, 3, 3, 3, 0)),
    ("trifinger_edu.urdf", "finger_tip_link_0", (0, 0, -1, 2, 2, 0)),
    ("panda_with_gripper.urdf", "panda_rightfinger", (3,) * 7 + (0, 0, -2)),
    ("general", "iiwa_link_ee", (3, 3, 3, 0, 3, 3, 3, 0)),
])
def test_axis_kind_of_every_chain_link(urdf, link, kinds):
    general = urdf == "general"
    _, ts = _pair("kuka_iiwa_iiwa7.urdf" if general else urdf, jnp.float64,
                  GENERAL_AXIS if general else None)
    consts = tfk.chain_constants(ts, ts.link_index(link))
    assert consts.axes == kinds
    # fixed links have the zero axis and the general kind
    assert all(k == tfk.AXIS_GENERAL for k, jt in zip(consts.axes, consts.types) if jt == 0)


def test_chain_ctypes_layout_has_the_axis_field():
    for dtype, width, link_size, chain_size in ((torch.float32, 4, 84, 1356),
                                                (torch.float64, 8, 160, 2576)):
        Chain = tfk.CHAIN_CTYPES[dtype]
        Link = dict(Chain._fields_)["link"]._type_
        offsets = {name: getattr(Link, name).offset for name, _ in Link._fields_}
        assert (offsets["type"], offsets["dof"], offsets["axis"]) == (0, 4, 8)
        # F after the three ints (and float64's 4 bytes of padding)
        assert offsets["F"] == (12 if width == 4 else 16)
        assert offsets["t"] == offsets["F"] + 15 * width
        assert (ctypes.sizeof(Link), ctypes.sizeof(Chain)) == (link_size, chain_size)
    _, ts = _pair("panda_with_gripper.urdf", jnp.float32)
    link = ts.link_index("panda_rightfinger")
    ch, consts = tfk.chain_struct(ts, link), tfk.chain_constants(ts, link)
    assert ch.n == len(consts.axes)
    assert [ch.link[k].axis for k in range(ch.n)] == list(consts.axes)
    assert all(ch.link[k].axis == 0 for k in range(ch.n, tfk.MAX_CHAIN))


@pytest.mark.filterwarnings("ignore:No dynamics information")
@pytest.mark.parametrize("urdf, link", [("panda_with_gripper.urdf", "panda_rightfinger"),
                                        ("general", "iiwa_link_7")])
def test_plain_k2_matches_jax_vjp_f64(urdf, link):
    general = urdf == "general"
    js, ts = _pair("kuka_iiwa_iiwa7.urdf" if general else urdf, jnp.float64,
                   GENERAL_AXIS if general else None)
    link = ts.link_index(link)
    rng = np.random.default_rng(7)
    q = rng.uniform(-2.5, 2.5, (js.n_dofs, 9))
    g = rng.normal(size=(3, 9))
    _, pull = jax.vjp(lambda x: JK.fk_link_position_dof_first(js, x, link), jnp.asarray(q))
    (dq_ref,) = pull(jnp.asarray(g))
    dq = tfk.fk_position_dof_major_vjp_reference(ts, torch.from_numpy(q), torch.from_numpy(g), link)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), rtol=0, atol=1e-9)
    off = [d for d in range(ts.n_dofs) if d not in tfk.chain_constants(ts, link).dofs]
    assert np.all(dq.numpy()[off] == 0)


def test_plain_k2_matches_jax_pallas_f32():
    js, ts = _pair("kuka_iiwa_iiwa7.urdf", jnp.float32, GENERAL_AXIS)
    link = ts.link_index("iiwa_link_ee")
    rng = np.random.default_rng(8)
    q = rng.uniform(-2.5, 2.5, (js.n_dofs, 200)).astype(np.float32)
    g = rng.normal(size=(3, 200)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, pull = jax.vjp(lambda x: j_fk_dm(js, x, link), jnp.asarray(q))
        (dq_j,) = pull(jnp.asarray(g))
    dq = tfk.fk_position_dof_major_vjp_reference(ts, torch.from_numpy(q), torch.from_numpy(g), link)
    # both sides sum ~7 terms of size |g||r| <= ~3 in float32
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_j), rtol=0, atol=1e-5)


def test_fk_bwd_refuses_axes_off_unit_length():
    _, ts = _pair("kuka_iiwa_iiwa7.urdf", jnp.float64)
    ee = ts.link_index("iiwa_link_ee")
    q, g = torch.zeros(7, 3, dtype=torch.float64), torch.ones(3, 3, dtype=torch.float64)
    arrays = {k: v.copy() for k, v in ts.numpy().items()}
    arrays["axis"][4] = (0.0, 0.0, 1.1)
    long_axis = struct_from_arrays(arrays, ts.static(), device="cpu")
    with pytest.raises(ValueError, match="fk_bwd needs unit joint axes.*length 1.1"):
        tfk.fk_bwd(long_axis, q, g, ee)
    arrays["axis"][4] = GENERAL_AXIS
    general = struct_from_arrays(arrays, ts.static(), device="cpu")
    dq = tfk.fk_bwd(general, q, g, ee)
    assert dq.shape == (7, 3) and torch.isfinite(dq).all()
