"""The port's chain FK against the JAX package's.

- the plain scalar FK (model API and scalar engine) in float64 to 1e-9 on a
  serial arm (iiwa), a robot with prismatic joints (fetch_full) and a
  branched tree (trifinger_edu);
- the plain versions of kernels K1/K2 against the JAX package's
  `fk_position_dof_major` run through its Pallas kernels in interpret mode,
  float32 iiwa, values to 2e-6;
- the `FkPositionDofMajor` entry (K1 forward, K2 backward) on the CPU.

The kernels themselves run only on a CUDA card: chip_smoke.py holds them
against these plain versions there.
"""

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
from differentiable_robot_model_tpu_torch.ops import kinematics as TK
from differentiable_robot_model_tpu_torch.ops.kernels import fk as tfk

ROBOTS = {
    "iiwa": ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee"),
    "fetch_full": ("fetch_full.urdf", "gripper_link"),
    "trifinger_edu": ("trifinger_edu.urdf", "finger_tip_link_120"),
}


def _structs(robot, dtype):
    """The same robot in both packages (JAX struct cast with astype)."""
    urdf, ee = ROBOTS[robot]
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    js = js.astype(dtype)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.link_index(ee)


@pytest.mark.filterwarnings("ignore:No dynamics information")
@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_plain_fk_matches_jax_f64(robot):
    js, ts, ee = _structs(robot, jnp.float64)
    q = np.random.default_rng(3).uniform(-1.5, 1.5, (js.n_dofs, 37))
    ref = np.asarray(JK.fk_link_position_dof_first(js, jnp.asarray(q), ee))
    qt = torch.from_numpy(q)
    np.testing.assert_allclose(TK.fk_link_position_dof_first(ts, qt, ee).numpy(), ref, atol=1e-9)
    np.testing.assert_allclose(tfk.fk_position_dof_major_reference(ts, qt, ee).numpy(), ref, atol=1e-9)
    np.testing.assert_allclose(TK.fk_link_position(ts, qt.T, ee).numpy(), ref.T, atol=1e-9)
    R, p = TK.fk_world_scalar(ts, qt.T)
    Rj, pj = jax.vmap(lambda x: JK.fk_world_scalar(js, x))(jnp.asarray(q.T))
    np.testing.assert_allclose(p.numpy(), np.asarray(pj), atol=1e-9)
    np.testing.assert_allclose(R.numpy(), np.asarray(Rj), atol=1e-9)
    # K2's plain version against autograd of the JAX scalar FK.
    g = np.random.default_rng(4).normal(size=(3, 37))
    _, pull = jax.vjp(lambda x: JK.fk_link_position_dof_first(js, x, ee), jnp.asarray(q))
    (dq_ref,) = pull(jnp.asarray(g))
    dq = tfk.fk_position_dof_major_vjp_reference(ts, qt, torch.from_numpy(g), ee)
    np.testing.assert_allclose(dq.numpy(), np.asarray(dq_ref), atol=1e-9)


def test_plain_kernel_versions_match_jax_pallas_f32():
    js, ts, ee = _structs("iiwa", jnp.float32)
    rng = np.random.default_rng(5)
    q = rng.uniform(-2.5, 2.5, (7, 300)).astype(np.float32)
    g = rng.normal(size=(3, 300)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        p_j, pull = jax.vjp(lambda x: j_fk_dm(js, x, ee), jnp.asarray(q))
        (dq_j,) = pull(jnp.asarray(g))
    qt = torch.from_numpy(q).requires_grad_(True)
    p_t = tfk.fk_position_dof_major_reference(ts, qt, ee)
    (dq_t,) = torch.autograd.grad(p_t, qt, torch.from_numpy(g))
    np.testing.assert_allclose(p_t.detach().numpy(), np.asarray(p_j), atol=2e-6)
    # VJP: both sides sum ~7 terms of size |g||r| <= ~3 in float32.
    np.testing.assert_allclose(dq_t.numpy(), np.asarray(dq_j), atol=1e-5)
    dq_k2 = tfk.fk_position_dof_major_vjp_reference(ts, qt.detach(), torch.from_numpy(g), ee)
    np.testing.assert_allclose(dq_k2.numpy(), np.asarray(dq_j), atol=1e-5)


@pytest.mark.filterwarnings("ignore:No dynamics information")
def test_autograd_entry_on_cpu_uses_plain_versions():
    _, ts, ee = _structs("fetch_full", jnp.float64)
    rng = np.random.default_rng(6)
    q = torch.from_numpy(rng.uniform(-1, 1, (ts.n_dofs, 11))).requires_grad_(True)
    g = torch.from_numpy(rng.normal(size=(3, 11)))
    before = (tfk.fk_fwd.launches, tfk.fk_bwd.launches)
    p = tfk.fk_position_dof_major(ts, q, ee)
    (dq,) = torch.autograd.grad(p, q, g)
    assert (tfk.fk_fwd.launches, tfk.fk_bwd.launches) == before  # no kernel on the CPU
    p_ref = tfk.fk_position_dof_major_reference(ts, q, ee)
    (dq_ref,) = torch.autograd.grad(p_ref, q, g)
    np.testing.assert_allclose(p.detach().numpy(), p_ref.detach().numpy(), atol=1e-12)
    np.testing.assert_allclose(dq.numpy(), dq_ref.numpy(), atol=1e-12)
    # The chain to the gripper skips the head dofs: their rows are zero.
    head = [d for d, l in enumerate(ts.dof_links) if "head" in ts.link_names[l]]
    assert head and np.all(dq.numpy()[head] == 0)


def test_kernel_entry_refuses_robot_gradients():
    """The kernels' autograd entry treats the robot as constant and refuses
    robot gradients; `fk_position_dof_major` decides before it and takes the
    plain differentiable FK for such a robot, as JAX's wrapper does (W7)."""
    _, ts, ee = _structs("iiwa", jnp.float32)
    ts2 = dataclasses.replace(ts, trans=ts.trans.clone().requires_grad_(True))
    q = torch.zeros(7, 4)
    with pytest.raises(ValueError, match="fk_impl='scalar'"):
        tfk.FkPositionDofMajor.apply(q, ts2, ee)
    p = tfk.fk_position_dof_major(ts2, q, ee)
    np.testing.assert_array_equal(p.detach().numpy(), TK.fk_link_position_dof_first(ts, q, ee).numpy())
    (g,) = torch.autograd.grad(p.sum(), ts2.trans)
    assert g.abs().max() > 0


def test_kernel_build_dir_stays_in_checkout_or_user_cache(tmp_path, monkeypatch):
    from differentiable_robot_model_tpu_torch.ops.kernels import build

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert build.BUILD_DIR == build.Path(repo) / "build" / "kernels"
    # an installed package (no pyproject.toml above it) builds in a per-user cache
    monkeypatch.setattr(build, "_CHECKOUT", tmp_path)
    monkeypatch.setenv("TORCH_EXTENSIONS_DIR", str(tmp_path / "ext"))
    assert build._build_dir() == tmp_path / "ext" / "differentiable_robot_model_tpu_torch"
    monkeypatch.delenv("TORCH_EXTENSIONS_DIR")
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    assert build._build_dir().parent.parent == tmp_path / "cache"
