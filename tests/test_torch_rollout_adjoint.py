"""The rollout adjoint's two phases (K6 `dyn_rollout_bwd` and K8
`dyn_rollout_ee_bwd`, ops/kernels/rollout.py) in their plain versions.

Phase A (`replay_reference`: per stage Ĥ's LDLᵀ factor, the clamp's mask,
the rows of ∂RNEA/∂(q, qd) at qdd* from D reverse sweeps and the folded
cotangents) and phase B (`adjoint_reference`: the chain from the last stage
back), composed by `dyn_rollout_*_bwd_reference` over windows of stages,
are held in float64:
- against `jax.vjp` of the JAX package's `dynamic_rollout_dof_major` and
  ee FK at 1e-9 of the largest entry, for the state-only and ee variants
  with cotangents on qs, on qds and on both, on the 2-link robot (pushed
  past its velocity limit, so that the mask matters) and trifinger_edu (a
  tree: the generic builds); iiwa's VJP is held the same way by
  tests/test_torch_dyn_rollout.py, whose plain adjoints compose these
  phases. One JAX compile per robot (5 s and 33 s on this CPU) serves
  every case;
- phase A's blocks against what they hold, computed apart: the factor
  against the mass matrix with implicit damping, the mask against the clip
  of qd + dt qdd*, the rows against the forward-mode `rnea_jacobians` at
  1e-12, the folded cotangents against `ee_jacobian_t`;
- windows of 2 stages against the whole, and the phase entries against
  the backward.
Inputs are numpy from a seed, H=4 and B=5.
"""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.ops.kinematics import fk_link_position_dof_first
from differentiable_robot_model_tpu.trajopt.rollout import dynamic_rollout_dof_major
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.ops.dynamics_scalar import (
    ldl_solve_scalar,
    mass_matrix_scalar,
    rnea_scalar,
)
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as krollout

ROBOTS = {"iiwa": "kuka_iiwa_iiwa7.urdf", "2link": "2link_robot.urdf", "trifinger": "trifinger_edu.urdf"}
H, B, DT = 4, 5, 0.02
TOL = 1e-9
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
# which cotangents reach the VJP: (gqs, gqds, gps) each kept or zeroed
PATTERNS = {"qs": (1, 0, 0), "qds": (0, 1, 0), "qs+qds": (1, 1, 0),
            "ee": (0, 0, 1), "ee+qs": (1, 0, 1), "ee+qds": (0, 1, 1)}


@functools.lru_cache(maxsize=None)
def _structs(robot):
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, ROBOTS[robot]), dtype=jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.n_links - 1


@functools.lru_cache(maxsize=None)
def _inputs(robot):
    """q0, qd0, tau, gqs, gqds, gps as float64 numpy arrays."""
    D = _structs(robot)[1].n_dofs
    rng = np.random.default_rng(61)
    q0 = rng.uniform(-0.5, 0.5, (D, B))
    qd0 = rng.uniform(-0.2, 0.2, (D, B))
    tau = rng.uniform(-3, 3, (H, D, B))
    if robot == "2link":  # near the 10 rad/s limit, pushed past it
        qd0 = rng.uniform(9.0, 9.9, (D, B)) * rng.choice([-1.0, 1.0], (D, B))
        tau = 200.0 * np.sign(qd0)[None] * rng.uniform(0.2, 1.0, (H, D, B))
    return q0, qd0, tau, rng.normal(size=(H, D, B)), rng.normal(size=(H, D, B)), rng.normal(size=(H, 3, B))


@functools.lru_cache(maxsize=None)
def _jax_vjp(robot):
    """JAX's rollout with the ee trajectory and its VJP for cotangents on
    qs, qds and ps, compiled once per robot."""
    js, _, ee = _structs(robot)
    D = js.n_dofs

    def f(q0, qd0, tau):
        qs, qds = dynamic_rollout_dof_major(js, q0, qd0, tau, DT)
        ps = fk_link_position_dof_first(js, qs.transpose(1, 0, 2).reshape(D, -1), ee)
        return qs, qds, ps.reshape(3, H, B).transpose(1, 0, 2)

    def f_vjp(q0, qd0, tau, gqs, gqds, gps):
        out, pull = jax.vjp(f, q0, qd0, tau)
        return out, pull((gqs, gqds, gps))

    shapes = [jax.ShapeDtypeStruct(s, jnp.float64)
              for s in ((D, B), (D, B), (H, D, B), (H, D, B), (H, D, B), (H, 3, B))]
    return jax.jit(f_vjp).lower(*shapes).compile(compiler_options=FAST)


def _port_rollout(robot):
    _, ts, ee = _structs(robot)
    q0, qd0, tau, gqs, gqds, gps = (torch.from_numpy(x) for x in _inputs(robot))
    qs, qds, ps = krollout.dyn_rollout_ee_fwd_reference(ts, q0, qd0, tau, DT, ee)
    return ts, ee, (q0, qd0, tau), (qs, qds, ps), (gqs, gqds, gps)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("pattern", list(PATTERNS))
@pytest.mark.parametrize("robot", ["2link", "trifinger"])
def test_composed_phases_match_jax_vjp(robot, pattern):
    ts, ee, x, (qs, qds, ps), cot = _port_rollout(robot)
    keep = PATTERNS[pattern]
    gqs, gqds, gps = (c if k else None for c, k in zip(cot, keep))
    if gps is None:
        got = krollout.dyn_rollout_bwd_reference(ts, *x, qs, qds, gqs, gqds, DT)
    else:
        got = krollout.dyn_rollout_ee_bwd_reference(ts, *x, qs, qds, ps, gps, DT, ee, gqs=gqs, gqds=gqds)
    args = _inputs(robot)
    out, (gq0, gqd0, gtau) = _jax_vjp(robot)(*args[:3], *(c * k for c, k in zip(args[3:], keep)))
    _close(qs, np.asarray(out[0]))
    for name, t, want in zip(("gtau", "gq0", "gqd0"), got, (gtau, gq0, gqd0)):
        assert t.shape == want.shape, name
        _close(t, np.asarray(want))
    if robot == "2link":  # the clamp was active, so the mask mattered
        assert np.any(np.abs(qds.numpy()) == np.asarray(ts.limit_velocity)[None, :, None])


@pytest.mark.parametrize("robot", sorted(ROBOTS))
def test_phase_a_scratch_holds_each_stage(robot):
    """Phase A's scratch block by block: Lf diag(dg) Lfᵀ = M + dt diag(d),
    the mask is the clamp's derivative at qd + dt qdd*, the rows from D
    reverse sweeps equal `rnea_jacobians`' forward tangents at 1e-12, and
    the folded cotangents are gqs + J^T gps and gqds."""
    ts, ee, (q0, qd0, tau), (qs, qds, ps), (gqs, gqds, gps) = _port_rollout(robot)
    D = ts.n_dofs
    scr = krollout.dyn_rollout_replay(ts, q0, qd0, tau, qs, qds, DT, gqs=gqs, gqds=gqds, ps=ps,
                                      gps=gps, ee_link_idx=ee)
    lay = krollout.replay_layout(D, True, True)
    assert scr.shape == (H, lay.K, B)
    q, qd = torch.cat([q0[None], qs[:-1]]).transpose(0, 1), torch.cat([qd0[None], qds[:-1]]).transpose(0, 1)
    M = mass_matrix_scalar(ts, q) + DT * torch.diag(ts.damping)[:, :, None, None]
    qdd = ldl_solve_scalar(M, tau.transpose(0, 1) - rnea_scalar(ts, q, qd, torch.zeros_like(q)))
    L = torch.eye(D, dtype=q.dtype)[:, :, None, None].repeat(1, 1, H, B)
    for i in range(1, D):
        for j in range(i):
            L[i, j] = scr[:, i * (i - 1) // 2 + j]
    dg = scr[:, lay.dg:lay.dg + D].transpose(0, 1)
    _close(torch.einsum("ikhb,khb,jkhb->ijhb", L, dg, L), M.numpy(), 1e-12)
    vmax = ts.limit_velocity[:, None, None]
    mask = krollout._clip_grad(qd + DT * qdd, -vmax, vmax)
    np.testing.assert_array_equal(scr[:, lay.mask:lay.mask + D].transpose(0, 1).numpy(), mask.numpy())
    rows = krollout.rnea_jacobians(ts, q, qd, qdd)
    want = torch.stack(rows).permute(2, 0, 1, 3).reshape(H, 2 * D * D, B)
    _close(scr[:, lay.rows:lay.rows + 2 * D * D], want.numpy(), 1e-12)
    _close(scr[:, lay.ox:lay.ox + D], (gqs + krollout.ee_jacobian_t(ts, qs, ps, gps, ee)).numpy(), 1e-12)
    np.testing.assert_array_equal(scr[:, lay.odx:lay.odx + D].numpy(), gqds.numpy())


@pytest.mark.parametrize("variant", ["state", "ee"])
@pytest.mark.parametrize("robot", ["iiwa", "trifinger"])
def test_windows_of_two_stages_match_the_whole(robot, variant, monkeypatch):
    ts, ee, x, (qs, qds, ps), (gqs, gqds, gps) = _port_rollout(robot)

    def backward():
        if variant == "state":
            return krollout.dyn_rollout_bwd(ts, *x, qs, qds, gqs, gqds, DT)
        return krollout.dyn_rollout_ee_bwd(ts, *x, qs, qds, ps, gps, DT, ee, gqs=gqs, gqds=gqds)

    whole = backward()
    lay = krollout.replay_layout(ts.n_dofs, True, True)
    per_stage = lay.K * B * 8
    monkeypatch.setattr(krollout, "SCRATCH_CAP_BYTES", 2 * per_stage)
    assert krollout._windows(H, lay, B, 8) == (2, [(2, 4), (0, 2)])
    for a, b in zip(backward(), whole):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    monkeypatch.setattr(krollout, "SCRATCH_CAP_BYTES", per_stage - 1)
    with pytest.raises(ValueError, match="passes its cap"):
        backward()


def test_phase_entries_compose_to_the_backward():
    """`dyn_rollout_replay` then `dyn_rollout_adjoint` (the phases alone, for
    the card's checks and timing) equal `dyn_rollout_bwd` and
    `dyn_rollout_ee_bwd`, for every layout of the cotangent rows."""
    ts, ee, x, (qs, qds, ps), (gqs, gqds, gps) = _port_rollout("iiwa")
    cases = [(dict(gqs=gqs), krollout.dyn_rollout_bwd(ts, *x, qs, qds, gqs, None, DT)),
             (dict(gqds=gqds), krollout.dyn_rollout_bwd(ts, *x, qs, qds, None, gqds, DT)),
             (dict(ps=ps, gps=gps, ee_link_idx=ee),
              krollout.dyn_rollout_ee_bwd(ts, *x, qs, qds, ps, gps, DT, ee))]
    for kw, want in cases:
        scr = krollout.dyn_rollout_replay(ts, *x, qs, qds, DT, **kw)
        got = krollout.dyn_rollout_adjoint(ts, scr, DT, "gqs" in kw or "ps" in kw, "gqds" in kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    with pytest.raises(ValueError, match="scr must be"):
        krollout.dyn_rollout_adjoint(ts, scr, DT, False, False)
