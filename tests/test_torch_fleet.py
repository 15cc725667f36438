"""The heterogeneous fleet (models/fleet.py) and the fleet MPC step against
the JAX package's, on the CPU in float64.

The members are the JAX package's tests/test_fleet.py fleet: the 2-link
robot, iiwa, panda, trifinger_edu (a 17-link tree) and the fetch arm.
- The port's `build_fleet` equals JAX's leaf for leaf, and
  `FleetRobot.from_arrays` of JAX's leaves gives the same fleet.
- Per member, at three states each (test_fleet.py's draw): FK, ee position,
  ee Jacobian, RNEA, mass matrix and FD against JAX's padded functions to
  1e-9 of the largest entry; padded entries exactly 0, padded mass-matrix
  rows the identity. The stacked fleet (`torch.func.vmap` over the
  members) equals the member-by-member calls.
- One padded kinematic solve against JAX's (horizon 4, 5 iterations, B=2)
  to 1e-9; padded actions exactly 0.
- The padded dynamic rollout and solve against the port's own
  single-robot `dynamic_rollout_dof_major` / `solve_dynamic_adam`, which
  earlier tests hold to JAX (JAX's test_fleet.py tolerances).
- Identification through the padded kinematic solve (test_fleet.py's
  setup: iiwa's link-2 z translation, horizon 6, 10 iterations) against
  central differences of the port's own solve; second-order gradients
  through the checkpointed chunks and steps equal the unchunked ones.
- The specialized solvers equal the padded ones per member.
- The fleet MPC step and `run_closed_loop` on a tuple of members.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu.models import fleet as jf
from differentiable_robot_model_tpu_torch.models import fleet as tf
from differentiable_robot_model_tpu_torch.ops import kinematics as TK
from differentiable_robot_model_tpu_torch.trajopt import mpc as tmpc
from differentiable_robot_model_tpu_torch.trajopt import rollout as trollout
from differentiable_robot_model_tpu_torch.trajopt import solvers as tsolvers

TOL = 1e-9
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
MEMBERS = [
    ("DifferentiableTwoLinkRobot", "endEffector"),
    ("DifferentiableKUKAiiwa", "iiwa_link_ee"),
    ("DifferentiableFrankaPanda", "panda_virtual_ee_link"),
    ("DifferentiableTrifingerEdu", "finger_tip_link_120"),
    ("DifferentiableFetchArm", "virtual_ee_link"),
]
EES = [ee for _, ee in MEMBERS]
R = len(MEMBERS)


@pytest.fixture(scope="module")
def fleets():
    jstructs = [getattr(jdrm, cls)(dtype=jnp.float64).struct for cls, _ in MEMBERS]
    tstructs = [getattr(drt, cls)(dtype=torch.float64, device="cpu").struct for cls, _ in MEMBERS]
    return (jstructs, jf.build_fleet(jstructs, EES, dtype=jnp.float64), tstructs,
            tf.build_fleet(tstructs, EES, dtype=torch.float64))


def _row(fleet, r):
    return type(fleet)(*(x[r] for x in fleet))


def _close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = max(np.abs(b).max(), 1.0)
    assert np.abs(a - b).max() <= tol * scale, (np.abs(a - b).max(), scale)


def _np(x):
    return x.detach().numpy()


def test_fleet_leaves_match_jax(fleets):
    _, jfleet, tstructs, tfleet = fleets
    assert tfleet.device == torch.device("cpu") and tfleet.dtype == torch.float64
    carried = tf.FleetRobot.from_arrays({k: np.asarray(v) for k, v in jfleet._asdict().items()},
                                        device="cpu")
    for name in tf.FleetRobot._fields:
        want = np.asarray(getattr(jfleet, name))
        np.testing.assert_array_equal(_np(getattr(tfleet, name)), want, err_msg=name)
        np.testing.assert_array_equal(_np(getattr(carried, name)), want, err_msg=name)
    assert tfleet.parent_idx.dtype == carried.parent_idx.dtype == torch.long
    moved = tstructs[0].to(device="meta")
    with pytest.raises(ValueError, match="different devices"):
        tf.build_fleet([moved, tstructs[1]], EES[:2])


def _states(struct, Dmax, seed):
    """test_fleet.py's `_padded_state`: three states, zeros past the real dofs."""
    rng = np.random.default_rng(seed)
    D = struct.n_dofs
    out = []
    for _ in range(3):
        x = np.zeros(Dmax)
        x[:D] = rng.uniform(-0.8, 0.8, D)
        out.append(x)
    return out


QUANTITIES = ("fk_R", "fk_p", "ee", "jac_lin", "jac_ang", "rnea", "mass", "fd")


def _quantities(F, robot, q, qd, qdd):
    R_, p = F.fk_world_fleet(robot, q)
    lin, ang = F.ee_jacobian_fleet(robot, q)
    return dict(zip(QUANTITIES, (R_, p, F.ee_position_fleet(robot, q), lin, ang,
                                 F.rnea_fleet(robot, q, qd, qdd), F.mass_matrix_fleet(robot, q),
                                 F.forward_dynamics_fleet(robot, q, qd, qdd))))


@pytest.fixture(scope="module")
def jax_quantities(fleets):
    """JAX's padded quantities for every member at its three states, one
    compiled program for all members."""
    jstructs, jfleet, _, _ = fleets
    Dmax = jfleet.damping.shape[-1]
    states = np.stack([np.stack(_states(s, Dmax, r)) for r, s in enumerate(jstructs)])  # [R, 3, Dmax]
    one = lambda robot, q, qd, qdd: _quantities(jf, robot, q, qd, qdd)
    f = jax.vmap(one, in_axes=(0, 0, 0, 0))
    out = jax.jit(f).lower(jfleet, *(states[:, i] for i in range(3))).compile(
        compiler_options=FAST)(jfleet, *(jnp.asarray(states[:, i]) for i in range(3)))
    return states, {k: np.asarray(v) for k, v in out.items()}


@pytest.mark.parametrize("r", range(R), ids=[cls for cls, _ in MEMBERS])
def test_quantities_match_jax_every_member(r, fleets, jax_quantities):
    _, _, tstructs, tfleet = fleets
    states, want = jax_quantities
    D = tstructs[r].n_dofs
    row = _row(tfleet, r)
    q, qd, qdd = (torch.tensor(states[r, i]) for i in range(3))
    got = _quantities(tf, row, q, qd, qdd)
    for k in QUANTITIES:
        _close(_np(got[k]), want[k][r], TOL)
    for k in ("rnea", "fd"):
        assert (got[k][D:] == 0).all()
    for k in ("jac_lin", "jac_ang"):
        assert (got[k][:, D:] == 0).all()
    Hm = _np(got["mass"])
    np.testing.assert_array_equal(Hm[D:, D:], np.eye(len(Hm) - D))
    assert (Hm[D:, :D] == 0).all() and (Hm[:D, D:] == 0).all()


def test_stacked_fleet_equals_each_member(fleets):
    _, _, _, tfleet = fleets
    Dmax = tfleet.damping.shape[-1]
    rng = np.random.default_rng(4)
    q, qd, qdd = (torch.tensor(rng.uniform(-0.5, 0.5, (R, 2, Dmax))) for _ in range(3))
    stacked = _quantities(tf, tfleet, q, qd, qdd)
    for r in range(R):
        each = _quantities(tf, _row(tfleet, r), q[r], qd[r], qdd[r])
        for k in QUANTITIES:
            np.testing.assert_allclose(_np(stacked[k][r]), _np(each[k]), rtol=0, atol=1e-12)


KIN = dict(horizon=4, n_iters=5, lr=0.02, eps=1e-3)


def _kin_inputs(structs, Dmax, B=2, seed=41):
    rng = np.random.default_rng(seed)
    q0 = np.zeros((R, B, Dmax))
    for r, s in enumerate(structs):
        q0[r, :, : s.n_dofs] = rng.uniform(-0.4, 0.4, (B, s.n_dofs))
    return q0, rng.uniform(0.2, 0.4, (R, B, 3))


def test_padded_kinematic_solve_matches_jax(fleets):
    jstructs, jfleet, tstructs, tfleet = fleets
    q0, goals = _kin_inputs(tstructs, tfleet.damping.shape[-1])
    solve = lambda f, a, b: jf.solve_fleet_kinematic_adam(f, a, b, **KIN)
    want = jax.jit(solve).lower(jfleet, q0, goals).compile(compiler_options=FAST)(
        jfleet, jnp.asarray(q0), jnp.asarray(goals))
    got = tf.solve_fleet_kinematic_adam(tfleet, torch.tensor(q0), torch.tensor(goals), **KIN)
    assert got.actions.shape == (R, 2, KIN["horizon"], tfleet.damping.shape[-1])
    for a, b in zip(got, want):
        _close(_np(a), np.asarray(b))
    for r, s in enumerate(tstructs):
        assert (got.actions[r, ..., s.n_dofs:] == 0).all()


def test_padded_dynamic_rollout_matches_single_robot(fleets):
    _, _, tstructs, tfleet = fleets
    Dmax = tfleet.damping.shape[-1]
    rng = np.random.default_rng(21)
    for r, s in enumerate(tstructs):
        D = s.n_dofs
        q0, taus = np.zeros(Dmax), np.zeros((6, Dmax))
        q0[:D] = rng.uniform(-0.5, 0.5, D)
        taus[:, :D] = rng.normal(0, 3.0, (6, D))
        qs, qds = tf.dynamic_rollout_fleet(_row(tfleet, r), torch.tensor(q0), torch.zeros(Dmax, dtype=torch.float64),
                                           torch.tensor(taus), dt=0.01)
        qs_s, qds_s = trollout.dynamic_rollout_dof_major(
            s, torch.tensor(q0[:D])[:, None], torch.zeros((D, 1), dtype=torch.float64),
            torch.tensor(taus[:, :D])[:, :, None], dt=0.01)
        np.testing.assert_allclose(_np(qs[:, :D]), _np(qs_s[..., 0]), rtol=0, atol=1e-9)
        np.testing.assert_allclose(_np(qds[:, :D]), _np(qds_s[..., 0]), rtol=0, atol=1e-9)
        assert (qs[:, D:] == 0).all() and (qds[:, D:] == 0).all()


def test_padded_dynamic_solve_matches_single_robot(fleets):
    """test_fleet.py's case (iiwa's goal 5 cm off its start, the others'
    0.3), held for iiwa and for trifinger, the tree."""
    _, _, tstructs, tfleet = fleets
    Dmax = tfleet.damping.shape[-1]
    rng = np.random.default_rng(23)
    q0 = np.zeros((R, Dmax))
    for r, s in enumerate(tstructs):
        q0[r, : s.n_dofs] = rng.uniform(-0.4, 0.4, s.n_dofs)
    goals = np.full((R, 3), 0.3)
    iiwa = tstructs[1]
    goals[1] = _np(TK.fk_link_position(iiwa, torch.tensor(q0[1, : iiwa.n_dofs]), iiwa.link_index(EES[1])))
    goals[1] += np.asarray([0.05, -0.05, 0.05])
    kw = dict(horizon=6, dt=0.02, n_iters=6, lr=0.5, eps=1e-1)
    res = tf.solve_fleet_dynamic_adam(tfleet, torch.tensor(q0), torch.zeros((R, Dmax), dtype=torch.float64),
                                      torch.tensor(goals), **kw)
    for r in (1, 3):
        s = tstructs[r]
        D = s.n_dofs
        single = tsolvers.solve_dynamic_adam(s, torch.tensor(q0[r, :D]), torch.zeros(D, dtype=torch.float64),
                                             torch.tensor(goals[r]), s.link_index(EES[r]), **kw)
        np.testing.assert_allclose(_np(res.cost_history[r]), _np(single.cost_history), rtol=1e-8)
        np.testing.assert_allclose(_np(res.actions[r, :, :D]), _np(single.actions), rtol=0, atol=1e-7)
    for r, s in enumerate(tstructs):
        assert (res.actions[r, :, s.n_dofs:] == 0).all()
        assert (res.cost_history[r, -1] < res.cost_history[r, 0]).item()


def test_identification_through_the_fleet_solve(fleets):
    """test_fleet.py's setup; the gradient against central differences of
    the port's own solve (tighter than test_fleet.py's 5e-3)."""
    _, _, _, tfleet = fleets
    Dmax = tfleet.damping.shape[-1]
    q0 = torch.zeros((R, Dmax), dtype=torch.float64)
    goals = torch.full((R, 3), 0.35, dtype=torch.float64)

    def objective(delta):
        trans = tfleet.trans.clone()
        trans[1, 2, 2] = trans[1, 2, 2] + delta
        res = tf.solve_fleet_kinematic_adam(tfleet._replace(trans=trans), q0, goals, horizon=6,
                                            n_iters=10, lr=2e-2, eps=1e-3)
        return res.cost.sum()

    delta = torch.zeros((), dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(objective(delta), delta)
    h = 1e-6
    with torch.no_grad():
        fd = (objective(torch.tensor(h)) - objective(torch.tensor(-h))) / (2 * h)
    assert abs(float(fd)) > 1e-6
    np.testing.assert_allclose(float(g), float(fd), rtol=1e-6)


def test_second_order_gradients_through_the_checkpoints(fleets):
    """d/d(trans) of the action gradient (what identification through a
    solve differentiates) is the same with the chunks and steps recomputed
    in the backward pass (torch.utils.checkpoint) as without."""
    _, _, tstructs, tfleet = fleets
    Dmax = tfleet.damping.shape[-1]
    rng = np.random.default_rng(8)
    q0 = torch.tensor(rng.uniform(-0.3, 0.3, (R, Dmax))) * tfleet.dof_valid
    taus = torch.tensor(rng.normal(0, 1.0, (R, 5, Dmax))) * tfleet.dof_valid[:, None]
    trans = tfleet.trans.clone().requires_grad_(True)
    fleet = tfleet._replace(trans=trans)
    out = []
    for remat, chunk in ((True, 2), (False, None)):
        a = taus.clone().requires_grad_(True)
        qs, _ = tf.dynamic_rollout_fleet(fleet, q0, torch.zeros_like(q0), a, 0.02, remat=remat)
        p = tf.ee_trajectory_fleet(fleet, qs, remat_chunk=chunk)
        (ga,) = torch.autograd.grad(p.square().sum(), a, create_graph=True)
        out.append(torch.autograd.grad(ga.square().sum(), trans)[0])
    assert out[1].abs().max() > 0
    np.testing.assert_allclose(_np(out[0]), _np(out[1]), rtol=0, atol=1e-12 * float(out[1].abs().max()))


def _members(tstructs, Dmax, B, seed):
    rng = np.random.default_rng(seed)
    q0 = np.zeros((R, B, Dmax))
    for r, s in enumerate(tstructs):
        q0[r, :, : s.n_dofs] = rng.uniform(-0.3, 0.3, (B, s.n_dofs))
    return q0, rng.uniform(0.2, 0.4, (R, B, 3))


def test_specialized_solvers_match_the_padded_ones(fleets):
    _, _, tstructs, tfleet = fleets
    Dmax = tfleet.damping.shape[-1]
    ee_idxs = [s.link_index(e) for s, e in zip(tstructs, EES)]
    q0, goals = _members(tstructs, Dmax, 2, 37)
    per = lambda x: tuple(torch.tensor(x[r, :, : s.n_dofs]) for r, s in enumerate(tstructs))
    goals_t = tuple(torch.tensor(goals[r]) for r in range(R))

    pad = tf.solve_fleet_kinematic_adam(tfleet, torch.tensor(q0), torch.tensor(goals), **KIN)
    spec = tf.solve_fleet_kinematic_specialized(tstructs, ee_idxs, per(q0), goals_t, fk_impl="scalar", **KIN)
    for r, s in enumerate(tstructs):
        np.testing.assert_allclose(_np(pad.actions[r, ..., : s.n_dofs]), _np(spec[r].actions), rtol=0, atol=1e-8)
        np.testing.assert_allclose(_np(pad.cost[r]), _np(spec[r].cost), rtol=1e-8)

    # the torque solves with the effort box at 5% of the URDF's, so that it binds
    kw = dict(horizon=5, dt=0.02, n_iters=4, lr=0.5, eps=1e-1, respect_effort_limits=True)
    boxed = [s.with_arrays(limit_effort=s.limit_effort * 0.05) for s in tstructs]
    pad = tf.solve_fleet_dynamic_adam(tfleet._replace(limit_effort=tfleet.limit_effort * 0.05),
                                      torch.tensor(q0), torch.zeros((R, 2, Dmax), dtype=torch.float64),
                                      torch.tensor(goals), **kw)
    spec = tf.solve_fleet_dynamic_specialized(boxed, ee_idxs, per(q0), per(np.zeros_like(q0)), goals_t,
                                              rollout_impl="scan", **kw)
    at_box = 0
    for r, s in enumerate(boxed):
        D = s.n_dofs
        np.testing.assert_allclose(_np(pad.actions[r, ..., :D]), _np(spec[r].actions), rtol=0, atol=1e-7)
        assert (pad.actions[r, ..., D:] == 0).all()
        np.testing.assert_allclose(_np(pad.cost_history[r]), _np(spec[r].cost_history).T, rtol=1e-7)
        assert (pad.actions[r, ..., :D].abs() <= s.limit_effort).all()
        at_box += int((pad.actions[r, ..., :D].abs() == s.limit_effort).sum())
    assert at_box > 0


def test_fleet_mpc_step_and_closed_loop(fleets):
    """Two members with their own configs, 2 ticks: `run_closed_loop` stacks
    each member's metrics and equals stepping by hand; per-tick goals
    slice every member's goal; one robot's loop still gives `MPCMetrics`."""
    _, _, tstructs, _ = fleets
    members = [(tstructs[0], tmpc.DynamicMPCConfig(horizon=4, iters_per_step=2, lr=0.3)),
               (tstructs[1], tmpc.DynamicMPCConfig(horizon=5, iters_per_step=2))]
    ees = [s.link_index(EES[r]) for r, (s, _) in enumerate(members)]
    rng = np.random.default_rng(3)
    states, goals = [], []
    for (s, c), ee in zip(members, ees):
        q0 = torch.tensor(rng.uniform(-0.3, 0.3, (3, s.n_dofs)))
        states.append(tmpc.dynamic_mpc_init(s, q0, torch.zeros_like(q0), c))
        goals.append(TK.fk_link_position(s, q0, ee) + torch.tensor([0.08, 0.08, -0.08], dtype=torch.float64))
    states, goals = tuple(states), tuple(goals)
    step = tmpc.make_fleet_dynamic_mpc_step_specialized([s for s, _ in members], ees, [c for _, c in members])
    final, metrics = tmpc.run_closed_loop(step, states, goals, 2)
    assert isinstance(metrics, tuple) and len(metrics) == 2
    by_hand, ticks = states, []
    for _ in range(2):
        by_hand, m = step(by_hand, goals)
        ticks.append(m)
    for r in range(2):
        assert isinstance(metrics[r], tmpc.MPCMetrics)
        for f, name in enumerate(tmpc.MPCMetrics._fields):
            assert metrics[r][f].shape == (2, 3), name
            np.testing.assert_array_equal(_np(metrics[r][f]), _np(torch.stack([t[r][f] for t in ticks])))
        for a, b in zip(final[r], by_hand[r]):
            np.testing.assert_array_equal(_np(a), _np(b))
    moving = tuple(torch.stack([g, g + 0.01]) for g in goals)
    _, m_moving = tmpc.run_closed_loop(step, states, moving, 2, per_tick_goal=True)
    np.testing.assert_array_equal(_np(m_moving[0].cost[0]), _np(metrics[0].cost[0]))
    single = tmpc.make_dynamic_mpc_step_batch(members[0][0], ees[0], members[0][1])
    _, m_one = tmpc.run_closed_loop(single, states[0], goals[0], 2)
    assert isinstance(m_one, tmpc.MPCMetrics) and m_one.goal_distance.shape == (2, 3)
    np.testing.assert_array_equal(_np(m_one.goal_distance), _np(metrics[0].goal_distance))
