"""The port's MPPI MPC steps against the JAX package's.

`make_mppi_mpc_step_batch` and `make_mppi_mpc_step`, through
`run_closed_loop`, against JAX's over 3 ticks at sigma = 0, where the
noise streams (threefry in JAX, Philox in the port) do not matter: the
plant step, the plan shift and the metrics in float64 to 1e-9, on the
2-link arm. At sigma > 0 on iiwa (as tests/test_mpc_and_utils.py:565) the
batch loop is deterministic in its initial keys, differs under other keys,
and brings the end effector closer to the goal.
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
from differentiable_robot_model_tpu.trajopt import mpc as jmpc
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.trajopt import mpc as tmpc

B, H, K = 3, 4, 8
TOL = 1e-9
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
URDF = {"iiwa": ("kuka_iiwa_iiwa7.urdf", "iiwa_link_ee"), "2link": ("2link_robot.urdf", None)}


@functools.lru_cache(maxsize=None)
def _structs(robot):
    urdf, ee_name = URDF[robot]
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, urdf), dtype=jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    return js, ts, js.link_index(ee_name) if ee_name else js.n_links - 1


@functools.lru_cache(maxsize=None)
def _problem():
    """The 2-link arm's q0, qd0 and goals [B, .]."""
    js, _, ee = _structs("2link")
    rng = np.random.default_rng(11)
    q0 = rng.uniform(-0.5, 0.5, (B, 2))
    qd0 = rng.uniform(-0.2, 0.2, (B, 2))
    goals = np.asarray(fk_link_position_dof_first(js, jnp.asarray(rng.uniform(-1, 1, (B, 2)).T), ee)).T
    return q0, qd0, goals

_MPC_KW = dict(horizon=H, iters_per_step=2, n_samples=K, noise_sigma=0.0, replan_interval=2)
TICKS = 3


@functools.lru_cache(maxsize=None)
def _jax_mpc_ticks(batched):
    js, _, ee = _structs("2link")
    q0, qd0, goals = _problem()
    cfg = jmpc.MPPIMPCConfig(**_MPC_KW)
    if batched:
        keys = jax.random.split(jax.random.PRNGKey(1), B)
        state = jax.vmap(lambda q, qd, k: jmpc.mppi_mpc_init(js, q, qd, cfg, k))(
            jnp.asarray(q0), jnp.asarray(qd0), keys)
        step_fn, g = jmpc.make_mppi_mpc_step_batch(js, ee, cfg), jnp.asarray(goals)
    else:
        state = jmpc.mppi_mpc_init(js, jnp.asarray(q0[0]), jnp.asarray(qd0[0]), cfg,
                                   jax.random.PRNGKey(1))
        step_fn, g = jmpc.make_mppi_mpc_step(js, ee, cfg), jnp.asarray(goals[0])
    step = jax.jit(step_fn).lower(state, g).compile(compiler_options=FAST)
    ticks = []
    for _ in range(TICKS):
        state, metrics = step(state, g)
        ticks.append((state, metrics))
    return ticks


def _assert_close(t, j, what):
    t = t.detach().double().numpy()
    j = np.asarray(j, np.float64)
    scale = max(float(np.abs(j).max()), 1.0)
    np.testing.assert_allclose(t, j, rtol=0, atol=TOL * scale, err_msg=what)


@pytest.mark.parametrize("batched", [True, False], ids=["batch", "single"])
def test_mpc_ticks_match_jax_at_zero_sigma(batched):
    """Plant step, plan shift and metrics of 3 ticks (replan_interval 2) of
    `make_mppi_mpc_step_batch` / `make_mppi_mpc_step`, through
    `run_closed_loop`, against JAX's at sigma = 0 (where the keys do not
    matter), float64."""
    _, ts, ee = _structs("2link")
    q0, qd0, goals = (torch.from_numpy(x) for x in _problem())
    if not batched:
        q0, qd0, goals = q0[0], qd0[0], goals[0]
    cfg = tmpc.MPPIMPCConfig(**_MPC_KW)
    make = tmpc.make_mppi_mpc_step_batch if batched else tmpc.make_mppi_mpc_step
    state0 = tmpc.mppi_mpc_init(ts, q0, qd0, cfg, 1)
    final, stacked = tmpc.run_closed_loop(make(ts, ee, cfg), state0, goals, TICKS)
    j_ticks = _jax_mpc_ticks(batched)
    for name in ("q", "qd", "plan", "step_count"):
        _assert_close(getattr(final, name), getattr(j_ticks[-1][0], name), name)
    for name in tmpc.MPCMetrics._fields:
        j_stack = np.stack([np.asarray(getattr(m, name)) for _, m in j_ticks])
        _assert_close(getattr(stacked, name), j_stack, name)


def test_mpc_batch_is_deterministic_in_its_keys_and_reaches_toward_the_goal():
    """At sigma > 0 (iiwa, as tests/test_mpc_and_utils.py:565): the same
    initial keys give the same trajectory, other keys another, and the mean
    goal distance falls over 5 ticks; the keys stay per scenario."""
    _, ts, ee = _structs("iiwa")
    q0 = torch.zeros((B, 7), dtype=torch.float64)
    q0[:, 3] = -1.2
    goals = tmpc.K.fk_link_position(ts, q0, ee) + torch.tensor([0.06, 0.06, -0.06],
                                                               dtype=torch.float64)
    cfg = tmpc.MPPIMPCConfig(horizon=8, iters_per_step=3, n_samples=32)
    step = tmpc.make_mppi_mpc_step_batch(ts, ee, cfg)
    run = lambda key, n: tmpc.run_closed_loop(
        step, tmpc.mppi_mpc_init(ts, q0, torch.zeros_like(q0), cfg, key), goals, n)
    final, metrics = run(5, 5)
    assert metrics.goal_distance[-1].mean() < metrics.goal_distance[0].mean()
    assert torch.all(final.step_count == 5) and final.key.shape == (B, 2)
    assert torch.all(torch.isfinite(final.q)) and metrics.cost.shape == (5, B)
    again = run(5, 2)[1]  # the same keys: the first two ticks again, bit for bit
    for x, y in zip(again, metrics):
        assert torch.equal(x, y[:2])
    assert not torch.equal(run(6, 1)[1].cost, metrics.cost[:1])
