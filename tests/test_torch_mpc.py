"""The port's MPC drivers against the JAX package's, tick for tick.

`make_mpc_step_batch` runs 3 warm-started ticks in float64 on the CPU with
the "scalar" engine ("auto" on the CPU) and the "fused" engine (the
whole-solve kernel's plain version); states, plans and metrics must match
the JAX driver's to 1e-9. The per-sample `make_mpc_step` gets 2 ticks.

The torque-space driver `make_dynamic_mpc_step_batch` runs 3 ticks on the
2-link robot in float64, executing 2 torques per replan, with each engine
("auto" = "scan" on the CPU, "kernel", "fused": the kernels' plain
versions), through `run_closed_loop`; its states and stacked metrics must
match JAX's `make_dynamic_mpc_step_batch` tick for tick to 1e-9, and the
single-scenario `make_dynamic_mpc_step` likewise for 2 ticks.
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
from differentiable_robot_model_tpu.ops.kinematics import fk_link_position as j_fk_link_position
from differentiable_robot_model_tpu.trajopt import mpc as jmpc
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.trajopt import mpc as tmpc

B, H, ITERS, TICKS = 8, 6, 3, 3
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _setup():
    js = j_from_urdf(
        os.path.join(jdrm.robot_description_folder, "kuka_iiwa_iiwa7.urdf"), dtype=jnp.float64
    )
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    rng = np.random.default_rng(21)
    lo, hi = np.asarray(js.limit_lower), np.asarray(js.limit_upper)
    q0 = rng.uniform(0.3 * lo, 0.3 * hi, (B, 7))
    goals = rng.uniform(-0.4, 0.4, (B, 3)) + np.array([0.0, 0.0, 0.6])
    return js, ts, js.link_index("iiwa_link_ee"), q0, goals


def _assert_close(t, j, what):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), atol=1e-9, rtol=0, err_msg=what)


@pytest.mark.parametrize("engine", ["auto", "fused"])
def test_batch_mpc_ticks_match_jax_f64(engine):
    js, ts, ee, q0, goals = _setup()
    cfg = jmpc.MPCConfig(horizon=H, iters_per_step=ITERS, lr=0.05)
    j_step = jax.jit(jmpc.make_mpc_step_batch(js, ee, cfg, fk_impl="scalar", eps=1.0))
    j_state = jax.vmap(lambda q: jmpc.mpc_init(js, q, cfg))(jnp.asarray(q0))
    tcfg = tmpc.MPCConfig(horizon=H, iters_per_step=ITERS, lr=0.05, fk_impl=engine)
    t_step = tmpc.make_mpc_step_batch(ts, ee, tcfg, eps=1.0)
    t_state = tmpc.mpc_init(ts, torch.from_numpy(q0), tcfg)
    t_goals = torch.from_numpy(goals)
    for tick in range(TICKS):
        j_state, j_m = j_step(j_state, jnp.asarray(goals))
        t_state, t_m = t_step(t_state, t_goals)
        for name in ("q", "plan", "step_count"):
            _assert_close(getattr(t_state, name), getattr(j_state, name), f"tick {tick} {name}")
        for name in tmpc.MPCMetrics._fields:
            _assert_close(getattr(t_m, name), getattr(j_m, name), f"tick {tick} {name}")
        assert torch.all(t_m.cost < t_m.cost_initial)


def test_single_mpc_ticks_match_jax_f64():
    js, ts, ee, q0, goals = _setup()
    cfg = jmpc.MPCConfig(horizon=H, iters_per_step=ITERS, lr=0.05)
    j_step = jax.jit(jmpc.make_mpc_step(js, ee, cfg))
    j_state = jmpc.mpc_init(js, jnp.asarray(q0[0]), cfg)
    t_step = tmpc.make_mpc_step(ts, ee, tmpc.MPCConfig(horizon=H, iters_per_step=ITERS, lr=0.05))
    t_state = tmpc.mpc_init(ts, torch.from_numpy(q0[0]), tmpc.MPCConfig(horizon=H))
    for tick in range(2):
        j_state, j_m = j_step(j_state, jnp.asarray(goals[0]))
        t_state, t_m = t_step(t_state, torch.from_numpy(goals[0]))
        for name in ("q", "plan", "step_count"):
            _assert_close(getattr(t_state, name), getattr(j_state, name), f"tick {tick} {name}")
        for name in tmpc.MPCMetrics._fields:
            _assert_close(getattr(t_m, name), getattr(j_m, name), f"tick {tick} {name}")


def _dyn_setup():
    js = j_from_urdf(os.path.join(jdrm.robot_description_folder, "2link_robot.urdf"), dtype=jnp.float64)
    ts = struct_from_arrays(
        {f: np.asarray(getattr(js, f)) for f in ARRAY_FIELDS},
        {f: getattr(js, f) for f in STATIC_FIELDS},
        device="cpu",
    )
    rng = np.random.default_rng(31)
    q0 = rng.uniform(-1.0, 1.0, (4, 2))
    qd0 = rng.uniform(-0.5, 0.5, (4, 2))
    q_goal = jnp.asarray(rng.uniform(-1.5, 1.5, (4, 2)))
    goals = np.array(jax.vmap(lambda q: j_fk_link_position(js, q, js.n_links - 1))(q_goal))
    return js, ts, js.n_links - 1, q0, qd0, goals


_DYN_KW = dict(horizon=H, iters_per_step=ITERS, replan_interval=2)


@functools.lru_cache(maxsize=None)
def _jax_dyn_ticks(n_ticks, batched=True):
    js, _, ee, q0, qd0, goals = _dyn_setup()
    if not batched:
        q0, qd0, goals = q0[0], qd0[0], goals[0]
    cfg = jmpc.DynamicMPCConfig(**_DYN_KW)
    if batched:
        state = jax.vmap(lambda q, qd: jmpc.dynamic_mpc_init(js, q, qd, cfg))(jnp.asarray(q0), jnp.asarray(qd0))
        step_fn = jmpc.make_dynamic_mpc_step_batch(js, ee, cfg)
    else:
        state = jmpc.dynamic_mpc_init(js, jnp.asarray(q0), jnp.asarray(qd0), cfg)
        step_fn = jmpc.make_dynamic_mpc_step(js, ee, cfg)
    step = jax.jit(step_fn).lower(state, jnp.asarray(goals)).compile(compiler_options=FAST)
    ticks = []
    for _ in range(n_ticks):
        state, metrics = step(state, jnp.asarray(goals))
        ticks.append((state, metrics))
    return ticks


@pytest.mark.parametrize("engine", ["auto", "kernel", "fused"])
def test_dynamic_mpc_ticks_and_closed_loop_match_jax_f64(engine):
    _, ts, ee, q0, qd0, goals = _dyn_setup()
    j_ticks = _jax_dyn_ticks(TICKS)
    cfg = tmpc.DynamicMPCConfig(rollout_impl=engine, **_DYN_KW)
    step = tmpc.make_dynamic_mpc_step_batch(ts, ee, cfg)
    state0 = tmpc.dynamic_mpc_init(ts, torch.from_numpy(q0), torch.from_numpy(qd0), cfg)
    state = state0
    for tick, (j_state, j_m) in enumerate(j_ticks):
        state, m = step(state, torch.from_numpy(goals))
        for name in tmpc.DynamicMPCState._fields:
            _assert_close(getattr(state, name), getattr(j_state, name), f"tick {tick} {name}")
        for name in tmpc.MPCMetrics._fields:
            _assert_close(getattr(m, name), getattr(j_m, name), f"tick {tick} {name}")
        assert torch.all(m.cost < m.cost_initial)
    final, stacked = tmpc.run_closed_loop(step, state0, torch.from_numpy(goals), TICKS)
    for name in tmpc.DynamicMPCState._fields:
        _assert_close(getattr(final, name), getattr(j_ticks[-1][0], name), f"closed loop {name}")
    for name in tmpc.MPCMetrics._fields:
        j_stack = np.stack([np.asarray(getattr(jm, name)) for _, jm in j_ticks])
        _assert_close(getattr(stacked, name), j_stack, f"closed loop {name}")


def test_single_dynamic_mpc_ticks_match_jax_f64():
    _, ts, ee, q0, qd0, goals = _dyn_setup()
    j_ticks = _jax_dyn_ticks(2, batched=False)
    cfg = tmpc.DynamicMPCConfig(**_DYN_KW)
    step = tmpc.make_dynamic_mpc_step(ts, ee, cfg)
    state = tmpc.dynamic_mpc_init(ts, torch.from_numpy(q0[0]), torch.from_numpy(qd0[0]), cfg)
    for tick, (j_state, j_m) in enumerate(j_ticks):
        state, m = step(state, torch.from_numpy(goals[0]))
        for name in tmpc.DynamicMPCState._fields:
            _assert_close(getattr(state, name), getattr(j_state, name), f"tick {tick} {name}")
        for name in tmpc.MPCMetrics._fields:
            _assert_close(getattr(m, name), getattr(j_m, name), f"tick {tick} {name}")
