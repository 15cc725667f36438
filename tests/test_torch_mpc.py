"""The port's MPC drivers against the JAX package's, tick for tick.

`make_mpc_step_batch` runs 3 warm-started ticks in float64 on the CPU with
the "scalar" engine ("auto" on the CPU) and the "fused" engine (the
whole-solve kernel's plain version); states, plans and metrics must match
the JAX driver's to 1e-9. The per-sample `make_mpc_step` gets 2 ticks.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import differentiable_robot_model_tpu as jdrm
from differentiable_robot_model_tpu.models.urdf import robot_struct_from_urdf as j_from_urdf
from differentiable_robot_model_tpu.trajopt import mpc as jmpc
from differentiable_robot_model_tpu_torch.models.structs import (
    ARRAY_FIELDS,
    STATIC_FIELDS,
    struct_from_arrays,
)
from differentiable_robot_model_tpu_torch.trajopt import mpc as tmpc

B, H, ITERS, TICKS = 8, 6, 3, 3


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
