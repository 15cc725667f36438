"""Closed-loop torque-space MPC for a fleet of different robots.

Twin of the JAX package's examples/run_fleet_mpc.py: a 2-link arm and a
KUKA iiwa, each with its own scenario batch, horizon and solver budget,
replan torque sequences through their own forward dynamics every tick
(`make_fleet_dynamic_mpc_step_specialized`: on the card the prologue and
K9 a replan and K7 the plant step, per member), and `run_closed_loop`
runs the whole fleet's ticks.

    python -m differentiable_robot_model_tpu_torch.examples.run_fleet_mpc [--device cpu]
"""

import argparse

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableKUKAiiwa, DifferentiableTwoLinkRobot
from differentiable_robot_model_tpu_torch.ops import kinematics as K
from differentiable_robot_model_tpu_torch.trajopt.mpc import (
    DynamicMPCConfig,
    dynamic_mpc_init,
    make_fleet_dynamic_mpc_step_specialized,
    run_closed_loop,
)


def run(n_steps: int = 25, batch: int = 4, seed: int = 0, device=None):
    """Drive every member's end effector toward a reach goal.

    Returns {member name: mean goal distance after each tick [n_steps]}."""
    members = [
        (DifferentiableTwoLinkRobot(device=device), "endEffector",
         DynamicMPCConfig(horizon=10, iters_per_step=4, lr=0.3)),
        (DifferentiableKUKAiiwa(device=device), "iiwa_link_ee",
         DynamicMPCConfig(horizon=20, iters_per_step=5)),
    ]
    structs = [m.struct for m, _, _ in members]
    ee_idxs = [s.link_index(ee) for s, (_, ee, _) in zip(structs, members)]
    configs = [c for _, _, c in members]

    rng = np.random.default_rng(seed)
    states, goals = [], []
    for s, ee_idx, c in zip(structs, ee_idxs, configs):
        q0 = torch.tensor(rng.uniform(-0.3, 0.3, (batch, s.n_dofs)), dtype=s.dtype, device=s.device)
        states.append(dynamic_mpc_init(s, q0, torch.zeros_like(q0), c))
        offset = torch.tensor([0.08, 0.08, -0.08], dtype=s.dtype, device=s.device)
        goals.append(K.fk_link_position(s, q0, ee_idx) + offset)

    step = make_fleet_dynamic_mpc_step_specialized(structs, ee_idxs, configs)
    _, metrics = run_closed_loop(step, tuple(states), tuple(goals), n_steps)

    out = {}
    for r, s in enumerate(structs):
        d = metrics[r].goal_distance.mean(dim=1).cpu().numpy()  # [n_steps]
        out[s.name] = d
        print(f"{s.name:30s} mean goal dist {d[0]:.4f} -> {d[-1]:.4f} m "
              f"over {n_steps} ticks (B={batch})")
    return out


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    run(device=parser.parse_args().device)
