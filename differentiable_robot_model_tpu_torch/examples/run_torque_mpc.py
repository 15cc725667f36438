"""Closed-loop torque-space MPC on the full forward dynamics.

Twin of the JAX package's examples/run_torque_mpc.py: the plan is a torque
sequence integrated through RNEA + mass matrix + LDL^T forward dynamics,
replanned closed-loop with warm starts, by preconditioned Adam
(`solver="adam"`), the sampling solver MPPI (`solver="mppi"`) or iLQR
(`solver="ilqr"`).

    python -m differentiable_robot_model_tpu_torch.examples.run_torque_mpc [adam|mppi|ilqr]
"""

import numpy as np
import torch

from differentiable_robot_model_tpu_torch import DifferentiableKUKAiiwa
from differentiable_robot_model_tpu_torch.ops import kinematics as K
from differentiable_robot_model_tpu_torch.trajopt.mpc import (
    DynamicMPCConfig,
    ILQRMPCConfig,
    MPPIMPCConfig,
    dynamic_mpc_init,
    ilqr_mpc_init,
    make_dynamic_mpc_step,
    make_ilqr_mpc_step,
    make_mppi_mpc_step,
    mppi_mpc_init,
)

EE_NAME = "iiwa_link_ee"


def run(n_steps: int = 30, solver: str = "adam", horizon: int = 20, seed: int = 0, device=None):
    """Drive the iiwa end effector to a reach goal under torque control.

    Returns the per-step goal distances [n_steps] (numpy)."""
    model = DifferentiableKUKAiiwa(device=device)
    struct = model.struct
    ee_idx = struct.link_index(EE_NAME)

    q0 = torch.zeros(7, device=struct.device)
    q0[3] = -1.2
    qd0 = torch.zeros(7, device=struct.device)
    goal = K.fk_link_position(struct, q0, ee_idx) + torch.tensor([0.10, 0.10, -0.10],
                                                                  device=struct.device)

    if solver == "adam":
        # "fused" is what "auto" picks on the card (K9); on the CPU it runs
        # K9's plain version, whose hand-written adjoint is far quicker there
        # than autograd through the eager rollout ("scan")
        config = DynamicMPCConfig(horizon=horizon, iters_per_step=5, rollout_impl="fused")
        step = make_dynamic_mpc_step(struct, ee_idx, config)
        state = dynamic_mpc_init(struct, q0, qd0, config)
    elif solver == "mppi":
        config = MPPIMPCConfig(horizon=horizon, iters_per_step=3, n_samples=128)
        step = make_mppi_mpc_step(struct, ee_idx, config)
        state = mppi_mpc_init(struct, q0, qd0, config, seed)
    elif solver == "ilqr":
        config = ILQRMPCConfig(horizon=horizon, iters_per_step=3)
        step = make_ilqr_mpc_step(struct, ee_idx, config)
        state = ilqr_mpc_init(struct, q0, qd0, config)
    else:
        raise ValueError(f"unknown solver '{solver}' (adam | mppi | ilqr)")

    dists = []
    for i in range(n_steps):
        state, metrics = step(state, goal)
        dists.append(float(metrics.goal_distance))
        if i % 5 == 0:
            print(f"step {i:3d}  goal dist {dists[-1]:.4f} m  plan cost {float(metrics.cost):.4f}")
    print(f"final goal distance: {dists[-1]:.4f} m ({solver})")
    return np.asarray(dists)


if __name__ == "__main__":
    import sys

    run(solver=sys.argv[1] if len(sys.argv) > 1 else "adam")
