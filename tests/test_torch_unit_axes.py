"""The hand-written dynamics adjoints refuse a revolute axis off unit length.

K6 `dyn_rollout_bwd`, K8 `dyn_rollout_ee_bwd`, their phase A alone
`dyn_rollout_replay` and K9 `dynamic_adam_solve` take the RNEA partials by
the identity Rᵀ dR/dq = [a]×, which holds only for a unit axis a. URDF
ingest normalises the axes, `struct_from_arrays` takes them as given, so
each wrapper checks them before it branches on the device (ROADMAP W6):
here, on the CPU, their plain versions refuse iiwa with joint 4's axis of
length 1.1 and take it set to the unit (0.6, 0.8, 0).
"""

import pytest
import torch

import differentiable_robot_model_tpu_torch as drt
from differentiable_robot_model_tpu_torch.models.structs import struct_from_arrays
from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ksolver

H, B, DT = 2, 3, 0.02


def _call(name, robot):
    D = robot.n_dofs
    ee = robot.link_index("iiwa_link_ee")
    gen = torch.Generator().manual_seed(0)
    x = lambda *shape: torch.rand(shape, generator=gen, dtype=torch.float64) - 0.5
    q0, qd0, tau = x(D, B), x(D, B), x(H, D, B)
    qs, qds, ps = kr.dyn_rollout_ee_fwd_reference(robot, q0, qd0, tau, DT, ee)
    if name == "dyn_rollout_bwd":
        return kr.dyn_rollout_bwd(robot, q0, qd0, tau, qs, qds, x(H, D, B), None, DT)[0]
    if name == "dyn_rollout_ee_bwd":
        return kr.dyn_rollout_ee_bwd(robot, q0, qd0, tau, qs, qds, ps, x(H, 3, B), DT, ee)[0]
    if name == "dyn_rollout_replay":
        return kr.dyn_rollout_replay(robot, q0, qd0, tau, qs, qds, DT)
    return ksolver.dynamic_adam_solve(robot, q0, qd0, x(3, B), x(D, B), None, x(H, D, B), ee,
                                      n_iters=1, dt=DT, lr=0.1, goal_weight=10.0,
                                      effort_weight=1e-4, eps=0.1)[0]


@pytest.mark.parametrize("name,what", [
    ("dyn_rollout_bwd", "dyn_rollout_bwd"),
    ("dyn_rollout_ee_bwd", "dyn_rollout_ee_bwd"),
    ("dyn_rollout_replay", "dyn_rollout_replay"),
    ("dynamic_adam_solve", "dyn_solve"),
])
def test_dynamics_adjoints_refuse_axes_off_unit_length(name, what):
    iiwa = drt.DifferentiableKUKAiiwa(dtype=torch.float64, device="cpu").struct
    arrays = {k: v.copy() for k, v in iiwa.numpy().items()}
    arrays["axis"][4] = (0.0, 0.0, 1.1)
    long_axis = struct_from_arrays(arrays, iiwa.static(), device="cpu")
    with pytest.raises(ValueError, match=f"{what} needs unit joint axes.*length 1.1"):
        _call(name, long_axis)
    arrays["axis"][4] = (0.6, 0.8, 0.0)
    general = struct_from_arrays(arrays, iiwa.static(), device="cpu")
    assert torch.isfinite(_call(name, general)).all()
