"""differentiable_robot_model_tpu_torch: the PyTorch/CUDA port of the JAX
package beside it, for NVIDIA Hopper GPUs.

Same layout as the JAX package (`models/`, `ops/`, `trajopt/`), with the
hand-written CUDA kernels' wrappers in `ops/kernels/` and their sources in
`csrc/`. The port imports neither JAX nor the JAX package; it ships its own
copies of the bundled URDFs in `robot_data/`. It serves all that the JAX
package does: the kinematic MPC path (`trajopt.mpc.make_mpc_step_batch`),
the torque-space MPC path (`trajopt.mpc.make_dynamic_mpc_step_batch`,
`run_closed_loop`), with the scalar dynamics under the latter in
`ops/dynamics_scalar.py`, the sampling (MPPI) MPC path
(`trajopt.mpc.make_mppi_mpc_step_batch`, `make_mppi_mpc_step`), the
second-order (iLQR) MPC path (`trajopt.solvers.ilqr_batch`,
`trajopt.mpc.make_ilqr_mpc_step`), the robot-model API
(`DifferentiableRobotModel.compute_*`, inverse dynamics on the RNEA
kernel) with the lie, spatial, kinematics and dynamics ops under it,
system identification (`make_link_param_learnable`,
`models/parametrizations.py`), the differentiable state-only rollout
(`ops.kernels.rollout.dynamic_rollout`) beside the one with the
end-effector trajectory (`dynamic_rollout_ee`), heterogeneous fleets
(`models/fleet.py`), scenario sharding, data-parallel training and the
horizon-sharded Riccati over torch.distributed (`parallel/`: one process a
GPU, `torchrun --nproc_per_node N`), and the profiling utilities
(`utils/profiling.py`). The solvers differentiate w.r.t. the robot and
their inputs (q0, qd0, goals, warm starts).

Entry points run on CUDA unless the caller passes `device="cpu"`, and raise
when no CUDA device exists. Float32 work runs in full float32: the port's
CUDA kernels do their arithmetic in FP32 without fast-math, and it expects
`torch.backends.cuda.matmul.allow_tf32 = False` (PyTorch's default), which
chip_smoke.py sets and asserts.
"""

from .models.robot import (
    DifferentiableAllegroHand,
    DifferentiableFetchArm,
    DifferentiableFetchFull,
    DifferentiableFrankaPanda,
    DifferentiableKinovaJaco,
    DifferentiableKinovaJacoFull,
    DifferentiableKUKAiiwa,
    DifferentiableKukaIiwaAllegro,
    DifferentiablePandaWithGripper,
    DifferentiableRobotModel,
    DifferentiableTrifingerEdu,
    DifferentiableTwoLinkRobot,
    robot_description_folder,
)
from .models.structs import RobotStruct, struct_from_arrays
from .models.urdf import robot_struct_from_urdf

__version__ = "0.1.0"

__all__ = [
    "DifferentiableRobotModel",
    "DifferentiableKUKAiiwa",
    "DifferentiableFrankaPanda",
    "DifferentiableTwoLinkRobot",
    "DifferentiableTrifingerEdu",
    "DifferentiableAllegroHand",
    "DifferentiableFetchArm",
    "DifferentiableKinovaJaco",
    "DifferentiableKinovaJacoFull",
    "DifferentiableKukaIiwaAllegro",
    "DifferentiablePandaWithGripper",
    "DifferentiableFetchFull",
    "RobotStruct",
    "robot_struct_from_urdf",
    "struct_from_arrays",
    "robot_description_folder",
]
