"""Scenario sharding over torch.distributed: the mesh, sharded MPC solves
and data-parallel training.

PyTorch counterpart of the JAX package's `parallel/mesh.py`. A mesh is a
1-D `torch.distributed.device_mesh.DeviceMesh` over the ranks of the
default process group, one GPU a rank (NCCL), or CPU processes (gloo).
Scenario batches are `DTensor`s whose leading axis is `Shard(0)` (the fleet
solve's scenario axis, axis 1, `Shard(1)`); each rank solves its own B / n
scenarios with the port's batch solver, so there is no collective inside a
solve, as in the JAX package. `full_tensor()` gathers a result.

DTensor's sharding propagation never sees a solve: each wrapper takes the
local block (`to_local`), runs the batch solver on plain tensors (the
kernels' ctypes launches and `autograd.Function`s have no sharding rules)
and wraps the outputs (`DTensor.from_local`). Both steps are
differentiable, so a loss over the sharded outputs reaches the sharded
inputs that require grad.

A wrapper given a plain tensor takes it as the whole batch and shards it
from rank 0 first (`shard_scenarios`), a collective before the solve.
Start one process a GPU with `torchrun --nproc_per_node N` and call
`torch.distributed.init_process_group("nccl")` before `make_mesh`; world
size 1 runs on one card. The wrappers keep the JAX package's signatures:
`axis_name` names the mesh's axis in `make_mesh`, and elsewhere the 1-D
mesh's one axis serves whatever its name.
"""

from __future__ import annotations

import os
from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

SCENARIO_AXIS = "scenario"


def make_mesh(devices=None, axis_name: str = SCENARIO_AXIS, device_type: str = "cuda") -> DeviceMesh:
    """1-D mesh over the ranks of the default process group (or the ranks
    listed in `devices`) for scenario and data parallelism.

    On "cuda" each rank owns `cuda:LOCAL_RANK` (torchrun sets it; else the
    rank modulo the device count), made the current device here; "cpu"
    runs on CPU processes. Raises if the process group is not initialised,
    or if CUDA is asked for and absent: no CPU mesh is built in its place.
    """
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised default process group "
                           "(torch.distributed.init_process_group, or torchrun)")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: device_type='cuda' but CUDA is not available "
                               "(pass device_type='cpu' for CPU processes)")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else dist.get_rank() % torch.cuda.device_count())
    elif device_type != "cpu":
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got {device_type!r}")
    ranks = list(range(dist.get_world_size())) if devices is None else [int(r) for r in devices]
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis_name,))


def _check_mesh(mesh: DeviceMesh) -> None:
    if mesh.ndim != 1:
        raise ValueError(f"the scenario mesh is 1-D, got {mesh.ndim} dimensions")


def _shard(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> DTensor:
    _check_mesh(mesh)
    n = mesh.size()
    if x.shape[dim] % n:
        raise ValueError(f"{x.shape[dim]} scenarios do not divide over {n} ranks")
    return distribute_tensor(x, mesh, [Shard(dim)])


def shard_scenarios(mesh: DeviceMesh, tree, axis_name: str = SCENARIO_AXIS):
    """Place each tensor's leading axis over the mesh (`Shard(0)`, from
    rank 0's tensor). Raises where B is not a multiple of the mesh size."""
    return tree_map(lambda x: _shard(mesh, x), tree)


def replicate(mesh: DeviceMesh, tree):
    """Place each tensor whole on every rank (`Replicate()`, rank 0's)."""
    _check_mesh(mesh)
    return tree_map(lambda x: distribute_tensor(x, mesh, [Replicate()]), tree)


def _local(mesh: DeviceMesh, x, dim: int = 0) -> torch.Tensor:
    """This rank's block of x along `dim`: a DTensor's local tensor (moved
    to `Shard(dim)` first if placed otherwise), or a plain tensor's after
    sharding it from rank 0."""
    if not isinstance(x, DTensor):
        x = _shard(mesh, x, dim)
    if x.device_mesh != mesh:
        raise ValueError("the input lies on another mesh")
    if x.placements != (Shard(dim),):
        x = x.redistribute(mesh, [Shard(dim)])
    return x.to_local()


def _wrap(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> DTensor:
    """The local block x as the rank's share of a DTensor `Shard(dim)`."""
    return DTensor.from_local(x, mesh, [Shard(dim)], run_check=False)


def sharded_batch_solver(mesh: DeviceMesh, solve_one: Callable, axis_name: str = SCENARIO_AXIS):
    """Turn `solve_one(scenario pytree) -> result pytree` into a sharded
    batched solver: `run(scenarios)` takes tensors with a leading batch
    axis sharded over the mesh and returns the stacked results, sharded
    likewise.

    Each rank loops over its local scenarios, one `solve_one` call each,
    and stacks the results. It does not use `torch.func.vmap`: the port's
    Adam solvers take their gradients with `torch.autograd.grad`, which
    does not compose with `vmap`. The batch solvers run a batch in one
    call; `sharded_kinematic_mpc` and its siblings below shard those.
    """

    def run(scenarios):
        leaves, spec = tree_flatten(tree_map(lambda x: _local(mesh, x), scenarios))
        results = [solve_one(tree_unflatten([x[i] for x in leaves], spec))
                   for i in range(leaves[0].shape[0])]
        stacked = tree_map(lambda *xs: torch.stack(xs), *results)
        return tree_map(lambda x: _wrap(mesh, x), stacked)

    return run


def sharded_kinematic_mpc(
    mesh: DeviceMesh,
    robot,
    ee_link_idx: int,
    horizon: int,
    n_iters: int = 10,
    lr: float = 1e-3,
    goal_weight: float = 100.0,
    fk_impl: str = "auto",
    eps: float = 1e-8,
    axis_name: str = SCENARIO_AXIS,
    **solver_kwargs,
):
    """Sharded `solve_kinematic_adam_batch`: returns `solve(q0 [B, D], goals
    [B, 3]) -> (actions [B, H, D], cost [B])`, each rank solving its B / n
    scenarios in one call of the batch solver (on a CUDA float32 robot one
    launch of K3 with `fk_impl="auto"`, the port's name for the default
    engine); zero collectives. Extra keyword arguments go to the solver
    unchanged."""
    from ..trajopt.solvers import solve_kinematic_adam_batch

    def solve(q0, goals):
        res = solve_kinematic_adam_batch(
            robot, _local(mesh, q0), _local(mesh, goals), ee_link_idx, horizon=horizon,
            n_iters=n_iters, lr=lr, goal_weight=goal_weight, fk_impl=fk_impl, eps=eps,
            **solver_kwargs,
        )
        return _wrap(mesh, res.actions), _wrap(mesh, res.cost)

    return solve


def sharded_dynamic_mpc(
    mesh: DeviceMesh,
    robot,
    ee_link_idx: int,
    horizon: int,
    dt: float = 0.02,
    n_iters: int = 10,
    lr: float = 0.5,
    goal_weight: float = 10.0,
    effort_weight: float = 1e-4,
    eps: float = 1e-8,
    axis_name: str = SCENARIO_AXIS,
    **solver_kwargs,
):
    """Sharded `solve_dynamic_adam_batch` (torque-space MPC): returns
    `solve(q0 [B, D], qd0 [B, D], goals [B, 3]) -> (actions [B, H, D], cost
    [B])`, each rank's scenarios in one call (the prologue and K9 on a CUDA
    float32 robot); zero collectives. The defaults are the solver's, so
    the sharded and unsharded solves agree under the same keyword
    arguments, which go to the solver unchanged (`respect_effort_limits`,
    `use_damping`, `precondition`, `rollout_impl`, ...)."""
    from ..trajopt.solvers import solve_dynamic_adam_batch

    def solve(q0, qd0, goals):
        res = solve_dynamic_adam_batch(
            robot, _local(mesh, q0), _local(mesh, qd0), _local(mesh, goals), ee_link_idx,
            horizon=horizon, dt=dt, n_iters=n_iters, lr=lr, goal_weight=goal_weight,
            effort_weight=effort_weight, eps=eps, **solver_kwargs,
        )
        return _wrap(mesh, res.actions), _wrap(mesh, res.cost)

    return solve


def sharded_mppi(
    mesh: DeviceMesh,
    robot,
    ee_link_idx: int,
    horizon: int,
    axis_name: str = SCENARIO_AXIS,
    **solver_kwargs,
):
    """Sharded batched MPPI: returns `solve(q0 [B, D], qd0 [B, D], goals [B,
    3], keys [B, 2]) -> (actions [B, H, D], cost [B])`.

    The keys are one a scenario (`ops.kernels.rng.split_key(key, B)`),
    sharded like the scenarios, and `solve_dynamic_mppi_batch` draws
    scenario b's noise under keys[b] alone: the same scenario draws the
    same noise on any number of ranks (one key split by the local batch
    would not). On a CUDA float32 robot each rank runs the prologue and
    one launch of K10 in its per-scenario-key form; zero collectives.
    Extra keyword arguments go to `solve_dynamic_mppi_batch` unchanged."""
    from ..trajopt.solvers import solve_dynamic_mppi_batch

    def solve(q0, qd0, goals, keys):
        res = solve_dynamic_mppi_batch(
            robot, _local(mesh, q0), _local(mesh, qd0), _local(mesh, goals), ee_link_idx,
            horizon, _local(mesh, keys), **solver_kwargs,
        )
        return _wrap(mesh, res.actions), _wrap(mesh, res.cost)

    return solve


def sharded_fleet_dynamic_mpc(
    mesh: DeviceMesh,
    fleet,
    horizon: int,
    axis_name: str = SCENARIO_AXIS,
    **solver_kwargs,
):
    """Sharded padded-fleet torque-space MPC (`models.fleet.
    solve_fleet_dynamic_adam`): the scenario axis sharded (`Shard(1)`), the
    fleet axis and the fleet's tensors whole on every rank. Returns
    `solve(q0 [R, B, Dmax], qd0, goals [R, B, 3]) -> (actions [R, B, H,
    Dmax], cost [R, B])`, each rank solving all R robots on its B / n
    scenarios; zero collectives. Keyword arguments go to the fleet solver
    unchanged."""
    from ..models.fleet import solve_fleet_dynamic_adam

    def solve(q0, qd0, goals):
        res = solve_fleet_dynamic_adam(
            fleet, _local(mesh, q0, 1), _local(mesh, qd0, 1), _local(mesh, goals, 1),
            horizon=horizon, **solver_kwargs,
        )
        return _wrap(mesh, res.actions, 1), _wrap(mesh, res.cost, 1)

    return solve


def make_data_parallel_train_step(
    mesh: DeviceMesh,
    loss_fn: Callable,  # loss_fn(local batch) -> scalar over the optimizer's parameters
    optimizer: torch.optim.Optimizer,
    axis_name: str = SCENARIO_AXIS,
):
    """Data-parallel training step: the parameters (those of `optimizer`,
    the model's `nn.Parameter`s) replicated, the batch sharded.

    The parameters are broadcast from the mesh's first rank once, here.
    `step(batch)` takes a pytree of tensors sharded over the mesh (or whole
    tensors, sharded from rank 0), computes the local loss and its
    gradients, averages both over the mesh with one all-reduce (a sum
    divided by the mesh size: the JAX package's `pmean`; gloo has no AVG),
    sets the parameters' `.grad` and takes the optimizer step. Returns the
    mean loss, detached.
    """
    _check_mesh(mesh)
    group, n = mesh.get_group(), mesh.size()
    params = [p for g in optimizer.param_groups for p in g["params"] if p.requires_grad]
    first = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for p in params:
            dist.broadcast(p.data, src=first, group=group)

    def step(batch):
        local = tree_map(lambda x: _local(mesh, x), batch)
        loss = loss_fn(local)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.detach().reshape(1)])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        flat = flat / n
        for p, g in zip(params, flat[:-1].split([p.numel() for p in params])):
            p.grad = g.view_as(p)
        optimizer.step()
        return flat[-1]

    return step
