"""The kinematic MPC's `kernel` engine (K1 `fk_fwd` 12 and K2 `fk_bwd` 10
times a replan) of one or two checkouts of the port on one CUDA card: its
replan time over many processes, a host profile of one replan, and how far
its actions sit from the `fused` engine's and from float64.

    python3 tools/kin_engines.py [--ab DIR] [--pairs N] [--seeds S ...]

Each measurement runs in a process of its own that imports the package of
one checkout and builds that checkout's kernels there (nvcc, into its
`build/kernels/`). At iiwa H=50, B=4096, 10 Adam iterations, lr 0.05, eps
1.0 (the kinematic MPC main path's shape, `chip_smoke.py`'s):

- **replan** (2 N processes; with `--ab DIR` alternated DIR, this, this,
  DIR, ...): one warm `kernel`-engine replan (`make_mpc_step_batch`), the
  median of 20 by CUDA events after 3 warm-ups, and the host's wall time a
  replan over 20 queued back to back; then one replan under
  `torch.profiler`: the operators' count and self CPU time, the CUDA
  runtime calls (launches, synchronisations, copies) and the card's busy
  time, and the operators that take the most host time.
- **gaps** (one process a checkout): for each seed, `chip_smoke.py`
  phase 4's engines comparison on scenarios drawn as its `scenarios` draws
  them (seed 0 is its own): cold solves by the float32 `fused` and
  `kernel` engines and the float64 `kernel` engine; the largest action
  difference of each pair, where it is (scenario, stage, dof), the three
  values there, that entry's difference after each number of iterations
  from 1 to 10, the iteration that moved it most and, at the actions that
  iteration's gradient was taken at, the trajectory entries of that
  scenario that one engine holds on a joint limit and the other does not
  (`flips`: stage, dof and each engine's distance to the limit there),
  the largest difference at each dof, and the scenarios over 1e-4 and
  1e-3. For the first seed also the largest differences after each number
  of iterations.

Prints the card's name and power limit, one JSON line a process and a
summary line. Run from the repo root on a machine with one CUDA card and
nvcc; a parent checkout is made as `tools/time_solves.py` says.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, ITERS, LR, EPS, GOAL_W = 4096, 50, 10, 0.05, 1.0, 100.0
REPS = 20
TOP_OPS = 8


def _problem(torch, model, dev, seed):
    """`chip_smoke.py` `scenarios` with the generator's seed as given."""
    import numpy as np

    rng = np.random.default_rng(seed)
    limits = model.get_joint_limits()
    lo = np.array([l["lower"] for l in limits], np.float32)
    hi = np.array([l["upper"] for l in limits], np.float32)
    q0 = rng.uniform(0.3 * lo, 0.3 * hi, (B, len(lo))).astype(np.float32)
    q_goal = rng.uniform(0.5 * lo, 0.5 * hi, (B, len(lo))).astype(np.float32)
    goals, _ = model.compute_forward_kinematics(torch.from_numpy(q_goal).to(dev), "iiwa_link_ee")
    return torch.from_numpy(q0).to(dev), goals.contiguous()


def _replan(torch, drt, s, ee, q0, goals):
    from differentiable_robot_model_tpu_torch.trajopt import mpc

    cfg = mpc.MPCConfig(horizon=H, iters_per_step=ITERS, lr=LR)
    step = mpc.make_mpc_step_batch(s, ee, cfg, fk_impl="kernel", eps=EPS)
    state, _ = step(mpc.mpc_init(s, q0, cfg), goals)
    call = lambda: step(state, goals)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPS):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        call()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    t = time.perf_counter()
    for _ in range(REPS):
        call()
    host_ms = (time.perf_counter() - t) / REPS * 1e3
    torch.cuda.synchronize()
    out = {"replan_kin_kernel_ms": statistics.median(times), "replan_host_ms": host_ms,
           "replan_ms_all": times}
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    rows = prof.key_averages()
    dev_us = lambda e: getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
    is_runtime = lambda e: e.key.startswith("cuda") and e.key[4:5].isupper()
    runtime = [e for e in rows if is_runtime(e)]
    ops = [e for e in rows if not is_runtime(e) and dev_us(e) == 0]
    out["profile"] = {
        "op_calls": sum(e.count for e in ops),
        "op_self_cpu_ms": sum(e.self_cpu_time_total for e in ops) / 1e3,
        "runtime": {e.key: [e.count, e.self_cpu_time_total / 1e3] for e in runtime},
        "kernels": sum(e.count for e in rows if dev_us(e) > 0),
        "card_busy_ms": sum(dev_us(e) for e in rows) / 1e3,
        "top_ops": [[e.key, e.count, e.self_cpu_time_total / 1e3]
                    for e in sorted(ops, key=lambda e: -e.self_cpu_time_total)[:TOP_OPS]],
    }
    return out


def _gaps(torch, model, s, ee, dev, seeds):
    from differentiable_robot_model_tpu_torch.trajopt.rollout import clamp_affine_q_traj
    from differentiable_robot_model_tpu_torch.trajopt.solvers import solve_kinematic_adam_batch

    s64 = s.to(dtype=torch.float64)
    lo, hi = s64.limit_lower, s64.limit_upper

    def solve(rob, q0, goals, engine, iters):
        return solve_kinematic_adam_batch(rob, q0, goals, ee, H, n_iters=iters, lr=LR,
                                          goal_weight=GOAL_W, eps=EPS, fk_impl=engine).actions.double()

    def solves(q0, goals, iters):
        return {"fused": solve(s, q0, goals, "fused", iters), "kernel": solve(s, q0, goals, "kernel", iters),
                "f64": solve(s64, q0.double(), goals.double(), "kernel", iters)}

    def clamps(q0, a, b):
        """Scenario b's trajectory [H, D] under actions a, and where it sits
        on a joint limit."""
        qT = clamp_affine_q_traj(q0[b].double(), a[b, : H - 1], lo, hi)
        return qT, (qT == lo) | (qT == hi)

    pairs = (("kernel", "fused"), ("fused", "f64"), ("kernel", "f64"))
    out = []
    for i, seed in enumerate(seeds):
        q0, goals = _problem(torch, model, dev, seed)
        by_k = [solves(q0, goals, k) for k in range(1, ITERS + 1)]  # actions after k iterations
        a = by_k[-1]
        row = {"seed": seed}
        for x, y in pairs:
            d = (a[x] - a[y]).abs()  # [B, H, D]
            per = d.amax(dim=(1, 2))
            b, rest = divmod(int(d.argmax()), d.shape[1] * d.shape[2])
            h, j = divmod(rest, d.shape[2])
            curve = [(ak[x][b, h, j] - ak[y][b, h, j]).abs().item() for ak in by_k]
            # the iteration whose step moved the entry's gap most, and the
            # clamped entries of scenario b where x and y part at the actions
            # that step's gradient was taken at (the zero actions before the first)
            k = max(range(ITERS), key=lambda k: abs(curve[k] - (curve[k - 1] if k else 0.0)))
            before = {e: (by_k[k - 1][e] if k else torch.zeros_like(a[e])) for e in a}
            traj = {e: clamps(q0, before[e], b) for e in a}
            near = lambda q, t, dd: min((q[t, dd] - lo[dd]).item(), (hi[dd] - q[t, dd]).item())
            flips = [[t, dd] + [near(traj[e][0], t, dd) for e in ("fused", "kernel", "f64")]
                     for t, dd in (traj[x][1] != traj[y][1]).nonzero().tolist()[:4]]
            row[f"{x}_{y}"] = {
                "max": d.max().item(), "at": [b, h, j], "by_dof": d.amax(dim=(0, 1)).tolist(),
                "values": {e: a[e][b, h, j].item() for e in a}, "curve": curve, "step": k + 1,
                "clamped": {e: int(traj[e][1].sum()) for e in a}, "flips": flips,
                "over_1e-4": int((per > 1e-4).sum()), "over_1e-3": int((per > 1e-3).sum()),
                "top": [[int(k), per[k].item()] for k in per.argsort(descending=True)[:4]]}
        if i == 0:
            row["by_iters"] = {k + 1: {f"{x}_{y}": (ak[x] - ak[y]).abs().max().item() for x, y in pairs}
                               for k, ak in enumerate(by_k)}
        out.append(row)
    return out


def measure(root: Path, job: str, seeds) -> dict:
    """One job of one checkout (this process imports the package under `root`)."""
    sys.path.insert(0, str(root))
    import torch

    import differentiable_robot_model_tpu_torch as drt
    from differentiable_robot_model_tpu_torch.ops.kernels import build

    pkg = Path(drt.__file__).resolve().parent
    if pkg.parent != root.resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    dev = torch.device("cuda", 0)
    build.build(("fk", "kin_solve"))
    model = drt.DifferentiableKUKAiiwa(device=dev)
    s = model.struct
    ee = s.link_index("iiwa_link_ee")
    out = {"root": str(root), "job": job}
    if job == "replan":
        out.update(_replan(torch, drt, s, ee, *_problem(torch, model, dev, 0)))
    else:
        out["gaps"] = _gaps(torch, model, s, ee, dev, seeds)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, help="a second checkout, measured in turns with this one")
    ap.add_argument("--pairs", type=int, default=10, help="replan processes a checkout")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)  # one job, in this process
    ap.add_argument("--job", choices=("replan", "gaps"), help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.root is not None:
        print(json.dumps(measure(a.root, a.job, a.seeds)), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    roots = [ROOT] if a.ab is None else [a.ab, ROOT]
    order = [("gaps", r) for r in roots]
    for i in range(a.pairs):
        order += [("replan", r) for r in (roots if i % 2 == 0 else roots[::-1])]
    runs = []
    for job, root in order:
        cmd = [sys.executable, __file__, "--root", str(root), "--job", job, "--seeds", *map(str, a.seeds)]
        p = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode != 0:
            sys.stderr.write(p.stderr)
            return p.returncode
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    summary = {"card": card}
    for label, root in (("this", ROOT), ("other", a.ab)):
        mine = [r for r in runs if root is not None and Path(r["root"]) == root and r["job"] == "replan"]
        if mine:
            summary[label] = {k: [r[k] for r in mine] for k in ("replan_kin_kernel_ms", "replan_host_ms")}
            summary[label]["median_ms"] = statistics.median(summary[label]["replan_kin_kernel_ms"])
            summary[label]["op_calls"] = [r["profile"]["op_calls"] for r in mine]
            summary[label]["op_self_cpu_ms"] = [r["profile"]["op_self_cpu_ms"] for r in mine]
            summary[label]["card_busy_ms"] = [r["profile"]["card_busy_ms"] for r in mine]
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
