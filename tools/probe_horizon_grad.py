"""Run chip_smoke.py's phase 6j gradient checks alone on one CUDA card,
after the kernels' build, twice: the horizon-sharded Riccati's gradient at
bench.py's linearization (B=64, H=50, float64) and a graph-keeping float64
ilqr(riccati="horizon_sharded") on phase 6k's iiwa problem, each against
the parallel form, on a world-size-1 NCCL group. `check` records failures
instead of raising, and they print at the end.

    python3 tools/probe_horizon_grad.py     # from the repository root; ~80 s
"""

import json
import os
import subprocess
import sys
import time

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402

if __name__ == "__main__":
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print("[env]", torch.__version__, torch.version.cuda, card, flush=True)
    t0 = time.time()
    cs.build.build()
    print(f"[build] {time.time() - t0:.1f} s", flush=True)
    fails = []
    cs.check = lambda c, m: None if c else fails.append(m)
    dev = torch.device("cuda", 0)
    model = cs.drt.DifferentiableKUKAiiwa(device=dev)
    struct = model.struct
    ee = struct.link_index("iiwa_link_ee")
    q0, goals = cs.scenarios(model, struct, "iiwa_link_ee", dev)
    inputs = cs.gradient_inputs(dev, struct, q0, goals)
    rendezvous = cs.build.BUILD_DIR / f"nccl_rendezvous_{time.time_ns()}"
    cs.build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    dist.init_process_group("nccl", init_method=f"file://{rendezvous}", world_size=1, rank=0,
                            device_id=dev)
    try:
        mesh = cs.pmesh.make_mesh()
        x0, us0, g = cs.ilqr_inputs(struct, q0, goals, cs.ILQR_B, cs.H)  # as phase 6j's Riccati
        dyn, _, _, lin = cs.ilqr_problem(struct, ee, g, us0[:, 0])
        usT = us0.transpose(0, 1)
        lq = list(lin(cs._rollout(dyn, x0, usT), usT))
        lq[5] = lq[5] + 1e-3 * torch.eye(struct.n_dofs, device=dev)
        by_path, report = {}, {}
        for rerun in range(2):
            t = time.time()
            cs.sharded_riccati_grad_check(dev, mesh, lq, report)
            cs.sharded_ilqr_grad_check(mesh, struct, ee, inputs, by_path, report)
            print(f"[phase] 6j gradient checks (run {rerun}) {time.time() - t:.2f} s", flush=True)
    finally:
        dist.destroy_process_group()
        rendezvous.unlink(missing_ok=True)
    print(json.dumps({"report": report, "by_path": by_path, "fails": fails}))
    sys.exit(1 if fails else 0)
