"""Run chip_smoke.py's phase 6k (the gradients through the solves) alone on
one CUDA card, after the kernels' build and phase 5g (iLQR parity), twice;
`check` records failures instead of raising, and they print at the end.

    python3 tools/probe_gradients.py     # from the repository root; ~3 min

The plain solves of phase 6k run in one CPU worker process, started before
phase 5g, as chip_smoke.py runs them in its CPU pool.
"""

import json
import multiprocessing
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import torch

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
    pool = ProcessPoolExecutor(max_workers=1, mp_context=multiprocessing.get_context("spawn"))
    inputs = cs.gradient_inputs(dev, struct, q0, goals)
    plain = pool.submit(cs.gradient_plain_cpu, {k: v.cpu().numpy() for k, v in inputs.items()})
    t = time.time()
    cs.ilqr_checks(struct, ee, q0, goals, {})
    print(f"[phase] 5g {time.time() - t:.1f} s", flush=True)
    plain.result()
    by_path = {}
    for rerun in range(2):
        t = time.time()
        cs.gradient_path(dev, struct, ee, q0, goals, inputs, plain, by_path, {})
        print(f"[phase] 6k gradients (run {rerun}) {time.time() - t:.1f} s", flush=True)
    pool.shutdown()
    print(json.dumps({"by_path": by_path, "fails": fails}))
    sys.exit(1 if fails else 0)
