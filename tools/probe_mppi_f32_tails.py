"""Probe of float32 K10 `mppi_solve`'s distance to float64, over several keys, on a CUDA card.

At temperature 0.01 a cost's rounding moves its softmax weight a hundredfold,
so where two samples nearly tie, float32 rounding can flip which one the
update follows, and that scenario's torques move far from the float64 solve
(ROADMAP F6). This script measures how far such tails reach. For each of
`chip_smoke.py`'s K10 check cases (`mppi_check_cases`: iiwa B=16 K=64 H=10 3
iterations, K=100, K=1024, a binding 5 N m box, no preconditioner,
kuka_iiwa7_allegro, panda_no_gripper, panda_with_gripper, and the main
path's shape B=256 K=128 H=50 10 iterations) and for each of several Philox keys it runs K10 and its plain
version in float32 and float64 and the plain float32 version once more on
the CPU (`chip_smoke.mppi_readings`), and prints, per case and key, the
median and max over the scenarios of each float32 evaluation's torque
distance to the float64 plain version, and each one's largest relative cost
distance. Per case it then prints the largest max each float32 evaluation
reached over the keys.

Run from the repo root on a machine with one CUDA card and nvcc:

    python3 tools/probe_mppi_f32_tails.py [--keys N] [--main-keys N] [--out DIR]

It writes `mppi_f32_tails.json` into the output directory (`--out`, by
default build/mppi_f32_tails/ of the checkout).
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
import differentiable_robot_model_tpu_torch as drt  # noqa: E402

FLOAT32_RUNS = ("kernel", "card", "cpu")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--keys", type=int, default=6, help="keys per small case")
    ap.add_argument("--main-keys", type=int, default=3, help="keys at the main path's shape")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "mppi_f32_tails")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_mppi_f32_tails: no CUDA device is available", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | {card}", flush=True)
    cs.build.build(("dyn_solve", "mppi_solve"))
    model = drt.DifferentiableKUKAiiwa(device=dev)
    s32 = model.struct
    ee = s32.link_index("iiwa_link_ee")
    cases = cs.mppi_check_cases(dev, s32, ee, model, torch.Generator(device=dev).manual_seed(6))
    keys = [cs.MPPI_KEY] + list(range(1, max(args.keys, args.main_keys)))
    report = {"card": card, "cases": {}}
    for name, (label, case_args, opts) in cases.items():
        rows = []
        for key in keys[:args.main_keys if name == "main" else args.keys]:
            t0 = time.perf_counter()
            r = cs.mppi_readings(*case_args, key=key, **opts)
            rows.append({"key": key, "e64": r["e64"], "e32": r["e32"], "cost32": r["cost32"],
                         "tau32": {n: list(v) for n, v in r["tau32"].items()}})
            print(f"[{name}] key {key:#x}: float64 {r['e64']:.3e} of max; torques to float64 "
                  "(median / max): " + ", ".join(
                      f"{n} {r['tau32'][n][0]:.3e} / {r['tau32'][n][1]:.3e}" for n in FLOAT32_RUNS)
                  + "; costs to float64: " + ", ".join(
                      f"{n} {r['cost32'][n]:.3e}" for n in FLOAT32_RUNS)
                  + f" ({time.perf_counter() - t0:.1f} s)", flush=True)
        most = {n: max(row["tau32"][n][1] for row in rows) for n in FLOAT32_RUNS}
        cost = {n: max(row["cost32"][n] for row in rows) for n in FLOAT32_RUNS}
        report["cases"][name] = {"label": label, "rows": rows, "max_over_keys": most,
                                 "cost_over_keys": cost}
        print(f"[{name}] {label}, {len(rows)} keys: largest torque max " + ", ".join(
            f"{n} {most[n]:.3e}" for n in FLOAT32_RUNS) + "; largest cost distance " + ", ".join(
            f"{n} {cost[n]:.3e}" for n in FLOAT32_RUNS), flush=True)
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "mppi_f32_tails.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
