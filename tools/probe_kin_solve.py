"""Where K3 `kin_solve` spends a solve on one CUDA card, by batch.

    python3 tools/probe_kin_solve.py [--out DIR]

Builds a copy of csrc/kin_solve.cu with a clock64 reading after each of the
kernel's warp barriers (block 0, thread 0: the start-up, then per pass the
clamp scan, the stage pass, the adjoint scan with the cost, and Adam) into
DIR (default `build/kin_solve_probe/`), launches it through the wrapper at
iiwa H=50, 10 iterations, lr 0.05, eps 1.0 (the kinematic MPC main path's
solve, scenarios as chip_smoke.py makes them, warm-started), and prints per
batch (B=1 to 4096): the kernel's card time per launch under
torch.profiler, the time by CUDA events (the wrapper's host time
included), and at B=1 and B=4096 the cycles of each phase per pass. Run
from the repo root on a machine with one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402
import differentiable_robot_model_tpu_torch as drt  # noqa: E402
from differentiable_robot_model_tpu_torch.ops.kernels import build  # noqa: E402
from differentiable_robot_model_tpu_torch.ops.kernels import solver as ks  # noqa: E402

PHASES = ("clamp scan", "stage pass", "adjoint scan + cost", "adam")
BATCHES = (1, 64, 256, 1056, 2112, 4096)
ARGS = dict(n_iters=10, lr=0.05, goal_weight=100.0, eps=1.0)
LAUNCHER = "// Launches kin_solve_kernel<NC>"  # the first line past the kernel


def instrumented(src: str) -> str:
    """csrc/kin_solve.cu with drm_prof[i] += the cycles since the previous
    reading, after the kernel's i-th warp barrier, and `kin_prof` to read
    and clear the sums."""
    src = src.replace(
        '#include "chain.cuh"',
        '#include "chain.cuh"\n__device__ unsigned long long drm_prof[8];\n'
        "#define DRM_MARK(i) if (blockIdx.x == 0 && threadIdx.x == 0) { unsigned long long c_ = "
        "clock64(); drm_prof[i] += c_ - t_last; t_last = c_; }\n", 1)
    src = src.replace("  extern __shared__ float shm[];\n",
                      "  extern __shared__ float shm[];\n  unsigned long long t_last = clock64();\n", 1)
    head, body = src.split("kin_solve_kernel(const __grid_constant__", 1)
    kernel, rest = body.split(LAUNCHER, 1)
    marks = iter(range(8))
    kernel = re.sub(r"__syncwarp\(\);", lambda m: f"__syncwarp();\n    DRM_MARK({next(marks)});", kernel)
    if next(marks) != 5:
        raise RuntimeError("csrc/kin_solve.cu no longer has the five warp barriers this probe reads")
    return (head + "kin_solve_kernel(const __grid_constant__" + kernel + LAUNCHER + rest
            + '\nextern "C" void kin_prof(unsigned long long* out) {\n'
              "  unsigned long long z[8] = {0};\n"
              "  cudaMemcpyFromSymbol(out, drm_prof, sizeof(z));\n"
              "  cudaMemcpyToSymbol(drm_prof, z, sizeof(z));\n}\n")


def card_us(fn) -> float:
    """The kernel's card time per launch (mean of 10) under torch.profiler."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
    return [e.device_time_total / e.count for e in prof.key_averages() if "kin_solve" in e.key][0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "kin_solve_probe")
    out = ap.parse_args().out
    out.mkdir(parents=True, exist_ok=True)
    src, lib_path = out / "kin_solve_probe.cu", out / "libkin_solve_probe.so"
    src.write_text(instrumented((build.CSRC / "kin_solve.cu").read_text()))
    r = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o", str(lib_path),
                        str(src)], capture_output=True, text=True)
    if r.returncode != 0:
        sys.stderr.write(r.stdout + r.stderr)
        return 1
    lib = ctypes.CDLL(str(lib_path))
    ks._configure(lib)
    lib.kin_prof.argtypes = [ctypes.c_void_p]
    build._loaded["kin_solve"] = lib  # the wrapper launches the instrumented copy

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    dev = torch.device("cuda", 0)
    model = drt.DifferentiableKUKAiiwa(device=dev)
    s = model.struct
    ee = s.link_index("iiwa_link_ee")
    q0, goals = chip_smoke.scenarios(model, s, "iiwa_link_ee", dev)
    lo, hi = s.limit_lower[:, None], s.limit_upper[:, None]
    q0T = torch.minimum(torch.maximum(q0.T, lo), hi).contiguous()
    goalT = goals.T.contiguous()
    a, _ = ks.kinematic_adam_solve(s, q0T, goalT, torch.zeros((chip_smoke.H, s.n_dofs, q0T.shape[1]),
                                                               device=dev), ee, **ARGS)
    a_warm = torch.cat([a[1:], torch.zeros_like(a[:1])]).contiguous()
    cycles = (ctypes.c_ulonglong * 8)()
    passes = ARGS["n_iters"] + 1
    for B in BATCHES:
        ins = [x[..., :B].contiguous() for x in (q0T, goalT, a_warm)]
        fn = lambda: ks.kinematic_adam_solve(s, *ins, ee, **ARGS)
        row = f"card {card_us(fn):.1f} µs, events {1e3 * chip_smoke.sync_time(fn):.1f} µs"
        if B in (1, BATCHES[-1]):
            lib.kin_prof(cycles)
            fn()
            torch.cuda.synchronize()
            lib.kin_prof(cycles)
            row += " (cycles a pass: " + ", ".join(
                f"{p} {c // passes}" for p, c in zip(PHASES, list(cycles)[1:5])) + ")"
        print(f"[kin_solve] {card} | iiwa H={chip_smoke.H} B={B}: {row}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
