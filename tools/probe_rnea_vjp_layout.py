"""Probe of how `rnea_bwd` stores its RNEA partials, on a CUDA card.

`rnea_bwd` (csrc/rnea.cu) takes q̄ and q̄d from 2D dual sweeps of the RNEA
(`drm_rnea_vjp` in csrc/dyn_step.cuh), which writes all 2D partials into one
array `jac`. A form that stored them into two local arrays, `jq` for the q
tangents and `jqd` for the qd tangents (`if (k < D) jq[k] = j; else
jqd[k - D] = j;`), gave a wrong q̄d on the card when a device function
filled them; the SASS shows `jqd` in the local-memory slot of the dual
RNEA's force accumulator. This script rebuilds csrc/rnea.cu with each of
these variants of the partials' storage

    one_array               the shipped source, unchanged
    two_arrays              the two local arrays, the sweeps written in the kernel
    two_arrays_fn           the two local arrays filled by a device function
    two_arrays_fn_noinline  the same, the function marked __noinline__
    one_array_fn_noinline   a copy of drm_rnea_vjp marked __noinline__
    direct_global           each partial stored straight into gq / gqd

under several compiler settings (`-O3`, ptxas `-O0`, device debug `-G`),
and for each build:

- holds rnea_bwd against its plain version (`rnea_bwd_reference`) on iiwa
  (B=65536), panda_with_gripper and kuka_iiwa7_allegro (B=4096), float32 and
  float64, gravity and damping on and off, with the outputs filled with NaN
  before the launch, so that an entry the kernel never writes shows;
- times rnea_bwd on iiwa B=65536 float32 (median of 20 by CUDA events);
- keeps ptxas's report (registers, stack frame, spills) and the SASS of
  `rnea_bwd_kernel` (instruction count, local loads and stores, and the
  text itself, gzipped under the output directory's `sass/`);
- with `--sanitize`, runs the float32 iiwa case of the `two_arrays_fn` build at
  B=256 under `compute-sanitizer` (memcheck, then initcheck).

Run from the repo root on a machine with one CUDA card and nvcc:

    python3 tools/probe_rnea_vjp_layout.py [--sanitize] [--out DIR]

It prints one line per case and writes `rnea_vjp_probe.json` into the
output directory (`--out`, by default build/rnea_vjp_probe/ of the checkout,
where the variant sources and libraries are built too).
"""

from __future__ import annotations

import argparse
import ctypes
import gzip
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import differentiable_robot_model_tpu_torch as drt  # noqa: E402
from differentiable_robot_model_tpu_torch.ops.kernels import build  # noqa: E402
from differentiable_robot_model_tpu_torch.ops.kernels import rnea as kn  # noqa: E402
from differentiable_robot_model_tpu_torch.ops.kernels.rollout import StepFlags, tree_struct  # noqa: E402

PROBE_DIR = ROOT / "build" / "rnea_vjp_probe"
SHIPPED = """  T jac[2 * ND];
  drm_rnea_vjp<T, NL, ND>(tr, qv, qdv, qddv, gv, jac);
  for (int d = 0; d < D; ++d) {
    gq[row + d] = jac[d];
    gqd[row + d] = jac[D + d];
  }
"""
SWEEP = """    Dual<T> qv2[ND], qdv2[ND], qddv2[ND], tauv[ND];
    for (int d = 0; d < D; ++d) {
      qv2[d] = Dual<T>(qv[d], k == d ? T(1) : T(0));
      qdv2[d] = Dual<T>(qdv[d], k == D + d ? T(1) : T(0));
      qddv2[d] = Dual<T>(qddv[d]);
    }
    Dual<T> Rl[NL][9], tl[NL][3];
    drm_local_all<Dual<T>, T, NL>(tr, qv2, Rl, tl);
    drm_rnea<Dual<T>, T, NL>(tr, Rl, tl, qdv2, qddv2, tauv);
    T j = T(0);
    for (int d = 0; d < D; ++d) j = j + gv[d] * tauv[d].t;
"""
STORE_TWO = "    if (k < D) jq[k] = j; else jqd[k - D] = j;\n"
TWO_OUT = """  for (int d = 0; d < D; ++d) {
    gq[row + d] = jq[d];
    gqd[row + d] = jqd[d];
  }
"""


def vjp_fn(name: str, qual: str, out: str, store: str) -> str:
    """A device function holding the 2D dual sweeps, as `drm_rnea_vjp` does."""
    return ("template <typename T, int NL, int ND>\n"
            f"{qual} void {name}(const Tree<T>& tr, const T* qv, const T* qdv, const T* qddv,\n"
            f"    const T* gv, {out}) {{\n  const int D = tr.D;\n"
            "  for (int k = 0; k < 2 * D; ++k) {\n" + SWEEP + store + "  }\n}\n\n")


# The device functions of the `*_fn*` variants, placed before the kernels:
# the two-array form and a copy of `drm_rnea_vjp`, either inlined as the
# compiler chooses or kept a call of its own (`__noinline__`), which puts the
# loop's arrays in the callee's frame, apart from the caller's arrays.
VJP_FNS = (vjp_fn("probe_vjp2", "__device__", "T* jq, T* jqd", STORE_TWO)
           + vjp_fn("probe_vjp2_noinline", "__device__ __noinline__", "T* jq, T* jqd", STORE_TWO)
           + vjp_fn("probe_vjp1_noinline", "__device__ __noinline__", "T* jac", "    jac[k] = j;\n"))
BODIES = {
    "one_array": SHIPPED,
    "two_arrays": "  T jq[ND], jqd[ND];\n  for (int k = 0; k < 2 * D; ++k) {\n" + SWEEP + STORE_TWO
    + "  }\n" + TWO_OUT,
    "two_arrays_fn": "  T jq[ND], jqd[ND];\n  probe_vjp2<T, NL, ND>(tr, qv, qdv, qddv, gv, jq, jqd);\n"
    + TWO_OUT,
    "two_arrays_fn_noinline": "  T jq[ND], jqd[ND];\n"
    "  probe_vjp2_noinline<T, NL, ND>(tr, qv, qdv, qddv, gv, jq, jqd);\n" + TWO_OUT,
    "one_array_fn_noinline": SHIPPED.replace("drm_rnea_vjp", "probe_vjp1_noinline"),
    "direct_global": "  for (int k = 0; k < 2 * D; ++k) {\n" + SWEEP
    + "    if (k < D) gq[row + k] = j; else gqd[row + k - D] = j;\n  }\n",
}
FLAGS = {"O3": (), "ptxas_O0": ("-Xptxas", "-O0"), "G": ("-G",)}
BUILDS = [("one_array", "O3"), ("two_arrays", "O3"), ("two_arrays_fn", "O3"),
          ("two_arrays_fn_noinline", "O3"), ("one_array_fn_noinline", "O3"),
          ("direct_global", "O3"), ("two_arrays", "ptxas_O0"), ("two_arrays", "G"),
          ("one_array", "G")]
CASES = (("iiwa", 65536), ("panda_gripper", 4096), ("allegro_kuka", 4096))
MODELS = {"iiwa": "DifferentiableKUKAiiwa", "panda_gripper": "DifferentiablePandaWithGripper",
          "allegro_kuka": "DifferentiableKukaIiwaAllegro"}
COMPILE_TIMEOUT_S = 300


def variant_source(body: str) -> str:
    src = (build.CSRC / "rnea.cu").read_text()
    if SHIPPED not in src:
        raise RuntimeError("csrc/rnea.cu no longer holds the block this probe replaces")
    src = src.replace(SHIPPED, BODIES[body])
    return src.replace("namespace {\n", "namespace {\n\n" + VJP_FNS, 1)


def compile_all():
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for body, flag in BUILDS:
        tag = f"{body}-{flag}"
        cu = PROBE_DIR / f"{tag}.cu"
        cu.write_text(variant_source(body))
        cmd = [build.nvcc(), *build.NVCC_FLAGS, *FLAGS[flag], "-I", str(build.CSRC),
               "-o", str(PROBE_DIR / f"lib{tag}.so"), str(cu)]
        procs[tag] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True), time.perf_counter())
    built = {}
    for tag, (p, t0) in procs.items():
        try:
            log, _ = p.communicate(timeout=max(1.0, COMPILE_TIMEOUT_S - (time.perf_counter() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            built[tag] = {"built": False, "why": f"nvcc over {COMPILE_TIMEOUT_S} s"}
            continue
        built[tag] = {"built": p.returncode == 0, "compile_s": round(time.perf_counter() - t0, 1),
                      "ptxas": ptxas_lines(log)}
        if p.returncode != 0:
            built[tag]["why"] = log[-2000:]
    return built


def ptxas_lines(log: str):
    """ptxas's report for each rnea_bwd_kernel instantiation: the function
    line and the two that follow it (stack frame, registers)."""
    lines, out = log.splitlines(), {}
    for i, ln in enumerate(lines):
        m = re.search(r"Compiling entry function '(\S*rnea_bwd_kernel\S*)'", ln)
        if m:
            out[m.group(1)] = " | ".join(x.split("info    :")[-1].strip() for x in lines[i + 1: i + 4])
    return out


def sass_stats(tag: str, out: Path):
    """Instruction, local-load and local-store counts of each rnea_bwd_kernel
    in the build's SASS; the text is kept gzipped."""
    lib = PROBE_DIR / f"lib{tag}.so"
    cuobjdump = str(Path(build.nvcc()).with_name("cuobjdump"))
    run = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True)
    if run.returncode != 0:
        return {"error": run.stderr[-500:]}
    stats, cur, keep = {}, None, []
    for ln in run.stdout.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = m.group(1) if "rnea_bwd_kernel" in m.group(1) else None
            if cur:
                stats[cur] = {"instructions": 0, "LDL": 0, "STL": 0}
        if cur:
            keep.append(ln)
            if re.search(r"/\*[0-9a-f]{4,}\*/", ln):
                stats[cur]["instructions"] += 1
                stats[cur]["LDL"] += " LDL" in ln
                stats[cur]["STL"] += " STL" in ln
    (out / "sass").mkdir(parents=True, exist_ok=True)
    with gzip.open(out / "sass" / f"{tag}.sass.gz", "wt") as f:
        f.write("\n".join(keep))
    return stats


def median_ms(launch, reps=20, warmup=3):
    """Median of `reps` CUDA-event times of `launch()`."""
    for _ in range(warmup):
        launch()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        launch()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[reps // 2]


def run_build(tag: str, cases, dtypes=(torch.float32, torch.float64)):
    lib = ctypes.CDLL(str(PROBE_DIR / f"lib{tag}.so"))
    kn._configure(lib)
    rows = []
    for name, n in cases:
        m32 = getattr(drt, MODELS[name])(device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(6)
        x32 = [torch.rand((n, m32.n_dofs), generator=gen, device="cuda") * 2 - 1 for _ in range(4)]
        for dtype in dtypes:
            s = m32.struct if dtype == torch.float32 else m32.struct.to(dtype=dtype)
            x = [t.to(dtype) for t in x32]
            for ig, ud in ((True, True), (False, False)):
                flags = StepFlags(0.0, ud, ig)
                outs = [torch.full_like(x[0], float("nan")) for _ in range(3)]
                fn = getattr(lib, "rnea_bwd_" + ("f32" if dtype == torch.float32 else "f64"))
                tree = tree_struct(s, flags)
                launch = lambda: fn(ctypes.byref(tree), *(t.data_ptr() for t in x),  # noqa: E731
                                    *(t.data_ptr() for t in outs), n,
                                    torch.cuda.current_stream().cuda_stream)
                rc = launch()
                torch.cuda.synchronize()
                ref = kn.rnea_bwd_reference(s, *x, ud, ig)
                errs = [((a - b).abs().max() / b.abs().max()).item() for a, b in zip(outs, ref)]
                unwritten = [int(torch.isnan(a).sum().item()) for a in outs]
                row = {"robot": name, "B": n, "dtype": str(dtype).split(".")[-1], "gravity": ig,
                       "damping": ud, "rc": rc, "rel_err_q_qd_qdd": errs, "nan_q_qd_qdd": unwritten}
                if name == "iiwa" and dtype == torch.float32 and ig and len(cases) > 1:
                    row["ms"] = median_ms(launch)
                rows.append(row)
                print(f"[probe] {tag} {name} B={n} {row['dtype']} gravity {ig} damping {ud}: rc {rc}, "
                      "rel err q/qd/qdd " + " / ".join(f"{e:.3e}" for e in errs)
                      + f", NaN left {unwritten}" + (f", {row['ms']:.4f} ms" if "ms" in row else ""),
                      flush=True)
    return rows


def sanitize(tool: str):
    """The float32 iiwa case of the two_arrays_fn build at B=256 under
    compute-sanitizer; its exit code and the end of its output."""
    exe = Path(build.nvcc()).with_name("compute-sanitizer")
    if not exe.exists():
        return {"tool": tool, "ran": False, "why": f"{exe} not found"}
    cmd = ["timeout", "-k", "5", "120", str(exe), "--tool", tool, "--error-exitcode", "9",
           sys.executable, __file__, "--only", "two_arrays_fn-O3", "--small"]
    t0 = time.perf_counter()
    run = subprocess.run(cmd, capture_output=True, text=True)
    return {"tool": tool, "ran": True, "rc": run.returncode, "s": round(time.perf_counter() - t0, 1),
            "tail": (run.stdout + run.stderr)[-1500:]}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sanitize", action="store_true")
    ap.add_argument("--only", help="run one already compiled build (used under the sanitizer)")
    ap.add_argument("--small", action="store_true", help="iiwa float32 at B=256 only")
    ap.add_argument("--out", type=Path, default=PROBE_DIR, help="where the report and SASS go")
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if a.only:
        run_build(a.only, (("iiwa", 256),) if a.small else CASES,
                  (torch.float32,) if a.small else (torch.float32, torch.float64))
        return 0
    a.out.mkdir(parents=True, exist_ok=True)
    report = {"card": subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                      "--format=csv,noheader"], capture_output=True, text=True).stdout.strip(),
              "nvcc": subprocess.run([build.nvcc(), "--version"], capture_output=True,
                                     text=True).stdout.strip().splitlines()[-1],
              "torch": torch.__version__}
    print("[probe]", report, flush=True)
    t0 = time.perf_counter()
    report["builds"] = compile_all()
    print(f"[probe] compiled in {time.perf_counter() - t0:.1f} s", flush=True)
    for tag, info in report["builds"].items():
        print(f"[probe] {tag}: built {info['built']} {info.get('compile_s')} s; ptxas {info.get('ptxas')}",
              flush=True)
        if not info["built"]:
            print(f"[probe] {tag}: {info.get('why', '')[-600:]}", flush=True)
            continue
        info["sass"] = sass_stats(tag, a.out)
        print(f"[probe] {tag}: sass {info['sass']}", flush=True)
        info["cases"] = run_build(tag, CASES)
    if a.sanitize:
        report["sanitizer"] = [sanitize(t) for t in ("memcheck", "initcheck")]
        for r in report["sanitizer"]:
            print(f"[probe] compute-sanitizer {r}", flush=True)
    (a.out / "rnea_vjp_probe.json").write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
