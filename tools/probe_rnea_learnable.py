"""Time and inspect K4's learnable form `rnea_fwd_learnable` and its robot
VJP `rnea_bwd_learnable` on the card, beside K4 `rnea_fwd` and its VJP
`rnea_bwd` (csrc/rnea.cu).

    python3 tools/probe_rnea_learnable.py [--ab DIR] [--frame SRC] [--switch]

`--ab DIR` times this checkout and the one at DIR in turns (DIR, this,
this, DIR), each in its own process that builds its own csrc/rnea.cu: per
kernel the card's time alone (`chip_smoke.card_time`: the card held busy
while the host queues the call) and the time by CUDA events around the
call (`sync_time`), medians of 20, on iiwa float32 (the learnable forms on
`chip_smoke.learnable_model("iiwa")`) at B=65536 and B=250; before timing,
each process holds its learnable kernels to their plain versions in
float64 at B=250 and checks that two VJP calls give the same bits. Make
DIR with `mkdir -p build/parent && git archive HEAD | tar -x -C
build/parent`.

`--switch` times this checkout's learnable kernels on iiwa at the batches
SWEEP_BS twice, in two processes: with the group form below every batch,
and with one thread a scenario at every batch (each from a copy of csrc/
whose switch, `kOneThreadWarpsPerSM`, is set so), to place the switch.

`--frame SRC` compiles the rnea.cu of the csrc directory SRC for sm_90a as
it is and in variants that each take one suspect out of the float64
serial9x7 robot VJP (the double-precision sincos of the robot partials, or
every sincos), and prints each variant's ptxas registers, stack frame and
spills for the learnable VJP and the PTX local depot NVVM gave it. The
variants are probes, not kernels: their arithmetic is wrong.

One JSON object a line; the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SWEEP_BS = (250, 1024, 2048, 4096, 8192, 16384, 65536)
# `--switch`'s two copies of csrc/: the group form at every batch, or never
FORMS = {"group": "constexpr int kOneThreadWarpsPerSM = 1 << 20;",
         "one_thread": "constexpr int kOneThreadWarpsPerSM = 0;"}
SWITCH = re.compile(r"constexpr int kOneThreadWarpsPerSM = \d+;")
NVCC = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
# (name, text, replacement): each variant replaces one text in SRC's files
FRAME_VARIANTS = (
    ("as_is", None, None),
    ("no_partials_sincos",
     "drm_sincos(k.q[P::dof(tr, l)], &sn, &cs);", "sn = k.q[P::dof(tr, l)]; cs = sn * sn;"),
    ("no_sincos",
     "__device__ __forceinline__ void drm_sincos(double x, double* s, double* c) { sincos(x, s, c); }",
     "__device__ __forceinline__ void drm_sincos(double x, double* s, double* c) { *s = x; *c = x * x; }"),
)


def _card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def _nvcc() -> str:
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _compile(src: Path, name: str, text, repl) -> dict:
    work = Path(tempfile.mkdtemp(prefix=f"frame_{name}_", dir=ROOT / "build"))
    shutil.copytree(src, work / "csrc")
    if text is not None:
        hits = 0
        for f in (work / "csrc").iterdir():
            body = f.read_text()
            if text in body:
                f.write_text(body.replace(text, repl))
                hits += 1
        if hits == 0:
            return {"variant": name, "applied": False}
    cu = work / "csrc" / "rnea.cu"
    rep = subprocess.run([_nvcc(), *NVCC, "-cubin", "-Xptxas", "-v", "-o", str(work / "rnea.cubin"),
                          str(cu)], capture_output=True, text=True)
    ptx = subprocess.run([_nvcc(), *NVCC, "-ptx", "-o", str(work / "rnea.ptx"), str(cu)],
                         capture_output=True, text=True)
    out = {"variant": name, "applied": True, "rc": rep.returncode}
    if rep.returncode != 0:
        out["error"] = rep.stderr[-2000:]
        return out
    sys.path.insert(0, str(ROOT))
    from differentiable_robot_model_tpu_torch.ops.kernels import build

    out["ptxas"] = [e for e in build.parse_ptxas(rep.stderr + rep.stdout, "learnable")]
    depots = {}
    if ptx.returncode == 0:
        fn = None
        for line in (work / "rnea.ptx").read_text().splitlines():
            m = re.match(r"\.visible \.entry (\S+)\(", line) or re.match(r"\.entry (\S+)\(", line)
            if m:
                fn = m.group(1)
            m = re.search(r"\.local \.align \d+ \.b8 \s*__local_depot\d+\[(\d+)\]", line)
            if m and fn and "learnable" in fn:
                depots[fn] = int(m.group(1))
    out["ptx_local_depot"] = depots
    calls = subprocess.run(["cuobjdump", "-sass", str(work / "rnea.cubin")] if shutil.which("cuobjdump")
                           else [str(Path(_nvcc()).with_name("cuobjdump")), "-sass", str(work / "rnea.cubin")],
                           capture_output=True, text=True).stdout
    counts, fn = {}, None
    for line in calls.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            fn = fn if "learnable" in fn else None
            if fn:
                counts[fn] = {"instructions": 0, "CALL": 0, "LDL": 0, "STL": 0}
        elif fn and "/*" in line and ";" in line:
            c = counts[fn]
            c["instructions"] += 1
            for op in ("CALL", "LDL", "STL"):
                if re.search(rf"\b{op}\b", line):
                    c[op] += 1
    out["sass"] = counts
    shutil.rmtree(work, ignore_errors=True)
    return out


def frame(src: Path) -> None:
    (ROOT / "build").mkdir(exist_ok=True)
    with ThreadPoolExecutor(len(FRAME_VARIANTS)) as pool:
        for r in pool.map(lambda v: _compile(src, *v), FRAME_VARIANTS):
            print(json.dumps({"frame": r}), flush=True)


def measure(root: Path, form: str | None = None) -> dict:
    """One checkout's times (this process imports the package under root);
    with `form`, this checkout's learnable kernels at SWEEP_BS alone, built
    from a copy of csrc/ with FORMS[form]'s switch."""
    sys.path.insert(0, str(root))
    import torch

    import chip_smoke as cs
    import differentiable_robot_model_tpu_torch as drt
    from differentiable_robot_model_tpu_torch.ops.kernels import build
    from differentiable_robot_model_tpu_torch.ops.kernels import rnea as kn

    pkg = Path(drt.__file__).resolve().parent
    if pkg.parent != root.resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    dev = torch.device("cuda", 0)
    if form is not None:
        copy = ROOT / "build" / f"csrc_{form}"
        shutil.rmtree(copy, ignore_errors=True)
        shutil.copytree(build.CSRC, copy)
        cu = copy / "rnea.cu"
        body, hits = SWITCH.subn(FORMS[form], cu.read_text())
        if hits != 1:
            raise RuntimeError("csrc/rnea.cu has no one `kOneThreadWarpsPerSM`")
        cu.write_text(body)
        build.CSRC = copy
    secs = build.build(("rnea",))
    out = {"root": str(root), "build_s": secs,
           "ptxas": [{k: e.get(k) for k in ("entry", "registers", "stack", "spill_stores", "spill_loads")}
                     for e in build.parse_ptxas(build.compiler_report("rnea"), "rnea_")]}
    s = drt.DifferentiableKUKAiiwa(device=dev).struct
    sl = kn._detached(cs.learnable_model("iiwa", torch.float32, dev).struct)
    if form is not None:
        gen = torch.Generator(device=dev).manual_seed(9)
        for B in SWEEP_BS:
            q, qd, qdd, w = (torch.rand((B, 7), generator=gen, device=dev) * 2 - 1 for _ in range(4))
            out[f"rnea_fwd_learnable_b{B}_card_ms"] = cs.card_time(lambda: kn.rnea_fwd_learnable(sl, q, qd, qdd))
            out[f"rnea_bwd_learnable_b{B}_card_ms"] = cs.card_time(
                lambda: kn.rnea_bwd_learnable(sl, q, qd, qdd, w))
        return {"form": form, **out}
    sl64 = sl.to(dtype=torch.float64)
    gen = torch.Generator(device=dev).manual_seed(9)
    # the plain versions, float64, and two VJP calls' bits
    x = [torch.rand((250, 7), generator=gen, device=dev, dtype=torch.float64) * 2 - 1 for _ in range(4)]
    tau, tau_p = kn.rnea_fwd_learnable(sl64, *x[:3]), kn.rnea_fwd_reference(sl64, *x[:3])
    gq, gqd, gqdd, rob = kn.rnea_bwd_learnable(sl64, *x)
    pq, pqd, pqdd, prob = kn.rnea_bwd_learnable_reference(sl64, *x)
    errs = [cs.rel_err(tau, tau_p)] + [cs.rel_err(a, b) for a, b in zip((gq, gqd, gqdd), (pq, pqd, pqdd))]
    errs += [cs.rel_err(rob[f], prob[f]) for f in kn.ROBOT_FIELDS]
    out["check_f64_worst_of_max"] = max(errs)
    again = kn.rnea_bwd_learnable(sl64, *x)[3]
    out["vjp_same_bits"] = all(torch.equal(rob[f], again[f]) for f in kn.ROBOT_FIELDS)
    if max(errs) > 1e-9:
        raise AssertionError(f"float64 learnable kernels disagree with their plain versions: {errs}")
    for B in (65536, 250):
        q, qd, qdd, w = (torch.rand((B, 7), generator=gen, device=dev) * 2 - 1 for _ in range(4))
        for name, call in (("rnea_fwd", lambda: kn.rnea_fwd(s, q, qd, qdd)),
                           ("rnea_bwd", lambda: kn.rnea_bwd(s, q, qd, qdd, w)),
                           ("rnea_fwd_learnable", lambda: kn.rnea_fwd_learnable(sl, q, qd, qdd)),
                           ("rnea_bwd_learnable", lambda: kn.rnea_bwd_learnable(sl, q, qd, qdd, w))):
            out[f"{name}_b{B}_card_ms"] = cs.card_time(call)
            out[f"{name}_b{B}_ms"] = cs.sync_time(call)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, help="the other checkout's root")
    ap.add_argument("--frame", type=Path, help="a csrc directory whose rnea.cu to probe")
    ap.add_argument("--switch", action="store_true", help="time both forms at SWEEP_BS")
    ap.add_argument("--measure", type=Path, help=argparse.SUPPRESS)  # one process's checkout
    ap.add_argument("--form", choices=sorted(FORMS), help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.measure is not None:
        print(json.dumps(measure(args.measure, args.form)), flush=True)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("probe_rnea_learnable: no CUDA device is available", file=sys.stderr)
        return 1
    print(json.dumps({"card": _card(), "device": torch.cuda.get_device_name(0)}), flush=True)
    if args.frame is not None:
        frame(args.frame.resolve())
    runs = []
    if args.ab is not None:
        runs += [[str(root.resolve())] for root in (args.ab, ROOT, ROOT, args.ab)]
    if args.switch:
        runs += [[str(ROOT), "--form", form] for form in FORMS]
    for run in runs:
        r = subprocess.run([sys.executable, __file__, "--measure", *run], capture_output=True,
                           text=True, env=dict(os.environ))
        if r.returncode != 0:
            print(r.stdout[-3000:], r.stderr[-3000:], file=sys.stderr)
            return r.returncode
        print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
