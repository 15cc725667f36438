"""Time K3 `kin_solve`, K9 `dyn_solve`, K10 `mppi_solve`, K6
`dyn_rollout_bwd`, K8 `dyn_rollout_ee_bwd` and `rnea_bwd` of one or two
checkouts of the port on one CUDA card, beside K5 and K7.

    python3 tools/time_solves.py [--check] [--detail]   # this checkout
    python3 tools/time_solves.py --ab DIR [--check]     # and the checkout at DIR

Each measurement runs in a process of its own that imports the package of
one checkout and builds that checkout's kernels there (nvcc, into its
`build/kernels/`): K3 at iiwa B=4096, H=50, 10 iterations, lr 0.05, eps
1.0, warm-started (the kinematic MPC main path's shape), `rnea_bwd` at iiwa
B=65536 float32 (the model API's), K9 at iiwa B=4096, H=50, 10 iterations
(the dynamic MPC main path's shape), K10 at iiwa B=256, K=128, H=50, 10 iterations (the MPPI
main path's), K5 `dyn_rollout_fwd` and K7 `dyn_rollout_ee_fwd` at iiwa
B=4096, H=50, K6 (a cotangent on qs) and K8 (one on the ee trajectory) at
the same shape, and, where the checkout has them, K6's and K8's two phases
alone (`dyn_rollout_replay`, `dyn_rollout_adjoint`), each the median of 20
launches by CUDA events after 3 warm-ups, and the ratios K9/K5 and K10/K7
(K5 and K7 are the same code in both checkouts, so the ratios carry from
one call to the next). Each prints ptxas's report for K9's, K10's and
K6/K8's kernels (registers, stack frame, spills) and one JSON line. With
`--ab DIR` the checkouts run in turns: DIR's, this one's, this one's,
DIR's, then a summary line of the medians. With `--check`, this
checkout's K3, K9, K10, K6, K8 and `rnea_bwd` are first held to their
plain versions at small shapes (K3: B=64, H=10, 3 iterations, float32; K9:
B=64, H=10, 5 iterations, the effort box off and on; K10: B=16, K=64,
H=10, 3 iterations, float64; K6 and K8: B=64, H=10, float64, every
cotangent at once; `rnea_bwd`: B=256, float64), and the run fails if they
disagree (K3 actions within 2e-3 and costs within 1e-3 relative, K9
torques within 5e-3, K10, K6, K8 and `rnea_bwd` within 1e-9 of the largest
entry). With `--detail`, this checkout's K3 is also timed alone at B=1
(one warp: its scans' and its stage pass's dependent chains), K9 on iiwa with the generic 16-link build
in place of the serial one and on the 2-link robot, K10 alone at B=1 (one
block: its dependent chain), and the SASS instructions of each K3, K9,
K10, K6/K8-phase and `rnea_bwd` instantiation are counted (`cuobjdump`).

A second checkout of a parent commit can be made with `git archive`
(`mkdir -p build/parent && git archive HEAD~1 differentiable_robot_model_tpu_torch
pyproject.toml | tar -x -C build/parent`). Run from the repo root on a
machine with one CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, ITERS, MPPI_B, MPPI_K, API_B = 4096, 50, 10, 256, 128, 65536
DT, LR, EPS, GOAL_W, EFFORT_W = 0.02, 0.5, 0.1, 10.0, 1e-4
KIN_LR, KIN_GOAL_W, KIN_EPS = 0.05, 100.0, 1.0  # MPCConfig's lr, the kinematic solve's goal weight, eps
REPS = 20
DEVICE = "cuda"


def _sync_ms(torch, fn, reps=REPS, warmup=3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _ptxas(report, kernel):
    """ptxas's report for each instantiation of `kernel` in a build report,
    parsed by this checkout's build module (the other checkout's may not
    have the parser)."""
    spec = importlib.util.spec_from_file_location(
        "_drm_build", ROOT / "differentiable_robot_model_tpu_torch" / "ops" / "kernels" / "build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return [f"{e['entry'].split('(')[0]}: {e.get('registers')} registers, {e.get('stack')} bytes "
            f"stack frame, {e.get('spill_stores')} / {e.get('spill_loads')} bytes spill stores / loads"
            for e in mod.parse_ptxas(report, kernel)]


def measure(root: Path, check: bool, detail: bool = False) -> dict:
    """The times of one checkout's K3, rnea_bwd, K9, K10, K6, K8, K5 and K7
    (this process imports the package under `root`)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import differentiable_robot_model_tpu_torch as drt
    from differentiable_robot_model_tpu_torch.ops.kernels import build
    from differentiable_robot_model_tpu_torch.ops.kernels import rnea as kn
    from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr
    from differentiable_robot_model_tpu_torch.ops.kernels import solver as ks
    from differentiable_robot_model_tpu_torch.ops.kinematics import fk_link_position

    pkg = Path(drt.__file__).resolve().parent
    if pkg.parent != root.resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    dev = torch.device(DEVICE, 0)
    secs = build.build(("kin_solve", "rnea", "dyn_rollout", "dyn_solve", "mppi_solve"))
    model = drt.DifferentiableKUKAiiwa(device=dev)
    s = model.struct
    ee = s.link_index("iiwa_link_ee")
    D = s.n_dofs
    lim = model.get_joint_limits()
    lo = np.array([x["lower"] for x in lim], np.float32)
    hi = np.array([x["upper"] for x in lim], np.float32)

    def problem(n, scale_q0):
        rng = np.random.default_rng(0)
        q0 = rng.uniform(scale_q0 * lo, scale_q0 * hi, (n, D)).astype(np.float32)
        qg = rng.uniform(0.5 * lo, 0.5 * hi, (n, D)).astype(np.float32)
        goals, _ = model.compute_forward_kinematics(torch.from_numpy(qg).to(dev), "iiwa_link_ee")
        q0T = torch.from_numpy(q0).to(dev).T.contiguous()
        return q0T, torch.zeros_like(q0T), goals.T.contiguous()

    kw = dict(dt=DT, lr=LR, goal_weight=GOAL_W, effort_weight=EFFORT_W, eps=EPS)
    mkw = lambda K, its: dict(n_iters=its, n_samples=K, dt=DT, temperature=0.01, noise_sigma=5.0,
                              goal_weight=GOAL_W, effort_weight=EFFORT_W)
    out = {"root": str(root), "card": torch.cuda.get_device_name(0), "build_s": secs,
           "ptxas": _ptxas(build.compiler_report("kin_solve"), "kin_solve_kernel")
           + _ptxas(build.compiler_report("rnea"), "rnea_bwd_kernel")
           + _ptxas(build.compiler_report("dyn_solve"), "dyn_solve_")
           + _ptxas(build.compiler_report("mppi_solve"), "mppi_kernel")
           + [line for kernel in ("bwd_kernel", "replay_kernel", "adjoint_kernel")
              for line in _ptxas(build.compiler_report("dyn_rollout"), kernel)]}
    kkw = dict(lr=KIN_LR, goal_weight=KIN_GOAL_W, eps=KIN_EPS)
    if check:
        q0T, _, goalT = problem(64, 0.3)
        a0 = 0.01 * torch.randn((10, D, 64), generator=torch.Generator(device=dev).manual_seed(3),
                                device=dev)
        ak, ck = ks.kinematic_adam_solve(s, q0T, goalT, a0, ee, n_iters=3, **kkw)
        ar, cr = ks.kinematic_adam_solve_reference(s, q0T, goalT, a0, ee, n_iters=3, **kkw)
        e, ec = (ak - ar).abs().max().item(), ((ck - cr).abs() / cr.abs()).max().item()
        out["check_k3"], out["check_k3_cost_rel"] = e, ec
        if not (e <= 2e-3 and ec <= 1e-3):
            raise AssertionError(f"K3 disagrees with its plain version: {e}, {ec}")
        s64 = s.to(dtype=torch.float64)
        gen = torch.Generator(device=dev).manual_seed(2)
        x = [torch.rand((256, D), generator=gen, device=dev, dtype=torch.float64) * 2 - 1
             for _ in range(4)]
        e = max(((a - b).abs().max() / b.abs().max()).item()
                for a, b in zip(kn.rnea_bwd(s64, *x), kn.rnea_bwd_reference(s64, *x)))
        out["check_rnea_bwd_f64"] = e
        if not e <= 1e-9:
            raise AssertionError(f"float64 rnea_bwd disagrees with its plain version: {e}")
        q0T, qd0T, goalT = problem(64, 0.3)
        tr, H0, a0 = ks.dyn_prologue(s, q0T, None, 10)
        for effort in (False, True):
            args = (s, q0T, qd0T, goalT, tr, H0, a0, ee)
            tk, _ = ks.dynamic_adam_solve(*args, n_iters=5, respect_effort_limits=effort, **kw)
            tp, _ = ks.dynamic_adam_solve_reference(*args, n_iters=5, respect_effort_limits=effort, **kw)
            e = (tk - tp).abs().max().item()
            out[f"check_k9_effort{int(effort)}"] = e
            if not e <= 5e-3:
                raise AssertionError(f"K9 disagrees with its plain version: {e}")
        s64 = s.to(dtype=torch.float64)
        q0T, qd0T, goalT = (x[:, :16].double().contiguous() for x in problem(16, 0.4))
        tr, H0, a0 = ks.dyn_prologue(s64, q0T, None, 10)
        args = (s64, q0T, qd0T, goalT, tr, H0, a0, 7, ee)
        tk, _ = ks.mppi_solve(*args, **mkw(64, 3))
        tp, _ = ks.mppi_solve_reference(*args, **mkw(64, 3))
        e = ((tk - tp).abs().max() / tp.abs().max()).item()
        out["check_k10_f64"] = e
        if not e <= 1e-9:
            raise AssertionError(f"float64 K10 disagrees with its plain version: {e}")
        gen = torch.Generator(device=dev).manual_seed(5)
        q0T, qd0T = (x[:, :64].double().contiguous() for x in problem(64, 0.3)[:2])
        tau = torch.randn((10, D, 64), generator=gen, device=dev, dtype=torch.float64)
        gqs, gqds = (torch.randn((10, D, 64), generator=gen, device=dev, dtype=torch.float64)
                     for _ in range(2))
        gps = torch.randn((10, 3, 64), generator=gen, device=dev, dtype=torch.float64)
        qs, qds, ps = kr.dyn_rollout_ee_fwd(s64, q0T, qd0T, tau, DT, ee)
        for tag, kern, ref, args, opt in (
                ("k6", kr.dyn_rollout_bwd, kr.dyn_rollout_bwd_reference,
                 (s64, q0T, qd0T, tau, qs, qds, gqs, gqds, DT), {}),
                ("k8", kr.dyn_rollout_ee_bwd, kr.dyn_rollout_ee_bwd_reference,
                 (s64, q0T, qd0T, tau, qs, qds, ps, gps, DT, ee), dict(gqs=gqs, gqds=gqds))):
            e = max(((a - b).abs().max() / b.abs().max()).item()
                    for a, b in zip(kern(*args, **opt), ref(*args, **opt)))
            out[f"check_{tag}_f64"] = e
            if not e <= 1e-9:
                raise AssertionError(f"float64 {tag.upper()} disagrees with its plain version: {e}")
    # K3 warm-started as the kinematic replan runs it, and rnea_bwd
    q0T, _, goalT = problem(B, 0.3)
    a, _ = ks.kinematic_adam_solve(s, q0T, goalT, torch.zeros((H, D, B), device=dev), ee,
                                   n_iters=ITERS, **kkw)
    a_warm = torch.cat([a[1:], torch.zeros_like(a[:1])]).contiguous()
    kin = lambda q, g, a0: ks.kinematic_adam_solve(s, q, g, a0, ee, n_iters=ITERS, **kkw)
    out["kin_solve_ms"] = _sync_ms(torch, lambda: kin(q0T, goalT, a_warm))
    gen = torch.Generator(device=dev).manual_seed(2)
    x = [torch.rand((API_B, D), generator=gen, device=dev) * 2 - 1 for _ in range(4)]
    out["rnea_bwd_ms"] = _sync_ms(torch, lambda: kn.rnea_bwd(s, *x))
    if detail:
        one = [t[..., :1].contiguous() for t in (q0T, goalT, a_warm)]
        out["kin_solve_b1_ms"] = _sync_ms(torch, lambda: kin(*one))
    q0T, qd0T, goalT = problem(B, 0.3)
    tr, H0, a0 = ks.dyn_prologue(s, q0T, None, H)
    tau = (tr[None] + torch.randn((H, D, B), generator=torch.Generator(device=dev).manual_seed(4),
                                  device=dev)).contiguous()
    args = (s, q0T, qd0T, goalT, tr, H0, a0, ee)
    out["dyn_solve_ms"] = _sync_ms(torch, lambda: ks.dynamic_adam_solve(*args, n_iters=ITERS, **kw))
    out["dyn_rollout_fwd_ms"] = _sync_ms(torch, lambda: kr.dyn_rollout_fwd(s, q0T, qd0T, tau, DT))
    out["dyn_rollout_ee_fwd_ms"] = _sync_ms(
        torch, lambda: kr.dyn_rollout_ee_fwd(s, q0T, qd0T, tau, DT, ee))
    # K6 with a cotangent on qs, K8 with one on the ee trajectory, and their
    # phases where this checkout has them apart
    gen = torch.Generator(device=dev).manual_seed(6)
    qs, qds, ps = kr.dyn_rollout_ee_fwd(s, q0T, qd0T, tau, DT, ee)
    gqs = torch.randn((H, D, B), generator=gen, device=dev)
    gps = torch.randn((H, 3, B), generator=gen, device=dev)
    out["dyn_rollout_bwd_ms"] = _sync_ms(
        torch, lambda: kr.dyn_rollout_bwd(s, q0T, qd0T, tau, qs, qds, gqs, None, DT))
    out["dyn_rollout_ee_bwd_ms"] = _sync_ms(
        torch, lambda: kr.dyn_rollout_ee_bwd(s, q0T, qd0T, tau, qs, qds, ps, gps, DT, ee))
    if hasattr(kr, "dyn_rollout_replay"):
        for tag, opt in (("k6", dict(gqs=gqs)), ("k8", dict(ps=ps, gps=gps, ee_link_idx=ee))):
            scr = kr.dyn_rollout_replay(s, q0T, qd0T, tau, qs, qds, DT, **opt)
            out[f"{tag}_replay_ms"] = _sync_ms(
                torch, lambda: kr.dyn_rollout_replay(s, q0T, qd0T, tau, qs, qds, DT, **opt))
            out[f"{tag}_adjoint_ms"] = _sync_ms(
                torch, lambda: kr.dyn_rollout_adjoint(s, scr, DT, True, False))
    q0T, qd0T, goalT = problem(MPPI_B, 0.4)
    tr, H0, a0 = ks.dyn_prologue(s, q0T, None, H)
    margs = (s, q0T, qd0T, goalT, tr, H0, a0, 7, ee)
    out["mppi_solve_ms"] = _sync_ms(torch, lambda: ks.mppi_solve(*margs, **mkw(MPPI_K, ITERS)))
    out["k9_over_k5"] = out["dyn_solve_ms"] / out["dyn_rollout_fwd_ms"]
    out["k10_over_k7"] = out["mppi_solve_ms"] / out["dyn_rollout_ee_fwd_ms"]
    if detail:
        # K9 on iiwa with the generic 16-link build forced in place of its
        # serial one, and on the 2-link robot's serial build
        two = drt.DifferentiableTwoLinkRobot(device=dev).struct
        q2T = q0T[:2].contiguous()
        g2T = fk_link_position(two, (q2T + 0.3).T, two.n_links - 1).T.contiguous()
        pick = ks.kernel_variant
        for tag, rob, q, g, e, variant in (("iiwa_generic16", s, q0T, goalT, ee, "generic16"),
                                            ("2link", two, q2T, g2T, two.n_links - 1, None)):
            tr, H0, a0 = ks.dyn_prologue(rob, q, None, H)
            args = (rob, q, torch.zeros_like(q), g, tr, H0, a0, e)
            ks.kernel_variant = pick if variant is None else (lambda r, v=variant: v)
            out[f"dyn_solve_{tag}_ms"] = _sync_ms(
                torch, lambda: ks.dynamic_adam_solve(*args, n_iters=ITERS, **kw))
            ks.kernel_variant = pick
        one = [x[..., :1].contiguous() for x in margs[1:7]]
        out["k10_b1_ms"] = _sync_ms(torch, lambda: ks.mppi_solve(s, *one, 7, ee, **mkw(MPPI_K, ITERS)))
        out["sass_instructions"] = _sass_counts(build)
    return out


def _sass_counts(build):
    """The SASS instruction count of each K3, rnea_bwd, K9, K10 and
    K6/K8-phase instantiation (`cuobjdump -sass`), where the toolkit has
    cuobjdump."""
    exe = Path(build.nvcc()).with_name("cuobjdump")
    counts = {}
    for name, kernel in (("kin_solve", "kin_solve_kernel"), ("rnea", "rnea_bwd_kernel"),
                         ("dyn_solve", "dyn_solve_"), ("mppi_solve", "mppi_kernel"),
                         ("dyn_rollout", "replay_kernel"), ("dyn_rollout", "adjoint_kernel")):
        if not exe.exists():
            break
        sass = subprocess.run([str(exe), "-sass", str(build.library_path(name))],
                              capture_output=True, text=True).stdout
        fn = None
        for line in sass.splitlines():
            if "Function :" in line:
                fn = line.split("Function :", 1)[1].strip()
                fn = fn if kernel in fn else None
                if fn:
                    counts[fn] = 0
            elif fn and line.strip().startswith("/*") and "*/" in line and ";" in line:
                counts[fn] += 1
    return counts


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ab", type=Path, help="a second checkout, timed in turns with this one")
    ap.add_argument("--check", action="store_true", help="first hold this checkout's K3, K9, "
                    "K10, K6, K8 and rnea_bwd to their plain versions at small shapes")
    ap.add_argument("--detail", action="store_true", help="also time this checkout's K3 "
                    "at B=1, K9 on iiwa's generic build and on "
                    "the 2-link robot, K10 at B=1, and count the SASS instructions of each K3, "
                    "rnea_bwd, K9, K10 and K6/K8-phase instantiation")
    ap.add_argument("--root", type=Path, help=argparse.SUPPRESS)  # one measurement, in this process
    a = ap.parse_args()
    if a.root is not None:
        r = measure(a.root, a.check, a.detail)
        for line in r.pop("ptxas"):
            print(f"[ptxas] {a.root.name or 'this'} {line}", flush=True)
        print(json.dumps(r), flush=True)
        return 0
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(f"[card] {card}", flush=True)
    order = [(ROOT, a.check)] if a.ab is None else [(a.ab, False), (ROOT, a.check), (ROOT, False),
                                                     (a.ab, False)]
    runs = []
    for root, check in order:
        cmd = [sys.executable, __file__, "--root", str(root)] + (["--check"] if check else [])
        cmd += ["--detail"] if a.detail and root == ROOT else []
        p = subprocess.run(cmd, capture_output=True, text=True)
        sys.stdout.write(p.stdout)
        if p.returncode != 0:
            sys.stderr.write(p.stderr)
            return p.returncode
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
    keys = ("kin_solve_ms", "rnea_bwd_ms", "dyn_solve_ms", "mppi_solve_ms", "dyn_rollout_fwd_ms", "dyn_rollout_ee_fwd_ms",
            "dyn_rollout_bwd_ms", "dyn_rollout_ee_bwd_ms", "k6_replay_ms", "k6_adjoint_ms",
            "k8_replay_ms", "k8_adjoint_ms", "k9_over_k5", "k10_over_k7")
    summary = {"card": card}
    for label, root in (("this", ROOT), ("other", a.ab)):
        mine = [r for r in runs if root is not None and Path(r["root"]) == root]
        if mine:
            summary[label] = {k: [r[k] for r in mine] for k in keys if k in mine[0]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
