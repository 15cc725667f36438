"""Time K1 `fk_fwd`, K2 `fk_bwd`, K3 `kin_solve`, K4 `rnea_fwd`,
`rnea_bwd`, the `dyn_prologue` kernel, K9 `dyn_solve`, K10 `mppi_solve`,
K5 `dyn_rollout_fwd`, K6 `dyn_rollout_bwd`, K7 `dyn_rollout_ee_fwd` and K8
`dyn_rollout_ee_bwd` of one or two checkouts of the port on one CUDA card.

    python3 tools/time_solves.py [--check] [--detail]   # this checkout
    python3 tools/time_solves.py --ab DIR [--check]     # and the checkout at DIR

Each measurement runs in a process of its own that imports the package of
one checkout and builds that checkout's kernels there (nvcc, into its
`build/kernels/`): K1 and K2 at iiwa M = 204,800 (the kinematic `kernel`
engine's M = B H) and M = 4096 (the kinematic replan's metrics call),
each by events, with the card held busy (`_card_ms`, as below) and by the
host's µs a call, K3 at iiwa B=4096, H=50, 10 iterations, lr 0.05, eps
1.0, warm-started (the kinematic MPC main path's shape), K4 and `rnea_bwd`
at iiwa B=65536 float32 with the model API's ID and NLE calls that launch
K4 (the model API's shape; these three also with the card held busy while
the host queues each call, `_card_ms`, as below), the prologue
warm-started at iiwa H=50, B=4096 and B=256 (the dynamic and MPPI replans'
shapes; also by `_card_ms`), K9 at iiwa B=4096, H=50,
10 iterations
(the dynamic MPC main path's shape), K10 at iiwa B=256, K=128, H=50, 10
iterations (the MPPI main path's), K5 at iiwa H=50, B=4096 (the
differentiated `dynamic_rollout`), K7 at every shape a path launches it
at (`K7_SHAPES`: H=50, B=4096, the dynamic `kernel` engine's rollout; H=1,
B=4096 and H=1, B=256, the dynamic and MPPI plant steps; H=50, B=32768,
the MPPI `kernel` engine's K B sample lanes), K6 (a cotangent on qs) and
K8 (one on the ee trajectory) at H=50, B=4096, and, where the checkout has
them, K6's and K8's two phases alone (`dyn_rollout_replay`,
`dyn_rollout_adjoint`), each the median of 20 launches by CUDA events after
3 warm-ups (K7's plant steps, H=1, also with the card held busy while the
host queues each call, which times the card's work alone, and by the
host's wall time per call), and one warm replan of each MPC path at its main shape (the
kinematic `fused` engine, the dynamic and MPPI `fused` and `kernel`
engines), the median of 20 the same way (also the kinematic `kernel` engine,
which launches K1 12 and K2 10 times a replan). Each prints ptxas's
report for K1's, K2's, K3's, K4's, `rnea_bwd`'s, K5/K7's, K6/K8's, the
prologue's, K9's and K10's kernels (registers,
stack frame, spills) and one JSON line. With `--ab DIR` the checkouts run in turns: DIR's, this one's,
this one's, DIR's, then a summary line of the medians. With `--check`,
this checkout's K1, K2, K3, K9, K10, K5, K7, K6, K8, K4, `rnea_bwd`
and the prologue are first held
to their plain versions at small shapes (K1 and K2: M = 4101 on iiwa
and on kuka_iiwa7_allegro's thumb chain (13 links), float32 and float64,
the outputs NaN-prefilled; K3: B=64, H=10, 3 iterations,
float32; K9: B=64, H=10, 5 iterations, the effort box off and on; K10:
B=16, K=64, H=10, 3 iterations, float64; K5 and K7: H=10 at B=64 and at
13 past the least batch that runs a serial chain one thread a scenario
(8,461 on 132 SMs), float32 and float64; K6 and K8: B=64, H=10, float64, every cotangent at once;
K4 and `rnea_bwd`: B=256, float64; the prologue: B=64 and B=4096, H=10,
warm-started, preconditioned and not, float64), and the run fails if they
disagree (K1 within 2e-6, K2 within 1e-5 of the largest entry in
float32, both within 1e-12 in float64; K3
actions within 2e-3 and costs within 1e-3 relative, K9 torques within
5e-3, float32 K5/K7 qs, qds and ps within 5e-4, 2e-3 and 5e-5 or no
farther from float64 than twice the plain float32 (median and max over the
scenarios), K10, float64 K5, K7, K6, K8, K4, `rnea_bwd` and the prologue
within 1e-9 of the
largest entry). With `--detail`, this checkout's K3, K5, K7 and K10 are
also timed alone at B=1 (their dependent chains), K9 on iiwa with the
generic 16-link build in place of the serial one and on the 2-link robot,
and the SASS instructions of each K3, K5/K7, K9, K10, K6/K8-phase and
`rnea_bwd` instantiation are counted (`cuobjdump`).

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
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
B, H, ITERS, MPPI_B, MPPI_K, API_B = 4096, 50, 10, 256, 128, 65536
DT, LR, EPS, GOAL_W, EFFORT_W = 0.02, 0.5, 0.1, 10.0, 1e-4
KIN_LR, KIN_GOAL_W, KIN_EPS = 0.05, 100.0, 1.0  # MPCConfig's lr, the kinematic solve's goal weight, eps
REPS = 20
DEVICE = "cuda"
# (H, B) of each shape a path launches K7 at; K5 runs at (H, B)
K7_SHAPES = ((50, 4096), (1, 4096), (1, 256), (50, 32768))
# M of each K1/K2 shape: the kinematic `kernel` engine's B H, the metrics call's B
FK_MS = (B * H, B)
QS_TOL, QDS_TOL, PS_TOL, F64_SLACK = 5e-4, 2e-3, 5e-5, 2.0


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


def _card_ms(torch, fn, reps=REPS, warmup=3):
    """As `_sync_ms`, with the card held busy (`torch.cuda._sleep`, ~1 ms)
    while the host queues the events and the call, so that they time the
    card's work alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _host_us(torch, fn, n=200):
    """The host's wall time per call, µs, over n calls queued back to back
    (the card's work per call is shorter, so the queue does not fill)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / n * 1e6


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
    """The times of one checkout's K3, K4, rnea_bwd, the prologue, K9, K10,
    K6, K8, K5 and K7
    (this process imports the package under `root`)."""
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    import differentiable_robot_model_tpu_torch as drt
    from differentiable_robot_model_tpu_torch.ops.kernels import build
    from differentiable_robot_model_tpu_torch.ops.kernels import fk as kfk
    from differentiable_robot_model_tpu_torch.ops.kernels import rnea as kn
    from differentiable_robot_model_tpu_torch.ops.kernels import rollout as kr
    from differentiable_robot_model_tpu_torch.ops.kernels import solver as ks
    from differentiable_robot_model_tpu_torch.ops.kinematics import fk_link_position

    pkg = Path(drt.__file__).resolve().parent
    if pkg.parent != root.resolve():
        raise RuntimeError(f"imported {pkg}, not the package under {root}")
    dev = torch.device(DEVICE, 0)
    secs = build.build(("fk", "kin_solve", "rnea", "dyn_rollout", "dyn_solve", "mppi_solve"))
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
           "ptxas": _ptxas(build.compiler_report("fk"), "fk_")
           + _ptxas(build.compiler_report("kin_solve"), "kin_solve_kernel")
           + _ptxas(build.compiler_report("rnea"), "rnea_")
           + _ptxas(build.compiler_report("dyn_solve"), "dyn_solve_")
           + _ptxas(build.compiler_report("dyn_solve"), "prologue")
           + _ptxas(build.compiler_report("mppi_solve"), "mppi_kernel")
           + [line for kernel in ("bwd_kernel", "replay_kernel", "adjoint_kernel")
              for line in _ptxas(build.compiler_report("dyn_rollout"), kernel)]
           + _ptxas(build.compiler_report("dyn_rollout"), "fwd_")}
    kkw = dict(lr=KIN_LR, goal_weight=KIN_GOAL_W, eps=KIN_EPS)
    if check:
        out.update(_check_fk(torch, drt, kfk, s, ee, dev))
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
        e = ((kn.rnea_fwd(s64, *x[:3]) - kn.rnea_fwd_reference(s64, *x[:3])).abs().max()
             / kn.rnea_fwd_reference(s64, *x[:3]).abs().max()).item()
        out["check_rnea_fwd_f64"] = e
        if not e <= 1e-9:
            raise AssertionError(f"float64 K4 disagrees with its plain version: {e}")
        # the prologue on iiwa (its serial build runs a group of lanes a
        # scenario at every batch; the generic builds' one thread a scenario
        # is checked by chip_smoke.py) at B=64 and 4096, H=10, warm started,
        # preconditioned and not
        for n in (64, B):
            q0T = problem(n, 0.3)[0].double()
            init = torch.randn((10, D, n), generator=gen, device=dev, dtype=torch.float64) * 5
            for pre in (True, False):
                k = ks.dyn_prologue(s64, q0T, init, 10, pre)
                r = ks.dyn_prologue_reference(s64, q0T, init, 10, pre)
                e = max(((a - b).abs().max() / b.abs().max()).item()
                        for a, b in zip(k, r) if b is not None)
                out[f"check_prologue_f64_b{n}_pre{int(pre)}"] = e
                if not e <= 1e-9:
                    raise AssertionError(f"float64 prologue disagrees with its plain version: {e}")
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
        out.update(_check_forwards(torch, kr, s, ee, dev))
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
    # K1 and K2 at each of FK_MS
    gen = torch.Generator(device=dev).manual_seed(1)
    qM = (torch.rand((D, max(FK_MS)), generator=gen, device=dev) * 5.0 - 2.5).contiguous()
    gM = torch.randn((3, max(FK_MS)), generator=gen, device=dev).contiguous()
    for M in FK_MS:
        q, g = qM[:, :M].contiguous(), gM[:, :M].contiguous()
        for name, call in (("fk_fwd", lambda: kfk.fk_fwd(s, q, ee)),
                           ("fk_bwd", lambda: kfk.fk_bwd(s, q, g, ee))):
            out[f"{name}_m{M}_ms"] = _sync_ms(torch, call)
            out[f"{name}_m{M}_card_ms"] = _card_ms(torch, call)
            out[f"{name}_m{M}_host_us"] = _host_us(torch, call)
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
    # K4, and the model API's ID and NLE calls that launch it; each also with
    # the card held busy while the host queues the call (`_card_ms`), which
    # times the card's work alone where the wrapper's host time is longer
    q, qd, qdd = x[:3]
    for key, call in (("rnea_fwd", lambda: kn.rnea_fwd(s, q, qd, qdd)),
                      ("api_id", lambda: model.compute_inverse_dynamics(q, qd, qdd)),
                      ("api_nle", lambda: model.compute_non_linear_effects(q, qd))):
        out[f"{key}_ms"] = _sync_ms(torch, call)
        out[f"{key}_card_ms"] = _card_ms(torch, call)
    if detail:
        one = [t[..., :1].contiguous() for t in (q0T, goalT, a_warm)]
        out["kin_solve_b1_ms"] = _sync_ms(torch, lambda: kin(*one))
    q0T, qd0T, goalT = problem(B, 0.3)
    tr, H0, a0 = ks.dyn_prologue(s, q0T, None, H)
    tau = (tr[None] + torch.randn((H, D, B), generator=torch.Generator(device=dev).manual_seed(4),
                                  device=dev)).contiguous()
    # the prologue warm-started, at the dynamic replan's shape and the MPPI one's
    for n in (B, MPPI_B):
        qn, init = q0T[:, :n].contiguous(), tau[:, :, :n].contiguous()
        call = lambda: ks.dyn_prologue(s, qn, init, H)
        out[f"dyn_prologue_b{n}_ms"] = _sync_ms(torch, call)
        out[f"dyn_prologue_b{n}_card_ms"] = _card_ms(torch, call)
    args = (s, q0T, qd0T, goalT, tr, H0, a0, ee)
    out["dyn_solve_ms"] = _sync_ms(torch, lambda: ks.dynamic_adam_solve(*args, n_iters=ITERS, **kw))
    out.update(_time_forwards(torch, kr, s, ee, dev, detail))
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
    out.update(_time_replans(torch, s, ee, problem, q0T))
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


def _check_fk(torch, drt, kfk, s, ee, dev):
    """K1 and K2 against their plain versions at M = 4101 (a ragged block)
    on iiwa and on kuka_iiwa7_allegro's thumb chain (13 links), float32
    and float64, with their outputs NaN-prefilled."""
    out = {}
    thumb = drt.DifferentiableKukaIiwaAllegro(device=dev).struct
    empty = torch.empty
    for tag, rob, link in (("iiwa", s, ee), ("allegro", thumb, thumb.link_index("link_15.0_tip"))):
        gen = torch.Generator(device=dev).manual_seed(8)
        q = torch.rand((rob.n_dofs, 4101), generator=gen, device=dev, dtype=torch.float64) * 5 - 2.5
        g = torch.randn((3, 4101), generator=gen, device=dev, dtype=torch.float64)
        for dtype, tol_p, tol_dq in ((torch.float32, 2e-6, 1e-5), (torch.float64, 1e-12, 1e-12)):
            r, qx, gx = rob.to(dtype=dtype), q.to(dtype), g.to(dtype)
            torch.empty = lambda *a, **k: empty(*a, **k).fill_(float("nan"))
            try:
                p, dq = kfk.fk_fwd(r, qx, link), kfk.fk_bwd(r, qx, gx, link)
            finally:
                torch.empty = empty
            pr = kfk.fk_position_dof_major_reference(r, qx, link)
            dqr = kfk.fk_position_dof_major_vjp_reference(r, qx, gx, link)
            e = (p - pr).abs().max().item()
            e_dq = ((dq - dqr).abs().max() / dqr.abs().max()).item()
            bits = "f32" if dtype == torch.float32 else "f64"
            out[f"check_k1_{tag}_{bits}"], out[f"check_k2_{tag}_{bits}"] = e, e_dq
            if not (e <= tol_p and e_dq <= tol_dq):
                raise AssertionError(f"K1/K2 disagree with their plain versions ({tag}, {bits}): {e}, {e_dq}")
    return out


def _forward_inputs(torch, D, H_, B_, dev, dtype):
    """q0, qd0 [D, B] and tau [H, D, B] of K5/K7, uniform from a seed."""
    gen = torch.Generator(device=dev).manual_seed(H_ * 7919 + B_)
    u = lambda *shape, a: ((torch.rand(shape, generator=gen, device=dev, dtype=torch.float64) * 2 - 1)
                           * a).to(dtype).contiguous()
    return u(D, B_, a=0.5), u(D, B_, a=0.2), u(H_, D, B_, a=3.0)


def _time_forwards(torch, kr, s, ee, dev, detail):
    """K5 at H=50, B=4096 and K7 at each of K7_SHAPES (and, with `detail`,
    both at B=1)."""
    out = {}
    x = _forward_inputs(torch, s.n_dofs, H, B, dev, torch.float32)
    out["dyn_rollout_fwd_ms"] = _sync_ms(torch, lambda: kr.dyn_rollout_fwd(s, *x, DT))
    shapes = K7_SHAPES + (((H, 1),) if detail else ())
    for Hs, Bs in shapes:
        y = _forward_inputs(torch, s.n_dofs, Hs, Bs, dev, torch.float32)
        tag = "" if (Hs, Bs) == (H, B) else f"_h{Hs}_b{Bs}"
        call = lambda: kr.dyn_rollout_ee_fwd(s, *y, DT, ee)
        out[f"dyn_rollout_ee_fwd{tag}_ms"] = _sync_ms(torch, call)
        if Hs == 1:  # the plant step, where the host's time shows in the events
            out[f"dyn_rollout_ee_fwd{tag}_card_ms"] = _card_ms(torch, call)
            out[f"dyn_rollout_ee_fwd{tag}_host_us"] = _host_us(torch, call)
    if detail:
        y = _forward_inputs(torch, s.n_dofs, H, 1, dev, torch.float32)
        out[f"dyn_rollout_fwd_h{H}_b1_ms"] = _sync_ms(torch, lambda: kr.dyn_rollout_fwd(s, *y, DT))
    return out


def _time_replans(torch, s, ee, problem, mppi_q0T):
    """One warm replan of each MPC path at its main shape (the kinematic and
    dynamic paths at iiwa H=50, B=4096, 10 iterations; MPPI at B=256,
    K=128), on the `fused` engines and on the `kernel` engines (kinematic:
    K1 12 and K2 10 times a replan; dynamic: K7 12 and K8 10 times; MPPI:
    K7 12 times)."""
    from differentiable_robot_model_tpu_torch.trajopt import mpc

    q0T, _, goalT = problem(B, 0.3)
    q0, goals = q0T.T.contiguous(), goalT.T.contiguous()
    kcfg = mpc.MPCConfig(horizon=H, iters_per_step=ITERS, lr=KIN_LR)
    steps = {f"kin_{engine}": (mpc.make_mpc_step_batch(s, ee, kcfg, fk_impl=engine, eps=KIN_EPS),
                               mpc.mpc_init(s, q0, kcfg), goals) for engine in ("fused", "kernel")}
    for engine in ("fused", "kernel"):
        cfg = mpc.DynamicMPCConfig(horizon=H, iters_per_step=ITERS, rollout_impl=engine)
        steps[f"dyn_{engine}"] = (mpc.make_dynamic_mpc_step_batch(s, ee, cfg),
                                  mpc.dynamic_mpc_init(s, q0, torch.zeros_like(q0), cfg), goals)
    mq0 = mppi_q0T.T.contiguous()
    mgoals = goals[:MPPI_B]
    for engine in ("fused", "kernel"):
        cfg = mpc.MPPIMPCConfig(horizon=H, iters_per_step=ITERS, n_samples=MPPI_K,
                                rollout_impl=engine)
        steps[f"mppi_{engine}"] = (mpc.make_mppi_mpc_step_batch(s, ee, cfg),
                                   mpc.mppi_mpc_init(s, mq0, torch.zeros_like(mq0), cfg, 7), mgoals)
    out = {}
    for name, (step, state, g) in steps.items():
        state, _ = step(state, g)
        out[f"replan_{name}_ms"] = _sync_ms(torch, lambda: step(state, g))
    return out


def _check_forwards(torch, kr, s, ee, dev):
    """K5 and K7 against their plain versions at H=10 on B=64 (a serial
    chain's group step) and on the least batch past the card's switch to
    one thread a scenario, plus a ragged 13 (`fwd_one_thread_from`):
    float64 within 1e-9 of the largest entry; float32 qs, qds, ps within
    QS_TOL, QDS_TOL, PS_TOL, or no farther from float64 than F64_SLACK
    times the plain float32 (median and max over the scenarios, ROADMAP
    F4)."""
    out = {}
    one_thread = kr.fwd_one_thread_from(dev) + 13
    out["check_fwd_one_thread_b"] = one_thread
    for Bc in (64, one_thread):
        out.update(_check_forwards_at(torch, kr, s, ee, dev, Bc, "" if Bc == 64 else f"_b{Bc}"))
    return out


def _check_forwards_at(torch, kr, s, ee, dev, Bc, sfx):
    """`_check_forwards` at H=10, batch Bc; its keys end in `sfx`."""
    out = {}
    s64 = s.to(dtype=torch.float64)

    def lane_err(a, b):
        per = (a.double() - b.double()).abs().reshape(-1, a.shape[-1]).amax(0)
        return per.median().item(), per.max().item()

    x64 = _forward_inputs(torch, s.n_dofs, 10, Bc, dev, torch.float64)
    x32 = [t.float() for t in x64]
    for tag, kern, ref, extra, tols in (
            ("k5" + sfx, kr.dyn_rollout_fwd, kr.dyn_rollout_fwd_reference, (), (QS_TOL, QDS_TOL)),
            ("k7" + sfx, kr.dyn_rollout_ee_fwd, kr.dyn_rollout_ee_fwd_reference, (ee,),
             (QS_TOL, QDS_TOL, PS_TOL))):
        k64, p64 = kern(s64, *x64, DT, *extra), ref(s64, *x64, DT, *extra)
        e = max(((a - b).abs().max() / b.abs().max()).item() for a, b in zip(k64, p64))
        out[f"check_{tag}_f64"] = e
        if not e <= 1e-9:
            raise AssertionError(f"float64 {tag.upper()} disagrees with its plain version: {e}")
        k32, p32 = kern(s, *x32, DT, *extra), ref(s, *x32, DT, *extra)
        e32 = [(a - b).abs().max().item() for a, b in zip(k32, p32)]
        out[f"check_{tag}_f32"] = e32
        near = all(e <= t for e, t in zip(e32, tols)) or all(
            kv <= F64_SLACK * pv for a, b, c in zip(k32, p32, p64)
            for kv, pv in zip(lane_err(a, c), lane_err(b, c)))
        if not near:
            raise AssertionError(f"float32 {tag.upper()} disagrees with its plain version: {e32}")
    return out


def _sass_counts(build):
    """The SASS instruction count of each K3, rnea_bwd, K9, K10 and
    K6/K8-phase instantiation (`cuobjdump -sass`), where the toolkit has
    cuobjdump."""
    exe = Path(build.nvcc()).with_name("cuobjdump")
    counts = {}
    for name, kernel in (("kin_solve", "kin_solve_kernel"), ("rnea", "rnea_bwd_kernel"),
                         ("dyn_solve", "dyn_solve_"), ("mppi_solve", "mppi_kernel"),
                         ("dyn_rollout", "replay_kernel"), ("dyn_rollout", "adjoint_kernel"),
                         ("dyn_rollout", "fwd_")):
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
    ap.add_argument("--check", action="store_true", help="first hold this checkout's K1, K2, K3, "
                    "K9, K10, K5, K7, K6, K8, K4, rnea_bwd and the prologue to their plain versions "
                    "at small shapes")
    ap.add_argument("--detail", action="store_true", help="also time this checkout's K3, K5, "
                    "K7 and K10 at B=1, K9 on iiwa's generic build and on the 2-link robot, and "
                    "count the SASS instructions of each K3, K5/K7, rnea_bwd, K9, K10 and "
                    "K6/K8-phase instantiation")
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
    keys = (*(f"{k}_m{m}_{t}" for k in ("fk_fwd", "fk_bwd") for m in FK_MS
              for t in ("ms", "card_ms", "host_us")), "kin_solve_ms", *(f"{k}{t}" for k in ("rnea_fwd", "api_id", "api_nle")
                              for t in ("_ms", "_card_ms")), "rnea_bwd_ms",
            *(f"dyn_prologue_b{n}{t}" for n in (B, MPPI_B) for t in ("_ms", "_card_ms")),
            "dyn_solve_ms", "mppi_solve_ms",
            "dyn_rollout_fwd_ms",
            *(f"dyn_rollout_ee_fwd{'' if (h, b) == (H, B) else f'_h{h}_b{b}'}_ms" for h, b in K7_SHAPES),
            *(f"dyn_rollout_ee_fwd_h1_b{b}_{k}" for _, b in K7_SHAPES[1:3] for k in ("card_ms", "host_us")),
            "dyn_rollout_bwd_ms", "dyn_rollout_ee_bwd_ms", "k6_replay_ms", "k6_adjoint_ms",
            "k8_replay_ms", "k8_adjoint_ms", *(f"replan_{p}_ms" for p in (
                "kin_fused", "kin_kernel", "dyn_fused", "dyn_kernel", "mppi_fused", "mppi_kernel")))
    summary = {"card": card}
    for label, root in (("this", ROOT), ("other", a.ab)):
        mine = [r for r in runs if root is not None and Path(r["root"]) == root]
        if mine:
            summary[label] = {k: [r[k] for r in mine] for k in keys if k in mine[0]}
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
