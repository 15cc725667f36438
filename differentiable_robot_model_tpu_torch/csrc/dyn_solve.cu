// Kernel dyn_solve (the whole torque-space Adam MPC solve in one launch) and
// its prologue dyn_prologue.
//
// dyn_solve replaces the JAX package's ops/pallas/solver.py `_solve_kernel`
// (wrapper `adam_solve_fused`). One thread per scenario runs every Adam
// iteration:
//
//   forward:  tau_h = tau_ref + H0 a_h, tau_c = clip(tau_h, +-emax) (with
//             the effort box), (q, qd) <- step(q, qd, tau_c), p_h = ee FK,
//             cost = cgoal_w sum |p_h - goal|^2 + ceff_w sum |H0 a_h|^2;
//             each stage's LDL^T factor of Ĥ = M(q) + dt diag(d), its
//             acceleration qdd* and J(q'_h)^T gpe_h (from the FK sweep's
//             joint axes and origins) are stored for the adjoint;
//   adjoint:  from the last stage back to the first, dq' = gq + J^T gpe_h,
//             the implicit-function step adjoint (the TPU kernel takes
//             jax.vjp of the step inside the kernel; CUDA has none) from
//             the stored factor and qdd*, with the RNEA partials from one
//             reverse sweep, the effort box's mask, the effort gradient on
//             the unclipped tau - tau_ref, the H0^T chain, and the
//             optax-form Adam update of a_h at once.
//
// dyn_prologue replaces no TPU kernel: it is the eager code around the
// solve (trajopt/solvers.py:424-425 and :500-502: the gravity torques and
// the mass matrix at q0, and the warm start's torques mapped back to action
// deltas through that matrix's LDL^T factor), which XLA fuses into a few
// programs and eager PyTorch would run as thousands of small launches.
//
// Layout: q0, qd0, tau_ref [D, B], goal [3, B], H0 [D*D, B], a0, a, tau
// [H*D, B], costs [n_iters+1, B]; scratch m, v, tau_s, qs, qds, jtg [H*D,
// B] and the step factors fac [H*(D(D-1)/2 + 2D), B], all scenario-minor.
// At iiwa H=50, B=4096 the scratch is about 69 MB.
//
// Bound on the H100: per scenario, stage and iteration the function needs a
// step and a chain FK with J^T g forward, and an LDL^T solve and an RNEA
// with its reverse sweep backward: thousands of FP32 operations over a few
// hundred bytes of inputs, so operations bound it. One thread per
// scenario at B=4096 is one warp per SM, so each scenario's dependent chain
// sets the time. The design cuts that chain: for a serial chain the step
// is instantiated with its shape fixed (dyn_step.cuh `DrmSerial`), so its
// per-link state stays in registers, and two warps share each scenario's
// work (`dyn_solve_pair_kernel`: the RNEA sweeps on one, the rest on the
// other); the adjoint reads the forward's factor, qdd* and J^T gpe instead
// of replaying the step and the FK sweep, and takes the RNEA partials from
// one reverse sweep in place of 2D dual-number sweeps. Trees run one thread
// per scenario (`dyn_solve_kernel`) on the generic builds.

#include <cstdint>

#include "dyn_step.cuh"

struct DynSolveParams {
  int H;
  int n_iters;
  int precond;  // tau = tau_ref + H0 a (else tau_ref + a)
  int effort;   // clip each applied torque to +-emax
  float cgoal_w, ceff_w;  // f32(f32(gw^2) / (3 H)), f32(f32(ew) / (H D))
  float gpe_w, geff_w;    // 2 cgoal_w, 2 ceff_w
  float b1, b2, omb1, omb2;
  float eps, eps_root;
};

namespace {

constexpr int kThreads = 32;

// Per stage, the forward's step factors that the adjoint reads: Ĥ's LDL^T
// factor (its strict lower triangle, then its diagonal) and qdd*.
__host__ __device__ constexpr int fac_rows(int D) { return D * (D - 1) / 2 + 2 * D; }

// K9 on one thread per scenario, for the generic builds (trees).
template <class Topo>
__global__ void __launch_bounds__(kThreads)
    dyn_solve_kernel(const __grid_constant__ Tree<float> tr, const __grid_constant__ Chain<float> ch,
                     const __grid_constant__ DynSolveParams P, const float* __restrict__ q0,
                     const float* __restrict__ qd0, const float* __restrict__ tau_ref,
                     const float* __restrict__ goal, const float* __restrict__ a0,
                     const float* __restrict__ H0, const float* __restrict__ bc,
                     float* __restrict__ tau_out, float* __restrict__ costs, float* __restrict__ a,
                     float* __restrict__ m, float* __restrict__ v, float* __restrict__ tau_s,
                     float* __restrict__ qs, float* __restrict__ qds, float* __restrict__ jtg,
                     float* __restrict__ fac, int64_t B) {
  constexpr int ND = Topo::ND, NP = ND * (ND + 1) / 2;
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = Topo::dofs(tr), H = P.H, NF = fac_rows(D), NS = D * (D - 1) / 2;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  // the factors of stage h: row f of `fac_rows`
  auto fat = [&](int h, int f) { return at(h * NF + f); };

  float q0r[ND], qd0r[ND], trf[ND];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q0r[d] = q0[at(d)];
    qd0r[d] = qd0[at(d)];
    trf[d] = tau_ref[at(d)];
  }
  const float gl[3] = {goal[at(0)], goal[at(1)], goal[at(2)]};
  for (int i = 0; i < H * D; ++i) {
    a[at(i)] = a0[at(i)];
    m[at(i)] = 0.f;
    v[at(i)] = 0.f;
  }
  auto box = [&](float x, int d) { return P.effort ? drm_clip(x, -tr.emax[d], tr.emax[d]) : x; };

  // The rollout at the current actions; saves tau, qs, qds, J^T gpe and the
  // step factors for the adjoint and returns the cost (with `final`, writes the
  // applied torques instead of the factors).
  auto forward = [&](bool final) {
    float q[ND], qd[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = q0r[d];
      qd[d] = qd0r[d];
    }
    float cg = 0.f, ce = 0.f;
    for (int h = 0; h < H; ++h) {
      float dtau[ND], tc[ND], Lf[NP], dg[ND], qdd[ND], qn[ND], qdn[ND];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        float s;
        if (P.precond) {
          s = 0.f;
#pragma unroll
          for (int e = 0; e < D; ++e) s = s + H0[at(d * D + e)] * a[at(h * D + e)];
        } else {
          s = a[at(h * D + d)];
        }
        dtau[d] = s;
        const float tau = trf[d] + s;
        tau_s[at(h * D + d)] = tau;
        tc[d] = box(tau, d);
        if (final) tau_out[at(h * D + d)] = tc[d];
      }
      drm_rr_fd_accel<float, Topo>(tr, q, qd, tc, Lf, dg, qdd);
      if (!final) {
#pragma unroll
        for (int i = 1; i < D; ++i)
#pragma unroll
          for (int j = 0; j < i; ++j) fac[fat(h, i * (i - 1) / 2 + j)] = Lf[drm_tri(i, j)];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          fac[fat(h, NS + d)] = dg[d];
          fac[fat(h, NS + D + d)] = qdd[d];
        }
      }
      drm_rr_euler<float, Topo>(tr, q, qd, qdd, qn, qdn);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        q[d] = qn[d];
        qd[d] = qdn[d];
        qs[at(h * D + d)] = qn[d];
        qds[at(h * D + d)] = qdn[d];
      }
      // the ee position, and J(q')^T gpe for the adjoint from each joint's
      // world axis z and origin o (drm_joint_vjp)
      float p[3], zs[ND][3], os[ND][3], gpe[3];
      int ty[ND];
#pragma unroll
      for (int d = 0; d < D; ++d) ty[d] = DRM_FIXED;
      drm_rr_ee<float, Topo>(
          ch, q,
          [&](int type, int dof, const float* z, const float* o) {
            ty[dof] = type;
            for (int i = 0; i < 3; ++i) {
              zs[dof][i] = z[i];
              os[dof][i] = o[i];
            }
          },
          p);
      for (int j = 0; j < 3; ++j) {
        const float diff = p[j] - gl[j];
        cg = cg + diff * diff;
        gpe[j] = P.gpe_w * diff;
      }
      if (!final) {
#pragma unroll
        for (int d = 0; d < D; ++d)
          jtg[at(h * D + d)] = ty[d] == DRM_FIXED ? 0.f : drm_joint_vjp(ty[d], zs[d], os[d], p, gpe);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) ce = ce + dtau[d] * dtau[d];
    }
    return P.cgoal_w * cg + P.ceff_w * ce;
  };

  // One call site of the forward, so that its unrolled step is emitted once.
  for (int t = 0;; ++t) {
    const bool final = t == P.n_iters;
    costs[at(t)] = forward(final);
    if (final) break;
    const float alpha = bc[2 * t], ibc2 = bc[2 * t + 1];
    float gq[ND], gqd[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) gq[d] = gqd[d] = 0.f;
    for (int h = H - 1; h >= 0; --h) {
      // dq' = gq + J(q')^T gpe_h
      float gqn[ND];
#pragma unroll
      for (int d = 0; d < D; ++d) gqn[d] = gq[d] + jtg[at(h * D + d)];
      // The step's adjoint from the stored factors (the implicit-function
      // identity of dyn_step.cuh's header): x̄ = (ḡqd' + dt ḡq') dclip(x),
      // λ = Ĥ⁻¹ dt x̄, then one reverse RNEA sweep at (q, qd, qdd*).
      float q[ND], qd[ND], qdd[ND], Lf[NP], dg[ND], gx[ND], rhs[ND], lam[ND], jac[2 * ND];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        q[d] = h == 0 ? q0r[d] : qs[at((h - 1) * D + d)];
        qd[d] = h == 0 ? qd0r[d] : qds[at((h - 1) * D + d)];
        dg[d] = fac[fat(h, NS + d)];
        qdd[d] = fac[fat(h, NS + D + d)];
      }
#pragma unroll
      for (int i = 1; i < D; ++i)
#pragma unroll
        for (int j = 0; j < i; ++j) Lf[drm_tri(i, j)] = fac[fat(h, i * (i - 1) / 2 + j)];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float x = qd[d] + tr.dt * qdd[d];
        gx[d] = (gqd[d] + tr.dt * gqn[d]) * drm_clip_grad(x, -tr.vmax[d], tr.vmax[d]);
        rhs[d] = tr.dt * gx[d];
      }
      drm_rr_ldl_solve<float, Topo>(tr, Lf, dg, rhs, lam);
      drm_rr_rnea_vjp<float, Topo>(tr, q, qd, qdd, lam, jac);
      float gt[ND];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        gq[d] = gqn[d] - jac[d];
        gqd[d] = gx[d] - jac[D + d];
        const float tau = tau_s[at(h * D + d)];
        const float g_box = P.effort ? lam[d] * drm_clip_grad(tau, -tr.emax[d], tr.emax[d]) : lam[d];
        gt[d] = g_box + P.geff_w * (tau - trf[d]);
      }
#pragma unroll
      for (int e = 0; e < D; ++e) {
        float g = gt[e];
        if (P.precond) {
          g = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) g = g + H0[at(d * D + e)] * gt[d];
        }
        const int64_t i = at(h * D + e);
        const float mu = P.b1 * m[i] + P.omb1 * g;
        const float nu = P.b2 * v[i] + P.omb2 * (g * g);
        m[i] = mu;
        v[i] = nu;
        a[i] = a[i] - alpha * mu / (sqrtf(nu * ibc2 + P.eps_root) + P.eps);
      }
    }
  }
}

// K9 for a serial chain, on two warps per block of kPairLanes scenarios,
// lane i of both warps on scenario i: warp 0 takes the RNEA sweeps, warp 1
// the rest, so that a scenario's chain of dependent operations runs on two
// schedulers at once. Per forward stage, warp 0 closes the previous stage
// (its ee FK, cost and J^T gpe) and computes the bias torques nle(q, qd)
// while warp 1 forms tau and Ĥ's LDL^T factor; warp 1 then solves for qdd*
// and both take the Euler step. Per adjoint stage, warp 0 computes the RNEA
// at (q, qd, qdd*) of the next stage down into shared memory while warp 1
// solves for λ, runs the reverse sweep from the RNEA in shared memory
// (double-buffered) and updates the actions. The arithmetic is
// dyn_solve_kernel's.
constexpr int kPairLanes = 32;

template <class Topo>
constexpr size_t pair_shared_bytes() {
  return sizeof(float) * kPairLanes *
         (2 * DrmSharedRnea<float, Topo, kPairLanes>::kSize + 2 * Topo::ND + 1);
}

template <class Topo>
__global__ void __launch_bounds__(2 * kPairLanes)
    dyn_solve_pair_kernel(const __grid_constant__ Tree<float> tr,
                          const __grid_constant__ Chain<float> ch,
                          const __grid_constant__ DynSolveParams P, const float* __restrict__ q0,
                          const float* __restrict__ qd0, const float* __restrict__ tau_ref,
                          const float* __restrict__ goal, const float* __restrict__ a0,
                          const float* __restrict__ H0, const float* __restrict__ bc,
                          float* __restrict__ tau_out, float* __restrict__ costs,
                          float* __restrict__ a, float* __restrict__ m, float* __restrict__ v,
                          float* __restrict__ tau_s, float* __restrict__ qs,
                          float* __restrict__ qds, float* __restrict__ jtg,
                          float* __restrict__ fac, int64_t B) {
  constexpr int ND = Topo::ND, NP = ND * (ND + 1) / 2, D = ND, NF = fac_rows(ND),
                NS = ND * (ND - 1) / 2;
  using Shared = DrmSharedRnea<float, Topo, kPairLanes>;
  extern __shared__ __align__(16) float pair_smem[];
  const int lane = int(threadIdx.x) % kPairLanes;
  const bool rnea_warp = int(threadIdx.x) < kPairLanes;
  const int64_t b0 = int64_t(blockIdx.x) * kPairLanes + lane;
  const bool live = b0 < B;
  const int64_t b = live ? b0 : B - 1;  // past the batch, a copy of the last scenario
  const int H = P.H;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  auto fat = [&](int h, int f) { return at(h * NF + f); };
  // shared memory: the adjoint's two RNEA buffers, then nle and qdd of the
  // forward's stage and the effort cost, each lane-strided
  auto rnea_buf = [&](int h) {
    return Shared{pair_smem + (h & 1) * Shared::kSize * kPairLanes + lane, tr};
  };
  float* x_nle = pair_smem + 2 * Shared::kSize * kPairLanes + lane;
  float* x_qdd = x_nle + ND * kPairLanes;
  float* x_ce = x_qdd + ND * kPairLanes;

  float q0r[ND], qd0r[ND], trf[ND];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q0r[d] = q0[at(d)];
    qd0r[d] = qd0[at(d)];
    trf[d] = tau_ref[at(d)];
  }
  const float gl[3] = {goal[at(0)], goal[at(1)], goal[at(2)]};
  if (!rnea_warp && live)
    for (int i = 0; i < H * D; ++i) {
      a[at(i)] = a0[at(i)];
      m[at(i)] = 0.f;
      v[at(i)] = 0.f;
    }
  __syncthreads();
  auto box = [&](float x, int d) { return P.effort ? drm_clip(x, -tr.emax[d], tr.emax[d]) : x; };

  for (int t = 0;; ++t) {
    const bool final = t == P.n_iters;
    // ---- the rollout
    float q[ND], qd[ND], cg = 0.f, ce = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = q0r[d];
      qd[d] = qd0r[d];
    }
    // warp 0: the ee FK at q_{h+1} closes stage h (cost, J^T gpe)
    auto close_stage = [&](int h) {
      float p[3], zs[ND][3], os[ND][3], gpe[3];
      int ty[ND];
#pragma unroll
      for (int d = 0; d < D; ++d) ty[d] = DRM_FIXED;
      drm_rr_ee<float, Topo>(
          ch, q,
          [&](int type, int dof, const float* z, const float* o) {
            ty[dof] = type;
            for (int i = 0; i < 3; ++i) {
              zs[dof][i] = z[i];
              os[dof][i] = o[i];
            }
          },
          p);
      for (int j = 0; j < 3; ++j) {
        const float diff = p[j] - gl[j];
        cg = cg + diff * diff;
        gpe[j] = P.gpe_w * diff;
      }
      if (!final && live) {
#pragma unroll
        for (int d = 0; d < D; ++d)
          jtg[at(h * D + d)] = ty[d] == DRM_FIXED ? 0.f : drm_joint_vjp(ty[d], zs[d], os[d], p, gpe);
      }
    };
    for (int h = 0; h < H; ++h) {
      float tc[ND], Lf[NP], dg[ND], qdd[ND];
      if (rnea_warp) {
        if (h > 0) close_stage(h - 1);
        float R[Topo::NL][9], tl[Topo::NL][3], zero[ND], nle[ND];
        drm_rr_local<float, Topo>(tr, q, R, tl);
#pragma unroll
        for (int d = 0; d < D; ++d) zero[d] = 0.f;
        DrmRneaState<float, Topo> st;
        drm_rr_rnea<float, Topo>(tr, R, tl, qd, zero, st, nle);
#pragma unroll
        for (int d = 0; d < D; ++d) x_nle[d * kPairLanes] = nle[d];
      } else {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          float s;
          if (P.precond) {
            s = 0.f;
#pragma unroll
            for (int e = 0; e < D; ++e) s = s + H0[at(d * D + e)] * a[at(h * D + e)];
          } else {
            s = a[at(h * D + d)];
          }
          ce = ce + s * s;
          const float tau = trf[d] + s;
          tc[d] = box(tau, d);
          if (live) {
            tau_s[at(h * D + d)] = tau;
            if (final) tau_out[at(h * D + d)] = tc[d];
          }
        }
        float R[Topo::NL][9], tl[Topo::NL][3];
        drm_rr_local<float, Topo>(tr, q, R, tl);
        drm_rr_crb<float, Topo>(tr, R, tl, Lf);
        if (tr.use_damping) {
#pragma unroll
          for (int d = 0; d < D; ++d) Lf[drm_tri(d, d)] = Lf[drm_tri(d, d)] + tr.dt_damping[d];
        }
        drm_rr_ldl_factor<float, Topo>(tr, Lf, dg);
      }
      __syncthreads();
      if (!rnea_warp) {
        float rhs[ND];
#pragma unroll
        for (int d = 0; d < D; ++d) rhs[d] = tc[d] - x_nle[d * kPairLanes];
        drm_rr_ldl_solve<float, Topo>(tr, Lf, dg, rhs, qdd);
#pragma unroll
        for (int d = 0; d < D; ++d) x_qdd[d * kPairLanes] = qdd[d];
        if (!final && live) {
#pragma unroll
          for (int i = 1; i < D; ++i)
#pragma unroll
            for (int j = 0; j < i; ++j) fac[fat(h, i * (i - 1) / 2 + j)] = Lf[drm_tri(i, j)];
#pragma unroll
          for (int d = 0; d < D; ++d) {
            fac[fat(h, NS + d)] = dg[d];
            fac[fat(h, NS + D + d)] = qdd[d];
          }
        }
      }
      __syncthreads();
      if (rnea_warp) {
#pragma unroll
        for (int d = 0; d < D; ++d) qdd[d] = x_qdd[d * kPairLanes];
      }
      float qn[ND], qdn[ND];
      drm_rr_euler<float, Topo>(tr, q, qd, qdd, qn, qdn);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        q[d] = qn[d];
        qd[d] = qdn[d];
      }
      if (!rnea_warp && live) {
#pragma unroll
        for (int d = 0; d < D; ++d) {
          qs[at(h * D + d)] = q[d];
          qds[at(h * D + d)] = qd[d];
        }
      }
    }
    if (rnea_warp) close_stage(H - 1);
    else x_ce[0] = ce;
    __syncthreads();
    if (rnea_warp && live) costs[at(t)] = P.cgoal_w * cg + P.ceff_w * x_ce[0];
    if (final) break;

    // ---- the adjoint, warp 0 one stage ahead of warp 1
    auto rnea_of = [&](int h) {  // warp 0: the RNEA at stage h into its buffer
      float qh[ND], qdh[ND], qddh[ND];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        qh[d] = h == 0 ? q0r[d] : qs[at((h - 1) * D + d)];
        qdh[d] = h == 0 ? qd0r[d] : qds[at((h - 1) * D + d)];
        qddh[d] = fac[fat(h, NS + D + d)];
      }
      rnea_buf(h).compute(qh, qdh, qddh);
    };
    if (rnea_warp) rnea_of(H - 1);
    __syncthreads();
    const float alpha = bc[2 * t], ibc2 = bc[2 * t + 1];
    float gq[ND], gqd[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) gq[d] = gqd[d] = 0.f;
    for (int h = H - 1; h >= 0; --h) {
      if (rnea_warp) {
        if (h > 0) rnea_of(h - 1);
      } else {
        // dq' = gq + J(q')^T gpe_h; the step's adjoint from the stored
        // factors (dyn_solve_kernel's), the RNEA from shared memory
        float gqn[ND], qd[ND], qdd[ND], Lf[NP], dg[ND], gx[ND], rhs[ND], lam[ND], jac[2 * ND];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          gqn[d] = gq[d] + jtg[at(h * D + d)];
          qd[d] = h == 0 ? qd0r[d] : qds[at((h - 1) * D + d)];
          dg[d] = fac[fat(h, NS + d)];
          qdd[d] = fac[fat(h, NS + D + d)];
        }
#pragma unroll
        for (int i = 1; i < D; ++i)
#pragma unroll
          for (int j = 0; j < i; ++j) Lf[drm_tri(i, j)] = fac[fat(h, i * (i - 1) / 2 + j)];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          const float x = qd[d] + tr.dt * qdd[d];
          gx[d] = (gqd[d] + tr.dt * gqn[d]) * drm_clip_grad(x, -tr.vmax[d], tr.vmax[d]);
          rhs[d] = tr.dt * gx[d];
        }
        drm_rr_ldl_solve<float, Topo>(tr, Lf, dg, rhs, lam);
        drm_rr_rnea_reverse<float, Topo>(tr, rnea_buf(h), qd, lam, jac);
        float gt[ND];
#pragma unroll
        for (int d = 0; d < D; ++d) {
          gq[d] = gqn[d] - jac[d];
          gqd[d] = gx[d] - jac[D + d];
          const float tau = tau_s[at(h * D + d)];
          const float g_box = P.effort ? lam[d] * drm_clip_grad(tau, -tr.emax[d], tr.emax[d]) : lam[d];
          gt[d] = g_box + P.geff_w * (tau - trf[d]);
        }
#pragma unroll
        for (int e = 0; e < D; ++e) {
          float g = gt[e];
          if (P.precond) {
            g = 0.f;
#pragma unroll
            for (int d = 0; d < D; ++d) g = g + H0[at(d * D + e)] * gt[d];
          }
          const int64_t i = at(h * D + e);
          const float mu = P.b1 * m[i] + P.omb1 * g;
          const float nu = P.b2 * v[i] + P.omb2 * (g * g);
          if (live) {
            m[i] = mu;
            v[i] = nu;
            a[i] = a[i] - alpha * mu / (sqrtf(nu * ibc2 + P.eps_root) + P.eps);
          }
        }
      }
      __syncthreads();
    }
  }
}

// ---- the prologue ------------------------------------------------------------
//
// Per scenario: tau_ref = RNEA(q0, 0, 0) with gravity, H0 = M(q0) (the
// plain mass matrix: no dt diag(d) on its diagonal) and its LDL^T factor,
// then a0[h] = H0^-1 (init[h] - tau_ref) for every stage h < H (zeros
// without init, the plain difference without precond). Phase 1 is each
// scenario's chain up to the factor, which it leaves in shared memory;
// phase 2, after a barrier, spreads the H solves, which share the factor
// and not each other's results, over the block's threads: one (stage,
// scenario) pair at a time, scenario fastest, so that the reads of init and
// the writes of a0 stay coalesced. On a serial chain phase 1 runs a
// scenario on a group of lanes, one lane a link (`prologue_group_kernel`,
// fwd_group_kernel's layout in dyn_rollout.cu); the generic builds run it
// one thread a scenario (`prologue_kernel`). Both give the card the same
// warps, 64 threads to 8 scenarios (16 for the 2-link robot's group of
// 4): the group keeps all of them busy in phase 1 and its chain short. On
// iiwa it measured as fast as one thread a scenario or faster at B=4096
// and within 4% at B=256 (PERF.md, the prologue's phase 1).

// What phase 1 leaves in shared memory for each scenario: the factor's
// packed lower triangle (entry (i, k) at drm_tri(i, k); the diagonal's slots
// unused), its diagonal at kDg, tau_ref at kTrf; the stride odd, so that
// lanes on distinct scenarios read distinct banks.
template <class P>
struct PrologueKeep {
  static constexpr int NP = P::ND * (P::ND + 1) / 2;
  static constexpr int kDg = NP, kTrf = NP + P::ND, kStride = (NP + 2 * P::ND) | 1;
};

// Phase 2 for the block's S scenarios b0 ... b0 + S - 1.
template <typename T, class P, int S>
__device__ __forceinline__ void prologue_solves(const Tree<T>& tr, const T* keep,
                                                const T* __restrict__ init, T* __restrict__ a0,
                                                int H, int precond, int64_t b0, int64_t B) {
  using K = PrologueKeep<P>;
  constexpr int ND = P::ND;
  const int D = P::dofs(tr);
  for (int pair = int(threadIdx.x); pair < H * S; pair += int(blockDim.x)) {
    const int h = pair / S, j = pair % S;
    const int64_t b = b0 + j;
    if (b >= B) continue;
    auto at = [&](int row) { return int64_t(row) * B + b; };
    const T* mine = keep + j * K::kStride;
    T rhs[ND], x[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) rhs[d] = init ? init[at(h * D + d)] - mine[K::kTrf + d] : T(0);
    if (init && precond) {
      drm_rr_ldl_solve<T, P>(tr, mine, mine + K::kDg, rhs, x);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) x[d] = rhs[d];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) a0[at(h * D + d)] = x[d];
  }
}

// Phase 1 on one thread a scenario (threads 0 ... S-1 of the block's NT),
// on the policy's register-resident sweeps.
template <typename T, class P, int S, int NT>
__global__ void __launch_bounds__(NT)
    prologue_kernel(const __grid_constant__ Tree<T> tr, const T* __restrict__ q0,
                    const T* __restrict__ init, T* __restrict__ tau_ref, T* __restrict__ H0,
                    T* __restrict__ a0, int H, int precond, int64_t B) {
  static_assert(S <= NT && NT % S == 0, "a block's threads cover its scenarios evenly");
  using K = PrologueKeep<P>;
  constexpr int NL = P::NL, ND = P::ND;
  __shared__ T keep[S * K::kStride];
  const int D = P::dofs(tr);
  const int64_t b0 = int64_t(blockIdx.x) * S;
  const int j = int(threadIdx.x);
  if (j < S && b0 + j < B) {
    const int64_t b = b0 + j;
    auto at = [&](int row) { return int64_t(row) * B + b; };
    T* mine = keep + j * K::kStride;
    T q[ND], zero[ND], trf[ND], R[NL][9], t[NL][3];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = q0[at(d)];
      zero[d] = T(0);
    }
    drm_rr_local<T, P>(tr, q, R, t);
    {
      DrmRneaState<T, P> st;
      drm_rr_rnea<T, P>(tr, R, t, zero, zero, st, trf);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      tau_ref[at(d)] = trf[d];
      mine[K::kTrf + d] = trf[d];
    }
    if (precond) {
      T Lf[K::NP], dg[ND];
      drm_rr_crb<T, P>(tr, R, t, Lf);
#pragma unroll
      for (int i = 0; i < D; ++i)
#pragma unroll
        for (int k = 0; k < D; ++k) H0[at(i * D + k)] = Lf[k <= i ? drm_tri(i, k) : drm_tri(k, i)];
      drm_rr_ldl_factor<T, P>(tr, Lf, dg);
#pragma unroll
      for (int i = 0; i < D; ++i) {
#pragma unroll
        for (int k = 0; k < i; ++k) mine[drm_tri(i, k)] = Lf[drm_tri(i, k)];
        mine[K::kDg + i] = dg[i];
      }
    }
  }
  __syncthreads();
  prologue_solves<T, P, S>(tr, keep, init, a0, H, precond, b0, B);
}

// Phase 1 of a serial chain on a group of G lanes a scenario, S scenarios a
// block: a step of fwd_group_kernel (dyn_rollout.cu) at qd = 0, lane g
// owning link g + 1 (its dof g, and M's row of that dof):
// `drm_group_forward` and `drm_group_backward` give every lane tau_ref
// (the RNEA's bias at qd = qdd = 0) and M, then every lane factors M, and
// lane g stores dof g's values. `prologue_kernel`'s arithmetic; lanes past
// B run on scenario B - 1 and store nothing, so that every lane meets every
// shuffle.
template <typename T, class P, int G, int S>
__global__ void __launch_bounds__(G * S)
    prologue_group_kernel(const __grid_constant__ Tree<T> tr, const T* __restrict__ q0,
                          const T* __restrict__ init, T* __restrict__ tau_ref,
                          T* __restrict__ H0, T* __restrict__ a0, int H, int precond, int64_t B) {
  static_assert(P::serial, "the group is laid out for a serial chain");
  static_assert(G >= P::NL - 1 && 32 % G == 0 && (G * S) % 32 == 0,
                "a lane a moving link, whole warps of whole groups");
  using K = PrologueKeep<P>;
  constexpr int NL = P::NL, ND = P::ND;
  __shared__ T keep[S * K::kStride];
  __shared__ DrmGroupLinks<T, NL> sl;
  sl.load(tr);
  __syncthreads();
  const int g = int(threadIdx.x) % G, j = int(threadIdx.x) / G;
  const int lk = min(g + 1, NL - 1);  // the lane's link (past the last link: the last again)
  const int64_t b0 = int64_t(blockIdx.x) * S;
  const bool live = b0 + j < B;
  const int64_t b = live ? b0 + j : B - 1;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  T* mine = keep + j * K::kStride;
  T q[ND], zero[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    q[d] = q0[at(d)];
    zero[d] = T(0);
  }
  T Ro[9], w[3], dw[3], dv[3], Rw[9], pw[3], trf[ND], Lf[K::NP], dg[ND];
  drm_group_forward<T, P, G>(tr, sl, lk, q, zero, Ro, w, dw, dv, Rw, pw);
  drm_group_backward<T, P, G>(tr, sl, lk, Ro, w, dw, dv, Rw, pw, trf, Lf);
  // lane g: dof g's tau_ref, H0's row and column g, the factor's row g
#pragma unroll
  for (int r = 0; r < ND; ++r) {
    if (!live || r != g) continue;
    tau_ref[at(r)] = trf[r];
    mine[K::kTrf + r] = trf[r];
    if (precond) {
#pragma unroll
      for (int i = 0; i <= r; ++i) {
        H0[at(r * ND + i)] = Lf[drm_tri(r, i)];
        H0[at(i * ND + r)] = Lf[drm_tri(r, i)];
      }
    }
  }
  if (precond) {
    drm_rr_ldl_factor<T, P>(tr, Lf, dg);
#pragma unroll
    for (int r = 0; r < ND; ++r) {
      if (!live || r != g) continue;
#pragma unroll
      for (int k = 0; k < r; ++k) mine[drm_tri(r, k)] = Lf[drm_tri(r, k)];
      mine[K::kDg + r] = dg[r];
    }
  }
  __syncthreads();
  prologue_solves<T, P, S>(tr, keep, init, a0, H, precond, b0, B);
}

inline unsigned blocks_for(int64_t B) { return unsigned((B + kThreads - 1) / kThreads); }

template <typename T>
int launch_prologue(int variant, const Tree<T>* tr, const T* q0, const T* init, T* tau_ref, T* H0,
                    T* a0, int H, int precond, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  return drm_by_variant(variant, [&](auto p) {
    using P = decltype(p);
    if constexpr (P::serial) {
      constexpr int G = drm_group_lanes<P>(), S = 64 / G;
      prologue_group_kernel<T, P, G, S><<<unsigned((B + S - 1) / S), G * S, 0, s>>>(
          *tr, q0, init, tau_ref, H0, a0, H, precond, B);
    } else {
      // 8 scenarios a block: a 32-dof float64 factor is ~4.7 KB of shared
      // memory a scenario
      prologue_kernel<T, P, 8, 64><<<unsigned((B + 7) / 8), 64, 0, s>>>(*tr, q0, init, tau_ref, H0,
                                                                       a0, H, precond, B);
    }
    return int(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// sizeof(Tree<float>), sizeof(Tree<double>), sizeof(Chain<float>),
// sizeof(DynSolveParams), then the (links, dofs) of each serial
// instantiation: the Python side checks its ctypes mirror and its variant
// table.
void dyn_solve_layout(int64_t* out) {
  out[0] = sizeof(Tree<float>);
  out[1] = sizeof(Tree<double>);
  out[2] = sizeof(Chain<float>);
  out[3] = sizeof(DynSolveParams);
  drm_variant_shapes(out + 4);
}

// `variant`: the instantiation ops/kernels/rollout.py `kernel_variant` names.
int dyn_prologue_f32(int variant, const Tree<float>* tr, const float* q0, const float* init,
                     float* tau_ref, float* H0, float* a0, int H, int precond, int64_t B,
                     void* stream) {
  return launch_prologue(variant, tr, q0, init, tau_ref, H0, a0, H, precond, B, stream);
}

int dyn_prologue_f64(int variant, const Tree<double>* tr, const double* q0, const double* init,
                     double* tau_ref, double* H0, double* a0, int H, int precond, int64_t B,
                     void* stream) {
  return launch_prologue(variant, tr, q0, init, tau_ref, H0, a0, H, precond, B, stream);
}

int dyn_solve_f32(int variant, const Tree<float>* tr, const Chain<float>* ch,
                  const DynSolveParams* P, const float* q0, const float* qd0, const float* tau_ref,
                  const float* goal, const float* a0, const float* H0, const float* bc,
                  float* tau_out, float* costs, float* a, float* m, float* v, float* tau_s,
                  float* qs, float* qds, float* jtg, float* fac, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  auto run = [&](auto kern) {
    kern<<<blocks_for(B), kThreads, 0, s>>>(*tr, *ch, *P, q0, qd0, tau_ref, goal, a0, H0, bc, tau_out,
                                            costs, a, m, v, tau_s, qs, qds, jtg, fac, B);
    return int(cudaGetLastError());
  };
  auto run_pair = [&](auto kern, size_t shm) {
    if (shm > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shm));
      if (e != cudaSuccess) return int(e);
    }
    const unsigned blocks = unsigned((B + kPairLanes - 1) / kPairLanes);
    kern<<<blocks, 2 * kPairLanes, shm, s>>>(*tr, *ch, *P, q0, qd0, tau_ref, goal, a0, H0, bc,
                                              tau_out, costs, a, m, v, tau_s, qs, qds, jtg, fac, B);
    return int(cudaGetLastError());
  };
  switch (variant) {
    case DRM_GENERIC16: return run(dyn_solve_kernel<DrmGeneric<16>>);
    case DRM_GENERIC32: return run(dyn_solve_kernel<DrmGeneric<32>>);
    case DRM_SERIAL_9_7:
      return run_pair(dyn_solve_pair_kernel<DrmSerial<9, 7>>, pair_shared_bytes<DrmSerial<9, 7>>());
    case DRM_SERIAL_4_2:
      return run_pair(dyn_solve_pair_kernel<DrmSerial<4, 2>>, pair_shared_bytes<DrmSerial<4, 2>>());
  }
  return int(cudaErrorInvalidValue);
}

}  // extern "C"
