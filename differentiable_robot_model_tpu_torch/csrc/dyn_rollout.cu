// Kernels dyn_rollout_fwd / dyn_rollout_bwd and dyn_rollout_ee_fwd /
// dyn_rollout_ee_bwd: H semi-implicit Euler forward-dynamics steps (with the
// end-effector position after each, for the _ee pair), and the adjoint of
// that rollout from cotangents on the states and the end effector.
//
// Replace the JAX package's ops/pallas/rollout.py `_fwd_kernel` /
// `_bwd_kernel` (the state-only pair) and `_fwd_ee_kernel` /
// `_bwd_ee_kernel`; one source, templated on whether the ee FK runs. Layout
// as at the TPU kernels' boundary, scenario-minor: q0, qd0 [D, B], tau, qs,
// qds, gqs, gqds, gtau [H, D, B], ps, gps [H, 3, B], so every load and store
// is coalesced along B.
//
// The forward (K5, and K7 with the ee position after each step) takes the
// build `kernel_variant` picks, as the backward does. On a serial chain
// (`DrmSerial`) it spreads each scenario's step over a group of lanes, one
// lane a link (`fwd_group_kernel`), while one thread a scenario would leave
// the card short of warps (B = 4096: one warp an SM); at larger batches (the
// MPPI "kernel" engine's K B lanes) and on every other robot it runs one
// thread a scenario through the H steps (`fwd_kernel`).
//
// The backward (the adjoint) runs in two phases on one stream, each a
// launch (ops/kernels/rollout.py runs them over windows of stages when the
// scratch would pass its cap):
//
//   A. `replay_kernel`, one thread per (stage h, scenario b): from the
//      stage's incoming state (q0, qd0 at h = 0, else qs[h-1], qds[h-1]) and
//      tau[h], the RNEA bias at qdd = 0, the composite-rigid-body mass
//      matrix, Ĥ = M + dt diag(d) and its LDL^T factor, qdd*, the clamp's
//      mask at qd + dt qdd*, and the D rows of ∂RNEA/∂(q, qd) at qdd* from
//      D reverse sweeps of one stored forward RNEA (`drm_rr_rnea_reverse`
//      with the unit cotangents, which on a serial chain skips the links a
//      unit cotangent leaves at zero); for the _ee pair also J(q'_h)^T
//      gps[h] from the ee FK (the geometric-Jacobian identity, p_h = ps[h]
//      known).
//      None of it depends on the carried cotangent. The cotangents gqs[h]
//      (plus J^T gps[h]) and gqds[h] are folded in, so that phase B reads
//      the scratch alone. Scratch [stage, row, B], rows per stage as
//      `replay_base` and ops/kernels/rollout.py `replay_layout` lay them
//      out.
//   B. `adjoint_kernel`, one thread per scenario, h = H-1 ... 0, the
//      implicit-function adjoint of the step on the stored quantities:
//      gqn = carry + gqx[h], gqdn = carry + gqdx[h], x̄ = (gqdn + dt gqn)
//      mask, λ = Ĥ⁻¹ dt x̄ = τ̄, q̄ = gqn - (∂RNEA/∂q)ᵀ λ, q̄d = x̄ -
//      (∂RNEA/∂qd)ᵀ λ. Its loads do not depend on the carry: where
//      kStages stages' rows fit in shared memory (kMaxStagedBytes), the
//      warp copies the rows of the next kStages - 1 stages there (cp.async)
//      while stage h computes.
//
// The TPU kernels get the step's adjoint from jax.vjp inside the kernel
// trace; CUDA has none. gqs and gqds may each be absent (a null pointer,
// read as zeros), so every cotangent pattern has a kernel; with gqs alone it
// is what the TPU's `_bwd_kernel` computes, with gps alone what
// `_bwd_ee_kernel` computes.
//
// Bound on the H100: per scenario and step the forward needs one RNEA, one
// composite-rigid-body mass matrix, an LDL^T factor and solve (and one chain
// FK for the _ee pair); the adjoint a replay of those, one more LDL^T solve,
// the reverse RNEA sweep (and the J^T g sweep): thousands (forward) to tens
// of thousands (adjoint) of FP32 operations over a few hundred bytes, so
// operations bound them. The forward is set by each scenario's dependent
// chain of H steps: the group step cuts a step's chain to the sweeps (run on
// every lane in lockstep) and one link's share of the rest, and gives the
// card G times the warps; the
// backward puts everything that does not depend on the carry into phase A,
// H B independent threads that fill the card, and leaves phase B's chain at
// one LDL^T solve and a 2D x D product a stage. Phase A pays D reverse
// sweeps a stage where the function needs one: that is this design's cost.
// Serial chains of a built shape run on `DrmSerial` (per-link state in
// registers), trees on `DrmGeneric` (ops/kernels/solver.py
// `kernel_variant` picks).

#include <cstdint>

#include "dyn_step.cuh"

namespace {

constexpr int kThreads = 32;

// One thread per scenario through the H steps: on a serial chain the
// register-resident step (`drm_rr_fd_accel`, `drm_rr_euler`), on any other
// robot `drm_fd_step` (measured a little faster than `drm_rr_fd_accel` on
// `DrmGeneric`: both keep their per-link arrays in local memory); K7's ee
// by the run-time-loop `drm_chain_sweep` (as fast as the unrolled serial
// sweep, and without its spills at 255 registers).
template <typename T, class P, bool EE>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(const __grid_constant__ Tree<T> tr, const __grid_constant__ Chain<T> ch,
               const T* __restrict__ q0, const T* __restrict__ qd0, const T* __restrict__ tau,
               T* __restrict__ qs, T* __restrict__ qds, T* __restrict__ ps, int H, int64_t B) {
  constexpr int ND = P::ND;
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = P::dofs(tr);
  auto at = [&](int row) { return int64_t(row) * B + b; };
  T q[ND], qd[ND];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = q0[at(d)];
    qd[d] = qd0[at(d)];
  }
  for (int h = 0; h < H; ++h) {
    T tv[ND], qn[ND], qdn[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) tv[d] = tau[at(h * D + d)];
    if constexpr (P::serial) {
      T Lf[ND * (ND + 1) / 2], dg[ND], qdd[ND];
      drm_rr_fd_accel<T, P>(tr, q, qd, tv, Lf, dg, qdd);
      drm_rr_euler<T, P>(tr, q, qd, qdd, qn, qdn);
    } else {
      drm_fd_step<T, P::NL, ND>(tr, q, qd, tv, qn, qdn);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = qn[d];
      qd[d] = qdn[d];
      qs[at(h * D + d)] = qn[d];
      qds[at(h * D + d)] = qdn[d];
    }
    if constexpr (EE) {
      T p[3];
      drm_chain_sweep(ch, [&](int d) { return q[d]; }, DrmNoRecord{}, p);
#pragma unroll
      for (int j = 0; j < 3; ++j) ps[at(h * 3 + j)] = p[j];
    }
  }
}

// One scenario on a group of G lanes of a warp, for a serial chain: lane g
// owns link g + 1 (its dof g, and M's column of that dof). A step, every
// lane in lockstep:
//   1. each lane its link's local rotation (sincos, Rodrigues);
//   2. the forward sweep link by link, each link's rotation shuffled from
//      its owner: the RNEA's motion (qdd = 0) and the world pose, each lane
//      running it only as far as its own link (K7's ee position at q_h is
//      the ee link owner's world position, the chain sweep's arithmetic,
//      stored as ps[h - 1]);
//   3. each lane its link's force, inertia about the world origin and
//      joint subspace;
//   4. the backward sweep link by link, each link's rotation, force and
//      inertia shuffled from its owner: the RNEA bias on every lane, and
//      each lane the composite inertia of its link's subtree;
//   5. each lane M's row of its dof, then every entry shuffled to every
//      lane (steps 1-2 `drm_group_forward`, 3-5 `drm_group_backward`,
//      dyn_step.cuh, which the prologue's group shares);
//   6. on every lane Ĥ = M + dt diag(d), its LDLᵀ factor and solve, the
//      clamp and the position update; lane g stores the dofs d with d % G
//      == g.
// That is `drm_rr_fd_accel` + `drm_rr_euler`'s arithmetic, operation for
// operation: only which lane does what differs. Lanes past B run on
// scenario B - 1 and store nothing, so that every lane meets every shuffle.
constexpr int kGroupThreads = 64;

template <typename T, class P, bool EE, int G>
__global__ void __launch_bounds__(kGroupThreads, 4)
    fwd_group_kernel(const __grid_constant__ Tree<T> tr, const __grid_constant__ Chain<T> ch,
                     const T* __restrict__ q0, const T* __restrict__ qd0,
                     const T* __restrict__ tau, T* __restrict__ qs, T* __restrict__ qds,
                     T* __restrict__ ps, int H, int64_t B) {
  static_assert(P::serial, "the group step is laid out for a serial chain");
  constexpr int NL = P::NL, ND = P::ND, NP = ND * (ND + 1) / 2;
  static_assert(G >= NL - 1 && 32 % G == 0, "a lane a moving link, a group within a warp");
  __shared__ DrmGroupLinks<T, NL> sl;
  sl.load(tr);
  __syncthreads();
  const int g = int(threadIdx.x) % G;
  const int lk = min(g + 1, NL - 1);  // the lane's link (past the last link: the last again)
  const int64_t bg = (int64_t(blockIdx.x) * blockDim.x + threadIdx.x) / G;
  const bool live = bg < B;
  const int64_t b = live ? bg : B - 1;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  const int ee = ch.n;  // the ee's chain: links 1 .. ee of the serial chain
  T q[ND], qd[ND];
#pragma unroll
  for (int d = 0; d < ND; ++d) {
    q[d] = q0[at(d)];
    qd[d] = qd0[at(d)];
  }
  for (int h = 0; h < H + (EE ? 1 : 0); ++h) {
    // 1-2. the lane's local rotation, the forward sweep as far as its link
    T Ro[9], w[3], dw[3], dv[3], Rw[9], pw[3];
    drm_group_forward<T, P, G>(tr, sl, lk, q, qd, Ro, w, dw, dv, Rw, pw);
    if constexpr (EE) {
      if (h > 0 && live && g == (ee == 0 ? 0 : ee - 1)) {
#pragma unroll
        for (int j = 0; j < 3; ++j) ps[at((h - 1) * 3 + j)] = ee == 0 ? T(0) : pw[j];
      }
      if (h == H) break;
    }
    T tv[ND];
#pragma unroll
    for (int d = 0; d < ND; ++d) tv[d] = tau[at(h * ND + d)];
    // 3-5. the backward sweep: the RNEA bias, and M on every lane
    T nle[ND], Lf[NP], dg[ND], rhs[ND], qdd[ND], qn[ND], qdn[ND];
    drm_group_backward<T, P, G>(tr, sl, lk, Ro, w, dw, dv, Rw, pw, nle, Lf);
    if (tr.use_damping) {
#pragma unroll
      for (int d = 0; d < ND; ++d) nle[d] = nle[d] + tr.damping[d] * qd[d];
    }
    // 6. the step on every lane
    if (tr.use_damping) {
#pragma unroll
      for (int d = 0; d < ND; ++d) Lf[drm_tri(d, d)] = Lf[drm_tri(d, d)] + tr.dt_damping[d];
    }
    drm_rr_ldl_factor<T, P>(tr, Lf, dg);
#pragma unroll
    for (int d = 0; d < ND; ++d) rhs[d] = tv[d] - nle[d];
    drm_rr_ldl_solve<T, P>(tr, Lf, dg, rhs, qdd);
    drm_rr_euler<T, P>(tr, q, qd, qdd, qn, qdn);
#pragma unroll
    for (int d = 0; d < ND; ++d) {
      q[d] = qn[d];
      qd[d] = qdn[d];
      if (live && d % G == g) {
        qs[at(h * ND + d)] = qn[d];
        qds[at(h * ND + d)] = qdn[d];
      }
    }
  }
}

// Phase A's rows of one stage before the optional cotangent rows: Ĥ's
// factor (its strict lower triangle, entry (i, j) at i(i-1)/2 + j), its
// diagonal, the clamp's mask, then row d of ∂RNEA/∂(q, qd) (2D entries: q
// partials, then qd partials) at 2D d.
__host__ __device__ constexpr int replay_base(int D) { return D * (D - 1) / 2 + 2 * D + 2 * D * D; }

constexpr int kReplayThreads = 64;

// Phase A for stage h0 + blockIdx.y. `ox` (or -1) is the row of gqs[h] (+
// J^T gps[h] with EE), `odx` (or -1) that of gqds[h]; K rows a stage.
template <typename T, class P, bool EE>
__global__ void __launch_bounds__(kReplayThreads)
    replay_kernel(const __grid_constant__ Tree<T> tr, const __grid_constant__ Chain<T> ch,
                  const T* __restrict__ q0, const T* __restrict__ qd0, const T* __restrict__ tau,
                  const T* __restrict__ qs, const T* __restrict__ qds, const T* __restrict__ ps,
                  const T* __restrict__ gps, const T* __restrict__ gqs,
                  const T* __restrict__ gqds, T* __restrict__ scr, int h0, int K, int ox, int odx,
                  int64_t B) {
  constexpr int ND = P::ND, NP = ND * (ND + 1) / 2;
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int hl = int(blockIdx.y), h = h0 + hl;
  const int D = P::dofs(tr), NS = D * (D - 1) / 2, OR = NS + 2 * D;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  auto out = [&](int k) -> T& { return scr[(int64_t(hl) * K + k) * B + b]; };
  T q[ND], qd[ND], tv[ND];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    q[d] = h == 0 ? q0[at(d)] : qs[at((h - 1) * D + d)];
    qd[d] = h == 0 ? qd0[at(d)] : qds[at((h - 1) * D + d)];
    tv[d] = tau[at(h * D + d)];
  }
  DrmLocalRnea<T, P> s;
  drm_rr_local<T, P>(tr, q, s.R, s.t);
  T qdd[ND];
  {
    // the step's acceleration (`drm_rr_fd_accel`) on the transforms kept in s
    T zero[ND], nle[ND], rhs[ND], Lf[NP], dg[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) zero[d] = T(0);
    drm_rr_rnea<T, P>(tr, s.R, s.t, qd, zero, s.st, nle);
    drm_rr_crb<T, P>(tr, s.R, s.t, Lf);
    if (tr.use_damping) {
#pragma unroll
      for (int d = 0; d < D; ++d) Lf[drm_tri(d, d)] = Lf[drm_tri(d, d)] + tr.dt_damping[d];
    }
    drm_rr_ldl_factor<T, P>(tr, Lf, dg);
#pragma unroll
    for (int d = 0; d < D; ++d) rhs[d] = tv[d] - nle[d];
    drm_rr_ldl_solve<T, P>(tr, Lf, dg, rhs, qdd);
#pragma unroll
    for (int i = 1; i < D; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) out(i * (i - 1) / 2 + j) = Lf[drm_tri(i, j)];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      out(NS + d) = dg[d];
      out(NS + D + d) = drm_clip_grad(qd[d] + tr.dt * qdd[d], -tr.vmax[d], tr.vmax[d]);
    }
  }
  // the RNEA at qdd*, kept in s, then one reverse sweep per unit cotangent:
  // sweep d gives row d of ∂RNEA/∂(q, qd)
  {
    T tau_star[ND];
    drm_rr_rnea<T, P>(tr, s.R, s.t, qd, qdd, s.st, tau_star);
  }
#pragma unroll 1
  for (int d = 0; d < D; ++d) {
    T lam[ND], jac[2 * ND];
#pragma unroll
    for (int e = 0; e < D; ++e) lam[e] = e == d ? T(1) : T(0);
    drm_rr_rnea_reverse<T, P>(tr, s, qd, lam, jac, d);
#pragma unroll
    for (int k = 0; k < 2 * D; ++k) out(OR + 2 * D * d + k) = jac[k];
  }
  if (ox >= 0) {
    T jt[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) jt[d] = gqs ? gqs[at(h * D + d)] : T(0);
    if constexpr (EE) {
      T qn[ND], pw[3];
#pragma unroll
      for (int d = 0; d < D; ++d) qn[d] = qs[at(h * D + d)];
      const T p[3] = {ps[at(h * 3)], ps[at(h * 3 + 1)], ps[at(h * 3 + 2)]};
      const T g[3] = {gps[at(h * 3)], gps[at(h * 3 + 1)], gps[at(h * 3 + 2)]};
      drm_chain_sweep(
          ch, [&](int d) { return qn[d]; },
          [&](int type, int dof, const T* z, const T* o) { jt[dof] += drm_joint_vjp(type, z, o, p, g); }, pw);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out(ox + d) = jt[d];
  }
  if (odx >= 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) out(odx + d) = gqds[at(h * D + d)];
  }
}

// Phase B: one block (one warp) of kLanes scenarios. Staged, the rows of
// kStages stages are in flight in shared memory, row k of buffer j at (j K
// + k) kLanes + lane. Where the block is whole and its rows start 16-byte
// aligned, the warp copies them in 16-byte pieces, each lane a share of
// every row; else each lane copies its own values.
constexpr int kLanes = 32;
constexpr int kStages = 3;
constexpr size_t kMaxStagedBytes = 200 * 1024;

template <typename T>
__device__ __forceinline__ void drm_async_copy(T* dst_shared, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst), "l"(src), "n"(int(sizeof(T)))
               : "memory");
#else
  *dst_shared = *src;
#endif
}

// 16 bytes, both addresses 16-byte aligned; bypasses L1 (.cg).
template <typename T>
__device__ __forceinline__ void drm_async_copy16(T* dst_shared, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(dst_shared));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src) : "memory");
#else
  for (int i = 0; i < int(16 / sizeof(T)); ++i) dst_shared[i] = src[i];
#endif
}

__device__ __forceinline__ void drm_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// Waits until at most N of this thread's committed copy groups are in flight.
template <int N>
__device__ __forceinline__ void drm_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// Stages h0 + nh - 1 ... h0 of the window whose scratch `scr` holds; the
// carry (q̄, q̄d) comes in from gq, gqd when `carry_in` (else zeros) and goes
// out there.
template <typename T, class P, bool STAGED>
__global__ void __launch_bounds__(kLanes)
    adjoint_kernel(const __grid_constant__ Tree<T> tr, const T* __restrict__ scr,
                   T* __restrict__ gtau, T* __restrict__ gq_io, T* __restrict__ gqd_io, int h0,
                   int nh, int K, int ox, int odx, int carry_in, int64_t B) {
  constexpr int ND = P::ND, NP = ND * (ND + 1) / 2, kVec = 16 / sizeof(T), kPieces = kLanes / kVec;
  extern __shared__ __align__(16) unsigned char adjoint_smem[];
  const int lane = int(threadIdx.x);
  const int64_t b0 = int64_t(blockIdx.x) * kLanes, b = b0 + lane;
  // uniform over the block: every lane is live and copies a share of each row
  const bool whole = STAGED && b0 + kLanes <= B && B % kVec == 0;
  if (b >= B) return;  // (never in a whole block)
  const int D = P::dofs(tr), NS = D * (D - 1) / 2, OR = NS + 2 * D;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  T* smem = reinterpret_cast<T*>(adjoint_smem);
  auto fetch = [&](int l) {
    if (l < 0) {
      drm_async_commit();  // an empty group keeps the count of groups in flight
      return;
    }
    T* buf = smem + (l % kStages) * K * kLanes;
    const T* src = scr + int64_t(l) * K * B + b0;
    if (whole) {
      for (int c = lane; c < K * kPieces; c += kLanes) {
        const int k = c / kPieces, j = (c % kPieces) * kVec;
        drm_async_copy16(buf + k * kLanes + j, src + int64_t(k) * B + j);
      }
    } else {
      for (int k = 0; k < K; ++k) drm_async_copy(buf + k * kLanes + lane, src + int64_t(k) * B + lane);
    }
    drm_async_commit();
  };
  T gq[ND], gqd[ND];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gq[d] = carry_in ? gq_io[at(d)] : T(0);
    gqd[d] = carry_in ? gqd_io[at(d)] : T(0);
  }
  if constexpr (STAGED) {
    for (int i = 0; i < kStages - 1; ++i) fetch(nh - 1 - i);
  }
  for (int l = nh - 1; l >= 0; --l) {
    if constexpr (STAGED) {
      // the buffer refilled now held stage l + kStages - 1 ... = l + 1, which
      // every lane has read
      if (whole) __syncwarp();
      fetch(l - (kStages - 1));
      drm_async_wait<kStages - 1>();
      if (whole) __syncwarp();
    }
    auto v = [&](int k) -> T {
      if constexpr (STAGED)
        return smem[((l % kStages) * K + k) * kLanes + lane];
      else
        return scr[(int64_t(l) * K + k) * B + b];
    };
    T gqn[ND], gx[ND], rhs[ND], lam[ND], Lf[NP], dg[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      gqn[d] = ox >= 0 ? gq[d] + v(ox + d) : gq[d];
      const T gqdn = odx >= 0 ? gqd[d] + v(odx + d) : gqd[d];
      gx[d] = (gqdn + tr.dt * gqn[d]) * v(NS + D + d);
      rhs[d] = tr.dt * gx[d];
      dg[d] = v(NS + d);
    }
#pragma unroll
    for (int i = 1; i < D; ++i)
#pragma unroll
      for (int j = 0; j < i; ++j) Lf[drm_tri(i, j)] = v(i * (i - 1) / 2 + j);
    drm_rr_ldl_solve<T, P>(tr, Lf, dg, rhs, lam);
#pragma unroll
    for (int d = 0; d < D; ++d) gtau[at((h0 + l) * D + d)] = lam[d];
    // q̄ = gqn - (∂RNEA/∂q)ᵀ λ, q̄d = x̄ - (∂RNEA/∂qd)ᵀ λ
#pragma unroll
    for (int k = 0; k < 2 * D; ++k) {
      T j = T(0);
#pragma unroll
      for (int d = 0; d < D; ++d) j = j + lam[d] * v(OR + 2 * D * d + k);
      if (k < D)
        gq[k] = gqn[k] - j;
      else
        gqd[k - D] = gx[k - D] - j;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gq_io[at(d)] = gq[d];
    gqd_io[at(d)] = gqd[d];
  }
}

inline unsigned blocks_for(int64_t B, int threads) { return unsigned((B + threads - 1) / threads); }

// The group step runs while one thread a scenario would give the card's
// SMs fewer than kOneThreadWarpsPerSM warps each. K7 at H=50 (PERF.md):
// the group is the faster up to B=8192 (B=4096, one warp an SM, the
// dynamic "kernel" engine's rollout: 0.39 against 0.53 ms), one thread a
// scenario from B=12288 on (the MPPI "kernel" engine's K B = 32,768 lanes:
// 0.53 against 1.57 ms), where its time has not yet begun to grow.
constexpr int kOneThreadWarpsPerSM = 2;

// The least batch at which a serial chain's forward runs one thread a
// scenario on the current card (8,448 on 132 SMs); below it, the group step.
inline int64_t one_thread_from() { return int64_t(kThreads) * kOneThreadWarpsPerSM * drm_sm_count(); }

inline bool use_group(int64_t B) { return B < one_thread_from(); }

// `ch` is null for the state-only kernels, which never read the chain.
template <typename T, class P, bool EE>
int launch_fwd(const Tree<T>* tr, const Chain<T>* ch, const T* q0, const T* qd0, const T* tau,
               T* qs, T* qds, T* ps, int H, int64_t B, cudaStream_t s) {
  const Chain<T> none{};
  const Chain<T>& c = ch ? *ch : none;
  if constexpr (P::serial) {
    if (use_group(B)) {
      constexpr int G = drm_group_lanes<P>();
      fwd_group_kernel<T, P, EE, G><<<blocks_for(B * G, kGroupThreads), kGroupThreads, 0, s>>>(
          *tr, c, q0, qd0, tau, qs, qds, ps, H, B);
      return int(cudaGetLastError());
    }
  }
  fwd_kernel<T, P, EE><<<blocks_for(B, kThreads), kThreads, 0, s>>>(*tr, c, q0, qd0, tau, qs, qds,
                                                                    ps, H, B);
  return int(cudaGetLastError());
}

// Phase A of stages h0 ... h0 + nh - 1; with `ch` (the _ee pair) ps and gps
// are read.
template <typename T, class P>
int launch_replay(const Tree<T>* tr, const Chain<T>* ch, const T* q0, const T* qd0, const T* tau,
                  const T* qs, const T* qds, const T* ps, const T* gps, const T* gqs,
                  const T* gqds, T* scr, int h0, int nh, int K, int ox, int odx, int64_t B,
                  cudaStream_t s) {
  const dim3 grid(blocks_for(B, kReplayThreads), unsigned(nh));
  const Chain<T> none{};
  if (ch)
    replay_kernel<T, P, true><<<grid, kReplayThreads, 0, s>>>(*tr, *ch, q0, qd0, tau, qs, qds, ps, gps,
                                                              gqs, gqds, scr, h0, K, ox, odx, B);
  else
    replay_kernel<T, P, false><<<grid, kReplayThreads, 0, s>>>(*tr, none, q0, qd0, tau, qs, qds, ps,
                                                               gps, gqs, gqds, scr, h0, K, ox, odx, B);
  return int(cudaGetLastError());
}

template <typename T, class P>
int launch_adjoint(const Tree<T>* tr, const T* scr, T* gtau, T* gq, T* gqd, int h0, int nh, int K,
                   int ox, int odx, int carry_in, int64_t B, cudaStream_t s) {
  const unsigned g = blocks_for(B, kLanes);
  const size_t shm = size_t(kStages) * K * kLanes * sizeof(T);
  if (shm <= kMaxStagedBytes) {
    auto kern = adjoint_kernel<T, P, true>;
    if (shm > 48 * 1024) {
      const cudaError_t e =
          cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shm));
      if (e != cudaSuccess) return int(e);
    }
    kern<<<g, kLanes, shm, s>>>(*tr, scr, gtau, gq, gqd, h0, nh, K, ox, odx, carry_in, B);
  } else {
    adjoint_kernel<T, P, false><<<g, kLanes, 0, s>>>(*tr, scr, gtau, gq, gqd, h0, nh, K, ox, odx,
                                                     carry_in, B);
  }
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// sizeof(Tree<float>), sizeof(Tree<double>), sizeof(Chain<float>),
// sizeof(Chain<double>), DRM_MAX_LINKS, the (links, dofs) of each serial
// instantiation, and phase A's base rows for 7 dofs: the Python side checks
// its ctypes mirror, its variant table and its scratch layout against these.
void dyn_rollout_layout(int64_t* out) {
  out[0] = sizeof(Tree<float>);
  out[1] = sizeof(Tree<double>);
  out[2] = sizeof(Chain<float>);
  out[3] = sizeof(Chain<double>);
  out[4] = DRM_MAX_LINKS;
  drm_variant_shapes(out + 5);
  out[9] = replay_base(7);
}

// The least batch at which K5/K7 on a serial chain run one thread a
// scenario on the current device (`use_group`).
int64_t dyn_rollout_fwd_one_thread_from() { return one_thread_from(); }

#define DRM_ROLLOUT_ENTRIES(T, SFX)                                                               \
  int dyn_rollout_fwd_##SFX(int variant, const Tree<T>* tr, const T* q0, const T* qd0,         \
                            const T* tau, T* qs, T* qds, int H, int64_t B, void* stream) {        \
    return drm_by_variant(variant, [&](auto p) {                                                  \
      return launch_fwd<T, decltype(p), false>(tr, nullptr, q0, qd0, tau, qs, qds, nullptr, H, B, \
                                               (cudaStream_t)stream);                             \
    });                                                                                           \
  }                                                                                               \
  int dyn_rollout_ee_fwd_##SFX(int variant, const Tree<T>* tr, const Chain<T>* ch, const T* q0,  \
                               const T* qd0, const T* tau, T* qs, T* qds, T* ps, int H,           \
                               int64_t B, void* stream) {                                         \
    return drm_by_variant(variant, [&](auto p) {                                                  \
      return launch_fwd<T, decltype(p), true>(tr, ch, q0, qd0, tau, qs, qds, ps, H, B,            \
                                              (cudaStream_t)stream);                              \
    });                                                                                           \
  }                                                                                               \
  int dyn_rollout_replay_##SFX(int variant, const Tree<T>* tr, const Chain<T>* ch, const T* q0,  \
                               const T* qd0, const T* tau, const T* qs, const T* qds,             \
                               const T* ps, const T* gps, const T* gqs, const T* gqds, T* scr,    \
                               int h0, int nh, int K, int ox, int odx, int64_t B, void* stream) { \
    return drm_by_variant(variant, [&](auto p) {                                                  \
      return launch_replay<T, decltype(p)>(tr, ch, q0, qd0, tau, qs, qds, ps, gps, gqs, gqds,     \
                                           scr, h0, nh, K, ox, odx, B, (cudaStream_t)stream);     \
    });                                                                                           \
  }                                                                                               \
  int dyn_rollout_adjoint_##SFX(int variant, const Tree<T>* tr, const T* scr, T* gtau, T* gq,    \
                                T* gqd, int h0, int nh, int K, int ox, int odx, int carry_in,     \
                                int64_t B, void* stream) {                                        \
    return drm_by_variant(variant, [&](auto p) {                                                  \
      return launch_adjoint<T, decltype(p)>(tr, scr, gtau, gq, gqd, h0, nh, K, ox, odx,           \
                                            carry_in, B, (cudaStream_t)stream);                   \
    });                                                                                           \
  }

DRM_ROLLOUT_ENTRIES(float, f32)
DRM_ROLLOUT_ENTRIES(double, f64)

}  // extern "C"
