// K3 kin_solve: the whole kinematic Adam MPC solve in one launch.
//
// Replaces the JAX package's ops/pallas/solver.py `_kin_solve_kernel`
// (wrapper `kinematic_adam_solve_fused`). Per scenario, n_iters times:
//
//   forward:  q'_h = clip(q'_{h-1} + a_h, lo, hi) for the H-1 action stages
//             from q'_{-1} = q0, p_h = ee FK(q'_h), cost = cgoal_w (cg0 +
//             sum_h |p_h - goal|^2), cg0 the start state's term;
//   adjoint:  gq <- (gq + J(q'_h)^T gpe_h) clip'(q'_{h-1} + a_h) from the
//             last stage back to the first (da_h is the new gq), J^T gpe by
//             the geometric-Jacobian identity, clip' by JAX's max/min tie
//             rule; then the optax-style Adam update of every a_h (the TPU
//             kernel differentiates each step with jax.vjp inside the
//             kernel; CUDA has none, so the adjoint is written out here).
//
// Design: one warp per scenario, its stages spread over the warp's lanes.
// Each stage's FK and Jacobian product depend only on its own q'_h, and
// a_h is read before its own update, so the adjoint needs no replay: one
// chain sweep a stage and iteration, which keeps every joint's world axis
// z and origin o in registers (the chain's length is a compile-time bound
// NC, 8 or 16, picked on the host) until p_h is known. Only two
// recursions walk the stages in order, both elementwise per dof and a few
// operations a step, on the warp's first D lanes: the clamp scan and the
// adjoint scan. An iteration is four steps with a warp barrier between
// them: (1) the clamp scan writes q'_h; (2) the stage pass, stage h on
// lane h mod 32, sweeps q'_h and writes the cost's differences and the
// rows J^T gpe_h; (3) the adjoint scan turns the rows into da_h in place,
// while the warp's last lane sums the cost in the plain version's order;
// (4) each stage's lane applies Adam to its a_h, m_h and v_h. The scans
// stay sequential, in the TPU kernel's order, so that q'_h and every clip
// tie follow the plain version.
//
// Per scenario a, m, v, q', the rows and the cost's differences live in
// shared memory (the scans read a_h by dof across the stages, which other
// lanes own), (5 (D | 1) + 3) (H-1) floats (D | 1: a stage's row is an
// odd number of floats apart, so that the stage pass's threads hit
// distinct banks), about 7 KB for iiwa at H=50; where a scenario does not
// fit in one block's shared memory the same rows live in a global scratch
// `work` [warps of the grid, per-scenario floats] instead. The boundary
// layout is the TPU kernel's: q0 [D, B], goal [3, B], a0 and a [H*D, B],
// costs [n_iters+1, B], scenario-minor.
//
// Bound on the H100: the function needs about (H-1) (n_iters+1) chain
// sweeps per scenario (J^T gpe from each sweep's own z and o), each one
// sincos and a few dozen FP32 operations per revolute link once the
// robot's zero and unit constants are folded, over about 12 MB of inputs
// and outputs at iiwa H=50 B=4096: FP32 throughput bounds it. B=4096
// gives 131,072 threads (49 stages on 32 lanes: three quarters of them
// busy in the stage pass), 16 scenarios an SM at the 128 registers the
// launch bounds ask of the 8-link build, and the scans' dependent steps
// partly hide behind the SM's other warps. What is left is latency: each
// scenario's iteration is a chain of the two scans, the sweeps and Adam's
// IEEE square roots and divisions (tools/probe_kin_solve.py splits it).
// No fast-math: Adam turns rounding into steps of up to lr (ROADMAP F2).

#include <cstdint>

#include "chain.cuh"

struct KinSolveParams {
  int H;
  int n_iters;
  float cgoal_w;  // f32(f32(gw^2) / (3 H))
  float gpe_w;    // f32(2 cgoal_w)
  float b1, b2, omb1, omb2;
  float eps, eps_root;
  float lo[DRM_MAX_DOF];  // joint limits, -inf / +inf where absent
  float hi[DRM_MAX_DOF];
};

namespace {

constexpr int kThreads = 128;  // threads a block at most: 4 scenarios
constexpr int kGroup = 32;     // threads a scenario: one warp
// Stages a scan loads ahead of the dependent steps that read them (a store
// of one step may alias the next step's load, so the compiler would not
// hoist the loads itself).
constexpr int kChunk = 8;

// The shared (or scratch) floats of one scenario with S action stages.
__host__ __device__ __forceinline__ int stage_stride(int D) { return D | 1; }
__host__ __device__ __forceinline__ int64_t scenario_floats(int S, int D) {
  return int64_t(S) * (5 * stage_stride(D) + 3);
}

__device__ __forceinline__ float clip_lohi(float x, float lo, float hi) {
  // jnp.maximum then jnp.minimum, NaN propagating like XLA's max/min.
  const float y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// d clip(x) / dx under JAX's rule for max and min: 1 strictly inside, 0.5
// at an exact tie with a limit, 0 outside.
__device__ __forceinline__ float clip_grad(float x, float lo, float hi) {
  const float g_max = x > lo ? 1.f : (x == lo ? 0.5f : 0.f);
  const float y = x < lo ? lo : x;
  const float g_min = y < hi ? 1.f : (y == hi ? 0.5f : 0.f);
  return g_max * g_min;
}

// `drm_chain_sweep` at the configuration q[d], unrolled over at most NC
// chain links, keeping each link's world axis z[k] and origin o[k] (read
// only for the joints) and leaving the chain end's position in p.
template <int NC>
__device__ __forceinline__ void sweep_joints(const Chain<float>& ch, const float* q,
                                             float (*z)[3], float (*o)[3], float p[3]) {
  float Rw[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
  p[0] = p[1] = p[2] = 0.f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k >= ch.n) break;
    const ChainLink<float>& L = ch.link[k];
    float R[9];
    float tt[3] = {L.t[0], L.t[1], L.t[2]};
    if (L.type == DRM_REVOLUTE) {
      float s, c, J[9];
      drm_sincos(q[L.dof], &s, &c);
      drm_rodrigues(L.a, c, s, J);
      drm_mat3(L.F, J, R);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = L.F[i];
      if (L.type == DRM_PRISMATIC) {
        const float qv = q[L.dof];
#pragma unroll
        for (int i = 0; i < 3; ++i) tt[i] = L.t[i] + L.Fa[i] * qv;
      }
    }
    if (L.type != DRM_FIXED) drm_rot(Rw, L.Fa, z[k]);
    float dt[3];
    drm_rot(Rw, tt, dt);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      p[i] += dt[i];
      o[k][i] = p[i];
    }
    float Rn[9];
    drm_mat3(Rw, R, Rn);
#pragma unroll
    for (int i = 0; i < 9; ++i) Rw[i] = Rn[i];
  }
}

// One warp per scenario, `per_block` warps a block. SHM: the scenario's
// rows live in dynamic shared memory, else in `work` (rows for every warp
// of the grid). SHM is a compile-time flag so that the rows' loads and
// stores compile to shared-memory instructions: a base pointer chosen at
// run time compiled to generic ones, which cost the scans 30-55% more
// cycles and the main shape 13% more card time on the H100 (PERF.md). A
// warp past B runs on scenario B-1's inputs in rows of its own and writes
// no output.
template <int NC, bool SHM>
__global__ void __launch_bounds__(kThreads, NC == 8 ? 4 : 1)
kin_solve_kernel(const __grid_constant__ Chain<float> ch, const __grid_constant__ KinSolveParams P,
                 const float* __restrict__ q0, const float* __restrict__ goal,
                 const float* __restrict__ a0, const float* __restrict__ bc,
                 float* __restrict__ a, float* __restrict__ costs, float* __restrict__ work,
                 int per_block, int64_t B) {
  extern __shared__ float shm[];
  constexpr int G = kGroup;
  const int grp = threadIdx.x / G, lane = threadIdx.x % G;
  const int64_t b_raw = int64_t(blockIdx.x) * per_block + grp;
  const bool live = b_raw < B;
  const int64_t b = live ? b_raw : B - 1;
  const int D = ch.D, S = P.H - 1, Dp = stage_stride(D);
  const int64_t per = scenario_floats(S, D);
  float* const base = SHM ? shm + grp * per : work + b_raw * per;
  float* const A = base;             // a_h      [S][Dp]
  float* const M = A + S * Dp;       // m_h
  float* const V = M + S * Dp;       // v_h
  float* const Q = V + S * Dp;       // q'_h
  float* const Gr = Q + S * Dp;      // J^T gpe_h, then da_h
  float* const C = Gr + S * Dp;      // p_h - goal [S][3]
  auto at = [&](int row) { return int64_t(row) * B + b; };

  const float gl[3] = {goal[at(0)], goal[at(1)], goal[at(2)]};
  const bool scan = lane < D;
  const float q0d = scan ? q0[at(lane)] : 0.f;
  const float lo = scan ? P.lo[lane] : 0.f, hi = scan ? P.hi[lane] : 0.f;
  for (int h = lane; h < S; h += G) {
    for (int d = 0; d < D; ++d) {
      A[h * Dp + d] = a0[at(h * D + d)];
      M[h * Dp + d] = 0.f;
      V[h * Dp + d] = 0.f;
      Gr[h * Dp + d] = 0.f;  // stays 0 for a dof off the chain
    }
  }
  // the start state's cost term (trajectory entry 0), on the cost thread
  float cg0 = 0.f;
  if (lane == G - 1) {
    float q0v[DRM_MAX_DOF];
    for (int d = 0; d < D; ++d) q0v[d] = q0[at(d)];
    float z[NC][3], o[NC][3], p[3];
    sweep_joints<NC>(ch, q0v, z, o, p);
    for (int j = 0; j < 3; ++j) {
      const float diff = p[j] - gl[j];
      cg0 = cg0 + diff * diff;
    }
  }
  __syncwarp();

  for (int t = 0; t <= P.n_iters; ++t) {
    const bool update = t < P.n_iters;  // the last pass only costs
    // 1. the clamp scan
    if (scan) {
      float q = q0d;
      int h = 0;
      for (; h + kChunk <= S; h += kChunk) {  // a chunk's loads ahead of its steps
        float x[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) x[i] = A[(h + i) * Dp + lane];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          q = clip_lohi(q + x[i], lo, hi);
          Q[(h + i) * Dp + lane] = q;
        }
      }
      for (; h < S; ++h) {
        q = clip_lohi(q + A[h * Dp + lane], lo, hi);
        Q[h * Dp + lane] = q;
      }
    }
    __syncwarp();
    // 2. the stage pass: one sweep, the cost's differences, J^T gpe
    for (int h = lane; h < S; h += G) {
      float z[NC][3], o[NC][3], p[3], gpe[3];
      sweep_joints<NC>(ch, Q + h * Dp, z, o, p);
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const float diff = p[j] - gl[j];
        C[h * 3 + j] = diff;
        gpe[j] = P.gpe_w * diff;
      }
      if (update) {
#pragma unroll
        for (int k = 0; k < NC; ++k) {
          const ChainLink<float>& L = ch.link[k];
          if (k < ch.n && L.type != DRM_FIXED)
            Gr[h * Dp + L.dof] = drm_joint_vjp(L.type, z[k], o[k], p, gpe);
        }
      }
    }
    __syncwarp();
    // 3. the adjoint scan, and the cost in the plain version's order
    if (scan && update) {
      auto factor = [&](int h) {  // clip' at x_h = q'_{h-1} + a_h
        return clip_grad((h == 0 ? q0d : Q[(h - 1) * Dp + lane]) + A[h * Dp + lane], lo, hi);
      };
      float gq = 0.f;
      int h = S - 1;
      for (; h + 1 >= kChunk; h -= kChunk) {  // stages h, h - 1, ..., h - kChunk + 1
        float r[kChunk], c[kChunk];
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          r[i] = Gr[(h - i) * Dp + lane];
          c[i] = factor(h - i);
        }
#pragma unroll
        for (int i = 0; i < kChunk; ++i) {
          gq = (gq + r[i]) * c[i];
          Gr[(h - i) * Dp + lane] = gq;  // da_h, and the cotangent of q'_{h-1}
        }
      }
      for (; h >= 0; --h) {
        gq = (gq + Gr[h * Dp + lane]) * factor(h);
        Gr[h * Dp + lane] = gq;
      }
    }
    if (lane == G - 1) {
      float cg = cg0;
      for (int i = 0; i < 3 * S; ++i) cg = cg + C[i] * C[i];
      if (live) costs[at(t)] = P.cgoal_w * cg;
    }
    __syncwarp();
    // 4. Adam, each stage on its own thread
    if (update) {
      const float alpha = bc[2 * t], ibc2 = bc[2 * t + 1];
      for (int h = lane; h < S; h += G) {
        for (int d = 0; d < D; ++d) {
          const int i = h * Dp + d;
          const float g = Gr[i];
          const float mu = P.b1 * M[i] + P.omb1 * g;
          const float nu = P.b2 * V[i] + P.omb2 * (g * g);
          M[i] = mu;
          V[i] = nu;
          A[i] = A[i] - alpha * mu / (sqrtf(nu * ibc2 + P.eps_root) + P.eps);
        }
      }
    }
    __syncwarp();
  }
  if (!live) return;
  for (int h = lane; h < S; h += G)
    for (int d = 0; d < D; ++d) a[at(h * D + d)] = A[h * Dp + d];
  if (scan) a[at(S * D + lane)] = a0[at(S * D + lane)];  // the last action gets no gradient
}

// Launches kin_solve_kernel<NC, SHM> for the rows in shared memory (work
// null), with the dynamic shared memory they take allowed, or in `work`.
template <int NC>
int launch(const Chain<float>* ch, const KinSolveParams* P, const float* q0, const float* goal,
           const float* a0, const float* bc, float* a, float* costs, float* work, int per_block,
           int64_t B, cudaStream_t stream) {
  const size_t shm = work ? 0 : size_t(per_block) * scenario_floats(P->H - 1, ch->D) * sizeof(float);
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kin_solve_kernel<NC, true>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(shm));
    if (e != cudaSuccess) return int(e);
  }
  const unsigned blocks = unsigned((B + per_block - 1) / per_block);
  if (work)
    kin_solve_kernel<NC, false><<<blocks, per_block * kGroup, 0, stream>>>(*ch, *P, q0, goal, a0, bc, a,
                                                                         costs, work, per_block, B);
  else
    kin_solve_kernel<NC, true><<<blocks, per_block * kGroup, shm, stream>>>(*ch, *P, q0, goal, a0, bc, a,
                                                                          costs, work, per_block, B);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// sizeof(Chain<float>), sizeof(KinSolveParams), DRM_MAX_CHAIN, DRM_MAX_DOF,
// the floats a scenario keeps at 49 stages and 7 dofs, the threads a block.
void kin_solve_layout(int64_t* out) {
  out[0] = sizeof(Chain<float>);
  out[1] = sizeof(KinSolveParams);
  out[2] = DRM_MAX_CHAIN;
  out[3] = DRM_MAX_DOF;
  out[4] = scenario_floats(49, 7);
  out[5] = kThreads;
}

// `per_block` scenarios a block, the rows in shared memory, or in `work`
// where it is not null.
int kin_solve_f32(const Chain<float>* ch, const KinSolveParams* params, const float* q0,
                  const float* goal, const float* a0, const float* bc, float* a, float* costs,
                  float* work, int per_block, int64_t B, void* stream) {
  if (per_block < 1 || per_block * kGroup > kThreads) return int(cudaErrorInvalidValue);
  auto run = ch->n <= 8 ? launch<8> : launch<16>;
  return run(ch, params, q0, goal, a0, bc, a, costs, work, per_block, B, (cudaStream_t)stream);
}

}  // extern "C"
