// K3 kin_solve: the whole kinematic Adam MPC solve in one launch.
//
// Replaces the JAX package's ops/pallas/solver.py `_kin_solve_kernel`
// (wrapper `kinematic_adam_solve_fused`). One thread per scenario runs
// every Adam iteration:
//
//   forward:  q_{h+1} = clip(q_h + a_h, lo, hi), p_h = ee FK(q_{h+1}),
//             cost = cgoal_w * sum_h |p_h - goal|^2 (plus the start term);
//   adjoint:  from the last action step back to the first, replay stage h
//             from the saved q, dq' = gq + J(q'_h)^T gpe_h by the
//             geometric-Jacobian identity, through the clip with JAX's
//             max/min tie rule, and apply the optax-style Adam update of
//             a_h at once (the TPU kernel differentiates the step with
//             jax.vjp inside the kernel; CUDA has none, so the adjoint is
//             written out here).
//
// Layout: q0 [D, B], goal [3, B], a0 and a [H*D, B], costs [n_iters+1, B],
// scratch m, v, qs [H*D, B] and ps [H*3, B], all scenario-minor so that
// the 32 threads of a warp touch 32 consecutive floats. At B=4096, H=50,
// D=7 the scratch is about 25 MB and stays in the 50 MB L2.
//
// Bound on the H100: the function needs about (H-1) (n_iters+1) chain
// sweeps per scenario (J^T gpe comes from the forward sweep's own joint
// axes and origins), each one sincos and a few dozen FP32 operations per
// revolute link once the robot's zero and unit constants are folded; the
// bytes moved once are small (inputs and outputs about 12 MB at the main
// path's shape), so FP32 throughput bounds it. The kernel sweeps twice per
// stage and iteration (forward, then a replay in the adjoint, which keeps no
// per-joint state), and at B=4096 there are only 4096 threads, 128 warps of
// 32 on 128 of the 132 SMs, so each SM runs one warp and the dependent
// FP32 and sincos chain's latency sets the time rather than throughput.
// The design uses 32-thread blocks to spread the warps over the SMs;
// spreading one scenario over several threads is a later change.

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

__global__ void kin_solve_kernel(const __grid_constant__ Chain<float> ch,
                                 const __grid_constant__ KinSolveParams P,
                                 const float* __restrict__ q0, const float* __restrict__ goal,
                                 const float* __restrict__ a0, const float* __restrict__ bc,
                                 float* __restrict__ a, float* __restrict__ costs,
                                 float* __restrict__ m, float* __restrict__ v,
                                 float* __restrict__ qs, float* __restrict__ ps, int64_t B) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = ch.D, H = P.H;
  auto at = [&](int row) { return int64_t(row) * B + b; };

  float q0r[DRM_MAX_DOF];
  for (int d = 0; d < D; ++d) q0r[d] = q0[at(d)];
  const float gl[3] = {goal[at(0)], goal[at(1)], goal[at(2)]};
  for (int i = 0; i < H * D; ++i) {
    a[at(i)] = a0[at(i)];
    m[at(i)] = 0.f;
    v[at(i)] = 0.f;
  }

  // Start-state cost term (trajectory entry 0): the same in every sweep.
  float cg0 = 0.f;
  {
    float pe[3];
    drm_chain_sweep(ch, [&](int d) { return q0r[d]; }, DrmNoRecord{}, pe);
    for (int j = 0; j < 3; ++j) {
      const float diff = pe[j] - gl[j];
      cg0 = cg0 + diff * diff;
    }
  }

  // H-1 action steps from q0, saving q'_h and p_h; returns the cost.
  auto forward = [&]() {
    float q[DRM_MAX_DOF];
    for (int d = 0; d < D; ++d) q[d] = q0r[d];
    float cg = cg0;
    for (int h = 0; h < H - 1; ++h) {
      for (int d = 0; d < D; ++d) {
        q[d] = clip_lohi(q[d] + a[at(h * D + d)], P.lo[d], P.hi[d]);
        qs[at(h * D + d)] = q[d];
      }
      float pe[3];
      drm_chain_sweep(ch, [&](int d) { return q[d]; }, DrmNoRecord{}, pe);
      for (int j = 0; j < 3; ++j) {
        ps[at(h * 3 + j)] = pe[j];
        const float diff = pe[j] - gl[j];
        cg = cg + diff * diff;
      }
    }
    return P.cgoal_w * cg;
  };

  for (int t = 0; t < P.n_iters; ++t) {
    costs[at(t)] = forward();
    const float alpha = bc[2 * t], ibc2 = bc[2 * t + 1];
    float gq[DRM_MAX_DOF];
    for (int d = 0; d < D; ++d) gq[d] = 0.f;
    for (int h = H - 2; h >= 0; --h) {
      float x[DRM_MAX_DOF], qn[DRM_MAX_DOF];
      for (int d = 0; d < D; ++d) {
        const float qp = h == 0 ? q0r[d] : qs[at((h - 1) * D + d)];
        x[d] = qp + a[at(h * D + d)];
        qn[d] = clip_lohi(x[d], P.lo[d], P.hi[d]);
      }
      float p[3], gpe[3];
      for (int j = 0; j < 3; ++j) {
        p[j] = ps[at(h * 3 + j)];
        gpe[j] = P.gpe_w * (p[j] - gl[j]);
      }
      // dq' = gq + J(q')^T gpe, accumulated in gq.
      float pw[3];
      drm_chain_sweep(
          ch, [&](int d) { return qn[d]; },
          [&](int type, int dof, const float* z, const float* o) {
            gq[dof] += drm_joint_vjp(type, z, o, p, gpe);
          },
          pw);
      for (int d = 0; d < D; ++d) {
        const float g = gq[d] * clip_grad(x[d], P.lo[d], P.hi[d]);
        gq[d] = g;  // the cotangent of q'_{h-1}, and da_h
        const int64_t i = at(h * D + d);
        const float mu = P.b1 * m[i] + P.omb1 * g;
        const float nu = P.b2 * v[i] + P.omb2 * (g * g);
        m[i] = mu;
        v[i] = nu;
        a[i] = a[i] - alpha * mu / (sqrtf(nu * ibc2 + P.eps_root) + P.eps);
      }
    }
  }
  costs[at(P.n_iters)] = forward();
}

// 32-thread blocks: at B=4096 that is one warp on each of 128 SMs.
constexpr int kThreads = 32;

}  // namespace

extern "C" {

// sizeof(Chain<float>), sizeof(KinSolveParams), DRM_MAX_CHAIN, DRM_MAX_DOF.
void kin_solve_layout(int64_t* out) {
  out[0] = sizeof(Chain<float>);
  out[1] = sizeof(KinSolveParams);
  out[2] = DRM_MAX_CHAIN;
  out[3] = DRM_MAX_DOF;
}

int kin_solve_f32(const Chain<float>* ch, const KinSolveParams* params, const float* q0,
                  const float* goal, const float* a0, const float* bc, float* a, float* costs,
                  float* m, float* v, float* qs, float* ps, int64_t B, void* stream) {
  const unsigned blocks = unsigned((B + kThreads - 1) / kThreads);
  kin_solve_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      *ch, *params, q0, goal, a0, bc, a, costs, m, v, qs, ps, B);
  return int(cudaGetLastError());
}

}  // extern "C"
