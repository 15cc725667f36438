// Kernels rnea_fwd and rnea_bwd: batched inverse dynamics by the recursive
// Newton-Euler algorithm (RNEA), and its vector-Jacobian product.
//
// rnea_fwd replaces the JAX package's ops/pallas/rnea.py `_kernel`: both
// RNEA sweeps of every scenario in one launch, with the flags for gravity
// (the tree's `gravity`, 0 when it is off) and joint damping (d * qd added to
// the torques). Its VJP is XLA's reverse mode of the scalar path there
// (`_scalar_vjp`); rnea_bwd is its counterpart here, written out: the RNEA
// (`drm_rr_rnea`) and one reverse sweep of it with lam = ḡ
// (`drm_rr_rnea_reverse` with QDD), which gives q̄ = (∂τ/∂q)ᵀ ḡ and
// q̄d = (∂τ/∂qd)ᵀ ḡ (damping included) and q̄dd = M(q) ḡ at once.
//
// Layout as at the model API, batch-major: q, qd, qdd, g, tau and the
// cotangents are [B, D], one thread per scenario reading its own row. The
// JAX wrapper transposes to dof-major tiles first; here no transpose is
// made: a warp's loads of one dof are D entries apart, and the 32 rows it
// reads are consecutive, so L1 serves the other dofs. (Staging a block's
// rows through shared memory with coalesced 16-byte copies, and storing tau
// the same way, measured no faster in float32 and slower in float64:
// PERF.md, K4's memory side.)
//
// Bound on the H100: per scenario rnea_fwd moves 16 D bytes (float32) and
// needs about a thousand FP32 operations for iiwa once the robot's
// constants are folded, so the bytes and the operations bound it about
// equally (chip_smoke.py counts both); rnea_bwd needs the reverse sweep
// more, so operations bound it. Both run on the topology policy
// `kernel_variant` picks (ops/kernels/rollout.py): on a serial chain of a
// built shape (iiwa, the 2-link robot) their loops unroll and the per-link
// state stays in registers; trees take the generic 16- or 32-link build
// (where `drm_rr_rnea` measured as fast as the older `drm_rnea` or
// faster). rnea_fwd is `drm_rr_local` + `drm_rr_rnea`, the first half of
// rnea_bwd. At B=65536 there are 16 warps per SM.

#include <cstdint>

#include "dyn_step.cuh"

namespace {

constexpr int kThreads = 128;

template <typename T, class P>
__global__ void __launch_bounds__(kThreads)
rnea_fwd_kernel(const __grid_constant__ Tree<T> tr, const T* __restrict__ q,
                const T* __restrict__ qd, const T* __restrict__ qdd, T* __restrict__ tau,
                int64_t B) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int NL = P::NL, ND = P::ND;
  const int D = P::dofs(tr);
  const int64_t row = b * D;
  T qv[ND], qdv[ND], qddv[ND], tv[ND];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = q[row + d];
    qdv[d] = qd[row + d];
    qddv[d] = qdd[row + d];
  }
  T R[NL][9], t[NL][3];
  drm_rr_local<T, P>(tr, qv, R, t);
  DrmRneaState<T, P> st;
  drm_rr_rnea<T, P>(tr, R, t, qdv, qddv, st, tv);
#pragma unroll
  for (int d = 0; d < D; ++d) tau[row + d] = tv[d];
}

template <typename T, class P>
__global__ void __launch_bounds__(kThreads)
rnea_bwd_kernel(const __grid_constant__ Tree<T> tr, const T* __restrict__ q,
                const T* __restrict__ qd, const T* __restrict__ qdd, const T* __restrict__ g,
                T* __restrict__ gq, T* __restrict__ gqd, T* __restrict__ gqdd, int64_t B) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int ND = P::ND;
  const int D = P::dofs(tr);
  const int64_t row = b * D;
  T qv[ND], qdv[ND], qddv[ND], gv[ND];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    qv[d] = q[row + d];
    qdv[d] = qd[row + d];
    qddv[d] = qdd[row + d];
    gv[d] = g[row + d];
  }
  DrmLocalRnea<T, P> s;
  T tau[ND];
  drm_rr_local<T, P>(tr, qv, s.R, s.t);
  drm_rr_rnea<T, P>(tr, s.R, s.t, qdv, qddv, s.st, tau);
  T jac[3 * ND];
  drm_rr_rnea_reverse<T, P, DrmLocalRnea<T, P>, true>(tr, s, qdv, gv, jac);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    gq[row + d] = jac[d];
    gqd[row + d] = jac[D + d];
    gqdd[row + d] = jac[2 * D + d];
  }
}

inline unsigned blocks_for(int64_t B) { return unsigned((B + kThreads - 1) / kThreads); }

template <typename T>
int launch_fwd(int variant, const Tree<T>* tr, const T* q, const T* qd, const T* qdd, T* tau,
               int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  return drm_by_variant(variant, [&](auto p) {
    rnea_fwd_kernel<T, decltype(p)><<<blocks_for(B), kThreads, 0, s>>>(*tr, q, qd, qdd, tau, B);
    return int(cudaGetLastError());
  });
}

template <typename T>
int launch_bwd(int variant, const Tree<T>* tr, const T* q, const T* qd, const T* qdd, const T* g,
               T* gq, T* gqd, T* gqdd, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  return drm_by_variant(variant, [&](auto p) {
    rnea_bwd_kernel<T, decltype(p)><<<blocks_for(B), kThreads, 0, s>>>(*tr, q, qd, qdd, g, gq,
                                                                        gqd, gqdd, B);
    return int(cudaGetLastError());
  });
}

}  // namespace

extern "C" {

// sizeof(Tree<float>), sizeof(Tree<double>), DRM_MAX_LINKS and the (links,
// dofs) of each serial instantiation: the Python side checks its ctypes
// mirror and its variant table against these.
void rnea_layout(int64_t* out) {
  out[0] = sizeof(Tree<float>);
  out[1] = sizeof(Tree<double>);
  out[2] = DRM_MAX_LINKS;
  drm_variant_shapes(out + 3);
}

// `variant`: the instantiation ops/kernels/rollout.py `kernel_variant` names.
int rnea_fwd_f32(int variant, const Tree<float>* tr, const float* q, const float* qd,
                 const float* qdd, float* tau, int64_t B, void* stream) {
  return launch_fwd(variant, tr, q, qd, qdd, tau, B, stream);
}

int rnea_fwd_f64(int variant, const Tree<double>* tr, const double* q, const double* qd,
                 const double* qdd, double* tau, int64_t B, void* stream) {
  return launch_fwd(variant, tr, q, qd, qdd, tau, B, stream);
}

int rnea_bwd_f32(int variant, const Tree<float>* tr, const float* q, const float* qd,
                 const float* qdd, const float* g, float* gq, float* gqd, float* gqdd, int64_t B,
                 void* stream) {
  return launch_bwd(variant, tr, q, qd, qdd, g, gq, gqd, gqdd, B, stream);
}

int rnea_bwd_f64(int variant, const Tree<double>* tr, const double* q, const double* qd,
                 const double* qdd, const double* g, double* gq, double* gqd, double* gqdd,
                 int64_t B, void* stream) {
  return launch_bwd(variant, tr, q, qd, qdd, g, gq, gqd, gqdd, B, stream);
}

}  // extern "C"
