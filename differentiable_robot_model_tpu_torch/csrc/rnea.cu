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
//
// rnea_fwd_learnable and rnea_bwd_learnable are the same two kernels for a
// robot whose link constants live on the card and change from call to call
// (learnable parameters under training): the counterpart of the JAX
// package's second `pallas_call` in ops/pallas/rnea.py, which reads the link
// constants as kernel operands, and of its VJP `_scalar_vjp`, which gives
// the robot's cotangent as well. No constant is read on the host: the host
// passes a `Tree<T>` template that holds only the topology and the flags
// (ops/kernels/rnea.py `tree_template`), and every block first builds the
// tree image in shared memory from the template and the link tensors
// (`rnea_pack`: F from the rpy angles by cos/sin in T, a, F a, t, mass, COM,
// the six inertia entries read, the damping). rnea_bwd_learnable adds the
// partials w.r.t. the link constants to rnea_bwd's reverse sweep
// (`drm_rr_robot_partials`) and writes them per scenario, [16 L + D, B]
// (rows: per link t, rpy, mass, COM, I6; then the damping), for a sum over
// the batch on the host side: no atomics, the same bits on every run.

#include <cstddef>
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

// The link tensors of a robot whose constants live on the card: trans,
// rot_angles, axis [L, 3], mass [L], com [L, 3], inertia_com [L, 3, 3] and
// damping [D], each contiguous.
template <typename T>
struct RobotArrays {
  const T* trans;
  const T* rpy;
  const T* axis;
  const T* mass;
  const T* com;
  const T* inertia;
  const T* damping;
};

// The block's tree image in shared memory: the template (topology, flags)
// copied word by word, then each link's constants from the tensors, one
// thread a link, and with dF (non-null) the partials of each link's rpy
// rotation F = Rz(yaw) Ry(pitch) Rx(roll) w.r.t. roll, pitch and yaw.
template <typename T>
__device__ __forceinline__ void rnea_pack(const Tree<T>& tmpl, const RobotArrays<T>& ra, Tree<T>& tr,
                                          T (*dF)[27]) {
  static_assert(sizeof(Tree<T>) % sizeof(int) == 0, "the tree is copied in words");
  const int* src = reinterpret_cast<const int*>(&tmpl);
  int* dst = reinterpret_cast<int*>(&tr);
  for (int i = threadIdx.x; i < int(sizeof(Tree<T>) / sizeof(int)); i += blockDim.x) dst[i] = src[i];
  __syncthreads();
  const int l = threadIdx.x;
  if (l < tmpl.n) {
    TreeLink<T>& L = tr.link[l];
    T sr, cr, sp, cp, sy, cy;
    drm_sincos(ra.rpy[3 * l], &sr, &cr);
    drm_sincos(ra.rpy[3 * l + 1], &sp, &cp);
    drm_sincos(ra.rpy[3 * l + 2], &sy, &cy);
    const T F[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                    sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                    -sp,     cp * sr,                cp * cr};
#pragma unroll
    for (int i = 0; i < 9; ++i) L.F[i] = F[i];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      L.a[i] = ra.axis[3 * l + i];
      L.t[i] = ra.trans[3 * l + i];
      L.com[i] = ra.com[3 * l + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) L.Fa[i] = F[3 * i] * L.a[0] + F[3 * i + 1] * L.a[1] + F[3 * i + 2] * L.a[2];
    L.mass = ra.mass[l];
    const T* I = ra.inertia + 9 * l;
    L.I6[0] = I[0];
    L.I6[1] = I[1];
    L.I6[2] = I[2];
    L.I6[3] = I[4];
    L.I6[4] = I[5];
    L.I6[5] = I[8];
    if (dF != nullptr) {
      const T d[27] = {
          // d/droll = F [e_x]x
          T(0), cy * sp * cr + sy * sr, sy * cr - cy * sp * sr,
          T(0), sy * sp * cr - cy * sr, -(sy * sp * sr) - cy * cr,
          T(0), cp * cr, -(cp * sr),
          // d/dpitch
          -(cy * sp), cy * cp * sr, cy * cp * cr,
          -(sy * sp), sy * cp * sr, sy * cp * cr,
          -cp, -(sp * sr), -(sp * cr),
          // d/dyaw = [e_z]x F
          -(sy * cp), -(sy * sp * sr) - cy * cr, cy * sr - sy * sp * cr,
          cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
          T(0), T(0), T(0)};
#pragma unroll
      for (int i = 0; i < 27; ++i) dF[l][i] = d[i];
    }
  }
  if (l < tmpl.D) tr.damping[l] = ra.damping[l];
  __syncthreads();
}

template <typename T, class P>
__global__ void __launch_bounds__(kThreads)
rnea_fwd_learnable_kernel(const __grid_constant__ Tree<T> tmpl, const RobotArrays<T> ra,
                          const T* __restrict__ q, const T* __restrict__ qd,
                          const T* __restrict__ qdd, T* __restrict__ tau, int64_t B) {
  __shared__ Tree<T> tr;
  rnea_pack(tmpl, ra, tr, static_cast<T(*)[27]>(nullptr));
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
rnea_bwd_learnable_kernel(const __grid_constant__ Tree<T> tmpl, const RobotArrays<T> ra,
                          const T* __restrict__ q, const T* __restrict__ qd,
                          const T* __restrict__ qdd, const T* __restrict__ g, T* __restrict__ gq,
                          T* __restrict__ gqd, T* __restrict__ gqdd, T* __restrict__ rob,
                          int64_t B) {
  __shared__ Tree<T> tr;
  __shared__ T dF[DRM_MAX_LINKS][27];
  rnea_pack(tmpl, ra, tr, dF);
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  constexpr int ND = P::ND;
  const int D = P::dofs(tr), n = P::links(tr);
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
  T* out = rob + b;
#pragma unroll
  for (int r = 0; r < 16; ++r) out[int64_t(r) * B] = T(0);  // the root has no constants
  const DrmRobotSink<T> sink{qv, dF, out, B};
  T jac[3 * ND];
  drm_rr_rnea_reverse<T, P, DrmLocalRnea<T, P>, true, true>(tr, s, qdv, gv, jac, -1, &sink);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    out[int64_t(16 * n + d) * B] = tr.use_damping ? gv[d] * qdv[d] : T(0);
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

template <typename T>
int launch_fwd_learnable(int variant, const Tree<T>* tmpl, const RobotArrays<T>& ra, const T* q,
                         const T* qd, const T* qdd, T* tau, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  return drm_by_variant(variant, [&](auto p) {
    rnea_fwd_learnable_kernel<T, decltype(p)><<<blocks_for(B), kThreads, 0, s>>>(*tmpl, ra, q, qd,
                                                                                 qdd, tau, B);
    return int(cudaGetLastError());
  });
}

template <typename T>
int launch_bwd_learnable(int variant, const Tree<T>* tmpl, const RobotArrays<T>& ra, const T* q,
                         const T* qd, const T* qdd, const T* g, T* gq, T* gqd, T* gqdd, T* rob,
                         int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  return drm_by_variant(variant, [&](auto p) {
    rnea_bwd_learnable_kernel<T, decltype(p)><<<blocks_for(B), kThreads, 0, s>>>(
        *tmpl, ra, q, qd, qdd, g, gq, gqd, gqdd, rob, B);
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

// For float and double, the offsets of Tree's `damping` and `link` and of
// TreeLink's `F`, `Fa` and `I6`: where the learnable kernels' tree image
// writes over the template (checked against the ctypes mirror before their
// first launch).
void rnea_image_layout(int64_t* out) {
  out[0] = offsetof(Tree<float>, damping);
  out[1] = offsetof(Tree<float>, link);
  out[2] = offsetof(TreeLink<float>, F);
  out[3] = offsetof(TreeLink<float>, Fa);
  out[4] = offsetof(TreeLink<float>, I6);
  out[5] = offsetof(Tree<double>, damping);
  out[6] = offsetof(Tree<double>, link);
  out[7] = offsetof(TreeLink<double>, F);
  out[8] = offsetof(TreeLink<double>, Fa);
  out[9] = offsetof(TreeLink<double>, I6);
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

// The learnable forms: `tmpl` holds the topology and the flags only; the
// link constants come from the tensors (RobotArrays' order) on every launch.
#define DRM_RNEA_LEARNABLE(T, SFX)                                                                 \
  int rnea_fwd_learnable_##SFX(int variant, const Tree<T>* tmpl, const T* trans, const T* rpy,   \
                               const T* axis, const T* mass, const T* com, const T* inertia,     \
                               const T* damping, const T* q, const T* qd, const T* qdd, T* tau,  \
                               int64_t B, void* stream) {                                        \
    const RobotArrays<T> ra{trans, rpy, axis, mass, com, inertia, damping};                      \
    return launch_fwd_learnable(variant, tmpl, ra, q, qd, qdd, tau, B, stream);                  \
  }                                                                                              \
  int rnea_bwd_learnable_##SFX(int variant, const Tree<T>* tmpl, const T* trans, const T* rpy,   \
                               const T* axis, const T* mass, const T* com, const T* inertia,     \
                               const T* damping, const T* q, const T* qd, const T* qdd,          \
                               const T* g, T* gq, T* gqd, T* gqdd, T* rob, int64_t B,            \
                               void* stream) {                                                   \
    const RobotArrays<T> ra{trans, rpy, axis, mass, com, inertia, damping};                      \
    return launch_bwd_learnable(variant, tmpl, ra, q, qd, qdd, g, gq, gqd, gqdd, rob, B, stream); \
  }

DRM_RNEA_LEARNABLE(float, f32)
DRM_RNEA_LEARNABLE(double, f64)
#undef DRM_RNEA_LEARNABLE

}  // extern "C"
