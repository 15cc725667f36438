// Kernels dyn_rollout_fwd / dyn_rollout_bwd and dyn_rollout_ee_fwd /
// dyn_rollout_ee_bwd: H semi-implicit Euler forward-dynamics steps (with the
// end-effector position after each, for the _ee pair), and the adjoint of
// that rollout from cotangents on the states and the end effector.
//
// Replace the JAX package's ops/pallas/rollout.py `_fwd_kernel` /
// `_bwd_kernel` (the state-only pair) and `_fwd_ee_kernel` /
// `_bwd_ee_kernel`; one source, templated on whether the ee FK runs. Layout
// as at the TPU kernels' boundary, scenario-minor: q0, qd0 [D, B], tau, qs,
// qds, gqs, gqds, gtau [H, D, B], ps, gps [H, 3, B], one thread per
// scenario, so every load and store is coalesced along B.
//
// The backward pass replays step h from the saved states (qs[h-1], qds[h-1],
// or q0, qd0 at h = 0). The cotangent of q'_h is the carry plus gqs[h] plus,
// for the _ee pair, J^T gps[h] from the ee FK (the geometric-Jacobian
// identity, with p_h = ps[h] known); that of qd'_h is the carry plus gqds[h].
// gqs and gqds may each be absent (a null pointer, read as zeros), so every
// cotangent pattern has a kernel; with gqs alone it is what the TPU's
// `_bwd_kernel` computes, with gps alone what `_bwd_ee_kernel` computes.
// They then go through the step by the implicit-function adjoint of
// dyn_step.cuh. The TPU kernels get the same from jax.vjp of the step inside
// the kernel trace; CUDA has none.
//
// Bound on the H100: per scenario and step the forward needs one RNEA, one
// composite-rigid-body mass matrix, an LDL^T factor and solve (and one chain
// FK for the _ee pair); the adjoint a replay of those, one more LDL^T solve,
// the reverse RNEA sweep (and the J^T g sweep): thousands (forward) to tens
// of thousands (adjoint) of FP32 operations over a few hundred bytes, so
// operations bound them. With one thread per scenario, B=4096 is one warp
// per SM, and each thread's dependent chain sets the time. The per-link
// state lives in local memory (ptxas reports the frame); 32-thread blocks
// spread the warps over the SMs.

#include <cstdint>

#include "dyn_step.cuh"

namespace {

template <typename T, int NL, int ND, bool EE>
__global__ void fwd_kernel(const __grid_constant__ Tree<T> tr, const __grid_constant__ Chain<T> ch,
                           const T* __restrict__ q0, const T* __restrict__ qd0,
                           const T* __restrict__ tau, T* __restrict__ qs, T* __restrict__ qds,
                           T* __restrict__ ps, int H, int64_t B) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = tr.D;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  T q[ND], qd[ND];
  for (int d = 0; d < D; ++d) {
    q[d] = q0[at(d)];
    qd[d] = qd0[at(d)];
  }
  for (int h = 0; h < H; ++h) {
    T tv[ND], qn[ND], qdn[ND];
    for (int d = 0; d < D; ++d) tv[d] = tau[at(h * D + d)];
    drm_fd_step<T, NL, ND>(tr, q, qd, tv, qn, qdn);
    for (int d = 0; d < D; ++d) {
      q[d] = qn[d];
      qd[d] = qdn[d];
      qs[at(h * D + d)] = qn[d];
      qds[at(h * D + d)] = qdn[d];
    }
    if constexpr (EE) {
      T p[3];
      drm_chain_sweep(ch, [&](int d) { return q[d]; }, DrmNoRecord{}, p);
      for (int j = 0; j < 3; ++j) ps[at(h * 3 + j)] = p[j];
    }
  }
}

template <typename T, int NL, int ND, bool EE>
__global__ void bwd_kernel(const __grid_constant__ Tree<T> tr, const __grid_constant__ Chain<T> ch,
                           const T* __restrict__ q0, const T* __restrict__ qd0,
                           const T* __restrict__ tau, const T* __restrict__ qs,
                           const T* __restrict__ qds, const T* __restrict__ ps,
                           const T* __restrict__ gps, const T* __restrict__ gqs,
                           const T* __restrict__ gqds, T* __restrict__ gtau, T* __restrict__ gq0,
                           T* __restrict__ gqd0, int H, int64_t B) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = tr.D;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  T gq[ND], gqd[ND];
  for (int d = 0; d < D; ++d) gq[d] = gqd[d] = T(0);
  for (int h = H - 1; h >= 0; --h) {
    T q[ND], qd[ND], tv[ND], gqn[ND], gqdn[ND], lam[ND];
    for (int d = 0; d < D; ++d) {
      q[d] = h == 0 ? q0[at(d)] : qs[at((h - 1) * D + d)];
      qd[d] = h == 0 ? qd0[at(d)] : qds[at((h - 1) * D + d)];
      tv[d] = tau[at(h * D + d)];
      gqn[d] = gqs ? gq[d] + gqs[at(h * D + d)] : gq[d];
      gqdn[d] = gqds ? gqd[d] + gqds[at(h * D + d)] : gqd[d];
    }
    if constexpr (EE) {
      T qn[ND];
      for (int d = 0; d < D; ++d) qn[d] = qs[at(h * D + d)];
      const T p[3] = {ps[at(h * 3)], ps[at(h * 3 + 1)], ps[at(h * 3 + 2)]};
      const T g[3] = {gps[at(h * 3)], gps[at(h * 3 + 1)], gps[at(h * 3 + 2)]};
      T pw[3];
      drm_chain_sweep(
          ch, [&](int d) { return qn[d]; },
          [&](int type, int dof, const T* z, const T* o) { gqn[dof] += drm_joint_vjp(type, z, o, p, g); },
          pw);
    }
    drm_fd_step_adjoint<T, NL, ND>(tr, q, qd, tv, gqn, gqdn, lam, gq, gqd);
    for (int d = 0; d < D; ++d) gtau[at(h * D + d)] = lam[d];
  }
  for (int d = 0; d < D; ++d) {
    gq0[at(d)] = gq[d];
    gqd0[at(d)] = gqd[d];
  }
}

constexpr int kThreads = 32;

inline unsigned blocks_for(int64_t B) { return unsigned((B + kThreads - 1) / kThreads); }

template <typename T>
bool small_tree(const Tree<T>* tr) { return tr->n <= 16 && tr->D <= 16; }

// `ch` is null for the state-only kernels, which never read the chain.
template <typename T, bool EE>
int launch_fwd(const Tree<T>* tr, const Chain<T>* ch, const T* q0, const T* qd0, const T* tau,
               T* qs, T* qds, T* ps, int H, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  const Chain<T> none{};
  const Chain<T>& c = ch ? *ch : none;
  if (small_tree(tr))
    fwd_kernel<T, 16, 16, EE><<<blocks_for(B), kThreads, 0, s>>>(*tr, c, q0, qd0, tau, qs, qds, ps, H, B);
  else
    fwd_kernel<T, 32, 32, EE><<<blocks_for(B), kThreads, 0, s>>>(*tr, c, q0, qd0, tau, qs, qds, ps, H, B);
  return int(cudaGetLastError());
}

template <typename T, bool EE>
int launch_bwd(const Tree<T>* tr, const Chain<T>* ch, const T* q0, const T* qd0, const T* tau,
               const T* qs, const T* qds, const T* ps, const T* gps, const T* gqs, const T* gqds,
               T* gtau, T* gq0, T* gqd0, int H, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  const Chain<T> none{};
  const Chain<T>& c = ch ? *ch : none;
  if (small_tree(tr))
    bwd_kernel<T, 16, 16, EE><<<blocks_for(B), kThreads, 0, s>>>(
        *tr, c, q0, qd0, tau, qs, qds, ps, gps, gqs, gqds, gtau, gq0, gqd0, H, B);
  else
    bwd_kernel<T, 32, 32, EE><<<blocks_for(B), kThreads, 0, s>>>(
        *tr, c, q0, qd0, tau, qs, qds, ps, gps, gqs, gqds, gtau, gq0, gqd0, H, B);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// sizeof(Tree<float>), sizeof(Tree<double>), sizeof(Chain<float>),
// sizeof(Chain<double>), DRM_MAX_LINKS: the Python side checks its ctypes
// mirror against these.
void dyn_rollout_layout(int64_t* out) {
  out[0] = sizeof(Tree<float>);
  out[1] = sizeof(Tree<double>);
  out[2] = sizeof(Chain<float>);
  out[3] = sizeof(Chain<double>);
  out[4] = DRM_MAX_LINKS;
}

#define DRM_ROLLOUT_ENTRIES(T, SFX)                                                               \
  int dyn_rollout_fwd_##SFX(const Tree<T>* tr, const T* q0, const T* qd0, const T* tau, T* qs,   \
                            T* qds, int H, int64_t B, void* stream) {                             \
    return launch_fwd<T, false>(tr, nullptr, q0, qd0, tau, qs, qds, nullptr, H, B, stream);       \
  }                                                                                               \
  int dyn_rollout_ee_fwd_##SFX(const Tree<T>* tr, const Chain<T>* ch, const T* q0, const T* qd0, \
                               const T* tau, T* qs, T* qds, T* ps, int H, int64_t B,              \
                               void* stream) {                                                    \
    return launch_fwd<T, true>(tr, ch, q0, qd0, tau, qs, qds, ps, H, B, stream);                  \
  }                                                                                               \
  int dyn_rollout_bwd_##SFX(const Tree<T>* tr, const T* q0, const T* qd0, const T* tau,          \
                            const T* qs, const T* qds, const T* gqs, const T* gqds, T* gtau,     \
                            T* gq0, T* gqd0, int H, int64_t B, void* stream) {                    \
    return launch_bwd<T, false>(tr, nullptr, q0, qd0, tau, qs, qds, nullptr, nullptr, gqs, gqds, \
                                gtau, gq0, gqd0, H, B, stream);                                   \
  }                                                                                               \
  int dyn_rollout_ee_bwd_##SFX(const Tree<T>* tr, const Chain<T>* ch, const T* q0, const T* qd0, \
                               const T* tau, const T* qs, const T* qds, const T* ps,              \
                               const T* gps, const T* gqs, const T* gqds, T* gtau, T* gq0,        \
                               T* gqd0, int H, int64_t B, void* stream) {                         \
    return launch_bwd<T, true>(tr, ch, q0, qd0, tau, qs, qds, ps, gps, gqs, gqds, gtau, gq0,      \
                               gqd0, H, B, stream);                                               \
  }

DRM_ROLLOUT_ENTRIES(float, f32)
DRM_ROLLOUT_ENTRIES(double, f64)

}  // extern "C"
