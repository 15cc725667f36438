// K1 fk_fwd and K2 fk_bwd: the world position of one link for M
// configurations, and its vector-Jacobian product with respect to q.
//
// Replace the JAX package's ops/pallas/fk.py `_fwd_kernel` and
// `_bwd_kernel`. Layout as at the TPU kernels' boundary: dof-major,
// configurations minor (q [D, M], p and g [3, M], dq [D, M]), one thread
// per configuration, so every load and store is coalesced along M.
//
// Bound on the H100: per configuration the function needs one sincos and,
// with the robot's zero and unit constants folded, a few dozen FP32
// operations per revolute link (iiwa: 471 flops for K1, 626 for K2, as
// chip_smoke.py counts them) and moves (D + 3) * 4 bytes (K1) or
// (2 D + 3) * 4 bytes (K2), so the bytes bound it, and at small M the launch
// latency. The kernels do more than that: the constants come from the
// parameter bank and are not folded, and K2 sweeps twice (the first sweep
// finds the end position, the second emits each joint's row as it passes)
// so that no per-joint state is stored. The whole chain state stays in
// registers.

#include <cstdint>

#include "chain.cuh"

namespace {

template <typename T>
__global__ void fk_fwd_kernel(const __grid_constant__ Chain<T> ch, const T* __restrict__ q,
                              T* __restrict__ p, int64_t M) {
  const int64_t m = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  auto qf = [&](int d) { return q[d * M + m]; };
  T pw[3];
  drm_chain_sweep(ch, qf, DrmNoRecord{}, pw);
  p[m] = pw[0];
  p[M + m] = pw[1];
  p[2 * M + m] = pw[2];
}

template <typename T>
__global__ void fk_bwd_kernel(const __grid_constant__ Chain<T> ch, const T* __restrict__ q,
                              const T* __restrict__ g, T* __restrict__ dq, int64_t M) {
  const int64_t m = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (m >= M) return;
  auto qf = [&](int d) { return q[d * M + m]; };
  for (int d = 0; d < ch.D; ++d)
    if (!((ch.dof_mask >> d) & 1u)) dq[d * M + m] = T(0);
  T p[3];
  drm_chain_sweep(ch, qf, DrmNoRecord{}, p);
  const T gv[3] = {g[m], g[M + m], g[2 * M + m]};
  T pw[3];
  drm_chain_sweep(
      ch, qf,
      [&](int type, int dof, const T* z, const T* o) {
        dq[dof * M + m] = drm_joint_vjp(type, z, o, p, gv);
      },
      pw);
}

constexpr int kThreads = 256;

inline unsigned blocks_for(int64_t M) { return unsigned((M + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// sizeof(Chain<float>), sizeof(Chain<double>), DRM_MAX_CHAIN, DRM_MAX_DOF:
// the Python side checks its ctypes mirror against these.
void fk_layout(int64_t* out) {
  out[0] = sizeof(Chain<float>);
  out[1] = sizeof(Chain<double>);
  out[2] = DRM_MAX_CHAIN;
  out[3] = DRM_MAX_DOF;
}

int fk_fwd_f32(const Chain<float>* ch, const float* q, float* p, int64_t M, void* stream) {
  fk_fwd_kernel<float><<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(*ch, q, p, M);
  return int(cudaGetLastError());
}

int fk_fwd_f64(const Chain<double>* ch, const double* q, double* p, int64_t M, void* stream) {
  fk_fwd_kernel<double><<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(*ch, q, p, M);
  return int(cudaGetLastError());
}

int fk_bwd_f32(const Chain<float>* ch, const float* q, const float* g, float* dq, int64_t M,
               void* stream) {
  fk_bwd_kernel<float><<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(*ch, q, g, dq, M);
  return int(cudaGetLastError());
}

int fk_bwd_f64(const Chain<double>* ch, const double* q, const double* g, double* dq, int64_t M,
               void* stream) {
  fk_bwd_kernel<double><<<blocks_for(M), kThreads, 0, (cudaStream_t)stream>>>(*ch, q, g, dq, M);
  return int(cudaGetLastError());
}

}  // extern "C"
