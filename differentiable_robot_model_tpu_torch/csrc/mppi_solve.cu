// Kernel mppi_solve: the whole MPPI (sampling) torque-space MPC solve in one
// launch.
//
// Replaces the JAX package's ops/pallas/solver.py `_mppi_solve_kernel`
// (wrapper `mppi_solve_fused`). Per scenario, n_iters times: K perturbed
// action sequences a + eps (sample 0 the unperturbed nominal), each rolled
// out through H semi-implicit Euler forward-dynamics steps (dyn_step.cuh)
// of tau = tau_ref + H0 (a + eps) (clipped to the effort box with
// `effort`) with the ee position after each (`drm_chain_sweep`), the cost
// cgoal_w sum |p - goal|^2 + ceff_w sum |H0 (a + eps)|^2 (compensated
// sums), the softmax
// weights w_k = exp(-(c_k - c_min) / T), and the nominal update
// a += sum_k w_k eps_k / sum_k w_k; then the nominal's own cost and the
// applied torques clip(tau_ref + H0 a).
//
// Layout: one block per scenario, one thread per sample; K is rounded up to
// a warp multiple and the padded threads are invalid samples (no noise,
// cost +inf in the minimum, weight 0), as the TPU kernel masks its padded
// lanes. The nominal a [H*D] and the scenario's constants (H0, tau_ref,
// q0, qd0, goal) sit in shared memory. The noise comes from Philox
// (philox.cuh) at the counter (scenario, iteration, (h*D + d) / 2, sample)
// under the solve's key, or at scenario word 0 under the scenario's own key
// (MppiParams::keys), and is drawn twice per iteration, for the rollout and
// again for the update, so no H*D*K noise tensor is stored (it would be 46 MB at iiwa
// H=50, K=128, B=256). The update reduces the H*D entries 32 at a time:
// warp shuffles, one shared-memory pass across the warps. Inputs are
// scenario-minor: q0, qd0, tau_ref [D, B], goal [3, B], H0 [D*D, B], a0
// [H*D, B]; outputs tau [H*D, B] and costs [n_iters+1, B] (costs[t] the
// best sampled cost of iteration t, costs[n_iters] the final nominal's).
//
// Bound on the H100: per scenario, iteration and sample H folded FD steps
// with the ee FK, a few thousand FP32 operations per step for iiwa, over a
// few kilobytes of inputs and outputs per scenario: operations bound it.
// One thread runs each sample's 50-step rollout, and at B=256, K=128 the
// card holds only 8 warps per SM, so each thread's dependent chain sets the
// time. For a serial chain the rollout runs the register-resident step and
// chain FK of dyn_step.cuh (`DrmSerial`: the shape fixed at compile time,
// the per-link state in registers), and blocks of up to 256 threads may use
// up to 255 registers a thread; trees keep `drm_fd_step` and
// `drm_chain_sweep` (the 16- and 32-link builds), and blocks of more than
// 256 threads (K > 256) the generic builds of 64 registers a thread.

#include <cmath>
#include <cstdint>

#include "dyn_step.cuh"
#include "philox.cuh"

struct MppiParams {
  int H;
  int n_iters;
  int K;        // samples; the block has K rounded up to a warp multiple threads
  int precond;  // tau = tau_ref + H0 a (else tau_ref + a)
  int effort;   // clip each applied torque to +-emax
  uint32_t key0, key1;
  // Per-scenario keys [B, 2] on the device, or null: scenario b then draws
  // under (keys[2b], keys[2b + 1]) at scenario word 0, the stream of a
  // one-scenario launch under that key; with null, under (key0, key1) at
  // scenario word b.
  const uint32_t* keys;
  // Rounded to the working type on the host: f(f(gw^2) / (3 H)),
  // f(f(ew) / (H D)), f(noise_sigma), f(temperature).
  double cgoal_w, ceff_w, sigma, temperature;
};

namespace {

constexpr int kChunk = 32;  // nominal entries per update pass

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmin(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's sum or minimum of v, in every thread; scratch holds a value
// per warp.
template <typename T, bool MIN>
__device__ T block_reduce(T v, T* scratch) {
  v = MIN ? warp_min(v) : warp_sum(v);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  T r = scratch[0];
  for (int w = 1; w < int(blockDim.x >> 5); ++w) r = MIN ? fmin(r, scratch[w]) : r + scratch[w];
  __syncthreads();
  return r;
}

// A compensated (Kahan) sum. The costs are summed so: at T = 0.01 a cost's
// rounding moves its softmax weight a hundred times as much, relative, and
// a plain running sum over the H (3 + D) terms rounds at each of them.
template <typename T>
struct KahanSum {
  T sum = T(0), comp = T(0);
  __device__ __forceinline__ void add(T x) {
    const T y = x - comp;
    const T t = sum + y;
    comp = (t - sum) - y;
    sum = t;
  }
};

template <typename T>
size_t shared_bytes(int H, int D, int threads) {
  const int nw = threads / 32;
  return sizeof(T) * (size_t(H) * D + size_t(D) * D + 3 * D + 3 + nw * kChunk + nw);
}

template <typename T, class Topo, int MAXT>
__global__ void __launch_bounds__(MAXT)
    mppi_kernel(const __grid_constant__ Tree<T> tr, const __grid_constant__ Chain<T> ch,
                const __grid_constant__ MppiParams P, const T* __restrict__ q0,
                const T* __restrict__ qd0, const T* __restrict__ tau_ref,
                const T* __restrict__ goal, const T* __restrict__ H0, const T* __restrict__ a0,
                T* __restrict__ tau_out, T* __restrict__ costs, int64_t B) {
  extern __shared__ __align__(16) unsigned char drm_smem[];
  constexpr int ND = Topo::ND;
  const int D = Topo::dofs(tr), H = P.H, HD = H * D, nw = int(blockDim.x >> 5);
  const int64_t b = blockIdx.x;
  const int k = threadIdx.x, lane = k & 31, warp = k >> 5;
  T* a = reinterpret_cast<T*>(drm_smem);  // [H*D] the nominal, acceleration units
  T* Hs = a + HD;                         // [D*D] H0
  T* trf = Hs + D * D;                    // [D] tau_ref
  T* q0s = trf + D;                       // [D]
  T* qd0s = q0s + D;                      // [D]
  T* gl = qd0s + D;                       // [3]
  T* part = gl + 3;                       // [nw * kChunk] the update's warp sums
  T* red = part + nw * kChunk;            // [nw] the reductions' warp results
  auto at = [&](int row) { return int64_t(row) * B + b; };
  for (int i = k; i < HD; i += blockDim.x) a[i] = a0[at(i)];
  if (P.precond)
    for (int i = k; i < D * D; i += blockDim.x) Hs[i] = H0[at(i)];
  for (int d = k; d < D; d += blockDim.x) {
    trf[d] = tau_ref[at(d)];
    q0s[d] = q0[at(d)];
    qd0s[d] = qd0[at(d)];
  }
  if (k < 3) gl[k] = goal[at(k)];
  __syncthreads();

  const bool valid = k < P.K;
  const bool perturbed = valid && k > 0;
  const uint32_t key0 = P.keys ? P.keys[2 * b] : P.key0;
  const uint32_t key1 = P.keys ? P.keys[2 * b + 1] : P.key1;
  const uint32_t scen = P.keys ? 0u : uint32_t(b);
  const T sigma = T(P.sigma), temp = T(P.temperature);
  const T cgoal_w = T(P.cgoal_w), ceff_w = T(P.ceff_w);

  // This sample's noise at entry i of iteration t, read in order of i: one
  // Philox call per pair of entries.
  int cached = -1;
  T z0 = T(0), z1 = T(0);
  auto noise = [&](int t, int i) -> T {
    const int pair = i >> 1;
    if (pair != cached) {
      const DrmPhilox4 r =
          drm_philox4x32(scen, uint32_t(t), uint32_t(pair), uint32_t(k), key0, key1);
      z0 = drm_box_muller<T>(r.w[0], r.w[1]);
      z1 = drm_box_muller<T>(r.w[2], r.w[3]);
      cached = pair;
    }
    return sigma * ((i & 1) ? z1 : z0);
  };

  // The cost of a + eps (eps = 0 unless `noisy`) at iteration t.
  auto rollout = [&](int t, bool noisy) -> T {
    T q[ND], qd[ND];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      q[d] = q0s[d];
      qd[d] = qd0s[d];
    }
    KahanSum<T> cg, ce;
    cached = -1;
    for (int h = 0; h < H; ++h) {
      T av[ND], tc[ND], qn[ND], qdn[ND];
#pragma unroll
      for (int e = 0; e < D; ++e) av[e] = noisy ? a[h * D + e] + noise(t, h * D + e) : a[h * D + e];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        T s;
        if (P.precond) {
          s = T(0);
#pragma unroll
          for (int e = 0; e < D; ++e) s = s + Hs[d * D + e] * av[e];
        } else {
          s = av[d];
        }
        ce.add(s * s);
        const T tau = trf[d] + s;
        tc[d] = P.effort ? drm_clip(tau, -tr.emax[d], tr.emax[d]) : tau;
      }
      if constexpr (Topo::serial) {
        T Lf[ND * (ND + 1) / 2], dg[ND], qdd[ND];
        drm_rr_fd_accel<T, Topo>(tr, q, qd, tc, Lf, dg, qdd);
        drm_rr_euler<T, Topo>(tr, q, qd, qdd, qn, qdn);
      } else {
        drm_fd_step<T, Topo::NL, ND>(tr, q, qd, tc, qn, qdn);
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        q[d] = qn[d];
        qd[d] = qdn[d];
      }
      T p[3];
      drm_rr_ee<T, Topo>(ch, q, DrmNoRecord{}, p);
      for (int j = 0; j < 3; ++j) {
        const T diff = p[j] - gl[j];
        cg.add(diff * diff);
      }
    }
    return cgoal_w * cg.sum + ceff_w * ce.sum;
  };

  // Iteration n_iters rolls out the final nominal (thread 0 alone): one call
  // site of the rollout, so that its unrolled step is emitted once.
  for (int t = 0;; ++t) {
    const bool last = t == P.n_iters;
    if (last && k != 0) break;
    const T c = rollout(t, perturbed && !last);
    if (last) {
      costs[at(t)] = c;
      break;
    }
    const T cmin = block_reduce<T, true>(valid ? c : T(INFINITY), red);
    const T w = valid ? drm_exp(-(c - cmin) / temp) : T(0);
    const T Z = block_reduce<T, false>(w, red);
    if (k == 0) costs[at(t)] = cmin;
    cached = -1;
    for (int i0 = 0; i0 < HD; i0 += kChunk) {
      const int n = min(kChunk, HD - i0);
      for (int j = 0; j < n; ++j) {
        const T v = warp_sum(perturbed ? w * noise(t, i0 + j) : T(0));
        if (lane == 0) part[warp * kChunk + j] = v;
      }
      __syncthreads();
      if (k < n) {
        T s = part[k];
        for (int v = 1; v < nw; ++v) s += part[v * kChunk + k];
        a[i0 + k] += s / Z;
      }
      __syncthreads();
    }
  }

  for (int h = k; h < H; h += blockDim.x) {
    for (int d = 0; d < D; ++d) {
      T s;
      if (P.precond) {
        s = T(0);
        for (int e = 0; e < D; ++e) s = s + Hs[d * D + e] * a[h * D + e];
      } else {
        s = a[h * D + d];
      }
      const T tau = trf[d] + s;
      tau_out[at(h * D + d)] = P.effort ? drm_clip(tau, -tr.emax[d], tr.emax[d]) : tau;
    }
  }
}

template <typename T, class Topo, int MAXT>
int launch_one(const Tree<T>* tr, const Chain<T>* ch, const MppiParams* P, const T* q0,
               const T* qd0, const T* tau_ref, const T* goal, const T* H0, const T* a0,
               T* tau_out, T* costs, int64_t B, cudaStream_t s) {
  const int threads = (P->K + 31) / 32 * 32;
  const size_t shm = shared_bytes<T>(P->H, tr->D, threads);
  auto kern = mppi_kernel<T, Topo, MAXT>;
  if (shm > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(shm));
    if (e != cudaSuccess) return int(e);
  }
  kern<<<unsigned(B), threads, shm, s>>>(*tr, *ch, *P, q0, qd0, tau_ref, goal, H0, a0, tau_out,
                                         costs, B);
  return int(cudaGetLastError());
}

// Blocks of up to 256 threads take the instantiation `variant` names, with
// up to 255 registers a thread; wider blocks (K > 256) the generic builds of
// 64 registers a thread.
template <typename T>
int launch(int variant, const Tree<T>* tr, const Chain<T>* ch, const MppiParams* P, const T* q0,
           const T* qd0, const T* tau_ref, const T* goal, const T* H0, const T* a0, T* tau_out,
           T* costs, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  auto run = [&](auto one) { return one(tr, ch, P, q0, qd0, tau_ref, goal, H0, a0, tau_out, costs, B, s); };
  if (P->K > 256)
    return tr->n <= 16 && tr->D <= 16 ? run(launch_one<T, DrmGeneric<16>, 1024>)
                                      : run(launch_one<T, DrmGeneric<32>, 1024>);
  switch (variant) {
    case DRM_GENERIC16: return run(launch_one<T, DrmGeneric<16>, 256>);
    case DRM_GENERIC32: return run(launch_one<T, DrmGeneric<32>, 256>);
    case DRM_SERIAL_9_7: return run(launch_one<T, DrmSerial<9, 7>, 256>);
    case DRM_SERIAL_4_2: return run(launch_one<T, DrmSerial<4, 2>, 256>);
  }
  return int(cudaErrorInvalidValue);
}

// The Philox words and both normals of each counter column ctr[:, i]: the
// check of the device generator against rng.py.
__global__ void rng_probe_kernel(const uint32_t* __restrict__ ctr, uint32_t k0, uint32_t k1,
                                 uint32_t* __restrict__ bits, float* __restrict__ n32,
                                 double* __restrict__ n64, int64_t N) {
  const int64_t i = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= N) return;
  const DrmPhilox4 r = drm_philox4x32(ctr[i], ctr[N + i], ctr[2 * N + i], ctr[3 * N + i], k0, k1);
  for (int j = 0; j < 4; ++j) bits[j * N + i] = r.w[j];
  n32[i] = drm_box_muller<float>(r.w[0], r.w[1]);
  n32[N + i] = drm_box_muller<float>(r.w[2], r.w[3]);
  n64[i] = drm_box_muller<double>(r.w[0], r.w[1]);
  n64[N + i] = drm_box_muller<double>(r.w[2], r.w[3]);
}

}  // namespace

extern "C" {

// sizeof(Tree<float>), sizeof(Tree<double>), sizeof(Chain<float>),
// sizeof(Chain<double>), sizeof(MppiParams), then the (links, dofs) of each
// serial instantiation: the Python side checks its ctypes mirror and its
// variant table.
void mppi_solve_layout(int64_t* out) {
  out[0] = sizeof(Tree<float>);
  out[1] = sizeof(Tree<double>);
  out[2] = sizeof(Chain<float>);
  out[3] = sizeof(Chain<double>);
  out[4] = sizeof(MppiParams);
  drm_variant_shapes(out + 5);
}

int mppi_solve_f32(int variant, const Tree<float>* tr, const Chain<float>* ch, const MppiParams* P,
                   const float* q0, const float* qd0, const float* tau_ref, const float* goal,
                   const float* H0, const float* a0, float* tau_out, float* costs, int64_t B,
                   void* stream) {
  return launch(variant, tr, ch, P, q0, qd0, tau_ref, goal, H0, a0, tau_out, costs, B, stream);
}

int mppi_solve_f64(int variant, const Tree<double>* tr, const Chain<double>* ch, const MppiParams* P,
                   const double* q0, const double* qd0, const double* tau_ref, const double* goal,
                   const double* H0, const double* a0, double* tau_out, double* costs, int64_t B,
                   void* stream) {
  return launch(variant, tr, ch, P, q0, qd0, tau_ref, goal, H0, a0, tau_out, costs, B, stream);
}

int mppi_rng_probe(const uint32_t* ctr, uint32_t k0, uint32_t k1, uint32_t* bits, float* n32,
                   double* n64, int64_t N, void* stream) {
  rng_probe_kernel<<<unsigned((N + 255) / 256), 256, 0, (cudaStream_t)stream>>>(ctr, k0, k1, bits,
                                                                                n32, n64, N);
  return int(cudaGetLastError());
}

}  // extern "C"
