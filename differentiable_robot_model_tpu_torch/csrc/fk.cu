// K1 fk_fwd and K2 fk_bwd: the world position of one link for M
// configurations, and its vector-Jacobian product with respect to q.
//
// Replace the JAX package's ops/pallas/fk.py `_fwd_kernel` and
// `_bwd_kernel`. Layout as at the TPU kernels' boundary: dof-major,
// configurations minor (q [D, M], p and g [3, M], dq [D, M]), consecutive
// configurations on consecutive threads, so every load and store is
// coalesced along M.
//
// Bound on the H100: per configuration the function needs one sincos and,
// with the robot's zero and unit constants folded, a few dozen FP32
// operations per revolute link (iiwa: 471 flops for K1, 626 for K2, as
// chip_smoke.py counts them) and moves (D + 3) * 4 bytes (K1) or
// (2 D + 3) * 4 bytes (K2), so the bytes bound it, and at small M the launch
// latency. What a thread issues is close to that count:
// - The sweep (`fk_sweep`) is unrolled over a compile-time chain bound NC
//   (8 or 16, the chain's length rounded up), so every link constant is a
//   fixed offset in the `__grid_constant__` Chain, an operand of the FMAs,
//   and the chain's q loads are all issued before the sweep.
// - A joint whose axis is exactly ±e_k (every joint of the bundled robots)
//   turns by a planar rotation: F·J keeps the 12 products whose factors are
//   not exact zeros or ones (`fk_axis_rot`), and the joint's world axis z is
//   ± column k of the next Rw, since F·a is ± F's column k. A general axis
//   keeps drm_rodrigues and the full F·J. The link's kind is a constant, so
//   each branch is uniform across the warp.
// - The first link multiplies nothing by the identity, and the last link's
//   rotation, which nothing reads, is not formed (nor its sincos).
// The dropped terms are exact zeros and ones, so the kernels compute the
// plain versions' formulas (ops/kernels/fk.py `chain_sweep`) up to FMA
// contraction and signed zeros.
//
// K2 sweeps once: each revolute joint keeps w = g × z and b = o·w in
// registers (4 values; z and o would take 6), and its row
// g·(z × (p − o)) = p·w − b is formed once p, the chain end, is known; a
// prismatic joint's row g·z is stored as it passes. The 4-value record keeps
// float64's 16-link build at 128 record registers rather than 192, and the
// float32 8-link build at 64 registers a thread. The operations are as many
// as for (z, o): w and b take 9 during the sweep, the row 3 after. The
// price is rounding: p·w and b are of the size |p| |w|, so a row's float32
// error scales with the chain end's distance from the root rather than
// with |p - o|; rows of joints near the chain end carry a few times the
// (z, o) form's error, still far inside chip_smoke.py's VJP_REL_TOL. The
// plain version forms the same records (`fk_position_dof_major_vjp_reference`).
//
// Launch shape (PERF.md, PR 10): 128 threads a block. K1 takes two
// configurations a thread only where one a thread would not fit the card in
// one wave of resident blocks (`fwd_wave`: past it a second wave of a few
// warps costs a whole chain's latency, and two a thread halve the warps and
// give each two independent chains); K2 always takes one (64 registers a
// thread in float32; two a thread would double its records and halve its
// resident warps).

#include <atomic>
#include <cstdint>

#include "chain.cuh"

namespace {

// The rotation F·J of a joint whose axis is ±e_K (NEG for the minus sign),
// by the angle with cosine c and sine s: column K of F; with s' = ±s and
// (I, J) = (K + 1, K + 2) mod 3, column I is F_I c + F_J s' and column J is
// F_J c - F_I s'. These are drm_rodrigues + drm_mat3's products whose
// factors are not exact zeros or ones.
template <int K, bool NEG, typename T>
__device__ __forceinline__ void fk_axis_rot(const T* F, T c, T s, T* R) {
  constexpr int I = (K + 1) % 3, J = (K + 2) % 3;
  const T sn = NEG ? -s : s;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    R[3 * r + K] = F[3 * r + K];
    R[3 * r + I] = F[3 * r + I] * c + F[3 * r + J] * sn;
    R[3 * r + J] = F[3 * r + J] * c - F[3 * r + I] * sn;
  }
}

// Rw <- Rw R; R itself on the first link, where Rw is the identity.
template <typename T>
__device__ __forceinline__ void fk_turn(T* Rw, const T* R, bool first) {
  if (first) {
#pragma unroll
    for (int i = 0; i < 9; ++i) Rw[i] = R[i];
    return;
  }
  T Rn[9];
  drm_mat3(Rw, R, Rn);
#pragma unroll
  for (int i = 0; i < 9; ++i) Rw[i] = Rn[i];
}

// A revolute joint on the axis ±e_K that is not the chain's last link: Rw
// turns by F·J, and z = ±Rw[:, K] after the turn (= Rw_before · F·a).
template <int K, bool NEG, typename T>
__device__ __forceinline__ void fk_axis_turn(const T* F, T c, T s, T* Rw, T* z, bool first) {
  T R[9];
  fk_axis_rot<K, NEG>(F, c, s, R);
  fk_turn(Rw, R, first);
#pragma unroll
  for (int i = 0; i < 3; ++i) z[i] = NEG ? -Rw[3 * i + K] : Rw[3 * i + K];
}

// fk_axis_turn for each of P configurations.
template <int K, bool NEG, int P, typename T>
__device__ __forceinline__ void fk_axis_turns(const T* F, const T (&c)[P], const T (&s)[P],
                                              T (&Rw)[P][9], T (&z)[P][3], bool first) {
#pragma unroll
  for (int r = 0; r < P; ++r) fk_axis_turn<K, NEG>(F, c[r], s[r], Rw[r], z[r], first);
}

// The chain sweep of K1/K2 for P configurations at once: drm_chain_sweep's
// arithmetic, unrolled over at most NC links, with the q value of link k in
// qv[r][k]. For every joint, rec(k, r, z, o) gets configuration r's world
// axis z and world origin o. On return pw[r] is the chain end's position.
template <int NC, int P, typename T, typename Rec>
__device__ __forceinline__ void fk_sweep(const Chain<T>& ch, const T (&qv)[P][NC], Rec rec,
                                         T (&pw)[P][3]) {
  T Rw[P][9];
  // the root's position, which a chain of no links (to the root) keeps
#pragma unroll
  for (int r = 0; r < P; ++r) pw[r][0] = pw[r][1] = pw[r][2] = T(0);
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k >= ch.n) break;
    const ChainLink<T>& L = ch.link[k];
    const bool first = k == 0, last = k + 1 == ch.n, joint = L.type != DRM_FIXED;
    const bool z_after = L.type == DRM_REVOLUTE && L.axis != DRM_AXIS_GENERAL && !last;
    T z[P][3];
#pragma unroll
    for (int r = 0; r < P; ++r) {
      T tt[3] = {L.t[0], L.t[1], L.t[2]};
      if (L.type == DRM_PRISMATIC) {
#pragma unroll
        for (int i = 0; i < 3; ++i) tt[i] = L.t[i] + L.Fa[i] * qv[r][k];
      }
      if (first) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          z[r][i] = L.Fa[i];
          pw[r][i] = tt[i];
        }
      } else {
        if (joint && !z_after) drm_rot(Rw[r], L.Fa, z[r]);
        T dt[3];
        drm_rot(Rw[r], tt, dt);
#pragma unroll
        for (int i = 0; i < 3; ++i) pw[r][i] += dt[i];
      }
    }
    if (!last) {
      if (L.type == DRM_REVOLUTE) {
        T c[P], s[P];
#pragma unroll
        for (int r = 0; r < P; ++r) drm_sincos(qv[r][k], &s[r], &c[r]);
        switch (L.axis) {
          case 1: fk_axis_turns<0, false>(L.F, c, s, Rw, z, first); break;
          case -1: fk_axis_turns<0, true>(L.F, c, s, Rw, z, first); break;
          case 2: fk_axis_turns<1, false>(L.F, c, s, Rw, z, first); break;
          case -2: fk_axis_turns<1, true>(L.F, c, s, Rw, z, first); break;
          case 3: fk_axis_turns<2, false>(L.F, c, s, Rw, z, first); break;
          case -3: fk_axis_turns<2, true>(L.F, c, s, Rw, z, first); break;
          default:
#pragma unroll
            for (int r = 0; r < P; ++r) {
              T J[9], R[9];
              drm_rodrigues(L.a, c[r], s[r], J);
              drm_mat3(L.F, J, R);
              fk_turn(Rw[r], R, first);
            }
        }
      } else {
#pragma unroll
        for (int r = 0; r < P; ++r) fk_turn(Rw[r], L.F, first);
      }
    }
    if (joint) {
#pragma unroll
      for (int r = 0; r < P; ++r) rec(k, r, z[r], pw[r]);
    }
  }
}

// Configuration r of a thread: m0 + r * blockDim.x, clamped to M - 1 past
// the end (its results are not stored).
template <int P>
__device__ __forceinline__ void fk_columns(int64_t m0, int64_t M, int64_t (&m)[P], bool (&ok)[P]) {
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int64_t x = m0 + int64_t(r) * blockDim.x;
    ok[r] = x < M;
    m[r] = ok[r] ? x : M - 1;
  }
}

template <int NC, int P, typename T>
__device__ __forceinline__ void fk_load_q(const Chain<T>& ch, const T* __restrict__ q, int64_t M,
                                          const int64_t (&m)[P], T (&qv)[P][NC]) {
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k >= ch.n) break;
    if (ch.link[k].type == DRM_FIXED) continue;
    const T* qd = q + ch.link[k].dof * M;
#pragma unroll
    for (int r = 0; r < P; ++r) qv[r][k] = qd[m[r]];
  }
}

template <typename T, int NC, int P>
__global__ void fk_fwd_kernel(const __grid_constant__ Chain<T> ch, const T* __restrict__ q,
                              T* __restrict__ p, int64_t M) {
  const int64_t m0 = int64_t(blockIdx.x) * blockDim.x * P + threadIdx.x;
  if (m0 >= M) return;
  int64_t m[P];
  bool ok[P];
  fk_columns(m0, M, m, ok);
  T qv[P][NC];
  fk_load_q(ch, q, M, m, qv);
  T pw[P][3];
  fk_sweep(ch, qv, [](int, int, const T*, const T*) {}, pw);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    if (!ok[r]) continue;
    p[m[r]] = pw[r][0];
    p[M + m[r]] = pw[r][1];
    p[2 * M + m[r]] = pw[r][2];
  }
}

template <typename T, int NC>
__global__ void fk_bwd_kernel(const __grid_constant__ Chain<T> ch, const T* __restrict__ q,
                              const T* __restrict__ g, T* __restrict__ dq, int64_t M) {
  const int64_t m[1] = {int64_t(blockIdx.x) * blockDim.x + threadIdx.x};
  if (m[0] >= M) return;
  T qv[1][NC];
  fk_load_q(ch, q, M, m, qv);
  const T gv[3] = {g[m[0]], g[M + m[0]], g[2 * M + m[0]]};
  // each revolute joint's record: w = g x z and b = o.w
  T w[NC][3], b[NC];
  T pw[1][3];
  fk_sweep(
      ch, qv,
      [&](int k, int, const T* z, const T* o) {
        if (ch.link[k].type == DRM_REVOLUTE) {
          T* wk = w[k];
          wk[0] = gv[1] * z[2] - gv[2] * z[1];
          wk[1] = gv[2] * z[0] - gv[0] * z[2];
          wk[2] = gv[0] * z[1] - gv[1] * z[0];
          b[k] = o[0] * wk[0] + o[1] * wk[1] + o[2] * wk[2];
        } else {
          dq[ch.link[k].dof * M + m[0]] = gv[0] * z[0] + gv[1] * z[1] + gv[2] * z[2];
        }
      },
      pw);
  const T* p = pw[0];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    if (k >= ch.n) break;
    if (ch.link[k].type != DRM_REVOLUTE) continue;
    dq[ch.link[k].dof * M + m[0]] = p[0] * w[k][0] + p[1] * w[k][1] + p[2] * w[k][2] - b[k];
  }
  // the rows of dofs off the chain
  if (__popc(ch.dof_mask) == ch.D) return;
  for (int d = 0; d < ch.D; ++d)
    if (!((ch.dof_mask >> d) & 1u)) dq[d * M + m[0]] = T(0);
}

constexpr int kThreads = 128;
constexpr int kMaxDevices = 64;

inline unsigned blocks_for(int64_t M, int per) {
  const int64_t span = int64_t(kThreads) * per;
  return unsigned((M + span - 1) / span);
}

// The configurations one wave of K1's resident blocks holds at one a thread
// on the current device, in *out; queried once a device and build.
template <typename T, int NC>
cudaError_t fwd_wave(int64_t* out) {
  static std::atomic<int64_t> wave[kMaxDevices];
  int dev, sms, blocks;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev >= kMaxDevices) return cudaErrorInvalidDevice;
  *out = wave[dev].load(std::memory_order_relaxed);
  if (*out != 0) return cudaSuccess;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc == cudaSuccess)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fk_fwd_kernel<T, NC, 1>, kThreads, 0);
  if (rc == cudaSuccess) {
    *out = int64_t(sms) * blocks * kThreads;
    wave[dev].store(*out, std::memory_order_relaxed);
  }
  return rc;
}

template <typename T, int NC>
int fwd_launch(const Chain<T>* ch, const T* q, T* p, int64_t M, cudaStream_t stream) {
  int64_t wave;
  const cudaError_t rc = fwd_wave<T, NC>(&wave);
  if (rc != cudaSuccess) return int(rc);
  if (M <= wave)
    fk_fwd_kernel<T, NC, 1><<<blocks_for(M, 1), kThreads, 0, stream>>>(*ch, q, p, M);
  else
    fk_fwd_kernel<T, NC, 2><<<blocks_for(M, 2), kThreads, 0, stream>>>(*ch, q, p, M);
  return int(cudaGetLastError());
}

template <typename T>
int fwd(const Chain<T>* ch, const T* q, T* p, int64_t M, void* stream) {
  if (ch->n < 0 || ch->n > DRM_MAX_CHAIN) return int(cudaErrorInvalidValue);
  return ch->n > 8 ? fwd_launch<T, 16>(ch, q, p, M, (cudaStream_t)stream)
                   : fwd_launch<T, 8>(ch, q, p, M, (cudaStream_t)stream);
}

template <typename T>
int bwd(const Chain<T>* ch, const T* q, const T* g, T* dq, int64_t M, void* stream) {
  if (ch->n < 0 || ch->n > DRM_MAX_CHAIN) return int(cudaErrorInvalidValue);
  auto kern = ch->n > 8 ? fk_bwd_kernel<T, 16> : fk_bwd_kernel<T, 8>;
  kern<<<blocks_for(M, 1), kThreads, 0, (cudaStream_t)stream>>>(*ch, q, g, dq, M);
  return int(cudaGetLastError());
}

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
  return fwd(ch, q, p, M, stream);
}

int fk_fwd_f64(const Chain<double>* ch, const double* q, double* p, int64_t M, void* stream) {
  return fwd(ch, q, p, M, stream);
}

int fk_bwd_f32(const Chain<float>* ch, const float* q, const float* g, float* dq, int64_t M,
               void* stream) {
  return bwd(ch, q, g, dq, M, stream);
}

int fk_bwd_f64(const Chain<double>* ch, const double* q, const double* g, double* dq, int64_t M,
               void* stream) {
  return bwd(ch, q, g, dq, M, stream);
}

}  // extern "C"
