// Philox4x32-10 (Salmon et al., SC 2011; the Random123 constants) and the
// MPPI noise drawn from it, written out for the device. The plain PyTorch
// version, bit for bit the same, is ops/kernels/rng.py.
//
// It takes the place of the TPU's on-core generator in the JAX package's
// ops/pallas/solver.py (`_uniforms`, `_normal_tile`). The MPPI stream's
// layout, fixed once (rng.py holds the same):
//
//   key     = the solve's 64-bit key, words (k0, k1) = (low, high)
//   counter = (scenario, iteration, (h*D + d) / 2, sample)
//   words 0, 1 -> the normal of the even entry h*D + d, words 2, 3 -> the odd
//
// A uniform is (bits >> 8) 2^-24 + 2^-25 in the working type (24 random
// bits, never 0; in float32 the top value rounds to 1, as on the TPU), a
// normal sqrt(-2 log u1) cos(2 pi u2). IEEE logf/cosf/sqrtf: the build
// has no --use_fast_math.
#pragma once

#include <cstdint>

#define DRM_PHILOX_M0 0xD2511F53u
#define DRM_PHILOX_M1 0xCD9E8D57u
#define DRM_PHILOX_W0 0x9E3779B9u
#define DRM_PHILOX_W1 0xBB67AE85u

struct DrmPhilox4 {
  uint32_t w[4];
};

__device__ __forceinline__ DrmPhilox4 drm_philox4x32(uint32_t c0, uint32_t c1, uint32_t c2,
                                                      uint32_t c3, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += DRM_PHILOX_W0;
      k1 += DRM_PHILOX_W1;
    }
    const uint32_t hi0 = __umulhi(DRM_PHILOX_M0, c0), lo0 = DRM_PHILOX_M0 * c0;
    const uint32_t hi1 = __umulhi(DRM_PHILOX_M1, c2), lo1 = DRM_PHILOX_M1 * c2;
    c0 = hi1 ^ c1 ^ k0;
    c1 = lo1;
    c2 = hi0 ^ c3 ^ k1;
    c3 = lo0;
  }
  return {{c0, c1, c2, c3}};
}

__device__ __forceinline__ float drm_log(float x) { return logf(x); }
__device__ __forceinline__ double drm_log(double x) { return log(x); }
__device__ __forceinline__ float drm_cos(float x) { return cosf(x); }
__device__ __forceinline__ double drm_cos(double x) { return cos(x); }
__device__ __forceinline__ float drm_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double drm_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float drm_exp(float x) { return expf(x); }
__device__ __forceinline__ double drm_exp(double x) { return exp(x); }

template <typename T>
__device__ __forceinline__ T drm_uniform(uint32_t bits) {
  return T(int(bits >> 8)) * T(5.9604644775390625e-08) + T(2.98023223876953125e-08);
}

template <typename T>
__device__ __forceinline__ T drm_box_muller(uint32_t w1, uint32_t w2) {
  const T u1 = drm_uniform<T>(w1), u2 = drm_uniform<T>(w2);
  return drm_sqrt(T(-2) * drm_log(u1)) * drm_cos(T(6.283185307179586) * u2);
}
