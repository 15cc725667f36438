// Shared device code of the chain-FK kernels: the robot's root->link chain
// as a by-value kernel argument, and the forward sweep over it.
//
// Port of the sweep in the JAX package's ops/pallas/fk.py (`_chain_sweep`)
// and ops/pallas/rollout.py (`_ee_fk_folded`). The TPU
// kernels bake every robot constant into the code as an f32 immediate; here
// the constants travel in a `Chain<T>` struct passed by value (it lives in
// the kernel's parameter bank, read through the constant cache), so one
// build serves every robot. The host prepares the constants
// (ops/kernels/fk.py `chain_constants`): the fixed rotation F from
// cos/sin rounded to T, the axis a, F@a and the translation t.
#pragma once

#include <cuda_runtime.h>

// Longest root->link chain over the bundled URDFs is 13 (kuka_iiwa7_allegro);
// the widest robot has 23 dofs. The Python wrappers check both limits and
// must agree with these values (checked at load through *_layout()).
#define DRM_MAX_CHAIN 16
#define DRM_MAX_DOF 32

#define DRM_FIXED 0
#define DRM_REVOLUTE 1
#define DRM_PRISMATIC 2

// ChainLink::axis: k + 1 where the axis a is exactly +e_k, -(k + 1) where it
// is exactly -e_k, DRM_AXIS_GENERAL for any other axis (read by K1/K2 only).
#define DRM_AXIS_GENERAL 0

template <typename T>
struct ChainLink {
  int type;  // DRM_FIXED / DRM_REVOLUTE / DRM_PRISMATIC
  int dof;   // dof index of the joint (unused for fixed links)
  int axis;  // the axis's kind, as above
  T F[9];    // fixed rpy rotation, row major
  T a[3];    // joint axis in the joint frame
  T Fa[3];   // F @ a: the axis after the fixed rotation
  T t[3];    // joint origin in the parent frame
};

template <typename T>
struct Chain {
  int n;             // links on the chain, root excluded
  int D;             // dofs of the robot
  unsigned dof_mask; // bit d set iff dof d is on the chain
  ChainLink<T> link[DRM_MAX_CHAIN];
};

__device__ __forceinline__ void drm_sincos(float x, float* s, float* c) { sincosf(x, s, c); }
__device__ __forceinline__ void drm_sincos(double x, double* s, double* c) { sincos(x, s, c); }

template <typename T>
__device__ __forceinline__ void drm_mat3(const T* A, const T* B, T* C) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[3 * i + j] = A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j];
}

template <typename T>
__device__ __forceinline__ void drm_rot(const T* R, const T* v, T* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

// Rotation about the unit axis a by the angle with cosine c and sine s. A
// diagonal entry with a_i^2 exactly 1 or 0 is 1 or c, as the TPU kernels
// fold it (ops/pallas/_fold.py `rodrigues`).
template <typename T>
__device__ __forceinline__ void drm_rodrigues(const T* a, T c, T s, T* J) {
  const T C = T(1) - c;
  T diag[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T aa = a[i] * a[i];
    diag[i] = aa == T(1) ? T(1) : (aa == T(0) ? c : c + aa * C);
  }
  J[0] = diag[0];
  J[1] = a[0] * a[1] * C - a[2] * s;
  J[2] = a[0] * a[2] * C + a[1] * s;
  J[3] = a[1] * a[0] * C + a[2] * s;
  J[4] = diag[1];
  J[5] = a[1] * a[2] * C - a[0] * s;
  J[6] = a[2] * a[0] * C - a[1] * s;
  J[7] = a[2] * a[1] * C + a[0] * s;
  J[8] = diag[2];
}

struct DrmNoRecord {
  template <typename T>
  __device__ __forceinline__ void operator()(int, int, const T*, const T*) const {}
};

// The forward sweep root -> chain end. `q(d)` returns the value of dof d.
// For every joint, `rec(type, dof, z, o)` is called with its world axis z
// and its world origin o (the link origin after this link's translation).
// On return pw holds the world position of the chain's last link.
template <typename T, typename Q, typename Rec>
__device__ __forceinline__ void drm_chain_sweep(const Chain<T>& ch, Q q, Rec rec, T pw[3]) {
  T Rw[9] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0), T(0), T(1)};
  pw[0] = pw[1] = pw[2] = T(0);
  for (int k = 0; k < ch.n; ++k) {
    const ChainLink<T>& L = ch.link[k];
    T R[9];
    T tt[3] = {L.t[0], L.t[1], L.t[2]};
    if (L.type == DRM_REVOLUTE) {
      T s, c;
      drm_sincos(q(L.dof), &s, &c);
      T J[9];
      drm_rodrigues(L.a, c, s, J);
      drm_mat3(L.F, J, R);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = L.F[i];
      if (L.type == DRM_PRISMATIC) {
        const T qv = q(L.dof);
#pragma unroll
        for (int i = 0; i < 3; ++i) tt[i] = L.t[i] + L.Fa[i] * qv;
      }
    }
    T z[3];
    if (L.type != DRM_FIXED) drm_rot(Rw, L.Fa, z);
    T dt[3];
    drm_rot(Rw, tt, dt);
#pragma unroll
    for (int i = 0; i < 3; ++i) pw[i] += dt[i];
    if (L.type != DRM_FIXED) rec(L.type, L.dof, z, pw);
    T Rn[9];
    drm_mat3(Rw, R, Rn);
#pragma unroll
    for (int i = 0; i < 9; ++i) Rw[i] = Rn[i];
  }
}

// Cotangent of the chain end's position g pulled back to joint `type` with
// world axis z through world point o, by the geometric-Jacobian identity
// (ops/pallas/fk.py `_bwd_kernel`): g.(z x (p - o)) for a revolute joint,
// g.z for a prismatic one.
template <typename T>
__device__ __forceinline__ T drm_joint_vjp(int type, const T* z, const T* o, const T* p, const T* g) {
  if (type == DRM_REVOLUTE) {
    const T r0 = p[0] - o[0], r1 = p[1] - o[1], r2 = p[2] - o[2];
    return g[0] * (z[1] * r2 - z[2] * r1) + g[1] * (z[2] * r0 - z[0] * r2) +
           g[2] * (z[0] * r1 - z[1] * r0);
  }
  return g[0] * z[0] + g[1] * z[1] + g[2] * z[2];
}
