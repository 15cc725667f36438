// Shared device code of the dynamics kernels: the robot's whole tree as a
// by-value kernel argument, one semi-implicit Euler forward-dynamics step,
// and that step's adjoint.
//
// Port of the JAX package's ops/pallas/rollout.py `_fd_step_folded` (RNEA
// bias at qdd = 0, world-frame composite-rigid-body mass matrix plus
// dt diag(damping), unrolled LDL^T solve, qd' = clip(qd + dt qdd, +-vmax),
// q' = q + dt qd'). The TPU kernel bakes the constants in as f32
// immediates; here they travel in a `Tree<T>` (built on the host by
// ops/kernels/rollout.py `tree_struct`, rounded to T as the TPU kernels
// round them), passed by value as a `__grid_constant__` parameter. A float64
// tree of 32 links is about 9 KB, past the classic 4 KB parameter limit:
// the kernels rely on CUDA 12.1+, which allows 32,764 bytes of parameters
// on sm_70 and later. One build serves every robot of up to 32 links and 32
// dofs; each kernel is instantiated for two capacities (16 and 32 links and
// dofs) so that the per-thread arrays of a small robot stay small.
//
// The adjoint (`drm_fd_step_adjoint`) is written out, since CUDA has no
// jax.vjp: with Ĥ = M(q) + dt diag(d) and qdd* the replayed step's
// acceleration, x̄ = (ḡqd' + dt ḡq') dclip(x), λ = Ĥ⁻¹ dt x̄, τ̄ = λ,
// q̄ = ḡq' - (∂RNEA(q, qd, qdd*)/∂q)ᵀ λ and q̄d = x̄ - (∂RNEA/∂qd)ᵀ λ. The
// RNEA partials come from 2D forward sweeps of the RNEA code on dual
// numbers, one tangent each: more operations than one reverse sweep, and
// the simplest form to hold against its plain version
// (ops/kernels/rollout.py `StepReplay`).
#pragma once

#include "chain.cuh"

// The largest bundled robot has 29 links (kuka_iiwa7_allegro); the Python
// side checks its ctypes mirror against these values at load.
#define DRM_MAX_LINKS 32

template <typename T>
struct TreeLink {
  int parent;  // parent link (the root, 0, is its own parent)
  int type;    // DRM_FIXED / DRM_REVOLUTE / DRM_PRISMATIC
  int dof;     // dof index of the joint, -1 for a fixed link
  T F[9];      // fixed rpy rotation, row major
  T a[3];      // joint axis in the joint frame
  T Fa[3];     // F @ a
  T t[3];      // joint origin in the parent frame
  T mass;
  T com[3];    // centre of mass in the link frame
  T I6[6];     // inertia about the COM: xx, xy, xz, yy, yz, zz
};

template <typename T>
struct Tree {
  int n;            // links, root included
  int D;            // dofs
  int use_damping;  // viscous joint damping on (in RNEA and, implicitly, in the step)
  T dt;
  T gravity;        // the base's upward acceleration +g (d'Alembert)
  int dof_link[DRM_MAX_DOF];
  unsigned anc[DRM_MAX_DOF];  // bit i set iff dof i is on dof j's root chain (j included)
  T damping[DRM_MAX_DOF];
  T dt_damping[DRM_MAX_DOF];  // dt * damping, rounded once
  T vmax[DRM_MAX_DOF];        // velocity clamp, inf where unbounded
  T emax[DRM_MAX_DOF];        // effort box, inf where unbounded
  TreeLink<T> link[DRM_MAX_LINKS];
};

// ---- forward-mode dual numbers ---------------------------------------------

template <typename T>
struct Dual {
  T v, t;
  __device__ __forceinline__ Dual() {}
  __device__ __forceinline__ Dual(T v_) : v(v_), t(T(0)) {}
  __device__ __forceinline__ Dual(T v_, T t_) : v(v_), t(t_) {}
};

template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.t + b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.t - b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(Dual<T> a) { return {-a.v, -a.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.t * b.v + a.v * b.t};
}
template <typename T>
__device__ __forceinline__ Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.t * b}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.t}; }
template <typename T>
__device__ __forceinline__ Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.t}; }

template <typename T>
__device__ __forceinline__ void drm_sincos(Dual<T> x, Dual<T>* s, Dual<T>* c) {
  T sv, cv;
  drm_sincos(x.v, &sv, &cv);
  *s = {sv, cv * x.t};
  *c = {cv, -sv * x.t};
}

// ---- small vector helpers (S: lane value, T: robot constant) ---------------

template <typename S>
__device__ __forceinline__ void drm_cross(const S* a, const S* b, S* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename S>
__device__ __forceinline__ void drm_rot_t(const S* R, const S* v, S* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[i] * v[0] + R[3 + i] * v[1] + R[6 + i] * v[2];
}

template <typename S>
__device__ __forceinline__ void drm_rot_s(const S* R, const S* v, S* out) {
#pragma unroll
  for (int i = 0; i < 3; ++i) out[i] = R[3 * i] * v[0] + R[3 * i + 1] * v[1] + R[3 * i + 2] * v[2];
}

// Symmetric 3x3 (xx, xy, xz, yy, yz, zz) @ v.
template <typename M, typename S>
__device__ __forceinline__ void drm_symm(const M* I, const S* v, S* out) {
  out[0] = I[0] * v[0] + I[1] * v[1] + I[2] * v[2];
  out[1] = I[1] * v[0] + I[3] * v[1] + I[4] * v[2];
  out[2] = I[2] * v[0] + I[4] * v[1] + I[5] * v[2];
}

template <typename T>
__device__ __forceinline__ T drm_clip(T x, T lo, T hi) {
  // jnp.maximum then jnp.minimum, NaN propagating like XLA's max/min.
  const T y = x < lo ? lo : x;
  return y > hi ? hi : y;
}

// d clip(x) / dx under JAX's rule for max and min: 1 strictly inside, 0.5 at
// an exact tie with a bound, 0 outside.
template <typename T>
__device__ __forceinline__ T drm_clip_grad(T x, T lo, T hi) {
  const T g_max = x > lo ? T(1) : (x == lo ? T(0.5) : T(0));
  const T y = x < lo ? lo : x;
  const T g_min = y < hi ? T(1) : (y == hi ? T(0.5) : T(0));
  return g_max * g_min;
}

// ---- the sweeps --------------------------------------------------------------

// Local rotation R (row major) and translation t of link L at joint value qv.
template <typename S, typename T>
__device__ __forceinline__ void drm_local(const TreeLink<T>& L, S qv, S* R, S* t) {
  if (L.type == DRM_REVOLUTE) {
    S s, c;
    drm_sincos(qv, &s, &c);
    const S C = T(1) - c;
    const T* a = L.a;
    S J[9];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T aa = a[i] * a[i];
      J[4 * i] = aa == T(1) ? S(T(1)) : (aa == T(0) ? c : c + aa * C);
    }
    J[1] = (a[0] * a[1]) * C - a[2] * s;
    J[2] = (a[0] * a[2]) * C + a[1] * s;
    J[3] = (a[1] * a[0]) * C + a[2] * s;
    J[5] = (a[1] * a[2]) * C - a[0] * s;
    J[6] = (a[2] * a[0]) * C - a[1] * s;
    J[7] = (a[2] * a[1]) * C + a[0] * s;
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j)
        R[3 * i + j] = L.F[3 * i] * J[j] + L.F[3 * i + 1] * J[3 + j] + L.F[3 * i + 2] * J[6 + j];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = S(L.t[i]);
  } else {
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = S(L.F[i]);
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = L.type == DRM_PRISMATIC ? L.Fa[i] * qv + L.t[i] : S(L.t[i]);
  }
}

template <typename S, typename T, int NL>
__device__ __forceinline__ void drm_local_all(const Tree<T>& tr, const S* q, S (*Rl)[9], S (*tl)[3]) {
  for (int l = 1; l < tr.n; ++l) {
    const TreeLink<T>& L = tr.link[l];
    drm_local(L, L.dof >= 0 ? q[L.dof] : S(T(0)), Rl[l], tl[l]);
  }
}

// RNEA from the local transforms: tau = M(q) qdd + C(q, qd) qd + g(q), plus
// d * qd with damping on (the link-frame Newton-Euler sweeps of
// ops/dynamics_scalar.py `_rnea_sweeps`; the linear velocity, which no
// force reads, is not propagated).
template <typename S, typename T, int NL>
__device__ void drm_rnea(const Tree<T>& tr, S (*Rl)[9], S (*tl)[3], const S* qd,
                         const S* qdd, S* tau) {
  S w[NL][3], dw[NL][3], dv[NL][3];
  const S zero = S(T(0));
#pragma unroll
  for (int i = 0; i < 3; ++i) w[0][i] = dw[0][i] = dv[0][i] = zero;
  dv[0][2] = S(tr.gravity);
  for (int l = 1; l < tr.n; ++l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = L.parent;
    const S* R = Rl[l];
    const S* t = tl[l];
    S w_c[3], dw_c[3], dv_c[3], c1[3], c2[3], c3[3], acc[3];
    drm_rot_t(R, w[par], w_c);
    drm_rot_t(R, dw[par], dw_c);
    drm_cross(dw[par], t, c1);
    drm_cross(w[par], t, c2);
    drm_cross(w[par], c2, c3);
#pragma unroll
    for (int i = 0; i < 3; ++i) acc[i] = dv[par][i] + (c1[i] + c3[i]);
    drm_rot_t(R, acc, dv_c);
    if (L.type == DRM_FIXED) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        w[l][i] = w_c[i];
        dw[l][i] = dw_c[i];
        dv[l][i] = dv_c[i];
      }
      continue;
    }
    const S qdl = qd[L.dof], qddl = qdd[L.dof];
    S j[3], wxj[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) j[i] = L.a[i] * qdl;
    drm_cross(w_c, j, wxj);
    if (L.type == DRM_REVOLUTE) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        w[l][i] = w_c[i] + j[i];
        dw[l][i] = dw_c[i] + (L.a[i] * qddl + wxj[i]);
        dv[l][i] = dv_c[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        w[l][i] = w_c[i];
        dw[l][i] = dw_c[i];
        dv[l][i] = dv_c[i] + (L.a[i] * qddl + wxj[i] * T(2));
      }
    }
  }

  S f_acc[NL][3], n_acc[NL][3];
  for (int l = 0; l < tr.n; ++l)
#pragma unroll
    for (int i = 0; i < 3; ++i) f_acc[l][i] = n_acc[l][i] = zero;
  for (int l = tr.n - 1; l >= 1; --l) {
    const TreeLink<T>& L = tr.link[l];
    // Newton: f = m a_c, a_c = dv + dw x c + w x (w x c); Euler about the
    // COM moved to the link origin: n = I dw + w x I w + c x f.
    S wc[3], wwc[3], dwc[3], f_new[3], Idw[3], Iw[3], wIw[3], cf[3], f_tot[3], n_tot[3];
    const S cS[3] = {S(L.com[0]), S(L.com[1]), S(L.com[2])};
    drm_cross(dw[l], cS, dwc);
    drm_cross(w[l], cS, wc);
    drm_cross(w[l], wc, wwc);
#pragma unroll
    for (int i = 0; i < 3; ++i) f_new[i] = (dv[l][i] + (dwc[i] + wwc[i])) * L.mass;
    drm_symm(L.I6, dw[l], Idw);
    drm_symm(L.I6, w[l], Iw);
    drm_cross(w[l], Iw, wIw);
    drm_cross(cS, f_new, cf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      f_tot[i] = f_acc[l][i] + f_new[i];
      n_tot[i] = n_acc[l][i] + ((Idw[i] + wIw[i]) + cf[i]);
    }
    if (L.type == DRM_REVOLUTE)
      tau[L.dof] = L.a[0] * n_tot[0] + L.a[1] * n_tot[1] + L.a[2] * n_tot[2];
    else if (L.type == DRM_PRISMATIC)
      tau[L.dof] = L.a[0] * f_tot[0] + L.a[1] * f_tot[1] + L.a[2] * f_tot[2];
    S f_p[3], Rn[3], tf[3];
    drm_rot_s(Rl[l], f_tot, f_p);
    drm_rot_s(Rl[l], n_tot, Rn);
    drm_cross(tl[l], f_p, tf);
    const int par = L.parent;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      f_acc[par][i] = f_acc[par][i] + f_p[i];
      n_acc[par][i] = n_acc[par][i] + (Rn[i] + tf[i]);
    }
  }
  if (tr.use_damping)
    for (int d = 0; d < tr.D; ++d) tau[d] = tau[d] + tr.damping[d] * qd[d];
}

// Index of entry (i, j), j <= i, of a packed lower triangle.
__device__ __forceinline__ int drm_tri(int i, int j) { return i * (i + 1) / 2 + j; }

// World-frame composite-rigid-body mass matrix M(q) into the packed lower
// triangle Hm (ops/dynamics_scalar.py `mass_matrix_scalar`).
template <typename T, int NL, int ND>
__device__ void drm_crb(const Tree<T>& tr, T (*Rl)[9], T (*tl)[3], T* Hm) {
  T Rw[NL][9], pw[NL][3];
  T m_c[NL], h_c[NL][3], I_c[NL][6];
#pragma unroll
  for (int i = 0; i < 9; ++i) Rw[0][i] = (i % 4 == 0) ? T(1) : T(0);
  pw[0][0] = pw[0][1] = pw[0][2] = T(0);
  for (int l = 1; l < tr.n; ++l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = L.parent;
    T d[3];
    drm_rot(Rw[par], tl[l], d);
#pragma unroll
    for (int i = 0; i < 3; ++i) pw[l][i] = pw[par][i] + d[i];
    drm_mat3(Rw[par], Rl[l], Rw[l]);
    // The link's own parameters about the world origin: m, h = m c_w and
    // I_o = R I R^T + m (|c|^2 E - c c^T).
    T rc[3], cw[3];
    drm_rot(Rw[l], L.com, rc);
#pragma unroll
    for (int i = 0; i < 3; ++i) cw[i] = pw[l][i] + rc[i];
    const T* R = Rw[l];
    T rows[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const T r[3] = {R[3 * i], R[3 * i + 1], R[3 * i + 2]};
      drm_symm(L.I6, r, rows[i]);
    }
    auto entry = [&](int i, int j) {
      return rows[i][0] * R[3 * j] + rows[i][1] * R[3 * j + 1] + rows[i][2] * R[3 * j + 2];
    };
    const T m = L.mass, cx = cw[0], cy = cw[1], cz = cw[2];
    I_c[l][0] = entry(0, 0) + m * (cy * cy + cz * cz);
    I_c[l][1] = entry(0, 1) - m * cx * cy;
    I_c[l][2] = entry(0, 2) - m * cx * cz;
    I_c[l][3] = entry(1, 1) + m * (cx * cx + cz * cz);
    I_c[l][4] = entry(1, 2) - m * cy * cz;
    I_c[l][5] = entry(2, 2) + m * (cx * cx + cy * cy);
    m_c[l] = m;
#pragma unroll
    for (int i = 0; i < 3; ++i) h_c[l][i] = cw[i] * m;
  }
  // Composites, child -> parent (the root's is never read).
  for (int l = tr.n - 1; l >= 2; --l) {
    const int par = tr.link[l].parent;
    if (par == 0) continue;
    m_c[par] = m_c[par] + m_c[l];
#pragma unroll
    for (int i = 0; i < 3; ++i) h_c[par][i] = h_c[par][i] + h_c[l][i];
#pragma unroll
    for (int i = 0; i < 6; ++i) I_c[par][i] = I_c[par][i] + I_c[l][i];
  }
  // Joint subspaces about the world origin, then H_ij = <S_i, Ic_j S_j> for
  // i on j's root chain.
  const int D = tr.D;
  T S_w[ND][6];
  for (int j = 0; j < D; ++j) {
    const int l = tr.dof_link[j];
    T z[3];
    drm_rot(Rw[l], tr.link[l].a, z);
    if (tr.link[l].type == DRM_REVOLUTE) {
      T pz[3];
      drm_cross(pw[l], z, pz);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        S_w[j][i] = z[i];
        S_w[j][3 + i] = pz[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        S_w[j][i] = T(0);
        S_w[j][3 + i] = z[i];
      }
    }
  }
  for (int i = 0; i < D * (D + 1) / 2; ++i) Hm[i] = T(0);
  for (int j = 0; j < D; ++j) {
    const int lj = tr.dof_link[j];
    const T* wv = S_w[j];
    const T* vv = S_w[j] + 3;
    T Iw[3], hv[3], hw[3], n[3], f[3];
    drm_symm(I_c[lj], wv, Iw);
    drm_cross(h_c[lj], vv, hv);
    drm_cross(h_c[lj], wv, hw);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      n[k] = Iw[k] + hv[k];
      f[k] = vv[k] * m_c[lj] - hw[k];
    }
    const unsigned anc = tr.anc[j];
    for (int i = 0; i <= j; ++i) {
      if (!((anc >> i) & 1u)) continue;
      const T* wi = S_w[i];
      const T* vi = S_w[i] + 3;
      Hm[drm_tri(j, i)] = (wi[0] * n[0] + wi[1] * n[1] + wi[2] * n[2]) +
                          (vi[0] * f[0] + vi[1] * f[1] + vi[2] * f[2]);
    }
  }
}

// In-place LDL^T of the packed lower triangle (L's strict lower entries
// replace H's, the diagonal goes to dg).
template <typename T>
__device__ void drm_ldl_factor(T* Hm, T* dg, int D) {
  for (int j = 0; j < D; ++j) {
    T s = Hm[drm_tri(j, j)];
    for (int k = 0; k < j; ++k) s = s - Hm[drm_tri(j, k)] * Hm[drm_tri(j, k)] * dg[k];
    dg[j] = s;
    const T inv = T(1) / s;
    for (int i = j + 1; i < D; ++i) {
      T s2 = Hm[drm_tri(i, j)];
      for (int k = 0; k < j; ++k) s2 = s2 - Hm[drm_tri(i, k)] * Hm[drm_tri(j, k)] * dg[k];
      Hm[drm_tri(i, j)] = s2 * inv;
    }
  }
}

template <typename T, int ND>
__device__ void drm_ldl_solve(const T* Lf, const T* dg, int D, const T* b, T* x) {
  T z[ND];
  for (int i = 0; i < D; ++i) {
    T s = b[i];
    for (int k = 0; k < i; ++k) s = s - Lf[drm_tri(i, k)] * z[k];
    z[i] = s;
  }
  for (int i = D - 1; i >= 0; --i) {
    T s = z[i] / dg[i];
    for (int k = i + 1; k < D; ++k) s = s - Lf[drm_tri(k, i)] * x[k];
    x[i] = s;
  }
}

// The step's acceleration qdd = Ĥ⁻¹ (tau - nle(q, qd)) with Ĥ = M(q) +
// dt diag(d); leaves Ĥ's factor in (Lf, dg) for the adjoint.
template <typename T, int NL, int ND>
__device__ void drm_fd_accel(const Tree<T>& tr, const T* q, const T* qd, const T* tau, T* Lf,
                             T* dg, T* qdd) {
  T Rl[NL][9], tl[NL][3];
  drm_local_all<T, T, NL>(tr, q, Rl, tl);
  const int D = tr.D;
  T zero[ND], nle[ND], b[ND];
  for (int d = 0; d < D; ++d) zero[d] = T(0);
  drm_rnea<T, T, NL>(tr, Rl, tl, qd, zero, nle);
  drm_crb<T, NL, ND>(tr, Rl, tl, Lf);
  if (tr.use_damping)
    for (int d = 0; d < D; ++d) Lf[drm_tri(d, d)] = Lf[drm_tri(d, d)] + tr.dt_damping[d];
  drm_ldl_factor(Lf, dg, D);
  for (int d = 0; d < D; ++d) b[d] = tau[d] - nle[d];
  drm_ldl_solve<T, ND>(Lf, dg, D, b, qdd);
}

// One semi-implicit Euler step (q, qd, tau) -> (qn, qdn) with the velocity clamp.
template <typename T, int NL, int ND>
__device__ void drm_fd_step(const Tree<T>& tr, const T* q, const T* qd, const T* tau, T* qn,
                            T* qdn) {
  T Lf[ND * (ND + 1) / 2], dg[ND], qdd[ND];
  drm_fd_accel<T, NL, ND>(tr, q, qd, tau, Lf, dg, qdd);
  for (int d = 0; d < tr.D; ++d) {
    const T x = drm_clip(qd[d] + tr.dt * qdd[d], -tr.vmax[d], tr.vmax[d]);
    qdn[d] = x;
    qn[d] = q[d] + tr.dt * x;
  }
}

// (∂RNEA(q, qd, qdd)/∂(q, qd))ᵀ w into jac[2D]: jac[k] = Σ_d w_d ∂τ_d/∂q_k
// for k < D and Σ_d w_d ∂τ_d/∂qd_{k-D} for k >= D, with the tree's gravity
// and damping, from 2D forward sweeps of the RNEA on dual numbers, one
// tangent direction each. All 2D partials go into the one array `jac`: with
// the q and qd partials written into two arrays of the caller instead, nvcc
// 12.9 -O3 gave one of them the local-memory slot of this loop's force
// accumulator, which overwrote it (tools/probe_rnea_vjp_layout.py).
// `__noinline__` would keep the loop's arrays in a frame of their own, at a
// cost of 5-10% on K6, K8 and K9; chip_smoke.py instead holds every build of
// every user of this function against its plain version.
template <typename T, int NL, int ND>
__device__ void drm_rnea_vjp(const Tree<T>& tr, const T* q, const T* qd, const T* qdd, const T* w,
                             T* jac) {
  const int D = tr.D;
  for (int k = 0; k < 2 * D; ++k) {
    Dual<T> qv[ND], qdv[ND], qddv[ND], tauv[ND];
    for (int d = 0; d < D; ++d) {
      qv[d] = Dual<T>(q[d], k == d ? T(1) : T(0));
      qdv[d] = Dual<T>(qd[d], k == D + d ? T(1) : T(0));
      qddv[d] = Dual<T>(qdd[d]);
    }
    Dual<T> Rl[NL][9], tl[NL][3];
    drm_local_all<Dual<T>, T, NL>(tr, qv, Rl, tl);
    drm_rnea<Dual<T>, T, NL>(tr, Rl, tl, qdv, qddv, tauv);
    T j = T(0);
    for (int d = 0; d < D; ++d) j = j + w[d] * tauv[d].t;
    jac[k] = j;
  }
}

// The adjoint of `drm_fd_step` at (q, qd, tau) for the cotangents gqn on q'
// and gqdn on qd' (gqd may alias gqdn): lam = τ̄, gq = q̄, gqd = q̄d.
template <typename T, int NL, int ND>
__device__ void drm_fd_step_adjoint(const Tree<T>& tr, const T* q, const T* qd, const T* tau,
                                    const T* gqn, const T* gqdn, T* lam, T* gq, T* gqd) {
  const int D = tr.D;
  T Lf[ND * (ND + 1) / 2], dg[ND], qdd[ND], gx[ND], rhs[ND];
  drm_fd_accel<T, NL, ND>(tr, q, qd, tau, Lf, dg, qdd);
  for (int d = 0; d < D; ++d) {
    const T x = qd[d] + tr.dt * qdd[d];
    gx[d] = (gqdn[d] + tr.dt * gqn[d]) * drm_clip_grad(x, -tr.vmax[d], tr.vmax[d]);
    rhs[d] = tr.dt * gx[d];
  }
  drm_ldl_solve<T, ND>(Lf, dg, D, rhs, lam);
  // q̄ = ḡq' - (∂RNEA(q, qd, qdd*)/∂q)ᵀ λ, q̄d = x̄ - (∂RNEA/∂qd)ᵀ λ.
  T jac[2 * ND];
  drm_rnea_vjp<T, NL, ND>(tr, q, qd, qdd, lam, jac);
  for (int d = 0; d < D; ++d) {
    gq[d] = gqn[d] - jac[d];
    gqd[d] = gx[d] - jac[D + d];
  }
}
