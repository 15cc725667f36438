// Shared device code of the dynamics kernels: the robot's whole tree as a
// by-value kernel argument, one semi-implicit Euler forward-dynamics step,
// the RNEA partials and the register-resident step.
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
// CUDA has no jax.vjp, so the step's adjoint is written out by the
// implicit-function identity: with Ĥ = M(q) + dt diag(d) and qdd* the
// step's acceleration, x̄ = (ḡqd' + dt ḡq') dclip(x), λ = Ĥ⁻¹ dt x̄, τ̄ = λ,
// q̄ = ḡq' - (∂RNEA(q, qd, qdd*)/∂q)ᵀ λ and q̄d = x̄ - (∂RNEA/∂qd)ᵀ λ
// (K6/K8 in dyn_rollout.cu, K9 in dyn_solve.cu; plain version
// ops/kernels/rollout.py `replay_reference` and `pull_stage`). The RNEA
// partials come from reverse sweeps of the RNEA (`drm_rr_rnea_reverse`),
// which also give K4's VJP `rnea_bwd` (rnea.cu) all three of its
// cotangents.
//
// The generic builds of K5/K7 run the first functions of this file; K4,
// `rnea_bwd`, the prologue, K5/K7's serial builds, K6, K8, K9 and K10 the
// register-resident step at its end (`drm_rr_*`): the same arithmetic on a
// topology policy that fixes a serial chain's shape at compile time (or
// reads a tree's at run time). K5/K7 and the prologue spread a serial
// chain's step over a group of lanes (`drm_group_*`).
#pragma once

#include <atomic>
#include <cstdint>

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

template <int K, typename T>
__device__ __forceinline__ void drm_copy(const T* from, T* to) {
#pragma unroll
  for (int i = 0; i < K; ++i) to[i] = from[i];
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

// ---- the register-resident step (K5/K7, K6/K8's backward, K9, K10) ---------
//
// The functions below take the robot's topology from a policy P: the link
// and dof counts, each link's parent, joint type and dof, each dof's link
// and the ancestor relation. `DrmSerial<NL, ND>` fixes them at compile
// time for a serial chain of NL links whose links 1..ND carry revolute dofs
// 0..ND-1 (link l's parent l - 1) and whose links ND+1..NL-1 are fixed
// (iiwa, panda_no_gripper and fetch_arm: 9 and 7; the 2-link robot: 4 and
// 2). Its loops unroll fully and every per-link array is indexed by
// constants, so the compiler keeps them in registers and reads each
// `tr.link[l]` constant from the parameter bank; the constants still come
// from the by-value `Tree<T>`, so one build serves every robot of that
// shape. `DrmGeneric<CAP>` reads the topology from the tree at run time,
// for any robot of up to CAP links and dofs; its arrays live in local
// memory as the functions above do. ops/kernels/solver.py `kernel_variant`
// picks the policy.

template <int NL_, int ND_>
struct DrmSerial {
  static constexpr int NL = NL_, ND = ND_;
  static constexpr bool serial = true;
  template <typename T> __device__ __forceinline__ static int links(const Tree<T>&) { return NL; }
  template <typename T> __device__ __forceinline__ static int dofs(const Tree<T>&) { return ND; }
  template <typename T> __device__ __forceinline__ static int parent(const Tree<T>&, int l) { return l - 1; }
  template <typename T>
  __device__ __forceinline__ static int type(const Tree<T>&, int l) {
    return l >= 1 && l <= ND ? DRM_REVOLUTE : DRM_FIXED;
  }
  template <typename T> __device__ __forceinline__ static int dof(const Tree<T>&, int l) { return l - 1; }
  template <typename T>
  __device__ __forceinline__ static int dof_link(const Tree<T>&, int j) { return j + 1; }
  template <typename T>
  __device__ __forceinline__ static bool anc(const Tree<T>&, int j, int i) { return i <= j; }
};

template <int CAP>
struct DrmGeneric {
  static constexpr int NL = CAP, ND = CAP;
  static constexpr bool serial = false;
  template <typename T> __device__ __forceinline__ static int links(const Tree<T>& tr) { return tr.n; }
  template <typename T> __device__ __forceinline__ static int dofs(const Tree<T>& tr) { return tr.D; }
  template <typename T>
  __device__ __forceinline__ static int parent(const Tree<T>& tr, int l) { return tr.link[l].parent; }
  template <typename T>
  __device__ __forceinline__ static int type(const Tree<T>& tr, int l) { return tr.link[l].type; }
  template <typename T>
  __device__ __forceinline__ static int dof(const Tree<T>& tr, int l) { return tr.link[l].dof; }
  template <typename T>
  __device__ __forceinline__ static int dof_link(const Tree<T>& tr, int j) { return tr.dof_link[j]; }
  template <typename T>
  __device__ __forceinline__ static bool anc(const Tree<T>& tr, int j, int i) {
    return (tr.anc[j] >> i) & 1u;
  }
};

// Every link's local transform (R, t) at q.
template <typename T, class P>
__device__ __forceinline__ void drm_rr_local(const Tree<T>& tr, const T* q, T (*R)[9], T (*t)[3]) {
#pragma unroll
  for (int l = 1; l < P::links(tr); ++l) {
    const TreeLink<T>& L = tr.link[l];
    const int ty = P::type(tr, l);
    const T qv = ty == DRM_FIXED ? T(0) : q[P::dof(tr, l)];
    if (ty == DRM_REVOLUTE) {
      T s, c, J[9];
      drm_sincos(qv, &s, &c);
      drm_rodrigues(L.a, c, s, J);
      drm_mat3(L.F, J, R[l]);
    } else {
      drm_copy<9>(L.F, R[l]);
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) t[l][i] = ty == DRM_PRISMATIC ? L.Fa[i] * qv + L.t[i] : L.t[i];
  }
}

// A link's motion carried from its parent's frame into its own, before its
// joint's: w_c = R^T w_p, dw_c = R^T dw_p, dv_c = R^T (dv_p + (dw_p x t +
// w_p x (w_p x t))) (ops/dynamics_scalar.py `_motion`).
template <typename T>
__device__ __forceinline__ void drm_rr_motion(const T* R, const T* t, const T* wp, const T* dwp,
                                              const T* dvp, T* w_c, T* dw_c, T* dv_c) {
  T c1[3], c2[3], c3[3], acc[3];
  drm_rot_t(R, wp, w_c);
  drm_rot_t(R, dwp, dw_c);
  drm_cross(dwp, t, c1);
  drm_cross(wp, t, c2);
  drm_cross(wp, c2, c3);
#pragma unroll
  for (int i = 0; i < 3; ++i) acc[i] = dvp[i] + (c1[i] + c3[i]);
  drm_rot_t(R, acc, dv_c);
}

// A link's own force f = m (dv + (dw x c + w x (w x c))) and moment about
// its origin n = (I dw + w x I w) + c x f (`_link_force`), from its COM c,
// mass m and inertia I6.
template <typename T>
__device__ __forceinline__ void drm_rr_force(const T* com, T mass, const T* I6, const T* w,
                                             const T* dw, const T* dv, T* f, T* n) {
  T wc[3], wwc[3], dwc[3], Idw[3], Iw[3], wIw[3], cf[3];
  drm_cross(dw, com, dwc);
  drm_cross(w, com, wc);
  drm_cross(w, wc, wwc);
#pragma unroll
  for (int i = 0; i < 3; ++i) f[i] = (dv[i] + (dwc[i] + wwc[i])) * mass;
  drm_symm(I6, dw, Idw);
  drm_symm(I6, w, Iw);
  drm_cross(w, Iw, wIw);
  drm_cross(com, f, cf);
#pragma unroll
  for (int i = 0; i < 3; ++i) n[i] = (Idw[i] + wIw[i]) + cf[i];
}

template <typename T>
__device__ __forceinline__ void drm_rr_force(const TreeLink<T>& L, const T* w, const T* dw,
                                             const T* dv, T* f, T* n) {
  drm_rr_force(L.com, L.mass, L.I6, w, dw, dv, f, n);
}

// The RNEA's sweeps kept for its reverse: per link its motion w, dw, dv and,
// after `drm_rr_rnea`, the force and moment totals f, n of its subtree.
template <typename T, class P>
struct DrmRneaState {
  T w[P::NL][3], dw[P::NL][3], dv[P::NL][3], f[P::NL][3], n[P::NL][3];
};

// RNEA from the local transforms, tau = M(q) qdd + C(q, qd) qd + g(q) (+ d
// qd with damping), keeping its sweeps in st. The forward sweep computes
// each link's own force as soon as its motion is known, so that a serial
// chain holds only the running motion when no reverse follows.
template <typename T, class P>
__device__ __forceinline__ void drm_rr_rnea(const Tree<T>& tr, const T (*R)[9], const T (*t)[3],
                                            const T* qd, const T* qdd, DrmRneaState<T, P>& st,
                                            T* tau) {
#pragma unroll
  for (int i = 0; i < 3; ++i) st.w[0][i] = st.dw[0][i] = st.dv[0][i] = st.f[0][i] = st.n[0][i] = T(0);
  st.dv[0][2] = tr.gravity;
#pragma unroll
  for (int l = 1; l < P::links(tr); ++l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = P::parent(tr, l), ty = P::type(tr, l);
    T w_c[3], dw_c[3], dv_c[3];
    drm_rr_motion(R[l], t[l], st.w[par], st.dw[par], st.dv[par], w_c, dw_c, dv_c);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      st.w[l][i] = w_c[i];
      st.dw[l][i] = dw_c[i];
      st.dv[l][i] = dv_c[i];
    }
    if (ty != DRM_FIXED) {
      const int d = P::dof(tr, l);
      T j[3], wxj[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) j[i] = L.a[i] * qd[d];
      drm_cross(w_c, j, wxj);
      if (ty == DRM_REVOLUTE) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          st.w[l][i] = w_c[i] + j[i];
          st.dw[l][i] = dw_c[i] + (L.a[i] * qdd[d] + wxj[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) st.dv[l][i] = dv_c[i] + (L.a[i] * qdd[d] + wxj[i] * T(2));
      }
    }
    drm_rr_force(L, st.w[l], st.dw[l], st.dv[l], st.f[l], st.n[l]);
  }
#pragma unroll
  for (int l = P::links(tr) - 1; l >= 1; --l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = P::parent(tr, l), ty = P::type(tr, l);
    if (ty == DRM_REVOLUTE)
      tau[P::dof(tr, l)] = L.a[0] * st.n[l][0] + L.a[1] * st.n[l][1] + L.a[2] * st.n[l][2];
    else if (ty == DRM_PRISMATIC)
      tau[P::dof(tr, l)] = L.a[0] * st.f[l][0] + L.a[1] * st.f[l][1] + L.a[2] * st.f[l][2];
    T f_p[3], Rn[3], tf[3];
    drm_rot_s(R[l], st.f[l], f_p);
    drm_rot_s(R[l], st.n[l], Rn);
    drm_cross(t[l], f_p, tf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      st.f[par][i] = st.f[par][i] + f_p[i];
      st.n[par][i] = st.n[par][i] + (Rn[i] + tf[i]);
    }
  }
  if (tr.use_damping) {
#pragma unroll
    for (int d = 0; d < P::dofs(tr); ++d) tau[d] = tau[d] + tr.damping[d] * qd[d];
  }
}

// What the RNEA's reverse sweep reads of its forward: per link the local
// transform (R, t) and the sweeps' state, kept in the thread's own arrays.
// `DrmSharedRnea` (below) keeps the same in shared memory instead.
template <typename T, class P>
struct DrmLocalRnea {
  T R[P::NL][9], t[P::NL][3];
  DrmRneaState<T, P> st;
  __device__ __forceinline__ void rot(int l, T* x) const { drm_copy<9>(R[l], x); }
  __device__ __forceinline__ void trans(int l, T* x) const { drm_copy<3>(t[l], x); }
  __device__ __forceinline__ void w(int l, T* x) const { drm_copy<3>(st.w[l], x); }
  __device__ __forceinline__ void dw(int l, T* x) const { drm_copy<3>(st.dw[l], x); }
  __device__ __forceinline__ void dv(int l, T* x) const { drm_copy<3>(st.dv[l], x); }
  __device__ __forceinline__ void f(int l, T* x) const { drm_copy<3>(st.f[l], x); }
  __device__ __forceinline__ void n(int l, T* x) const { drm_copy<3>(st.n[l], x); }
};

// (∂RNEA(q, qd, qdd)/∂(q, qd))ᵀ lam into jac[2D] (jac[k] the q_k partial,
// jac[D + k] the qd_k one), with the tree's gravity and damping, by one
// reverse sweep of the RNEA whose forward `s` holds (`DrmLocalRnea` or
// `DrmSharedRnea`): the plain version's arithmetic
// (ops/dynamics_scalar.py `rnea_vjp_scalar`, whose docstring gives the
// identities), line for line. With QDD, also (∂RNEA/∂qdd)ᵀ lam = M(q) lam
// into jac[2D + k]: a joint's qdd enters only its own link's angular
// (revolute) or linear (prismatic) acceleration, along its axis, so its
// partial is the axis dotted with that acceleration's cotangent, which the
// sweep carries anyway. Every partial goes into the one array `jac`: nvcc
// 12.9 miscompiled the form with two local arrays filled by one inlined
// device function (ROADMAP F5). `unit` >= 0 says that lam is the unit
// cotangent on that dof: on a serial chain the links up to its joint's
// parent then carry no force cotangent, and their share of the sweeps (the
// totals' reverse, the link forces' reverse) is skipped. (rnea.cu
// `learn_vjp` runs the same arithmetic in two sweeps, with the partials
// w.r.t. the link constants.)
template <typename T, class P, class S, bool QDD = false>
__device__ __forceinline__ void drm_rr_rnea_reverse(const Tree<T>& tr, const S& s, const T* qd,
                                                    const T* lam, T* jac, int unit = -1) {
  constexpr int NL = P::NL;
  const int n = P::links(tr), D = P::dofs(tr);
  // link l of a serial chain carries dof l - 1
  auto quiet = [&](int l) { return P::serial && l <= unit; };
#pragma unroll
  for (int d = 0; d < D; ++d) {
    jac[d] = T(0);
    jac[D + d] = tr.use_damping ? tr.damping[d] * lam[d] : T(0);
    if constexpr (QDD) jac[2 * D + d] = T(0);
  }
  // the backward sweep's reverse, root -> tip: fb, nb the cotangents of the
  // totals f, n
  T fb[NL][3], nb[NL][3], tb[NL][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) fb[0][i] = nb[0][i] = T(0);
#pragma unroll
  for (int l = 1; l < n; ++l) {
    if (quiet(l)) {
#pragma unroll
      for (int i = 0; i < 3; ++i) fb[l][i] = nb[l][i] = T(0);
      continue;
    }
    const TreeLink<T>& L = tr.link[l];
    const int par = P::parent(tr, l), ty = P::type(tr, l);
    T R[9], t[3], u[3], nt[3];
    s.rot(l, R);
    s.trans(l, t);
    drm_cross(nb[par], t, nt);
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = fb[par][i] + nt[i];
    drm_rot_t(R, u, fb[l]);
    drm_rot_t(R, nb[par], nb[l]);
    T fl[3];
    s.f(l, fl);
    if (ty == DRM_REVOLUTE) {
      const int d = P::dof(tr, l);
      T nl[3], x[3], y[3];
      s.n(l, nl);
      drm_cross(fl, fb[l], x);
      drm_cross(nl, nb[l], y);
      jac[d] = jac[d] + (L.a[0] * (x[0] + y[0]) + L.a[1] * (x[1] + y[1]) + L.a[2] * (x[2] + y[2]));
#pragma unroll
      for (int i = 0; i < 3; ++i) nb[l][i] = nb[l][i] + L.a[i] * lam[d];
    } else if (ty == DRM_PRISMATIC) {
      T f_p[3];
      drm_rot_s(R, fl, f_p);
      drm_cross(f_p, nb[par], tb[l]);
#pragma unroll
      for (int i = 0; i < 3; ++i) fb[l][i] = fb[l][i] + L.a[i] * lam[P::dof(tr, l)];
    }
  }
  // the forward sweep's reverse, tip -> root: wb, dwb, dvb gather the
  // children's cotangents, then each link adds its force reverse
  // (`_link_force_vjp`) and passes its motion's on to its parent
  T wb[NL][3], dwb[NL][3], dvb[NL][3];
#pragma unroll
  for (int l = 0; l < n; ++l)
#pragma unroll
    for (int i = 0; i < 3; ++i) wb[l][i] = dwb[l][i] = dvb[l][i] = T(0);
#pragma unroll
  for (int l = n - 1; l >= 1; --l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = P::parent(tr, l), ty = P::type(tr, l);
    T R[9], t[3], wl[3], wp[3], dwp[3], dvp[3];
    s.rot(l, R);
    s.trans(l, t);
    s.w(l, wl);
    s.w(par, wp);
    s.dw(par, dwp);
    s.dv(par, dvp);
    if (!quiet(l)) {
      T fc[3], acb[3], ca[3], Inb[3], wc[3], x1[3], aw[3], x2[3], Iw[3], x3[3], nw[3], x4[3];
      drm_cross(nb[l], L.com, fc);
#pragma unroll
      for (int i = 0; i < 3; ++i) acb[i] = (fb[l][i] + fc[i]) * L.mass;
      drm_cross(L.com, acb, ca);
      drm_symm(L.I6, nb[l], Inb);
      drm_cross(wl, L.com, wc);
      drm_cross(wc, acb, x1);
      drm_cross(acb, wl, aw);
      drm_cross(L.com, aw, x2);
      drm_symm(L.I6, wl, Iw);
      drm_cross(Iw, nb[l], x3);
      drm_cross(nb[l], wl, nw);
      drm_symm(L.I6, nw, x4);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wb[l][i] = wb[l][i] + ((x1[i] + x2[i]) + (x3[i] + x4[i]));
        dwb[l][i] = dwb[l][i] + (ca[i] + Inb[i]);
        dvb[l][i] = dvb[l][i] + acb[i];
      }
    }
    if constexpr (QDD) {
      if (ty == DRM_REVOLUTE)
        jac[2 * D + P::dof(tr, l)] = L.a[0] * dwb[l][0] + L.a[1] * dwb[l][1] + L.a[2] * dwb[l][2];
      else if (ty == DRM_PRISMATIC)
        jac[2 * D + P::dof(tr, l)] = L.a[0] * dvb[l][0] + L.a[1] * dvb[l][1] + L.a[2] * dvb[l][2];
    }
    T w_c[3], dw_c[3], dv_c[3], wcb[3];
    drm_rr_motion(R, t, wp, dwp, dvp, w_c, dw_c, dv_c);
#pragma unroll
    for (int i = 0; i < 3; ++i) wcb[i] = wb[l][i];
    if (ty != DRM_FIXED) {
      const int d = P::dof(tr, l);
      T j[3], x[3], jb[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) j[i] = L.a[i] * qd[d];
      if (ty == DRM_REVOLUTE) {
        drm_cross(dwb[l], w_c, x);
#pragma unroll
        for (int i = 0; i < 3; ++i) jb[i] = wb[l][i] + x[i];
        drm_cross(j, dwb[l], x);
#pragma unroll
        for (int i = 0; i < 3; ++i) wcb[i] = wb[l][i] + x[i];
        T y1[3], y2[3], y3[3];
        drm_cross(wcb, w_c, y1);
        drm_cross(dwb[l], dw_c, y2);
        drm_cross(dvb[l], dv_c, y3);
        jac[d] = jac[d] + (L.a[0] * ((y1[0] + y2[0]) + y3[0]) + L.a[1] * ((y1[1] + y2[1]) + y3[1]) +
                           L.a[2] * ((y1[2] + y2[2]) + y3[2]));
      } else {
        drm_cross(dvb[l], w_c, x);
#pragma unroll
        for (int i = 0; i < 3; ++i) jb[i] = x[i] * T(2);
        drm_cross(j, dvb[l], x);
#pragma unroll
        for (int i = 0; i < 3; ++i) wcb[i] = wb[l][i] + x[i] * T(2);
      }
      jac[D + d] = jac[D + d] + (L.a[0] * jb[0] + L.a[1] * jb[1] + L.a[2] * jb[2]);
    }
    T accb[3], c2[3], c2b[3], Rw[3], Rdw[3], x1[3], x2[3], x3[3];
    drm_rot_s(R, dvb[l], accb);
    drm_cross(accb, wp, c2b);
    drm_rot_s(R, wcb, Rw);
    drm_cross(wp, t, c2);
    drm_cross(c2, accb, x1);
    drm_cross(t, c2b, x2);
    drm_rot_s(R, dwb[l], Rdw);
    drm_cross(t, accb, x3);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      wb[par][i] = wb[par][i] + (Rw[i] + (x1[i] + x2[i]));
      dwb[par][i] = dwb[par][i] + (Rdw[i] + x3[i]);
      dvb[par][i] = dvb[par][i] + accb[i];
    }
    if (ty == DRM_PRISMATIC) {
      T y1[3], y2[3];
      drm_cross(accb, dwp, y1);
      drm_cross(c2b, wp, y2);
      const int d = P::dof(tr, l);
      jac[d] = jac[d] + (L.Fa[0] * (tb[l][0] + (y1[0] + y2[0])) + L.Fa[1] * (tb[l][1] + (y1[1] + y2[1])) +
                         L.Fa[2] * (tb[l][2] + (y1[2] + y2[2])));
    }
  }
}

// `drm_rr_rnea_reverse` of the RNEA at (q, qd, qdd), computed here.
template <typename T, class P>
__device__ __forceinline__ void drm_rr_rnea_vjp(const Tree<T>& tr, const T* q, const T* qd,
                                                const T* qdd, const T* lam, T* jac) {
  DrmLocalRnea<T, P> s;
  T tau[P::ND];
  drm_rr_local<T, P>(tr, q, s.R, s.t);
  drm_rr_rnea<T, P>(tr, s.R, s.t, qd, qdd, s.st, tau);
  drm_rr_rnea_reverse<T, P>(tr, s, qd, lam, jac);
}

// The same forward in shared memory, one thread's values `LANES` floats
// apart (lane-strided, so that a warp's accesses fall in distinct banks): per
// link R (9), then w, dw, dv, f, n (3 each). For a serial policy, whose
// links' translations are constants.
template <typename T, class P, int LANES>
struct DrmSharedRnea {
  static_assert(P::serial, "shared-memory state is laid out for a serial chain");
  static constexpr int NL = P::NL;
  static constexpr int kR = 0, kW = 9 * NL, kDW = kW + 3 * NL, kDV = kDW + 3 * NL,
                       kF = kDV + 3 * NL, kN = kF + 3 * NL, kSize = kN + 3 * NL;
  T* base;  // this thread's first value
  const Tree<T>& tr;
  __device__ __forceinline__ void get(int at, int k, T* x) const {
#pragma unroll
    for (int i = 0; i < k; ++i) x[i] = base[(at + i) * LANES];
  }
  __device__ __forceinline__ void put(int at, int k, const T* x) const {
#pragma unroll
    for (int i = 0; i < k; ++i) base[(at + i) * LANES] = x[i];
  }
  __device__ __forceinline__ void rot(int l, T* x) const { get(kR + 9 * l, 9, x); }
  __device__ __forceinline__ void trans(int l, T* x) const { drm_copy<3>(tr.link[l].t, x); }
  __device__ __forceinline__ void w(int l, T* x) const { get(kW + 3 * l, 3, x); }
  __device__ __forceinline__ void dw(int l, T* x) const { get(kDW + 3 * l, 3, x); }
  __device__ __forceinline__ void dv(int l, T* x) const { get(kDV + 3 * l, 3, x); }
  __device__ __forceinline__ void f(int l, T* x) const { get(kF + 3 * l, 3, x); }
  __device__ __forceinline__ void n(int l, T* x) const { get(kN + 3 * l, 3, x); }
  // stores the RNEA of `drm_rr_rnea_vjp` at (q, qd, qdd)
  __device__ __forceinline__ void compute(const T* q, const T* qd, const T* qdd) const {
    DrmLocalRnea<T, P> s;
    T tau[P::ND];
    drm_rr_local<T, P>(tr, q, s.R, s.t);
    drm_rr_rnea<T, P>(tr, s.R, s.t, qd, qdd, s.st, tau);
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      put(kR + 9 * l, 9, s.R[l]);
      put(kW + 3 * l, 3, s.st.w[l]);
      put(kDW + 3 * l, 3, s.st.dw[l]);
      put(kDV + 3 * l, 3, s.st.dv[l]);
      put(kF + 3 * l, 3, s.st.f[l]);
      put(kN + 3 * l, 3, s.st.n[l]);
    }
  }
};

// A link's own inertial parameters about the world origin, from its world
// pose (R, p), COM c, mass m and inertia I6: I_o = R I Rᵀ + m (|c_w|² E -
// c_w c_wᵀ) into I (xx, xy, xz, yy, yz, zz) and h = m c_w (`drm_crb`'s).
template <typename T>
__device__ __forceinline__ void drm_rr_link_inertia(const T* R, const T* p, const T* com, T m,
                                                    const T* I6, T* I, T* h) {
  T rc[3], cw[3];
  drm_rot(R, com, rc);
#pragma unroll
  for (int i = 0; i < 3; ++i) cw[i] = p[i] + rc[i];
  T rows[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T r[3] = {R[3 * i], R[3 * i + 1], R[3 * i + 2]};
    drm_symm(I6, r, rows[i]);
  }
  auto entry = [&](int i, int j) {
    return rows[i][0] * R[3 * j] + rows[i][1] * R[3 * j + 1] + rows[i][2] * R[3 * j + 2];
  };
  const T cx = cw[0], cy = cw[1], cz = cw[2];
  I[0] = entry(0, 0) + m * (cy * cy + cz * cz);
  I[1] = entry(0, 1) - m * cx * cy;
  I[2] = entry(0, 2) - m * cx * cz;
  I[3] = entry(1, 1) + m * (cx * cx + cz * cz);
  I[4] = entry(1, 2) - m * cy * cz;
  I[5] = entry(2, 2) + m * (cx * cx + cy * cy);
#pragma unroll
  for (int i = 0; i < 3; ++i) h[i] = cw[i] * m;
}

// A revolute joint's subspace about the world origin, (z, p x z) with z =
// R a its world axis, from its link's world pose (R, p).
template <typename T>
__device__ __forceinline__ void drm_rr_revolute_subspace(const T* R, const T* p, const T* a, T* S) {
  drm_rot(R, a, S);
  drm_cross(p, S, S + 3);
}

// The column j of M from the composite (I, h, m) of dof j's subtree and
// its subspace Sj: (n, f) = (I w + h x v, m v - h x w) for Sj = (w, v).
template <typename T>
__device__ __forceinline__ void drm_rr_crb_column(const T* I, const T* h, T m, const T* Sj, T* nn,
                                                  T* f) {
  const T* wv = Sj;
  const T* vv = Sj + 3;
  T Iw[3], hv[3], hw[3];
  drm_symm(I, wv, Iw);
  drm_cross(h, vv, hv);
  drm_cross(h, wv, hw);
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    nn[k] = Iw[k] + hv[k];
    f[k] = vv[k] * m - hw[k];
  }
}

// Entry (j, i) of M: <S_i, (n, f)> of column j.
template <typename T>
__device__ __forceinline__ T drm_rr_crb_entry(const T* Si, const T* nn, const T* f) {
  return (Si[0] * nn[0] + Si[1] * nn[1] + Si[2] * nn[2]) + (Si[3] * f[0] + Si[4] * f[1] + Si[5] * f[2]);
}

// World-frame composite-rigid-body mass matrix M(q) into the packed lower
// triangle Hm: `drm_crb`'s arithmetic, with each joint's subspace formed as
// soon as its link's world pose is known, so that a serial chain holds only
// the running pose.
template <typename T, class P>
__device__ __forceinline__ void drm_rr_crb(const Tree<T>& tr, const T (*Rl)[9], const T (*tl)[3],
                                           T* Hm) {
  constexpr int NL = P::NL, ND = P::ND;
  const int n = P::links(tr), D = P::dofs(tr);
  T Rw[NL][9], pw[NL][3], m_c[NL], h_c[NL][3], I_c[NL][6], S_w[ND][6];
#pragma unroll
  for (int i = 0; i < 9; ++i) Rw[0][i] = (i % 4 == 0) ? T(1) : T(0);
  pw[0][0] = pw[0][1] = pw[0][2] = T(0);
#pragma unroll
  for (int l = 1; l < n; ++l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = P::parent(tr, l), ty = P::type(tr, l);
    T d[3];
    drm_rot(Rw[par], tl[l], d);
#pragma unroll
    for (int i = 0; i < 3; ++i) pw[l][i] = pw[par][i] + d[i];
    drm_mat3(Rw[par], Rl[l], Rw[l]);
    const T* R = Rw[l];
    drm_rr_link_inertia(R, pw[l], L.com, L.mass, L.I6, I_c[l], h_c[l]);
    m_c[l] = L.mass;
    if (ty != DRM_FIXED) {
      T* S = S_w[P::dof(tr, l)];
      if (ty == DRM_REVOLUTE) {
        drm_rr_revolute_subspace(R, pw[l], L.a, S);
      } else {
        T z[3];
        drm_rot(R, L.a, z);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          S[i] = T(0);
          S[3 + i] = z[i];
        }
      }
    }
  }
#pragma unroll
  for (int l = n - 1; l >= 2; --l) {
    const int par = P::parent(tr, l);
    if (par == 0) continue;
    m_c[par] = m_c[par] + m_c[l];
#pragma unroll
    for (int i = 0; i < 3; ++i) h_c[par][i] = h_c[par][i] + h_c[l][i];
#pragma unroll
    for (int i = 0; i < 6; ++i) I_c[par][i] = I_c[par][i] + I_c[l][i];
  }
#pragma unroll
  for (int j = 0; j < D; ++j) {
    const int lj = P::dof_link(tr, j);
    T nn[3], f[3];
    drm_rr_crb_column(I_c[lj], h_c[lj], m_c[lj], S_w[j], nn, f);
#pragma unroll
    for (int i = 0; i <= j; ++i)
      Hm[drm_tri(j, i)] = P::anc(tr, j, i) ? drm_rr_crb_entry(S_w[i], nn, f) : T(0);
  }
}

// In-place LDL^T of the packed lower triangle (`drm_ldl_factor`) and the
// solve with it (`drm_ldl_solve`), with the dof loops unrolled for P.
template <typename T, class P>
__device__ __forceinline__ void drm_rr_ldl_factor(const Tree<T>& tr, T* Hm, T* dg) {
  const int D = P::dofs(tr);
#pragma unroll
  for (int j = 0; j < D; ++j) {
    T s = Hm[drm_tri(j, j)];
#pragma unroll
    for (int k = 0; k < j; ++k) s = s - Hm[drm_tri(j, k)] * Hm[drm_tri(j, k)] * dg[k];
    dg[j] = s;
    const T inv = T(1) / s;
#pragma unroll
    for (int i = j + 1; i < D; ++i) {
      T s2 = Hm[drm_tri(i, j)];
#pragma unroll
      for (int k = 0; k < j; ++k) s2 = s2 - Hm[drm_tri(i, k)] * Hm[drm_tri(j, k)] * dg[k];
      Hm[drm_tri(i, j)] = s2 * inv;
    }
  }
}

template <typename T, class P>
__device__ __forceinline__ void drm_rr_ldl_solve(const Tree<T>& tr, const T* Lf, const T* dg,
                                                 const T* b, T* x) {
  const int D = P::dofs(tr);
  T z[P::ND];
#pragma unroll
  for (int i = 0; i < D; ++i) {
    T s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - Lf[drm_tri(i, k)] * z[k];
    z[i] = s;
  }
#pragma unroll
  for (int i = D - 1; i >= 0; --i) {
    T s = z[i] / dg[i];
#pragma unroll
    for (int k = i + 1; k < D; ++k) s = s - Lf[drm_tri(k, i)] * x[k];
    x[i] = s;
  }
}

// `drm_fd_accel` on the policy: qdd = Ĥ⁻¹ (tau - nle(q, qd)), Ĥ's factor
// left in (Lf, dg).
template <typename T, class P>
__device__ __forceinline__ void drm_rr_fd_accel(const Tree<T>& tr, const T* q, const T* qd,
                                                const T* tau, T* Lf, T* dg, T* qdd) {
  constexpr int NL = P::NL, ND = P::ND;
  const int D = P::dofs(tr);
  T R[NL][9], t[NL][3], zero[ND], nle[ND], b[ND];
  drm_rr_local<T, P>(tr, q, R, t);
#pragma unroll
  for (int d = 0; d < D; ++d) zero[d] = T(0);
  {
    DrmRneaState<T, P> st;
    drm_rr_rnea<T, P>(tr, R, t, qd, zero, st, nle);
  }
  drm_rr_crb<T, P>(tr, R, t, Lf);
  if (tr.use_damping) {
#pragma unroll
    for (int d = 0; d < D; ++d) Lf[drm_tri(d, d)] = Lf[drm_tri(d, d)] + tr.dt_damping[d];
  }
  drm_rr_ldl_factor<T, P>(tr, Lf, dg);
#pragma unroll
  for (int d = 0; d < D; ++d) b[d] = tau[d] - nle[d];
  drm_rr_ldl_solve<T, P>(tr, Lf, dg, b, qdd);
}

// The semi-implicit Euler step with the velocity clamp from qdd
// (`drm_fd_step`'s last loop).
template <typename T, class P>
__device__ __forceinline__ void drm_rr_euler(const Tree<T>& tr, const T* q, const T* qd,
                                             const T* qdd, T* qn, T* qdn) {
#pragma unroll
  for (int d = 0; d < P::dofs(tr); ++d) {
    const T x = drm_clip(qd[d] + tr.dt * qdd[d], -tr.vmax[d], tr.vmax[d]);
    qdn[d] = x;
    qn[d] = q[d] + tr.dt * x;
  }
}

// The ee position after a chain sweep (`drm_chain_sweep`) on a serial
// chain: chain link k is the tree's link k + 1, revolute with dof k for
// k < ND and fixed after, so the dof indices are constants.
template <typename T, class P, typename Rec>
__device__ __forceinline__ void drm_rr_chain_sweep(const Chain<T>& ch, const T* q, Rec rec, T pw[3]) {
  static_assert(P::serial, "the generic policy takes drm_chain_sweep");
  T Rw[9] = {T(1), T(0), T(0), T(0), T(1), T(0), T(0), T(0), T(1)};
  pw[0] = pw[1] = pw[2] = T(0);
#pragma unroll
  for (int k = 0; k < P::NL - 1; ++k) {
    if (k >= ch.n) break;
    const ChainLink<T>& L = ch.link[k];
    const bool rev = k < P::ND;
    T R[9];
    if (rev) {
      T s, c, J[9];
      drm_sincos(q[k], &s, &c);
      drm_rodrigues(L.a, c, s, J);
      drm_mat3(L.F, J, R);
    } else {
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = L.F[i];
    }
    T z[3], dt[3];
    if (rev) drm_rot(Rw, L.Fa, z);
    drm_rot(Rw, L.t, dt);
#pragma unroll
    for (int i = 0; i < 3; ++i) pw[i] += dt[i];
    if (rev) rec(DRM_REVOLUTE, k, z, pw);
    T Rn[9];
    drm_mat3(Rw, R, Rn);
#pragma unroll
    for (int i = 0; i < 9; ++i) Rw[i] = Rn[i];
  }
}

// The ee position after a chain sweep at q for policy P: the serial sweep
// above, or `drm_chain_sweep` for the generic policy.
template <typename T, class P, typename Rec>
__device__ __forceinline__ void drm_rr_ee(const Chain<T>& ch, const T* q, Rec rec, T pw[3]) {
  if constexpr (P::serial)
    drm_rr_chain_sweep<T, P>(ch, q, rec, pw);
  else
    drm_chain_sweep(ch, [&](int d) { return q[d]; }, rec, pw);
}

// A serial chain's group (fwd_group_kernel in dyn_rollout.cu, the
// prologue's group in dyn_solve.cu): one lane a moving link, rounded up to a
// power of two (8 for DrmSerial<9, 7>, 4 for DrmSerial<4, 2>), and the
// shuffle within it.
template <class P>
constexpr int drm_group_lanes() {
  int g = 1;
  while (g < P::NL - 1) g *= 2;
  return g;
}

template <typename T, int G>
__device__ __forceinline__ T drm_group_shfl(T v, int src) {
  return __shfl_sync(0xffffffffu, v, src, G);
}

// The link constants that differ between a group's lanes, in shared memory
// ([field][link]; read from the parameter bank, a group's distinct links
// would serialise).
template <typename T, int NL>
struct DrmGroupLinks {
  T F[9][NL], a[3][NL], com[3][NL], I6[6][NL], mass[NL];
  // by the block's threads; a __syncthreads() must follow
  __device__ __forceinline__ void load(const Tree<T>& tr) {
    for (int l = int(threadIdx.x); l < NL; l += int(blockDim.x)) {
      const TreeLink<T>& L = tr.link[l];
      for (int i = 0; i < 9; ++i) F[i][l] = L.F[i];
      for (int i = 0; i < 3; ++i) {
        a[i][l] = L.a[i];
        com[i][l] = L.com[i];
      }
      for (int i = 0; i < 6; ++i) I6[i][l] = L.I6[i];
      mass[l] = L.mass;
    }
  }
};

// The first half of a serial chain's step on a group of G lanes, lane g
// owning link lk = min(g + 1, NL - 1) (its dof g): the lane's local rotation
// Ro at q, then the forward sweep as far as its own link, each link's
// rotation shuffled from its owner: the RNEA's motion at (q, qd) and qdd =
// 0 (w, dw, dv) and the link's world pose (Rw, pw). Every lane meets every
// shuffle. `drm_rr_rnea`'s and `drm_rr_crb`'s arithmetic, operation for
// operation.
template <typename T, class P, int G>
__device__ __forceinline__ void drm_group_forward(const Tree<T>& tr,
                                                  const DrmGroupLinks<T, P::NL>& sl, int lk,
                                                  const T* q, const T* qd, T* Ro, T* w, T* dw,
                                                  T* dv, T* Rw, T* pw) {
  constexpr int NL = P::NL, ND = P::ND;
  T F[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) F[i] = sl.F[i][lk];
  if (lk <= ND) {
    T qv = q[0];
#pragma unroll
    for (int d = 1; d < ND; ++d) qv = d == lk - 1 ? q[d] : qv;
    const T a[3] = {sl.a[0][lk], sl.a[1][lk], sl.a[2][lk]};
    T s, c, J[9];
    drm_sincos(qv, &s, &c);
    drm_rodrigues(a, c, s, J);
    drm_mat3(F, J, Ro);
  } else {
    drm_copy<9>(F, Ro);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) w[i] = dw[i] = dv[i] = pw[i] = T(0);
  dv[2] = tr.gravity;
#pragma unroll
  for (int i = 0; i < 9; ++i) Rw[i] = (i % 4 == 0) ? T(1) : T(0);
#pragma unroll
  for (int l = 1; l < NL; ++l) {
    T R[9];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = drm_group_shfl<T, G>(Ro[i], l - 1);
    if (l <= lk) {
      const TreeLink<T>& L = tr.link[l];
      T w_c[3], dw_c[3], dv_c[3];
      drm_rr_motion(R, L.t, w, dw, dv, w_c, dw_c, dv_c);
      if (l <= ND) {
        T j[3], wxj[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) j[i] = L.a[i] * qd[l - 1];
        drm_cross(w_c, j, wxj);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          w[i] = w_c[i] + j[i];
          dw[i] = dw_c[i] + wxj[i];
        }
      } else {
        drm_copy<3>(w_c, w);
        drm_copy<3>(dw_c, dw);
      }
      drm_copy<3>(dv_c, dv);
      T d[3], Rn[9];
      drm_rot(Rw, L.t, d);
#pragma unroll
      for (int i = 0; i < 3; ++i) pw[i] = pw[i] + d[i];
      drm_mat3(Rw, R, Rn);
      drm_copy<9>(Rn, Rw);
    }
  }
}

// The second half, from `drm_group_forward`'s outputs: each lane its link's
// force, inertia about the world origin and joint subspace; the backward
// sweep, each link's values shuffled from its owner: the RNEA's bias nle
// at qdd = 0 on every lane (without the damping term d qd) and the lane's
// composite; the lane's row of M, then the packed lower triangle of M
// (entry (i, k) at drm_tri(i, k)) on every lane.
template <typename T, class P, int G>
__device__ __forceinline__ void drm_group_backward(const Tree<T>& tr,
                                                   const DrmGroupLinks<T, P::NL>& sl, int lk,
                                                   const T* Ro, const T* w, const T* dw,
                                                   const T* dv, const T* Rw, const T* pw, T* nle,
                                                   T* M) {
  constexpr int NL = P::NL, ND = P::ND;
  T of[3], on[3], oI[6], oh[3], oS[6];
  const T om = sl.mass[lk];
  {
    const T com[3] = {sl.com[0][lk], sl.com[1][lk], sl.com[2][lk]};
    const T a[3] = {sl.a[0][lk], sl.a[1][lk], sl.a[2][lk]};
    T I6[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) I6[i] = sl.I6[i][lk];
    drm_rr_force(com, om, I6, w, dw, dv, of, on);
    drm_rr_link_inertia(Rw, pw, com, om, I6, oI, oh);
    drm_rr_revolute_subspace(Rw, pw, a, oS);
  }
  T cf[3], cn[3], cI[6], cH[3], cm;
#pragma unroll
  for (int l = NL - 1; l >= 1; --l) {
    const int src = l - 1;
    T R[9], f[3], n[3], I[6], hh[3];
#pragma unroll
    for (int i = 0; i < 9; ++i) R[i] = drm_group_shfl<T, G>(Ro[i], src);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      f[i] = drm_group_shfl<T, G>(of[i], src);
      n[i] = drm_group_shfl<T, G>(on[i], src);
      hh[i] = drm_group_shfl<T, G>(oh[i], src);
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) I[i] = drm_group_shfl<T, G>(oI[i], src);
    const T m = drm_group_shfl<T, G>(om, src);
    const TreeLink<T>& L = tr.link[l];
    if (l < NL - 1) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        f[i] = f[i] + cf[i];
        n[i] = n[i] + cn[i];
      }
    }
    if (l <= ND) nle[l - 1] = L.a[0] * n[0] + L.a[1] * n[1] + L.a[2] * n[2];
    T f_p[3], Rn[3], tf[3];
    drm_rot_s(R, f, f_p);
    drm_rot_s(R, n, Rn);
    drm_cross(L.t, f_p, tf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      cf[i] = f_p[i];
      cn[i] = Rn[i] + tf[i];
    }
    // the composite of link l's subtree: its own, plus its child's
    if (l == NL - 1) {
      drm_copy<6>(I, cI);
      drm_copy<3>(hh, cH);
      cm = m;
    } else if (l >= lk) {
#pragma unroll
      for (int i = 0; i < 6; ++i) cI[i] = I[i] + cI[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) cH[i] = hh[i] + cH[i];
      cm = m + cm;
    }
  }
  T Hrow[ND], cnn[3], cff[3];
  drm_rr_crb_column(cI, cH, cm, oS, cnn, cff);
#pragma unroll
  for (int i = 0; i < ND; ++i) {
    T Si[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) Si[c] = drm_group_shfl<T, G>(oS[c], i);
    Hrow[i] = drm_rr_crb_entry(Si, cnn, cff);
  }
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int i = 0; i <= j; ++i) M[drm_tri(j, i)] = drm_group_shfl<T, G>(Hrow[i], j);
}

// The current card's SM count, read from the driver once per device (1
// where it cannot be read): the group forms' switches.
#define DRM_MAX_DEVICES 64

inline int drm_sm_count() {
  static std::atomic<int> known[DRM_MAX_DEVICES];
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= DRM_MAX_DEVICES) return 1;
  int sms = known[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 1;
    known[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// The instantiations of K4-K10, `rnea_bwd` and the prologue, by the code
// ops/kernels/rollout.py `kernel_variant` passes.
enum DrmVariant { DRM_GENERIC16 = 0, DRM_GENERIC32 = 1, DRM_SERIAL_9_7 = 2, DRM_SERIAL_4_2 = 3 };

// (links, dofs) of DRM_SERIAL_9_7 and DRM_SERIAL_4_2, for the Python side's check.
inline void drm_variant_shapes(int64_t* out) {
  out[0] = 9;
  out[1] = 7;
  out[2] = 4;
  out[3] = 2;
}

// run(policy) on the instantiation that `variant` names.
template <typename F>
int drm_by_variant(int variant, F run) {
  switch (variant) {
    case DRM_GENERIC16: return run(DrmGeneric<16>{});
    case DRM_GENERIC32: return run(DrmGeneric<32>{});
    case DRM_SERIAL_9_7: return run(DrmSerial<9, 7>{});
    case DRM_SERIAL_4_2: return run(DrmSerial<4, 2>{});
  }
  return int(cudaErrorInvalidValue);
}
