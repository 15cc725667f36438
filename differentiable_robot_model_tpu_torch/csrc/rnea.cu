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
// (ops/kernels/rnea.py `tree_template`), and each block builds the tree
// image of the robot's n links in shared memory from it and the link tensors
// (`rnea_pack`: F from the rpy angles by cos/sin in T, a, F a, t, mass, COM,
// the six inertia entries read, the damping). Their grid is at most one wave
// of resident blocks, each looping over tiles of scenarios, so a block
// builds its image once a launch, while its first tile's rows are read.
// rnea_bwd_learnable runs a scenario's RNEA and reverse in two sweeps
// (`learn_vjp`: rnea_bwd's arithmetic, with each link's partials w.r.t.
// its constants as the second sweep leaves it), and sums those partials
// over the scenarios on the card: over a warp by shuffles
// (`warp_sum16`), over a block's warps in shared memory, then one row a
// block, which a second small launch (`robot_sum_kernel`) sums over the
// blocks into the robot's cotangent in its fields' layout. Every sum runs
// in a fixed order, with no atomics: the same bits on every run. Bound on
// the H100: as rnea_fwd and rnea_bwd (the link constants are a few KB a
// call); the robot's cotangent adds (19 L + D) values a block to the
// traffic, not a value a scenario. Below
// `group_below()` scenarios, where one thread a scenario leaves the card
// short of warps, a serial chain's scenario runs on a group of lanes, one a
// link (the `_group_kernel`s).

#include <atomic>
#include <cstddef>
#include <cstdint>

#include "dyn_step.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
// The most blocks of a learnable launch (whose grid is at most one wave),
// and the fewest scenarios a block of one takes (a tile of the group form
// on 8 lanes a scenario): the wrapper sizes the VJP's per-block rows by them.
constexpr int kMaxGrid = 4096;
constexpr int kFewest = kThreads / 8;

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

// ---- the learnable forms ---------------------------------------------------

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

// sin and cos of x[0], ..., x[n - 1] into s and c, in double precision by
// one call: CUDA's double sincos reaches its slow path
// (the Payne-Hanek reduction of huge arguments) through a function call,
// and a kernel with such calls in its unrolled sweeps, beside hundreds of
// live values, was compiled at 32 registers with a 6-10 KB stack frame
// (PERF.md); out of line, the one call sits before the sweeps. Float's
// sincosf inlines whole.
template <typename T>
__device__ __noinline__ void learn_sincos_call(const T* x, T* s, T* c, int n) {
  for (int i = 0; i < n; ++i) drm_sincos(x[i], &s[i], &c[i]);
}

template <typename T>
__device__ __forceinline__ void learn_sincos(const T* x, T* s, T* c, int n) {
  if constexpr (sizeof(T) == sizeof(double)) {
    learn_sincos_call(x, s, c, n);
  } else {
#pragma unroll
    for (int i = 0; i < n; ++i) drm_sincos(x[i], &s[i], &c[i]);
  }
}

// The block's tree image in shared memory: from the template its header
// (links, dofs, the damping flag, gravity) and, for a tree, each link's
// parent, joint type and dof; from the tensors each link's constants, one
// thread a link, for the robot's n links only (nothing past them is read);
// with dF (non-null) the partials of each link's rpy rotation F = Rz(yaw)
// Ry(pitch) Rx(roll) w.r.t. roll, pitch and yaw. A __syncthreads() must
// follow before the image is read.
template <typename T, class P>
__device__ __forceinline__ void rnea_pack(const Tree<T>& tmpl, const RobotArrays<T>& ra, Tree<T>& tr,
                                          T (*dF)[27]) {
  const int l = threadIdx.x;
  if (l == 0) {
    tr.n = tmpl.n;
    tr.D = tmpl.D;
    tr.use_damping = tmpl.use_damping;
    tr.gravity = tmpl.gravity;
  }
  if (l < P::links(tmpl)) {
    TreeLink<T>& L = tr.link[l];
    if constexpr (!P::serial) {
      L.parent = tmpl.link[l].parent;
      L.type = tmpl.link[l].type;
      L.dof = tmpl.link[l].dof;
    }
    T rpy[3], sn[3], cs[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) rpy[i] = ra.rpy[3 * l + i];
    learn_sincos<T>(rpy, sn, cs, 3);
    const T sr = sn[0], cr = cs[0], sp = sn[1], cp = cs[1], sy = sn[2], cy = cs[2];
    const T F[9] = {cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
                    sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
                    -sp,     cp * sr,                cp * cr};
#pragma unroll
    for (int i = 0; i < 9; ++i) L.F[i] = F[i];
    T a[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a[i] = ra.axis[3 * l + i];
      L.a[i] = a[i];
      L.t[i] = ra.trans[3 * l + i];
      L.com[i] = ra.com[3 * l + i];
    }
#pragma unroll
    for (int i = 0; i < 3; ++i) L.Fa[i] = F[3 * i] * a[0] + F[3 * i + 1] * a[1] + F[3 * i + 2] * a[2];
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
  if (l < P::dofs(tmpl)) tr.damping[l] = ra.damping[l];
}

// A link's local rotation R = F J (J its joint's Rodrigues factor, from the
// joint's sine s and cosine c) and translation t at joint value qv:
// `drm_rr_local`'s arithmetic.
template <typename T>
__device__ __forceinline__ void learn_local(const TreeLink<T>& L, int ty, T qv, T s, T c, T* J, T* R,
                                            T* t) {
  if (ty == DRM_REVOLUTE) {
    drm_rodrigues(L.a, c, s, J);
    drm_mat3(L.F, J, R);
  } else {
    drm_copy<9>(L.F, R);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = ty == DRM_PRISMATIC ? L.Fa[i] * qv + L.t[i] : L.t[i];
}

// Link l's 16 partials of lamᵀ RNEA w.r.t. its constants, into v: the
// joint origin's translation (3), its rpy angles (3), the mass, the COM (3)
// and the six inertia entries the RNEA reads (xx, xy, xz, yy, yz, zz). The
// own force f = m a_c, a_c = dv + dw x c + w x (w x c), and moment n = I dw
// + w x I w + c x f give the mass, COM and inertia partials; t enters the
// carried acceleration and the parent's moment (t x R f); the local
// rotation R = F J(q) enters the carried motion (Rᵀ x) and the totals
// passed up (R f, R n), and F-bar = R-bar Jᵀ (R-bar for a fixed joint, plus
// q t-bar aᵀ through F a for a prismatic one) is dotted with dF/d(roll,
// pitch, yaw).
template <typename T>
__device__ __forceinline__ void learn_link_partials(
    const TreeLink<T>& L, int ty, T qv, const T* J, const T* t, const T* dF, const T* wl,
    const T* dwl, const T* dvl, const T* wp, const T* dwp, const T* dvp, const T* fl, const T* nl,
    const T* f_p, const T* fbl, const T* nbl, const T* fbp, const T* nbp, const T* wcb,
    const T* dwbl, const T* dvbl, const T* accb, const T* c2b, T* v) {
  T fc[3], dwc[3], wc[3], wwc[3], fo[3], ac[3];
  drm_cross(nbl, L.com, fc);
  drm_cross(dwl, L.com, dwc);
  drm_cross(wl, L.com, wc);
  drm_cross(wl, wc, wwc);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    fo[i] = fbl[i] + fc[i];  // the own force's cotangent
    ac[i] = dvl[i] + (dwc[i] + wwc[i]);
  }
  v[6] = ac[0] * fo[0] + ac[1] * fo[1] + ac[2] * fo[2];
  T acb[3], fown[3], x1[3], x2[3], aw[3], x3[3], nw[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    acb[i] = fo[i] * L.mass;
    fown[i] = ac[i] * L.mass;
  }
  drm_cross(fown, nbl, x1);
  drm_cross(acb, dwl, x2);
  drm_cross(acb, wl, aw);
  drm_cross(aw, wl, x3);
#pragma unroll
  for (int i = 0; i < 3; ++i) v[7 + i] = (x1[i] + x2[i]) + x3[i];
  // I's cotangent G = nb dwᵀ + (nb x w) wᵀ, folded onto the entries read
  drm_cross(nbl, wl, nw);
  auto G = [&](int i, int j) { return nbl[i] * dwl[j] + nw[i] * wl[j]; };
  v[10] = G(0, 0);
  v[11] = G(0, 1) + G(1, 0);
  v[12] = G(0, 2) + G(2, 0);
  v[13] = G(1, 1);
  v[14] = G(1, 2) + G(2, 1);
  v[15] = G(2, 2);
  T y1[3], y2[3], y3[3], tbar[3];
  drm_cross(f_p, nbp, y1);
  drm_cross(accb, dwp, y2);
  drm_cross(c2b, wp, y3);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    tbar[i] = y1[i] + (y2[i] + y3[i]);
    v[i] = tbar[i];
  }
  T u[3], nt[3], c1[3], c2[3], c3[3], acc[3], Rb[9];
  drm_cross(nbp, t, nt);
  drm_cross(dwp, t, c1);
  drm_cross(wp, t, c2);
  drm_cross(wp, c2, c3);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    u[i] = fbp[i] + nt[i];
    acc[i] = dvp[i] + (c1[i] + c3[i]);
  }
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      Rb[3 * i + j] = ((wp[i] * wcb[j] + dwp[i] * dwbl[j]) + acc[i] * dvbl[j]) +
                      (u[i] * fl[j] + nbp[i] * nl[j]);
  T Fb[9];
  if (ty == DRM_REVOLUTE) {
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int m = 0; m < 3; ++m)
        Fb[3 * i + m] = Rb[3 * i] * J[3 * m] + Rb[3 * i + 1] * J[3 * m + 1] + Rb[3 * i + 2] * J[3 * m + 2];
  } else {
    const T qp = ty == DRM_PRISMATIC ? qv : T(0);
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
      for (int j = 0; j < 3; ++j) Fb[3 * i + j] = Rb[3 * i + j] + (qp * tbar[i]) * L.a[j];
  }
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    T acc_r = T(0);
#pragma unroll
    for (int e = 0; e < 9; ++e) acc_r = acc_r + Fb[e] * dF[9 * r + e];
    v[3 + r] = acc_r;
  }
}

// One scenario's VJP of the RNEA at (q, qd, qdd) for the cotangent lam on
// tau, w.r.t. (q, qd, qdd) and the link constants: `drm_rr_rnea` and
// `drm_rr_rnea_reverse` (with QDD) operation for operation, with the
// partials of each link's constants, reordered into two sweeps. The
// reverse of the RNEA's backward sweep (fb, nb, the cotangents of the force
// and moment totals, root -> tip) reads only the local transforms and lam,
// so it runs beside the forward sweep (the motion w, dw, dv); the backward
// sweep (the totals, tip -> root) runs beside the forward sweep's reverse
// (wb, dwb, dvb), which at a link reads that link's totals and what its
// children passed on. A link's partials are then final as the second sweep
// leaves it: dof_out(d, q̄_d, q̄d_d, q̄dd_d) for its joint's dof, and
// link_out(l, v) with its 16 partials (`learn_link_partials`). Nothing per
// link outlives the first sweep but the motion, fb, nb and the joints' sines
// and cosines (taken first, `learn_sincos`): the local rotation is rebuilt
// from them, the link's own force recomputed.
template <typename T, class P, class LinkOut, class DofOut>
__device__ __forceinline__ void learn_vjp(const Tree<T>& tr, const T (*dF)[27], const T* q, const T* qd,
                                          const T* qdd, const T* lam, LinkOut link_out,
                                          DofOut dof_out) {
  constexpr int NL = P::NL, ND = P::ND;
  const int n = P::links(tr);
  T sn[ND], cs[ND], w[NL][3], dw[NL][3], dv[NL][3], fb[NL][3], nb[NL][3];
  learn_sincos<T>(q, sn, cs, P::dofs(tr));
#pragma unroll
  for (int i = 0; i < 3; ++i) w[0][i] = dw[0][i] = dv[0][i] = fb[0][i] = nb[0][i] = T(0);
  dv[0][2] = tr.gravity;
#pragma unroll
  for (int l = 1; l < n; ++l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = P::parent(tr, l), ty = P::type(tr, l);
    const int d = ty == DRM_FIXED ? 0 : P::dof(tr, l);
    const T qv = ty == DRM_FIXED ? T(0) : q[d];
    T J[9], R[9], t[3];
    learn_local(L, ty, qv, sn[d], cs[d], J, R, t);
    T w_c[3], dw_c[3], dv_c[3];
    drm_rr_motion(R, t, w[par], dw[par], dv[par], w_c, dw_c, dv_c);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      w[l][i] = w_c[i];
      dw[l][i] = dw_c[i];
      dv[l][i] = dv_c[i];
    }
    if (ty != DRM_FIXED) {
      T j[3], wxj[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) j[i] = L.a[i] * qd[d];
      drm_cross(w_c, j, wxj);
      if (ty == DRM_REVOLUTE) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          w[l][i] = w_c[i] + j[i];
          dw[l][i] = dw_c[i] + (L.a[i] * qdd[d] + wxj[i]);
        }
      } else {
#pragma unroll
        for (int i = 0; i < 3; ++i) dv[l][i] = dv_c[i] + (L.a[i] * qdd[d] + wxj[i] * T(2));
      }
    }
    T nt[3], u[3];
    drm_cross(nb[par], t, nt);
#pragma unroll
    for (int i = 0; i < 3; ++i) u[i] = fb[par][i] + nt[i];
    drm_rot_t(R, u, fb[l]);
    drm_rot_t(R, nb[par], nb[l]);
    if (ty == DRM_REVOLUTE) {
#pragma unroll
      for (int i = 0; i < 3; ++i) nb[l][i] = nb[l][i] + L.a[i] * lam[d];
    } else if (ty == DRM_PRISMATIC) {
#pragma unroll
      for (int i = 0; i < 3; ++i) fb[l][i] = fb[l][i] + L.a[i] * lam[d];
    }
  }
  // fa, na: the children's share of each link's force and moment totals
  T fa[NL][3], na[NL][3], wb[NL][3], dwb[NL][3], dvb[NL][3];
#pragma unroll
  for (int l = 0; l < n; ++l)
#pragma unroll
    for (int i = 0; i < 3; ++i) fa[l][i] = na[l][i] = wb[l][i] = dwb[l][i] = dvb[l][i] = T(0);
#pragma unroll
  for (int l = n - 1; l >= 1; --l) {
    const TreeLink<T>& L = tr.link[l];
    const int par = P::parent(tr, l), ty = P::type(tr, l);
    const int d = ty == DRM_FIXED ? 0 : P::dof(tr, l);
    const T qv = ty == DRM_FIXED ? T(0) : q[d];
    T J[9], R[9], t[3];
    learn_local(L, ty, qv, sn[d], cs[d], J, R, t);
    // the totals, and their share passed up
    T fl[3], nl[3], f_p[3], Rn[3], tf[3];
    drm_rr_force(L, w[l], dw[l], dv[l], fl, nl);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fl[i] = fl[i] + fa[l][i];
      nl[i] = nl[i] + na[l][i];
    }
    drm_rot_s(R, fl, f_p);
    drm_rot_s(R, nl, Rn);
    drm_cross(t, f_p, tf);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      fa[par][i] = fa[par][i] + f_p[i];
      na[par][i] = na[par][i] + (Rn[i] + tf[i]);
    }
    // the backward sweep's reverse at this link (fb, nb from the first sweep)
    T jq = T(0), jqd = tr.use_damping ? tr.damping[d] * lam[d] : T(0), jqdd = T(0), tb[3];
    if (ty == DRM_REVOLUTE) {
      T nbl[3], x[3], y[3];
      drm_rot_t(R, nb[par], nbl);  // nb[l] before its a lam
      drm_cross(fl, fb[l], x);
      drm_cross(nl, nbl, y);
      jq = jq + (L.a[0] * (x[0] + y[0]) + L.a[1] * (x[1] + y[1]) + L.a[2] * (x[2] + y[2]));
    } else if (ty == DRM_PRISMATIC) {
      drm_cross(f_p, nb[par], tb);
    }
    // the link force's reverse
    {
      T fc[3], acb[3], ca[3], Inb[3], wc[3], x1[3], aw[3], x2[3], Iw[3], x3[3], nw[3], x4[3];
      drm_cross(nb[l], L.com, fc);
#pragma unroll
      for (int i = 0; i < 3; ++i) acb[i] = (fb[l][i] + fc[i]) * L.mass;
      drm_cross(L.com, acb, ca);
      drm_symm(L.I6, nb[l], Inb);
      drm_cross(w[l], L.com, wc);
      drm_cross(wc, acb, x1);
      drm_cross(acb, w[l], aw);
      drm_cross(L.com, aw, x2);
      drm_symm(L.I6, w[l], Iw);
      drm_cross(Iw, nb[l], x3);
      drm_cross(nb[l], w[l], nw);
      drm_symm(L.I6, nw, x4);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wb[l][i] = wb[l][i] + ((x1[i] + x2[i]) + (x3[i] + x4[i]));
        dwb[l][i] = dwb[l][i] + (ca[i] + Inb[i]);
        dvb[l][i] = dvb[l][i] + acb[i];
      }
    }
    if (ty == DRM_REVOLUTE)
      jqdd = L.a[0] * dwb[l][0] + L.a[1] * dwb[l][1] + L.a[2] * dwb[l][2];
    else if (ty == DRM_PRISMATIC)
      jqdd = L.a[0] * dvb[l][0] + L.a[1] * dvb[l][1] + L.a[2] * dvb[l][2];
    // the motion's reverse
    T w_c[3], dw_c[3], dv_c[3], wcb[3];
    drm_rr_motion(R, t, w[par], dw[par], dv[par], w_c, dw_c, dv_c);
#pragma unroll
    for (int i = 0; i < 3; ++i) wcb[i] = wb[l][i];
    if (ty != DRM_FIXED) {
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
        jq = jq + (L.a[0] * ((y1[0] + y2[0]) + y3[0]) + L.a[1] * ((y1[1] + y2[1]) + y3[1]) +
                   L.a[2] * ((y1[2] + y2[2]) + y3[2]));
      } else {
        drm_cross(dvb[l], w_c, x);
#pragma unroll
        for (int i = 0; i < 3; ++i) jb[i] = x[i] * T(2);
        drm_cross(j, dvb[l], x);
#pragma unroll
        for (int i = 0; i < 3; ++i) wcb[i] = wb[l][i] + x[i] * T(2);
      }
      jqd = jqd + (L.a[0] * jb[0] + L.a[1] * jb[1] + L.a[2] * jb[2]);
    }
    T accb[3], c2[3], c2b[3], Rw[3], Rdw[3], x1[3], x2[3], x3[3];
    drm_rot_s(R, dvb[l], accb);
    drm_cross(accb, w[par], c2b);
    drm_rot_s(R, wcb, Rw);
    drm_cross(w[par], t, c2);
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
      drm_cross(accb, dw[par], y1);
      drm_cross(c2b, w[par], y2);
      jq = jq + (L.Fa[0] * (tb[0] + (y1[0] + y2[0])) + L.Fa[1] * (tb[1] + (y1[1] + y2[1])) +
                 L.Fa[2] * (tb[2] + (y1[2] + y2[2])));
    }
    if (ty != DRM_FIXED) dof_out(d, jq, jqd, jqdd);
    T v[16];
    learn_link_partials(L, ty, qv, J, t, dF[l], w[l], dw[l], dv[l], w[par], dw[par], dv[par], fl, nl,
                        f_p, fb[l], nb[l], fb[par], nb[par], wcb, dwb[l], dvb[l], accb, c2b, v);
    link_out(l, v);
  }
}

// The sums of v[k], k < 16, over the lanes of a warp that share their
// place g in a group of G lanes, by recursive halving: at each step a lane
// keeps half of its values, sends the other half to its partner and adds
// what it receives (16 values cost 8 + 4 + ... shuffles, not 16 a step).
// Each lane returns `base` and holds the sums of v[base], ..., v[base + 16 G
// / 32 - 1] in v[0], ...: the lanes of one g hold different parts, summed in
// an order fixed by the lanes (the same bits on every run). Every lane of
// the warp must call it.
template <typename T, int G>
__device__ __forceinline__ int group_sum16(T* v) {
  const int lane = int(threadIdx.x) & 31;
  int base = 0;
#pragma unroll
  for (int s = 0; (16 >> s) >= G; ++s) {
    const int h = 8 >> s, m = 16 >> s;
    const bool up = lane & m;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const T send = up ? v[i] : v[i + h];
      const T keep = up ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, m);
    }
    base += up ? h : 0;
  }
  return base;
}

// The warp's sum of v[k] over its 32 lanes, for each k < 16: lanes 2k and
// 2k + 1 return the sum of v[k]. v is overwritten.
template <typename T>
__device__ __forceinline__ T warp_sum16(T* v) {
  group_sum16<T, 2>(v);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// The robot's cotangent as the wrapper returns it, flat: trans [n, 3],
// rot_angles [n, 3], mass [n], com [n, 3], inertia_com [n, 3, 3], damping
// [D]. Column o's partial is row robot_row(o, n) of a scenario's 16 n + D
// (16 l + k: link l's k-th partial in `learn_link_partials`' order; 16 n +
// d: the damping of dof d), or -1 for an inertia entry below the diagonal,
// which the RNEA does not read (its cotangent is 0).
__host__ __device__ constexpr int robot_cols(int n, int D) { return 19 * n + D; }

__device__ __forceinline__ int robot_row(int o, int n) {
  if (o < 3 * n) return 16 * (o / 3) + o % 3;
  o -= 3 * n;
  if (o < 3 * n) return 16 * (o / 3) + 3 + o % 3;
  o -= 3 * n;
  if (o < n) return 16 * o + 6;
  o -= n;
  if (o < 3 * n) return 16 * (o / 3) + 7 + o % 3;
  o -= 3 * n;
  if (o < 9 * n) {
    const int l = o / 9, i = o % 9 / 3, j = o % 3;
    if (j < i) return -1;
    return 16 * l + 10 + (i == 0 ? j : (i == 1 ? 2 + j : 5));  // xx xy xz, yy yz, zz
  }
  return 16 * n + (o - 9 * n);
}

// The block's row of the robot's cotangent, rows[blockIdx.x]: its warps'
// sums (acc[w][r], r a scenario's partial as `robot_row` numbers them)
// added in order, in the flat layout. After a __syncthreads().
template <typename T, int RC>
__device__ __forceinline__ void block_row(const T (*acc)[RC], int n, int D, T* rows) {
  const int cols = robot_cols(n, D);
  for (int o = threadIdx.x; o < cols; o += kThreads) {
    const int r = robot_row(o, n);
    T s = T(0);
    if (r >= 0) {
      s = acc[0][r];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) s = s + acc[w][r];
    }
    rows[int64_t(blockIdx.x) * cols + o] = s;
  }
}

template <typename T>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, int64_t row, int D, T* v) {
#pragma unroll
  for (int d = 0; d < D; ++d) v[d] = x[row + d];
}

// K4's learnable form, one thread a scenario. The grid is at most one wave
// of resident blocks, each taking the tiles blockIdx.x, + gridDim.x, ...
// of kThreads scenarios, so a block builds its tree image once; the first
// tile's rows are read while it does.
template <typename T, class P>
__global__ void __launch_bounds__(kThreads)
rnea_fwd_learnable_kernel(const __grid_constant__ Tree<T> tmpl, const RobotArrays<T> ra,
                          const T* __restrict__ q, const T* __restrict__ qd,
                          const T* __restrict__ qdd, T* __restrict__ tau, int64_t B) {
  __shared__ Tree<T> tr;
  constexpr int NL = P::NL, ND = P::ND;
  const int D = P::dofs(tmpl);
  const int64_t step = int64_t(gridDim.x) * kThreads;
  int64_t b = int64_t(blockIdx.x) * kThreads + threadIdx.x;
  T qv[ND], qdv[ND], qddv[ND], tv[ND];
  if (b < B) {
    load_rows<T>(q, b * D, D, qv);
    load_rows<T>(qd, b * D, D, qdv);
    load_rows<T>(qdd, b * D, D, qddv);
  }
  rnea_pack<T, P>(tmpl, ra, tr, static_cast<T(*)[27]>(nullptr));
  __syncthreads();
  for (bool first = true; b < B; b += step, first = false) {
    const int64_t row = b * D;
    if (!first) {
      load_rows<T>(q, row, D, qv);
      load_rows<T>(qd, row, D, qdv);
      load_rows<T>(qdd, row, D, qddv);
    }
    // `drm_rr_local`, its sincos first
    T sn[ND], cs[ND], R[NL][9], t[NL][3];
    learn_sincos<T>(qv, sn, cs, D);
#pragma unroll
    for (int l = 1; l < P::links(tr); ++l) {
      const int ty = P::type(tr, l), d = ty == DRM_FIXED ? 0 : P::dof(tr, l);
      T J[9];
      learn_local(tr.link[l], ty, ty == DRM_FIXED ? T(0) : qv[d], sn[d], cs[d], J, R[l], t[l]);
    }
    DrmRneaState<T, P> st;
    drm_rr_rnea<T, P>(tr, R, t, qdv, qddv, st, tv);
#pragma unroll
    for (int d = 0; d < D; ++d) tau[row + d] = tv[d];
  }
}

// Its robot VJP, one thread a scenario (`learn_vjp`), on the fwd kernel's
// grid. Each link's 16 partials are summed over the warp as the sweep
// leaves the link (`warp_sum16`) and added to the warp's row in shared
// memory, the damping's after the sweep; the block's row (the warps' rows
// summed in order, in the flat layout of `robot_row`) goes to rows[blockIdx.x].
// Lanes past B run scenario B - 1 and add 0, so that every lane meets every
// shuffle.
template <typename T, class P>
__global__ void __launch_bounds__(kThreads)
rnea_bwd_learnable_kernel(const __grid_constant__ Tree<T> tmpl, const RobotArrays<T> ra,
                          const T* __restrict__ q, const T* __restrict__ qd,
                          const T* __restrict__ qdd, const T* __restrict__ g, T* __restrict__ gq,
                          T* __restrict__ gqd, T* __restrict__ gqdd, T* __restrict__ rows,
                          int64_t B) {
  constexpr int NL = P::NL, ND = P::ND, RC = 16 * NL + ND;
  __shared__ Tree<T> tr;
  __shared__ T dF[NL][27];
  __shared__ T acc[kWarps][RC];
  const int n = P::links(tmpl), D = P::dofs(tmpl);
  const int warp = int(threadIdx.x) / 32, lane = int(threadIdx.x) & 31;
  for (int i = threadIdx.x; i < kWarps * RC; i += kThreads) (&acc[0][0])[i] = T(0);
  const int64_t tiles = (B + kThreads - 1) / kThreads;
  int64_t tile = blockIdx.x;
  T qv[ND], qdv[ND], qddv[ND], gv[ND];
  auto load = [&](int64_t b) {
    load_rows<T>(q, b * D, D, qv);
    load_rows<T>(qd, b * D, D, qdv);
    load_rows<T>(qdd, b * D, D, qddv);
    load_rows<T>(g, b * D, D, gv);
  };
  auto scenario = [&](int64_t t) {
    const int64_t b = t * kThreads + threadIdx.x;
    return b < B ? b : B - 1;
  };
  load(scenario(tile));
  rnea_pack<T, P>(tmpl, ra, tr, dF);
  __syncthreads();
  for (bool first = true; tile < tiles; tile += gridDim.x, first = false) {
    const bool live = tile * kThreads + threadIdx.x < B;
    const int64_t b = scenario(tile), row = b * D;
    if (!first) load(b);
    auto link_out = [&](int l, T* v) {
      if (!live) {
#pragma unroll
        for (int k = 0; k < 16; ++k) v[k] = T(0);
      }
      const T s = warp_sum16(v);
      if (!(lane & 1)) acc[warp][16 * l + lane / 2] += s;
    };
    auto dof_out = [&](int d, T jq, T jqd, T jqdd) {
      if (live) {
        gq[row + d] = jq;
        gqd[row + d] = jqd;
        gqdd[row + d] = jqdd;
      }
    };
    learn_vjp<T, P>(tr, dF, qv, qdv, qddv, gv, link_out, dof_out);
    for (int k0 = 0; k0 < D; k0 += 16) {
      T v[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int d = k0 + k < ND ? k0 + k : ND - 1;
        v[k] = live && tr.use_damping && k0 + k < D ? gv[d] * qdv[d] : T(0);
      }
      const T s = warp_sum16(v);
      if (!(lane & 1) && k0 + lane / 2 < D) acc[warp][16 * n + k0 + lane / 2] += s;
    }
  }
  __syncthreads();
  block_row(acc, n, D, rows);
}

// ---- the learnable forms at small batches: a scenario on a group of lanes ----
//
// Below `group_below()` scenarios a serial chain's scenario runs on a group
// of G lanes (`drm_group_lanes`: 8 for DrmSerial<9, 7>, 4 for DrmSerial<4,
// 2>), lane g owning link lk = min(g + 1, NL - 1) and its dof g, as K5 and K7
// do (csrc/dyn_rollout.cu `fwd_group_kernel`): what is a link's own (its
// local rotation, its own force, the force's reverse, its partials) runs on
// its lane, beside the other links'; the sweeps pass each link's values
// along the chain by shuffles. The arithmetic is the one-thread form's,
// operation for operation. Lanes past B run scenario B - 1 and store
// nothing, so that every lane meets every shuffle.

template <typename T, int G>
__device__ __forceinline__ T group_sum(T x) {
#pragma unroll
  for (int m = 16; m >= G; m /= 2) x = x + __shfl_xor_sync(0xffffffffu, x, m);
  return x;
}

// The lane's link lk's local rotation at q: `learn_local`'s (a serial chain
// has no prismatic joint, and its translations are the links' own).
template <typename T, class P>
__device__ __forceinline__ void group_local(const Tree<T>& tr, int lk, const T* q, T& sn, T& cs,
                                            T* J, T* R) {
  constexpr int ND = P::ND;
  const TreeLink<T>& L = tr.link[lk];
  sn = cs = T(0);
  if (lk <= ND) {
    T qv = q[0];
#pragma unroll
    for (int d = 1; d < ND; ++d) qv = d == lk - 1 ? q[d] : qv;
    learn_sincos<T>(&qv, &sn, &cs, 1);
    drm_rodrigues(L.a, cs, sn, J);
    drm_mat3(L.F, J, R);
  } else {
    drm_copy<9>(L.F, R);
  }
}

// K4's learnable form on groups of G lanes: each lane its link's local
// rotation; the forward sweep, each link's rotation shuffled from its owner,
// on every lane as far as its own link; each lane its link's own force; the
// backward sweep on every lane, each link's rotation and own force shuffled
// from its owner; lane g stores tau of dof g. A block takes tiles of
// kThreads / G scenarios.
template <typename T, class P, int G>
__global__ void __launch_bounds__(kThreads)
rnea_fwd_learnable_group_kernel(const __grid_constant__ Tree<T> tmpl, const RobotArrays<T> ra,
                                const T* __restrict__ q, const T* __restrict__ qd,
                                const T* __restrict__ qdd, T* __restrict__ tau, int64_t B) {
  static_assert(P::serial, "the group form is laid out for a serial chain");
  constexpr int NL = P::NL, ND = P::ND, S = kThreads / G;
  static_assert(G >= NL - 1 && 32 % G == 0, "a lane a moving link, a group within a warp");
  __shared__ Tree<T> tr;
  const int g = int(threadIdx.x) % G, lk = g + 1 < NL - 1 ? g + 1 : NL - 1;
  const int64_t tiles = (B + S - 1) / S;
  int64_t tile = blockIdx.x;
  auto scenario = [&](int64_t t) {
    const int64_t b = t * S + threadIdx.x / G;
    return b < B ? b : B - 1;
  };
  T qv[ND], qdv[ND], qddv[ND];
  auto load = [&](int64_t b) {
    load_rows<T>(q, b * ND, ND, qv);
    load_rows<T>(qd, b * ND, ND, qdv);
    load_rows<T>(qdd, b * ND, ND, qddv);
  };
  load(scenario(tile));
  rnea_pack<T, P>(tmpl, ra, tr, static_cast<T(*)[27]>(nullptr));
  __syncthreads();
  for (bool first = true; tile < tiles; tile += gridDim.x, first = false) {
    const bool live = tile * S + threadIdx.x / G < B;
    const int64_t b = scenario(tile);
    if (!first) load(b);
    T sn, cs, J[9], Ro[9];
    group_local<T, P>(tr, lk, qv, sn, cs, J, Ro);
    T w[3], dw[3], dv[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = dw[i] = dv[i] = T(0);
    dv[2] = tr.gravity;
#pragma unroll
    for (int l = 1; l < NL; ++l) {
      T R[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = __shfl_sync(0xffffffffu, Ro[i], l - 1, G);
      if (l <= lk) {
        const TreeLink<T>& L = tr.link[l];
        T w_c[3], dw_c[3], dv_c[3];
        drm_rr_motion(R, L.t, w, dw, dv, w_c, dw_c, dv_c);
        drm_copy<3>(w_c, w);
        drm_copy<3>(dw_c, dw);
        drm_copy<3>(dv_c, dv);
        if (l <= ND) {
          T j[3], wxj[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) j[i] = L.a[i] * qdv[l - 1];
          drm_cross(w_c, j, wxj);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            w[i] = w_c[i] + j[i];
            dw[i] = dw_c[i] + (L.a[i] * qddv[l - 1] + wxj[i]);
          }
        }
      }
    }
    T of[3], on[3];
    drm_rr_force(tr.link[lk], w, dw, dv, of, on);
    T cf[3], cn[3], tv = T(0);
#pragma unroll
    for (int l = NL - 1; l >= 1; --l) {
      T R[9], f[3], n[3];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = __shfl_sync(0xffffffffu, Ro[i], l - 1, G);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        f[i] = __shfl_sync(0xffffffffu, of[i], l - 1, G);
        n[i] = __shfl_sync(0xffffffffu, on[i], l - 1, G);
      }
      const TreeLink<T>& L = tr.link[l];
      if (l < NL - 1) {
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          f[i] = f[i] + cf[i];
          n[i] = n[i] + cn[i];
        }
      }
      if (l <= ND && l - 1 == g) tv = L.a[0] * n[0] + L.a[1] * n[1] + L.a[2] * n[2];
      T f_p[3], Rn[3], tf[3];
      drm_rot_s(R, f, f_p);
      drm_rot_s(R, n, Rn);
      drm_cross(L.t, f_p, tf);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        cf[i] = f_p[i];
        cn[i] = Rn[i] + tf[i];
      }
    }
    if (live && g < ND) {
      if (tr.use_damping) {
        T qdg = qdv[0];
#pragma unroll
        for (int d = 1; d < ND; ++d) qdg = d == g ? qdv[d] : qdg;
        tv = tv + tr.damping[g] * qdg;
      }
      tau[b * ND + g] = tv;
    }
  }
}

// Its robot VJP on groups of G lanes: `learn_vjp`'s two sweeps with a lane
// a link. The first on every lane as far as its own link (each link's
// rotation shuffled from its owner), so that each lane holds its link's
// and its parent's motion, fb and nb. The second in turns, tip -> root: the
// owner of link l takes what its child's owner passed on (the children's
// share of the totals, and wb, dwb, dvb: 15 shuffles), adds its own link's
// (its own force and the force's reverse, computed beside the other lanes
// first), and passes its parent's share on. Then each lane its link's
// partials and its dof's cotangents, beside the others; the partials are
// summed over the warp's groups (`group_sum16`) into the warp's row.
template <typename T, class P, int G>
__global__ void __launch_bounds__(kThreads)
rnea_bwd_learnable_group_kernel(const __grid_constant__ Tree<T> tmpl, const RobotArrays<T> ra,
                                const T* __restrict__ q, const T* __restrict__ qd,
                                const T* __restrict__ qdd, const T* __restrict__ g,
                                T* __restrict__ gq, T* __restrict__ gqd, T* __restrict__ gqdd,
                                T* __restrict__ rows, int64_t B) {
  static_assert(P::serial, "the group form is laid out for a serial chain");
  constexpr int NL = P::NL, ND = P::ND, S = kThreads / G, RC = 16 * NL + ND;
  static_assert(G >= NL - 1 && 32 % G == 0, "a lane a moving link, a group within a warp");
  __shared__ Tree<T> tr;
  __shared__ T dF[NL][27];
  __shared__ T acc[kWarps][RC];
  const int gl = int(threadIdx.x) % G, lk = gl + 1 < NL - 1 ? gl + 1 : NL - 1;
  const bool owner = gl + 1 <= NL - 1;  // the lane's link is its own (not a repeat of the last)
  const int warp = int(threadIdx.x) / 32;
  for (int i = threadIdx.x; i < kWarps * RC; i += kThreads) (&acc[0][0])[i] = T(0);
  const int64_t tiles = (B + S - 1) / S;
  int64_t tile = blockIdx.x;
  auto scenario = [&](int64_t t) {
    const int64_t b = t * S + threadIdx.x / G;
    return b < B ? b : B - 1;
  };
  T qv[ND], qdv[ND], qddv[ND], gv[ND];
  auto load = [&](int64_t b) {
    load_rows<T>(q, b * ND, ND, qv);
    load_rows<T>(qd, b * ND, ND, qdv);
    load_rows<T>(qdd, b * ND, ND, qddv);
    load_rows<T>(g, b * ND, ND, gv);
  };
  // the lane's dof's entry of a row
  auto own = [&](const T* x) {
    T v = x[0];
#pragma unroll
    for (int d = 1; d < ND; ++d) v = d == lk - 1 ? x[d] : v;
    return v;
  };
  load(scenario(tile));
  rnea_pack<T, P>(tmpl, ra, tr, dF);
  __syncthreads();
  const TreeLink<T>& L = tr.link[lk];
  const bool rev = lk <= ND;
  for (bool first = true; tile < tiles; tile += gridDim.x, first = false) {
    const bool live = tile * S + threadIdx.x / G < B;
    const int64_t b = scenario(tile), row = b * ND;
    if (!first) load(b);
    T sn, cs, J[9], Ro[9];
    group_local<T, P>(tr, lk, qv, sn, cs, J, Ro);
    // the first sweep, root -> the lane's link: motion, fb, nb (and the parent's)
    T w[3], dw[3], dv[3], fb[3], nb[3], wp[3], dwp[3], dvp[3], fbp[3], nbp[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) w[i] = dw[i] = dv[i] = fb[i] = nb[i] = T(0);
    dv[2] = tr.gravity;
#pragma unroll
    for (int l = 1; l < NL; ++l) {
      T R[9];
#pragma unroll
      for (int i = 0; i < 9; ++i) R[i] = __shfl_sync(0xffffffffu, Ro[i], l - 1, G);
      if (l <= lk) {
        const TreeLink<T>& K = tr.link[l];
        drm_copy<3>(w, wp);
        drm_copy<3>(dw, dwp);
        drm_copy<3>(dv, dvp);
        drm_copy<3>(fb, fbp);
        drm_copy<3>(nb, nbp);
        T w_c[3], dw_c[3], dv_c[3];
        drm_rr_motion(R, K.t, wp, dwp, dvp, w_c, dw_c, dv_c);
        drm_copy<3>(w_c, w);
        drm_copy<3>(dw_c, dw);
        drm_copy<3>(dv_c, dv);
        if (l <= ND) {
          T j[3], wxj[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) j[i] = K.a[i] * qdv[l - 1];
          drm_cross(w_c, j, wxj);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            w[i] = w_c[i] + j[i];
            dw[i] = dw_c[i] + (K.a[i] * qddv[l - 1] + wxj[i]);
          }
        }
        T nt[3], u[3];
        drm_cross(nbp, K.t, nt);
#pragma unroll
        for (int i = 0; i < 3; ++i) u[i] = fbp[i] + nt[i];
        drm_rot_t(R, u, fb);
        drm_rot_t(R, nbp, nb);
        if (l <= ND) {
#pragma unroll
          for (int i = 0; i < 3; ++i) nb[i] = nb[i] + K.a[i] * gv[l - 1];
        }
      }
    }
    // the lane's own link: its force and moment, and the force's reverse
    T fo[3], no[3], wbo[3], dwbo[3], dvbo[3];
    drm_rr_force(L, w, dw, dv, fo, no);
    {
      T fc[3], acb[3], ca[3], Inb[3], wc[3], x1[3], aw[3], x2[3], Iw[3], x3[3], nw[3], x4[3];
      drm_cross(nb, L.com, fc);
#pragma unroll
      for (int i = 0; i < 3; ++i) acb[i] = (fb[i] + fc[i]) * L.mass;
      drm_cross(L.com, acb, ca);
      drm_symm(L.I6, nb, Inb);
      drm_cross(w, L.com, wc);
      drm_cross(wc, acb, x1);
      drm_cross(acb, w, aw);
      drm_cross(L.com, aw, x2);
      drm_symm(L.I6, w, Iw);
      drm_cross(Iw, nb, x3);
      drm_cross(nb, w, nw);
      drm_symm(L.I6, nw, x4);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        wbo[i] = (x1[i] + x2[i]) + (x3[i] + x4[i]);
        dwbo[i] = ca[i] + Inb[i];
        dvbo[i] = acb[i];
      }
    }
    // the second sweep in turns, tip -> root: the lane of link l finishes
    // its totals and cotangents from its child's share (`learn_vjp`'s pass
    // 2 at l) and leaves its parent's share in `up`
    T up[15], fl[3], nl[3], f_p[3], wb[3], dwb[3], dvb[3], wcb[3], accb[3], c2b[3];
    T jq = T(0), jqd = T(0), jqdd = T(0);
#pragma unroll
    for (int i = 0; i < 15; ++i) up[i] = T(0);
#pragma unroll
    for (int i = 0; i < 3; ++i)
      fl[i] = nl[i] = f_p[i] = wb[i] = dwb[i] = dvb[i] = wcb[i] = accb[i] = c2b[i] = T(0);
#pragma unroll
    for (int l = NL - 1; l >= 1; --l) {
      T in[15];
#pragma unroll
      for (int i = 0; i < 15; ++i) in[i] = __shfl_sync(0xffffffffu, up[i], l, G);
      if (l == NL - 1) {
#pragma unroll
        for (int i = 0; i < 15; ++i) in[i] = T(0);
      }
      if (lk == l && owner) {
        T Rn[3], tf[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          fl[i] = fo[i] + in[i];
          nl[i] = no[i] + in[3 + i];
        }
        drm_rot_s(Ro, fl, f_p);
        drm_rot_s(Ro, nl, Rn);
        drm_cross(L.t, f_p, tf);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          up[i] = T(0) + f_p[i];
          up[3 + i] = T(0) + (Rn[i] + tf[i]);
        }
        jqd = tr.use_damping ? tr.damping[lk - 1 < ND ? lk - 1 : 0] * own(gv) : T(0);
        if (rev) {
          T nbl[3], x[3], y[3];
          drm_rot_t(Ro, nbp, nbl);  // nb before its a lam
          drm_cross(fl, fb, x);
          drm_cross(nl, nbl, y);
          jq = jq + (L.a[0] * (x[0] + y[0]) + L.a[1] * (x[1] + y[1]) + L.a[2] * (x[2] + y[2]));
        }
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          wb[i] = in[6 + i] + wbo[i];
          dwb[i] = in[9 + i] + dwbo[i];
          dvb[i] = in[12 + i] + dvbo[i];
        }
        if (rev) jqdd = L.a[0] * dwb[0] + L.a[1] * dwb[1] + L.a[2] * dwb[2];
        T w_c[3], dw_c[3], dv_c[3];
        drm_rr_motion(Ro, L.t, wp, dwp, dvp, w_c, dw_c, dv_c);
        drm_copy<3>(wb, wcb);
        if (rev) {
          T j[3], x[3], jb[3], y1[3], y2[3], y3[3];
          const T qdl = own(qdv);
#pragma unroll
          for (int i = 0; i < 3; ++i) j[i] = L.a[i] * qdl;
          drm_cross(dwb, w_c, x);
#pragma unroll
          for (int i = 0; i < 3; ++i) jb[i] = wb[i] + x[i];
          drm_cross(j, dwb, x);
#pragma unroll
          for (int i = 0; i < 3; ++i) wcb[i] = wb[i] + x[i];
          drm_cross(wcb, w_c, y1);
          drm_cross(dwb, dw_c, y2);
          drm_cross(dvb, dv_c, y3);
          jq = jq + (L.a[0] * ((y1[0] + y2[0]) + y3[0]) + L.a[1] * ((y1[1] + y2[1]) + y3[1]) +
                     L.a[2] * ((y1[2] + y2[2]) + y3[2]));
          jqd = jqd + (L.a[0] * jb[0] + L.a[1] * jb[1] + L.a[2] * jb[2]);
        }
        T c2[3], Rw[3], Rdw[3], x1[3], x2[3], x3[3];
        drm_rot_s(Ro, dvb, accb);
        drm_cross(accb, wp, c2b);
        drm_rot_s(Ro, wcb, Rw);
        drm_cross(wp, L.t, c2);
        drm_cross(c2, accb, x1);
        drm_cross(L.t, c2b, x2);
        drm_rot_s(Ro, dwb, Rdw);
        drm_cross(L.t, accb, x3);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          up[6 + i] = T(0) + (Rw[i] + (x1[i] + x2[i]));
          up[9 + i] = T(0) + (Rdw[i] + x3[i]);
          up[12 + i] = T(0) + accb[i];
        }
      }
    }
    if (live && owner && rev) {
      gq[row + lk - 1] = jq;
      gqd[row + lk - 1] = jqd;
      gqdd[row + lk - 1] = jqdd;
    }
    T v[16];
    learn_link_partials(L, rev ? DRM_REVOLUTE : DRM_FIXED, T(0), J, L.t, dF[lk], w, dw, dv, wp, dwp,
                        dvp, fl, nl, f_p, fb, nb, fbp, nbp, wcb, dwb, dvb, accb, c2b, v);
    if (!live || !owner) {
#pragma unroll
      for (int k = 0; k < 16; ++k) v[k] = T(0);
    }
    const int base = group_sum16<T, G>(v);
    if (owner) {
#pragma unroll
      for (int i = 0; i < 16 * G / 32; ++i) acc[warp][16 * lk + base + i] += v[i];
    }
    const T dmp = group_sum<T, G>(live && tr.use_damping && gl < ND ? own(gv) * own(qdv) : T(0));
    if (gl < ND && int(threadIdx.x) % 32 < G) acc[warp][16 * NL + gl] += dmp;
  }
  __syncthreads();
  block_row(acc, NL, ND, rows);
}

// The robot's cotangent: each column of the blocks' rows summed over the
// blocks in a fixed order (slice s of a column takes the rows s, s +
// kSumSlices, ..., then the slices are added in order).
constexpr int kSumCols = 32, kSumSlices = 8;

template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
robot_sum_kernel(const T* __restrict__ rows, int nrows, int cols, T* __restrict__ out) {
  __shared__ T part[kSumSlices][kSumCols];
  const int c = int(threadIdx.x) % kSumCols, s = int(threadIdx.x) / kSumCols;
  const int o = int(blockIdx.x) * kSumCols + c;
  T sum = T(0);
  if (o < cols)
    for (int i = s; i < nrows; i += kSumSlices) sum = sum + rows[int64_t(i) * cols + o];
  part[s][c] = sum;
  __syncthreads();
  if (s == 0 && o < cols) {
    T x = part[0][c];
#pragma unroll
    for (int j = 1; j < kSumSlices; ++j) x = x + part[j][c];
    out[o] = x;
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

// The group form runs below this many scenarios: while one thread a
// scenario would give the card's SMs fewer than kOneThreadWarpsPerSM warps
// each (4,224 on 132 SMs), as K5 and K7 (csrc/dyn_rollout.cu) do at two
// warps. On iiwa in float32 (PERF.md, tools/probe_rnea_learnable.py
// --switch) the group form was the faster up to B=4096 (the VJP 0.0182
// against 0.0268 ms, the card alone), one thread a scenario from B=8192
// (0.0264 against 0.0280 ms).
constexpr int kOneThreadWarpsPerSM = 1;

inline int64_t group_below() { return int64_t(32) * kOneThreadWarpsPerSM * drm_sm_count(); }

// The blocks of `kernel` (kThreads threads each) that one wave of the
// current card holds, its SMs times the blocks resident on one, queried
// once a device and instantiation through `cache`.
template <typename K>
cudaError_t wave_blocks(K kernel, std::atomic<int>* cache, int* out) {
  int dev = 0, per = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  if (dev < 0 || dev >= DRM_MAX_DEVICES) return cudaErrorInvalidDevice;
  *out = cache[dev].load(std::memory_order_relaxed);
  if (*out != 0) return cudaSuccess;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0);
  if (rc != cudaSuccess) return rc;
  const int sms = drm_sm_count();
  *out = sms * per > 0 ? sms * per : 1;
  cache[dev].store(*out, std::memory_order_relaxed);
  return cudaSuccess;
}

// Launch `kernel` on tiles of S scenarios: a block a tile, at most one wave
// and kMaxGrid blocks; `cache` is the instantiation's. The grid in *grid.
template <typename K, typename... A>
int learnable_launch(K kernel, std::atomic<int>* cache, int64_t B, int S, cudaStream_t s,
                     unsigned* grid, A... args) {
  int wave = 0;
  const cudaError_t rc = wave_blocks(kernel, cache, &wave);
  if (rc != cudaSuccess) return int(rc);
  int64_t n = (B + S - 1) / S;
  if (n > wave) n = wave;
  if (n > kMaxGrid) n = kMaxGrid;
  *grid = unsigned(n);
  kernel<<<*grid, kThreads, 0, s>>>(args...);
  return int(cudaGetLastError());
}

template <typename T>
int launch_fwd_learnable(int variant, const Tree<T>* tmpl, const RobotArrays<T>& ra, const T* q,
                         const T* qd, const T* qdd, T* tau, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  unsigned grid = 0;
  return drm_by_variant(variant, [&](auto p) {
    using P = decltype(p);
    if constexpr (P::serial) {
      constexpr int G = drm_group_lanes<P>();
      static std::atomic<int> wave[DRM_MAX_DEVICES];
      if (B < group_below())
        return learnable_launch(rnea_fwd_learnable_group_kernel<T, P, G>, wave, B, kThreads / G, s,
                                &grid, *tmpl, ra, q, qd, qdd, tau, B);
    }
    static std::atomic<int> wave[DRM_MAX_DEVICES];
    return learnable_launch(rnea_fwd_learnable_kernel<T, P>, wave, B, kThreads, s, &grid, *tmpl, ra,
                            q, qd, qdd, tau, B);
  });
}

// The VJP, then the sum of its blocks' rows into `rob` (robot_cols(n, D)
// values); `rows` holds at least min(ceil(B / kFewest), kMaxGrid) rows.
template <typename T>
int launch_bwd_learnable(int variant, const Tree<T>* tmpl, const RobotArrays<T>& ra, const T* q,
                         const T* qd, const T* qdd, const T* g, T* gq, T* gqd, T* gqdd, T* rows,
                         T* rob, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  unsigned grid = 0;
  const int rc = drm_by_variant(variant, [&](auto p) {
    using P = decltype(p);
    if constexpr (P::serial) {
      constexpr int G = drm_group_lanes<P>();
      static std::atomic<int> wave[DRM_MAX_DEVICES];
      if (B < group_below())
        return learnable_launch(rnea_bwd_learnable_group_kernel<T, P, G>, wave, B, kThreads / G, s,
                                &grid, *tmpl, ra, q, qd, qdd, g, gq, gqd, gqdd, rows, B);
    }
    static std::atomic<int> wave[DRM_MAX_DEVICES];
    return learnable_launch(rnea_bwd_learnable_kernel<T, P>, wave, B, kThreads, s, &grid, *tmpl, ra,
                            q, qd, qdd, g, gq, gqd, gqdd, rows, B);
  });
  if (rc != 0) return rc;
  const int cols = robot_cols(tmpl->n, tmpl->D);
  robot_sum_kernel<T><<<unsigned((cols + kSumCols - 1) / kSumCols), kSumCols * kSumSlices, 0, s>>>(
      rows, int(grid), cols, rob);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// sizeof(Tree<float>), sizeof(Tree<double>), DRM_MAX_LINKS and the (links,
// dofs) of each serial instantiation: the Python side checks its ctypes
// mirror and its variant table against these. Then the fewest scenarios a
// block of a learnable launch takes and its most blocks: the learnable VJP's
// `rows` hold min(ceil(B / fewest), most) rows of robot_cols(n, D).
void rnea_layout(int64_t* out) {
  out[0] = sizeof(Tree<float>);
  out[1] = sizeof(Tree<double>);
  out[2] = DRM_MAX_LINKS;
  drm_variant_shapes(out + 3);  // out[3], ..., out[6]
  out[7] = kFewest;
  out[8] = kMaxGrid;
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

// The least batch at which the learnable forms run one thread a scenario on
// a serial chain, on the current card; below it, a group of lanes.
int64_t rnea_learnable_one_thread_from() { return group_below(); }

// The learnable forms: `tmpl` holds the topology and the flags only; the
// link constants come from the tensors (RobotArrays' order) on every launch.
// rnea_bwd_learnable's `rob` receives the robot's cotangent, flat: trans,
// rot_angles, mass, com, inertia_com (0 below the diagonal), damping.
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
                               const T* g, T* gq, T* gqd, T* gqdd, T* rows, T* rob, int64_t B,   \
                               void* stream) {                                                   \
    const RobotArrays<T> ra{trans, rpy, axis, mass, com, inertia, damping};                      \
    return launch_bwd_learnable(variant, tmpl, ra, q, qd, qdd, g, gq, gqd, gqdd, rows, rob, B,    \
                                stream);                                                         \
  }

DRM_RNEA_LEARNABLE(float, f32)
DRM_RNEA_LEARNABLE(double, f64)
#undef DRM_RNEA_LEARNABLE

}  // extern "C"
