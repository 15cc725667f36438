// Kernel dyn_solve (the whole torque-space Adam MPC solve in one launch) and
// its prologue dyn_prologue.
//
// dyn_solve replaces the JAX package's ops/pallas/solver.py `_solve_kernel`
// (wrapper `adam_solve_fused`). One thread per scenario runs every Adam
// iteration:
//
//   forward:  tau_h = tau_ref + H0 a_h, tau_c = clip(tau_h, +-emax) (with
//             the effort box), (q, qd) <- step(q, qd, tau_c), p_h = ee FK,
//             cost = cgoal_w sum |p_h - goal|^2 + ceff_w sum |H0 a_h|^2;
//   adjoint:  from the last stage back to the first, replay stage h from the
//             saved state, dq' = gq + J^T gpe_h, the implicit-function step
//             adjoint of dyn_step.cuh (the TPU kernel takes jax.vjp of the
//             step inside the kernel; CUDA has none), the effort box's mask,
//             the effort gradient on the unclipped tau - tau_ref, the H0^T
//             chain, and the optax-form Adam update of a_h at once.
//
// dyn_prologue replaces no TPU kernel: it is the eager code around the
// solve (trajopt/solvers.py:424-425 and :500-502: the gravity torques and
// the mass matrix at q0, and the warm start's torques mapped back to action
// deltas through that matrix's LDL^T factor), which XLA fuses into a few
// programs and eager PyTorch would run as thousands of small launches.
//
// Layout: q0, qd0, tau_ref [D, B], goal [3, B], H0 [D*D, B], a0, a, tau
// [H*D, B], costs [n_iters+1, B]; scratch m, v, tau_s, qs, qds [H*D, B] and
// ps [H*3, B], all scenario-minor. At iiwa H=50, B=4096 the scratch is about
// 37 MB and may stay in the 50 MB L2.
//
// Bound on the H100: per scenario, stage and iteration the function needs a
// step and a chain FK forward, and a replayed step, an LDL^T solve, the
// J^T g sweep and the RNEA partials backward: tens of thousands of FP32
// operations over a few hundred bytes of inputs, so operations bound it. One
// thread per scenario at B=4096 is one warp per SM, so each thread's
// dependent chain sets the time; spreading a scenario over several threads,
// and one reverse RNEA sweep for the partials in place of 2D dual sweeps,
// are the later changes.

#include <cstdint>

#include "dyn_step.cuh"

struct DynSolveParams {
  int H;
  int n_iters;
  int precond;  // tau = tau_ref + H0 a (else tau_ref + a)
  int effort;   // clip each applied torque to +-emax
  float cgoal_w, ceff_w;  // f32(f32(gw^2) / (3 H)), f32(f32(ew) / (H D))
  float gpe_w, geff_w;    // 2 cgoal_w, 2 ceff_w
  float b1, b2, omb1, omb2;
  float eps, eps_root;
};

namespace {

template <int NL, int ND>
__global__ void dyn_solve_kernel(const __grid_constant__ Tree<float> tr,
                                 const __grid_constant__ Chain<float> ch,
                                 const __grid_constant__ DynSolveParams P,
                                 const float* __restrict__ q0, const float* __restrict__ qd0,
                                 const float* __restrict__ tau_ref, const float* __restrict__ goal,
                                 const float* __restrict__ a0, const float* __restrict__ H0,
                                 const float* __restrict__ bc, float* __restrict__ tau_out,
                                 float* __restrict__ costs, float* __restrict__ a,
                                 float* __restrict__ m, float* __restrict__ v,
                                 float* __restrict__ tau_s, float* __restrict__ qs,
                                 float* __restrict__ qds, float* __restrict__ ps, int64_t B) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = tr.D, H = P.H;
  auto at = [&](int row) { return int64_t(row) * B + b; };

  float q0r[ND], qd0r[ND], trf[ND], H0v[ND * ND];
  for (int d = 0; d < D; ++d) {
    q0r[d] = q0[at(d)];
    qd0r[d] = qd0[at(d)];
    trf[d] = tau_ref[at(d)];
  }
  if (P.precond)
    for (int i = 0; i < D * D; ++i) H0v[i] = H0[at(i)];
  const float gl[3] = {goal[at(0)], goal[at(1)], goal[at(2)]};
  for (int i = 0; i < H * D; ++i) {
    a[at(i)] = a0[at(i)];
    m[at(i)] = 0.f;
    v[at(i)] = 0.f;
  }
  auto box = [&](float x, int d) { return P.effort ? drm_clip(x, -tr.emax[d], tr.emax[d]) : x; };

  // The rollout at the current actions; saves tau, qs, qds and ps for the
  // adjoint and returns the cost (with `final`, writes the applied torques).
  auto forward = [&](bool final) {
    float q[ND], qd[ND];
    for (int d = 0; d < D; ++d) {
      q[d] = q0r[d];
      qd[d] = qd0r[d];
    }
    float cg = 0.f, ce = 0.f;
    for (int h = 0; h < H; ++h) {
      float dtau[ND], tc[ND], qn[ND], qdn[ND];
      for (int d = 0; d < D; ++d) {
        float s;
        if (P.precond) {
          s = 0.f;
          for (int e = 0; e < D; ++e) s = s + H0v[d * D + e] * a[at(h * D + e)];
        } else {
          s = a[at(h * D + d)];
        }
        dtau[d] = s;
        const float tau = trf[d] + s;
        tau_s[at(h * D + d)] = tau;
        tc[d] = box(tau, d);
        if (final) tau_out[at(h * D + d)] = tc[d];
      }
      drm_fd_step<float, NL, ND>(tr, q, qd, tc, qn, qdn);
      for (int d = 0; d < D; ++d) {
        q[d] = qn[d];
        qd[d] = qdn[d];
        qs[at(h * D + d)] = qn[d];
        qds[at(h * D + d)] = qdn[d];
      }
      float p[3];
      drm_chain_sweep(ch, [&](int d) { return q[d]; }, DrmNoRecord{}, p);
      for (int j = 0; j < 3; ++j) {
        ps[at(h * 3 + j)] = p[j];
        const float diff = p[j] - gl[j];
        cg = cg + diff * diff;
      }
      for (int d = 0; d < D; ++d) ce = ce + dtau[d] * dtau[d];
    }
    return P.cgoal_w * cg + P.ceff_w * ce;
  };

  for (int t = 0; t < P.n_iters; ++t) {
    costs[at(t)] = forward(false);
    const float alpha = bc[2 * t], ibc2 = bc[2 * t + 1];
    float gq[ND], gqd[ND];
    for (int d = 0; d < D; ++d) gq[d] = gqd[d] = 0.f;
    for (int h = H - 1; h >= 0; --h) {
      float q[ND], qd[ND], tau[ND], tc[ND], qn[ND], gqn[ND], lam[ND], gt[ND];
      for (int d = 0; d < D; ++d) {
        q[d] = h == 0 ? q0r[d] : qs[at((h - 1) * D + d)];
        qd[d] = h == 0 ? qd0r[d] : qds[at((h - 1) * D + d)];
        tau[d] = tau_s[at(h * D + d)];
        tc[d] = box(tau[d], d);
        qn[d] = qs[at(h * D + d)];
        gqn[d] = gq[d];
      }
      float p[3], gpe[3];
      for (int j = 0; j < 3; ++j) {
        p[j] = ps[at(h * 3 + j)];
        gpe[j] = P.gpe_w * (p[j] - gl[j]);
      }
      float pw[3];
      drm_chain_sweep(
          ch, [&](int d) { return qn[d]; },
          [&](int type, int dof, const float* z, const float* o) {
            gqn[dof] += drm_joint_vjp(type, z, o, p, gpe);
          },
          pw);
      drm_fd_step_adjoint<float, NL, ND>(tr, q, qd, tc, gqn, gqd, lam, gq, gqd);
      for (int d = 0; d < D; ++d) {
        const float g_box = P.effort ? lam[d] * drm_clip_grad(tau[d], -tr.emax[d], tr.emax[d]) : lam[d];
        gt[d] = g_box + P.geff_w * (tau[d] - trf[d]);
      }
      for (int e = 0; e < D; ++e) {
        float g = gt[e];
        if (P.precond) {
          g = 0.f;
          for (int d = 0; d < D; ++d) g = g + H0v[d * D + e] * gt[d];
        }
        const int64_t i = at(h * D + e);
        const float mu = P.b1 * m[i] + P.omb1 * g;
        const float nu = P.b2 * v[i] + P.omb2 * (g * g);
        m[i] = mu;
        v[i] = nu;
        a[i] = a[i] - alpha * mu / (sqrtf(nu * ibc2 + P.eps_root) + P.eps);
      }
    }
  }
  costs[at(P.n_iters)] = forward(true);
}

template <typename T, int NL, int ND>
__global__ void prologue_kernel(const __grid_constant__ Tree<T> tr, const T* __restrict__ q0,
                                const T* __restrict__ init, T* __restrict__ tau_ref,
                                T* __restrict__ H0, T* __restrict__ a0, int H, int precond,
                                int64_t B) {
  const int64_t b = int64_t(blockIdx.x) * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const int D = tr.D;
  auto at = [&](int row) { return int64_t(row) * B + b; };
  T q[ND], zero[ND], trf[ND], Lf[ND * (ND + 1) / 2], dg[ND];
  for (int d = 0; d < D; ++d) {
    q[d] = q0[at(d)];
    zero[d] = T(0);
  }
  {
    T Rl[NL][9], tl[NL][3];
    drm_local_all<T, T, NL>(tr, q, Rl, tl);
    drm_rnea<T, T, NL>(tr, Rl, tl, zero, zero, trf);
    if (precond) drm_crb<T, NL, ND>(tr, Rl, tl, Lf);
  }
  for (int d = 0; d < D; ++d) tau_ref[at(d)] = trf[d];
  if (precond) {
    for (int i = 0; i < D; ++i)
      for (int j = 0; j < D; ++j) H0[at(i * D + j)] = Lf[j <= i ? drm_tri(i, j) : drm_tri(j, i)];
    drm_ldl_factor(Lf, dg, D);
  }
  for (int h = 0; h < H; ++h) {
    T rhs[ND], x[ND];
    for (int d = 0; d < D; ++d) rhs[d] = init ? init[at(h * D + d)] - trf[d] : T(0);
    if (init && precond)
      drm_ldl_solve<T, ND>(Lf, dg, D, rhs, x);
    else
      for (int d = 0; d < D; ++d) x[d] = rhs[d];
    for (int d = 0; d < D; ++d) a0[at(h * D + d)] = x[d];
  }
}

constexpr int kThreads = 32;

inline unsigned blocks_for(int64_t B) { return unsigned((B + kThreads - 1) / kThreads); }

template <typename T>
int launch_prologue(const Tree<T>* tr, const T* q0, const T* init, T* tau_ref, T* H0, T* a0,
                    int H, int precond, int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  if (tr->n <= 16 && tr->D <= 16)
    prologue_kernel<T, 16, 16><<<blocks_for(B), kThreads, 0, s>>>(*tr, q0, init, tau_ref, H0, a0,
                                                                  H, precond, B);
  else
    prologue_kernel<T, 32, 32><<<blocks_for(B), kThreads, 0, s>>>(*tr, q0, init, tau_ref, H0, a0,
                                                                  H, precond, B);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// sizeof(Tree<float>), sizeof(Tree<double>), sizeof(Chain<float>),
// sizeof(DynSolveParams): the Python side checks its ctypes mirror.
void dyn_solve_layout(int64_t* out) {
  out[0] = sizeof(Tree<float>);
  out[1] = sizeof(Tree<double>);
  out[2] = sizeof(Chain<float>);
  out[3] = sizeof(DynSolveParams);
}

int dyn_prologue_f32(const Tree<float>* tr, const float* q0, const float* init, float* tau_ref,
                     float* H0, float* a0, int H, int precond, int64_t B, void* stream) {
  return launch_prologue(tr, q0, init, tau_ref, H0, a0, H, precond, B, stream);
}

int dyn_prologue_f64(const Tree<double>* tr, const double* q0, const double* init,
                     double* tau_ref, double* H0, double* a0, int H, int precond, int64_t B,
                     void* stream) {
  return launch_prologue(tr, q0, init, tau_ref, H0, a0, H, precond, B, stream);
}

int dyn_solve_f32(const Tree<float>* tr, const Chain<float>* ch, const DynSolveParams* P,
                  const float* q0, const float* qd0, const float* tau_ref, const float* goal,
                  const float* a0, const float* H0, const float* bc, float* tau_out, float* costs,
                  float* a, float* m, float* v, float* tau_s, float* qs, float* qds, float* ps,
                  int64_t B, void* stream) {
  auto s = (cudaStream_t)stream;
  if (tr->n <= 16 && tr->D <= 16)
    dyn_solve_kernel<16, 16><<<blocks_for(B), kThreads, 0, s>>>(
        *tr, *ch, *P, q0, qd0, tau_ref, goal, a0, H0, bc, tau_out, costs, a, m, v, tau_s, qs, qds,
        ps, B);
  else
    dyn_solve_kernel<32, 32><<<blocks_for(B), kThreads, 0, s>>>(
        *tr, *ch, *P, q0, qd0, tau_ref, goal, a0, H0, bc, tau_out, costs, a, m, v, tau_s, qs, qds,
        ps, B);
  return int(cudaGetLastError());
}

}  // extern "C"
