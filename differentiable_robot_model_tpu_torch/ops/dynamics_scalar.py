"""Scalar-expanded rigid-body dynamics on lanes: the topological sweep, RNEA,
the composite-rigid-body mass matrix, an unrolled LDL^T solve and forward
dynamics.

PyTorch counterpart of the JAX package's `ops/dynamics_scalar.py`. Every
3-vector and rotation is a tuple of tensors and the link loops unroll over
the static topology, so a dof-major `q [D, B...]` runs each algorithm on
`[B...]` lanes with elementwise ops only. These are the plain versions that
the dynamic-rollout and whole-solve kernels are checked against.

The sweeps only add, subtract and multiply their lane values, so they also
run on any number type that does (the forward-mode duals of
`ops/kernels/rollout.py`); `_local_rotation` takes the joint's cos/sin from
the caller for that reason.
"""

from __future__ import annotations

import torch

from ..models.structs import JOINT_FIXED, JOINT_PRISMATIC, JOINT_REVOLUTE, RobotStruct

GRAVITY = 9.81  # m/s^2, as the JAX package's ops/dynamics.py


def _link_dof_map(robot: RobotStruct):
    return {l: d for d, l in enumerate(robot.dof_links)}


def _ancestors(robot: RobotStruct, link_idx: int) -> set:
    """Links on the path root..link_idx (inclusive)."""
    chain = {link_idx}
    while link_idx != 0:
        link_idx = robot.parent[link_idx]
        chain.add(link_idx)
    return chain


def _cross(a, b):
    return (
        a[1] * b[2] - a[2] * b[1],
        a[2] * b[0] - a[0] * b[2],
        a[0] * b[1] - a[1] * b[0],
    )


def _add(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])


def _sub(a, b):
    return (a[0] - b[0], a[1] - b[1], a[2] - b[2])


def _scale(a, s):
    return (a[0] * s, a[1] * s, a[2] * s)


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _rot(R, v):
    """R @ v with R a 9-tuple (row major)."""
    return (
        R[0] * v[0] + R[1] * v[1] + R[2] * v[2],
        R[3] * v[0] + R[4] * v[1] + R[5] * v[2],
        R[6] * v[0] + R[7] * v[1] + R[8] * v[2],
    )


def _rot_t(R, v):
    """R^T @ v."""
    return (
        R[0] * v[0] + R[3] * v[1] + R[6] * v[2],
        R[1] * v[0] + R[4] * v[1] + R[7] * v[2],
        R[2] * v[0] + R[5] * v[1] + R[8] * v[2],
    )


def _symm(M, v):
    """Symmetric 3x3 (6-tuple xx, xy, xz, yy, yz, zz) @ v."""
    xx, xy, xz, yy, yz, zz = M
    return (
        xx * v[0] + xy * v[1] + xz * v[2],
        xy * v[0] + yy * v[1] + yz * v[2],
        xz * v[0] + yz * v[1] + zz * v[2],
    )


def _mat3(A, B):
    return tuple(
        A[3 * i] * B[j] + A[3 * i + 1] * B[3 + j] + A[3 * i + 2] * B[6 + j]
        for i in range(3)
        for j in range(3)
    )


def _vec3(x, l):
    return (x[l, 0], x[l, 1], x[l, 2])


def _inertia6(robot: RobotStruct, l: int):
    I = robot.inertia_com
    return (I[l, 0, 0], I[l, 0, 1], I[l, 0, 2], I[l, 1, 1], I[l, 1, 2], I[l, 2, 2])


def _local_rotation(robot: RobotStruct, l: int, q_l, cs=None):
    """Local joint rotation R_rpy @ R_axis(q) as a 9-tuple; `cs` = (cos q,
    sin q) when the caller has them (a number type torch.cos cannot take)."""
    roll, pitch, yaw = robot.rot_angles[l, 0], robot.rot_angles[l, 1], robot.rot_angles[l, 2]
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    F = (
        cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
        sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
        -sp, cp * sr, cp * cr,
    )
    if robot.joint_types[l] != JOINT_REVOLUTE:
        return F
    ax, ay, az = robot.axis[l, 0], robot.axis[l, 1], robot.axis[l, 2]
    c, s = (torch.cos(q_l), torch.sin(q_l)) if cs is None else cs
    C = 1.0 - c
    J = (
        c + ax * ax * C, ax * ay * C - az * s, ax * az * C + ay * s,
        ay * ax * C + az * s, c + ay * ay * C, ay * az * C - ax * s,
        az * ax * C - ay * s, az * ay * C + ax * s, c + az * az * C,
    )
    return _mat3(F, J)


def _local_transforms(robot: RobotStruct, q_link, zero, cs_link=None, keep=None):
    """Per link l >= 1 (in `keep`, when given) its local rotation (9-tuple)
    and translation in the parent frame, the prismatic offset included; the
    other entries stay None."""
    L = robot.n_links
    Rl, tl = [None] * L, [None] * L
    for l in range(1, L):
        if keep is not None and l not in keep:
            continue
        cs = None if cs_link is None else cs_link[l]
        Rl[l] = _local_rotation(robot, l, q_link[l], cs)
        t = _vec3(robot.trans, l)
        if robot.joint_types[l] == JOINT_PRISMATIC:
            F = _local_rotation(robot, l, zero)  # R_rpy only
            t = _add(t, _scale(_rot(F, _vec3(robot.axis, l)), q_link[l]))
        tl[l] = t
    return Rl, tl


def _world_poses_scalar(robot: RobotStruct, q: torch.Tensor, link_idx: int | None = None):
    """World (Rw 9-tuple, pw 3-tuple) per link via a topological sweep.

    q is dof-indexed: [D] or dof-major [D, B...]. With `link_idx`, only that
    link's ancestors are computed (the others stay None), which is what the
    JAX package gets from dead-code elimination.
    """
    L = robot.n_links
    keep = _ancestors(robot, link_idx) if link_idx is not None else set(range(L))
    one = torch.ones(q.shape[1:], dtype=q.dtype, device=q.device)
    zero = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
    ld = _link_dof_map(robot)
    q_link = [q[ld[l]] if l in ld else zero for l in range(L)]
    Rl, tl = _local_transforms(robot, q_link, zero, keep=keep)
    Rw = [None] * L
    pw = [None] * L
    Rw[0] = (one, zero, zero, zero, one, zero, zero, zero, one)
    pw[0] = (zero, zero, zero)
    for l in range(1, L):
        if l not in keep:
            continue
        Rp, pp = Rw[robot.parent[l]], pw[robot.parent[l]]
        pw[l] = _add(pp, _rot(Rp, tl[l]))
        Rw[l] = _mat3(Rp, Rl[l])
    return Rw, pw


def _rnea_sweeps(robot: RobotStruct, Rl, tl, qd_link, qdd_link, zero, gz):
    """The two RNEA sweeps from local transforms: per link the torque about
    (revolute) or force along (prismatic) its joint axis, `zero` elsewhere.
    `gz` is the base's upward acceleration (+g for gravity, d'Alembert)."""
    L = robot.n_links
    z3 = (zero, zero, zero)
    w, v, dw, dv = [z3] * L, [z3] * L, [z3] * L, [z3] * L
    dv[0] = (zero, zero, gz)
    for l in range(1, L):
        par = robot.parent[l]
        jt = robot.joint_types[l]
        R, t, a = Rl[l], tl[l], _vec3(robot.axis, l)
        # motion transform child <- parent: w_c = R^T w_p,
        # v_c = R^T (v_p + w_p x t)
        w_p, v_p, dw_p, dv_p = w[par], v[par], dw[par], dv[par]
        w_c = _rot_t(R, w_p)
        v_c = _rot_t(R, _add(v_p, _cross(w_p, t)))
        dw_c = _rot_t(R, dw_p)
        dv_c = _rot_t(R, _add(dv_p, _add(_cross(dw_p, t), _cross(w_p, _cross(w_p, t)))))
        if jt == JOINT_REVOLUTE:
            wj = _scale(a, qd_link[l])
            w[l] = _add(w_c, wj)
            v[l] = v_c
            dw[l] = _add(dw_c, _add(_scale(a, qdd_link[l]), _cross(w_c, wj)))
            dv[l] = dv_c
        elif jt == JOINT_PRISMATIC:
            vj = _scale(a, qd_link[l])
            w[l] = w_c
            v[l] = _add(v_c, vj)
            dw[l] = dw_c
            dv[l] = _add(dv_c, _add(_scale(a, qdd_link[l]), _scale(_cross(w_c, vj), 2.0)))
        else:
            w[l], v[l], dw[l], dv[l] = w_c, v_c, dw_c, dv_c

    n_f, f_f = [z3] * L, [z3] * L
    tau_link = [zero] * L
    for l in range(L - 1, 0, -1):
        m = robot.mass[l]
        c = _vec3(robot.com, l)
        I6 = _inertia6(robot, l)
        # Newton: f = m a_c with a_c = dv + dw x c + w x (w x c); Euler about
        # the COM shifted to the link origin: n = I dw + w x I w + c x f.
        a_c = _add(dv[l], _add(_cross(dw[l], c), _cross(w[l], _cross(w[l], c))))
        f_new = _scale(a_c, m)
        n_new = _add(_add(_symm(I6, dw[l]), _cross(w[l], _symm(I6, w[l]))), _cross(c, f_new))
        f_tot = _add(f_f[l], f_new)
        n_tot = _add(n_f[l], n_new)
        a = _vec3(robot.axis, l)
        jt = robot.joint_types[l]
        if jt == JOINT_REVOLUTE:
            tau_link[l] = _dot(a, n_tot)
        elif jt == JOINT_PRISMATIC:
            tau_link[l] = _dot(a, f_tot)
        par = robot.parent[l]
        f_p = _rot(Rl[l], f_tot)
        n_p = _add(_rot(Rl[l], n_tot), _cross(tl[l], f_p))
        f_f[par] = _add(f_f[par], f_p)
        n_f[par] = _add(n_f[par], n_p)
    return tau_link


def rnea_scalar(
    robot: RobotStruct,
    q: torch.Tensor,
    qd: torch.Tensor,
    qdd: torch.Tensor,
    include_gravity: bool = True,
    use_damping: bool = True,
    gravity: float = GRAVITY,
) -> torch.Tensor:
    """Inverse dynamics ([D] -> [D], or dof-major [D, B...] -> [D, B...]).

    Gravity enters as an upward base acceleration +g z (d'Alembert) and the
    joint damping d * qd is added to the torques, as in the JAX package.
    """
    zero = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
    ld = _link_dof_map(robot)
    pick = lambda x: [x[ld[l]] if l in ld else zero for l in range(robot.n_links)]
    Rl, tl = _local_transforms(robot, pick(q), zero)
    gz = zero + gravity if include_gravity else zero
    tau_link = _rnea_sweeps(robot, Rl, tl, pick(qd), pick(qdd), zero, gz)
    tau = torch.stack([tau_link[l] for l in robot.dof_links]) if robot.n_dofs else torch.zeros_like(q)
    if use_damping:
        tau = tau + robot.damping.reshape(robot.damping.shape + (1,) * (qd.dim() - 1)) * qd
    return tau


def _motion(R, t, w_p, dw_p, dv_p):
    """A link's velocity and accelerations carried from its parent's frame
    into its own, before its joint's motion: w_c = Rᵀ w_p, dw_c = Rᵀ dw_p,
    dv_c = Rᵀ (dv_p + (dw_p × t + w_p × (w_p × t)))."""
    acc = _add(dv_p, _add(_cross(dw_p, t), _cross(w_p, _cross(w_p, t))))
    return _rot_t(R, w_p), _rot_t(R, dw_p), _rot_t(R, acc)


def _link_force(robot: RobotStruct, l: int, w, dw, dv):
    """Link l's own force f = m (dv + (dw × c + w × (w × c))) and moment about
    its origin n = (I dw + w × I w) + c × f, in its frame."""
    c, I6 = _vec3(robot.com, l), _inertia6(robot, l)
    f = _scale(_add(dv, _add(_cross(dw, c), _cross(w, _cross(w, c)))), robot.mass[l])
    return f, _add(_add(_symm(I6, dw), _cross(w, _symm(I6, w))), _cross(c, f))


def _link_force_vjp(robot: RobotStruct, l: int, w, dw, fb, nb):
    """The cotangents (w̄, dw̄, dv̄) of `_link_force`'s inputs for the
    cotangents fb on f and nb on n."""
    c, I6, m = _vec3(robot.com, l), _inertia6(robot, l), robot.mass[l]
    acb = _scale(_add(fb, _cross(nb, c)), m)  # of a_c = dv + dw × c + w × (w × c)
    dwb = _add(_cross(c, acb), _symm(I6, nb))
    wb = _add(_add(_cross(_cross(w, c), acb), _cross(c, _cross(acb, w))),
              _add(_cross(_symm(I6, w), nb), _symm(I6, _cross(nb, w))))
    return wb, dwb, acb


def rnea_vjp_scalar(
    robot: RobotStruct,
    q: torch.Tensor,
    qd: torch.Tensor,
    qdd: torch.Tensor,
    lam: torch.Tensor,
    include_gravity: bool = True,
    use_damping: bool = True,
    gravity: float = GRAVITY,
    with_qdd: bool = False,
) -> torch.Tensor:
    """(∂RNEA(q, qd, qdd)/∂q)ᵀ λ and (∂RNEA/∂qd)ᵀ λ as one [2D, B...] tensor
    (rows k < D the q partials, D + k the qd ones) for dof-major q, qd, qdd,
    λ [D, B...], with gravity and damping as `rnea_scalar` has them. With
    `with_qdd`, [3D, B...]: rows 2D + k the qdd partials (∂RNEA/∂qdd)ᵀ λ =
    M(q) λ, each joint's axis dotted with the cotangent that the sweep's
    reverse carries for its link's angular (revolute) or linear (prismatic)
    acceleration, which is where its qdd enters.

    One reverse sweep of the RNEA: its forward sweep (each link's motion and
    own force) and backward sweep (the totals) once, then their reverse,
    root to tip for the force and moment totals' cotangents, tip to root
    for each link's force reverse and its motion's. A revolute joint's local
    rotation R = F J(q) about its unit axis a has Jᵀ dJ/dq = [a]×, so
    y = Rᵀ x with cotangent ȳ adds a·(ȳ × y) to q̄ and z = R x adds
    a·(x × Rᵀ z̄); a prismatic joint's offset t = t0 + (F a) q adds
    (F a)·t̄. The plain version of csrc/dyn_step.cuh `drm_rr_rnea_vjp` (the
    sweeps, then `drm_rr_rnea_reverse`, with QDD for `with_qdd`), which
    follows it line for line."""
    L, D = robot.n_links, robot.n_dofs
    zero = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
    ld = _link_dof_map(robot)
    pick = lambda x: [x[ld[l]] if l in ld else zero for l in range(L)]
    qd_l, qdd_l = pick(qd), pick(qdd)
    Rl, tl = _local_transforms(robot, pick(q), zero)
    z3 = (zero, zero, zero)
    w, dw, dv, f, n = [z3] * L, [z3] * L, [z3] * L, [z3] * L, [z3] * L
    dv[0] = (zero, zero, zero + gravity if include_gravity else zero)
    for l in range(1, L):
        par, jt, a = robot.parent[l], robot.joint_types[l], _vec3(robot.axis, l)
        w_c, dw_c, dv_c = _motion(Rl[l], tl[l], w[par], dw[par], dv[par])
        w[l], dw[l], dv[l] = w_c, dw_c, dv_c
        if jt != JOINT_FIXED:
            j = _scale(a, qd_l[l])
            wxj, aq = _cross(w_c, j), _scale(a, qdd_l[l])
            if jt == JOINT_REVOLUTE:
                w[l], dw[l] = _add(w_c, j), _add(dw_c, _add(aq, wxj))
            else:
                dv[l] = _add(dv_c, _add(aq, _scale(wxj, 2.0)))
        f[l], n[l] = _link_force(robot, l, w[l], dw[l], dv[l])
    for l in range(L - 1, 0, -1):  # f[l], n[l] become the totals of l's subtree
        par = robot.parent[l]
        f_p = _rot(Rl[l], f[l])
        f[par] = _add(f[par], f_p)
        n[par] = _add(n[par], _add(_rot(Rl[l], n[l]), _cross(tl[l], f_p)))

    gq, gqdd = [zero] * D, [zero] * D
    gqd = [robot.damping[d] * lam[d] if use_damping else zero for d in range(D)]
    fb, nb, wb, dwb, dvb, tb = ([z3] * L for _ in range(6))
    for l in range(1, L):  # the backward sweep's reverse, root -> tip: fb, nb of the totals
        par, jt, a = robot.parent[l], robot.joint_types[l], _vec3(robot.axis, l)
        R, t = Rl[l], tl[l]
        fb_l = _rot_t(R, _add(fb[par], _cross(nb[par], t)))  # f_p = R f and t x f_p
        nb_l = _rot_t(R, nb[par])
        if jt == JOINT_REVOLUTE:
            d = ld[l]
            gq[d] = gq[d] + _dot(a, _add(_cross(f[l], fb_l), _cross(n[l], nb_l)))
            nb_l = _add(nb_l, _scale(a, lam[d]))
        elif jt == JOINT_PRISMATIC:
            tb[l] = _cross(_rot(R, f[l]), nb[par])
            fb_l = _add(fb_l, _scale(a, lam[ld[l]]))
        fb[l], nb[l] = fb_l, nb_l
    # the forward sweep's reverse, tip -> root: wb, dwb, dvb gather the
    # children's cotangents, then each link adds its force reverse
    for l in range(L - 1, 0, -1):
        par, jt, a = robot.parent[l], robot.joint_types[l], _vec3(robot.axis, l)
        R, t = Rl[l], tl[l]
        seeds = _link_force_vjp(robot, l, w[l], dw[l], fb[l], nb[l])
        wb[l], dwb[l], dvb[l] = (_add(x, y) for x, y in zip((wb[l], dwb[l], dvb[l]), seeds))
        if jt != JOINT_FIXED:  # qdd enters dw (revolute) or dv (prismatic) along a
            gqdd[ld[l]] = _dot(a, dwb[l] if jt == JOINT_REVOLUTE else dvb[l])
        w_c, dw_c, dv_c = _motion(R, t, w[par], dw[par], dv[par])
        wcb, dwcb, dvcb = wb[l], dwb[l], dvb[l]
        if jt != JOINT_FIXED:
            d = ld[l]
            j = _scale(a, qd_l[l])
            if jt == JOINT_REVOLUTE:
                jb = _add(wb[l], _cross(dwb[l], w_c))
                wcb = _add(wb[l], _cross(j, dwb[l]))
                gq[d] = gq[d] + _dot(a, _add(_add(_cross(wcb, w_c), _cross(dwcb, dw_c)),
                                             _cross(dvcb, dv_c)))
            else:
                jb = _scale(_cross(dvb[l], w_c), 2.0)
                wcb = _add(wb[l], _scale(_cross(j, dvb[l]), 2.0))
            gqd[d] = gqd[d] + _dot(a, jb)
        accb = _rot(R, dvcb)
        c2b = _cross(accb, w[par])
        wb[par] = _add(wb[par], _add(_rot(R, wcb), _add(_cross(_cross(w[par], t), accb),
                                                         _cross(t, c2b))))
        dwb[par] = _add(dwb[par], _add(_rot(R, dwcb), _cross(t, accb)))
        dvb[par] = _add(dvb[par], accb)
        if jt == JOINT_PRISMATIC:
            tbl = _add(tb[l], _add(_cross(accb, dw[par]), _cross(c2b, w[par])))
            d = ld[l]
            gq[d] = gq[d] + _dot(_rot(R, _vec3(robot.axis, l)), tbl)
    if D == 0:
        return torch.zeros((0,) + tuple(q.shape[1:]), dtype=q.dtype, device=q.device)
    return torch.stack(gq + gqd + (gqdd if with_qdd else []))


def _rot_symm_rot_t(R, I6):
    """R @ I @ R^T for symmetric I (6-tuple), returning the 6-tuple."""
    rows = [_symm(I6, (R[3 * i], R[3 * i + 1], R[3 * i + 2])) for i in range(3)]

    def entry(i, j):
        return rows[i][0] * R[3 * j] + rows[i][1] * R[3 * j + 1] + rows[i][2] * R[3 * j + 2]

    return (entry(0, 0), entry(0, 1), entry(0, 2), entry(1, 1), entry(1, 2), entry(2, 2))


def _dof_chains(robot: RobotStruct):
    """Per dof, the dofs on its link's root chain (itself first)."""
    dof_of = list(robot.dof_links)
    chains = []
    for l in dof_of:
        chain, k = [], l
        while k != 0:
            if robot.joint_types[k] != JOINT_FIXED:
                chain.append(dof_of.index(k))
            k = robot.parent[k]
        chains.append(chain)
    return chains


def mass_matrix_scalar(robot: RobotStruct, q: torch.Tensor) -> torch.Tensor:
    """Joint-space inertia matrix H(q): [D, D] (or [D, D, B...] for dof-major
    q [D, B...]), world-frame composite-rigid-body algorithm on lanes."""
    L, D = robot.n_links, robot.n_dofs
    zero = torch.zeros(q.shape[1:], dtype=q.dtype, device=q.device)
    Rw, pw = _world_poses_scalar(robot, q)

    # Per-link composite parameters about the world origin: m, h = m c_w,
    # I_o = I_cw + m (|c|^2 E - c c^T); composites accumulate child -> parent.
    m_c, h_c, I_c = [zero] * L, [(zero,) * 3] * L, [(zero,) * 6] * L
    for l in range(L):
        m = robot.mass[l]
        cw = _add(pw[l], _rot(Rw[l], _vec3(robot.com, l)))
        icw = _rot_symm_rot_t(Rw[l], _inertia6(robot, l))
        cx, cy, cz = cw
        I_c[l] = (
            icw[0] + m * (cy * cy + cz * cz),
            icw[1] - m * cx * cy,
            icw[2] - m * cx * cz,
            icw[3] + m * (cx * cx + cz * cz),
            icw[4] - m * cy * cz,
            icw[5] + m * (cx * cx + cy * cy),
        )
        m_c[l] = m + zero
        h_c[l] = _scale(cw, m)
    for l in range(L - 1, 0, -1):
        par = robot.parent[l]
        m_c[par] = m_c[par] + m_c[l]
        h_c[par] = _add(h_c[par], h_c[l])
        I_c[par] = tuple(a + b for a, b in zip(I_c[par], I_c[l]))

    # World joint subspaces (about the world origin), F_j = Ic_j S_j and
    # H_ij = <S_i, F_j> for i on j's root chain.
    S_w = []
    for l in robot.dof_links:
        z = _rot(Rw[l], _vec3(robot.axis, l))
        if robot.joint_types[l] == JOINT_REVOLUTE:
            S_w.append((z, _cross(pw[l], z)))
        else:
            S_w.append(((zero, zero, zero), z))
    rows = [[zero] * D for _ in range(D)]
    for j, chain in enumerate(_dof_chains(robot)):
        lj = robot.dof_links[j]
        wv, vv = S_w[j]
        n = _add(_symm(I_c[lj], wv), _cross(h_c[lj], vv))
        f = _sub(_scale(vv, m_c[lj]), _cross(h_c[lj], wv))
        for i in chain:
            wi, vi = S_w[i]
            rows[i][j] = rows[j][i] = _dot(wi, n) + _dot(vi, f)
    if D == 0:
        return torch.zeros((0, 0) + tuple(q.shape[1:]), dtype=q.dtype, device=q.device)
    return torch.stack([torch.stack(r) for r in rows])


def ldl_factor(H):
    """Unrolled LDL^T of the symmetric positive-definite H ([D][D] nested
    lists or a [D, D, B...] tensor): (L as nested lists, strictly lower
    entries set, d)."""
    D = len(H)
    L_ = [[None] * D for _ in range(D)]
    d = [None] * D
    for j in range(D):
        s = H[j][j]
        for k in range(j):
            s = s - L_[j][k] * L_[j][k] * d[k]
        d[j] = s
        inv_dj = 1.0 / s
        for i in range(j + 1, D):
            s2 = H[i][j]
            for k in range(j):
                s2 = s2 - L_[i][k] * L_[j][k] * d[k]
            L_[i][j] = s2 * inv_dj
    return L_, d


def ldl_back(L_, d, b):
    """Solve L D L^T x = b with the factor of `ldl_factor` (b indexable by dof)."""
    D = len(d)
    z = [None] * D
    for i in range(D):
        s = b[i]
        for k in range(i):
            s = s - L_[i][k] * z[k]
        z[i] = s
    x = [None] * D
    for i in range(D - 1, -1, -1):
        s = z[i] / d[i]
        for k in range(i + 1, D):
            s = s - L_[k][i] * x[k]
        x[i] = s
    return x


def ldl_solve_scalar(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve H x = b for symmetric positive-definite H: [D, D], b: [D] (or
    trailing-batched H [D, D, B...], b [D, B...], whose batch dims
    broadcast): fully unrolled LDL^T, no sqrt, no pivoting."""
    out_dtype = H.dtype
    compute = torch.promote_types(out_dtype, torch.float32)
    H, b = H.to(compute), b.to(compute)
    L_, d = ldl_factor(H)
    return torch.stack(ldl_back(L_, d, b)).to(out_dtype)


def forward_dynamics_scalar(
    robot: RobotStruct,
    q: torch.Tensor,
    qd: torch.Tensor,
    f: torch.Tensor,
    include_gravity: bool = True,
    use_damping: bool = False,
    gravity: float = GRAVITY,
) -> torch.Tensor:
    """Forward dynamics qdd = H^-1 (f - nle): NLE by `rnea_scalar`, H by
    `mass_matrix_scalar`, the solve by the unrolled LDL^T."""
    nle = rnea_scalar(robot, q, qd, torch.zeros_like(q), include_gravity, use_damping, gravity)
    return ldl_solve_scalar(mass_matrix_scalar(robot, q), f - nle)
