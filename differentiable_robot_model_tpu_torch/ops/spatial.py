"""Spatial (Plücker) vector algebra on stacked tensors, world-frame oriented.

PyTorch counterpart of the JAX package's `ops/spatial.py`. A spatial vector
is one (..., 6) tensor in Featherstone's [angular(3), linear(3)] order:
motion m = [omega, v], force f = [n, f]. The spatial inertia of a body with
mass m, COM c (from the reference point) and rotational inertia I_c about
the COM is

    I = [[ I_c + m c~ c~^T ,  m c~ ],
         [      -m c~      ,  m 1  ]].
"""

from __future__ import annotations

import torch

from .lie import cross, skew


def _matvec(R: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return torch.einsum("...ij,...j->...i", R, x)


def motion_cross_motion(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Spatial cross product m1 x m2 (crm); (..., 6) x (..., 6) -> (..., 6)."""
    w1, v1 = a[..., :3], a[..., 3:]
    w2, v2 = b[..., :3], b[..., 3:]
    return torch.cat([cross(w1, w2), cross(w1, v2) + cross(v1, w2)], dim=-1)


def motion_cross_force(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial cross product m x* f (crf)."""
    w, v = m[..., :3], m[..., 3:]
    n, fl = f[..., :3], f[..., 3:]
    return torch.cat([cross(w, n) + cross(v, fl), cross(w, fl)], dim=-1)


def spatial_inertia_matrix(mass: torch.Tensor, com: torch.Tensor, inertia_com: torch.Tensor):
    """The (..., 6, 6) spatial inertia about a reference point from the mass
    (...,), the COM (..., 3) relative to the point and the rotational inertia
    about the COM (..., 3, 3), both in the frame the result lives in."""
    c_skew = skew(com)
    m = mass[..., None, None]
    i_o = inertia_com + m * (c_skew @ c_skew.transpose(-1, -2))
    mc = m * c_skew
    eye = torch.eye(3, dtype=inertia_com.dtype, device=inertia_com.device).expand(c_skew.shape)
    top = torch.cat([i_o, mc], dim=-1)
    bot = torch.cat([-mc, m * eye], dim=-1)
    return torch.cat([top, bot], dim=-2)


def inertia_times_motion(mass, com, inertia_com, m_vec: torch.Tensor) -> torch.Tensor:
    """I @ m without the 6x6: n = I_o w + m c x v, f = m v - m c x w, with
    I_o = I_c + m c~ c~^T."""
    w, v = m_vec[..., :3], m_vec[..., 3:]
    mc = mass[..., None] * com
    c_skew = skew(com)
    i_o = inertia_com + mass[..., None, None] * (c_skew @ c_skew.transpose(-1, -2))
    n = _matvec(i_o, w) + cross(mc, v)
    f = mass[..., None] * v - cross(mc, w)
    return torch.cat([n, f], dim=-1)


def motion_dot_force(m: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Power pairing <m, f> = w.n + v.f."""
    return (m * f).sum(-1)


def motion_to_world(R: torch.Tensor, p: torch.Tensor, m_local: torch.Tensor) -> torch.Tensor:
    """A motion vector in frame (R, p) re-expressed at the world origin:
    omega_w = R omega, v_w = R v + p x omega_w."""
    w = _matvec(R, m_local[..., :3])
    return torch.cat([w, _matvec(R, m_local[..., 3:]) + cross(p, w)], dim=-1)


def force_to_world(R: torch.Tensor, p: torch.Tensor, f_local: torch.Tensor) -> torch.Tensor:
    """A force vector in frame (R, p) re-expressed at the world origin:
    f_w = R f, n_w = R n + p x f_w."""
    f = _matvec(R, f_local[..., 3:])
    return torch.cat([_matvec(R, f_local[..., :3]) + cross(p, f), f], dim=-1)


def force_at_point(f_world: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A world-origin force vector with its moment re-referenced to point p:
    n_p = n_w - p x f."""
    return torch.cat([f_world[..., :3] - cross(p, f_world[..., 3:]), f_world[..., 3:]], dim=-1)


def transform_compose(R1, p1, R2, p2):
    """(R1, p1) o (R2, p2) = (R1 R2, R1 p2 + p1)."""
    return R1 @ R2, _matvec(R1, p2) + p1


def transform_inverse(R: torch.Tensor, p: torch.Tensor):
    """The inverse rigid transform (R^T, -R^T p)."""
    Rt = R.transpose(-1, -2)
    return Rt, -_matvec(Rt, p)


def transform_apply(R: torch.Tensor, p: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """R x + p for points x."""
    return _matvec(R, x) + p
