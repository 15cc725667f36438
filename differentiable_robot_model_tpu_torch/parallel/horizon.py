"""Horizon-sharded Riccati factorization: the LQR backward pass spread over
the ranks of a mesh.

PyTorch counterpart of the JAX package's `parallel/horizon.py`. The LQR
backward pass is a reverse composition of conditional value-function
elements (`trajopt.solvers.riccati_combine`, associative), so it runs over
ranks as a suffix scan does:

  1. the H+1 stage elements (`riccati_stage_elements`) are padded with the
     composition's identity (A = I, b = 0, C = 0, eta = 0, J = 0) so that
     every rank holds a contiguous block of equal length (any H, any
     number of ranks);
  2. each rank runs the reverse `trajopt.rollout.associative_scan` over its
     block;
  3. one `all_gather` of the block totals (five small tensors a rank);
  4. each rank folds the totals of the later blocks, last first, and
     composes that suffix onto its local suffixes (the last block has none);
  5. the suffixes shift by one (V_{k+1} for stage k) and each rank takes
     its stages' gains (`riccati_gains_from_suffix`); a second
     `all_gather` gives every rank the whole horizon's gains.

On one rank this is `_parallel_riccati_gains`'s arithmetic, op for op.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..trajopt.rollout import associative_scan
from ..trajopt.solvers import riccati_combine, riccati_gains_from_suffix, riccati_stage_elements

HORIZON_AXIS = "horizon"


def _identity_elements(k: int, like):
    """k identity elements shaped as the elements `like` beyond axis 0."""
    A = like[0]
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device).expand((k,) + A.shape[1:])
    return tuple(eye if i == 0 else torch.zeros((k,) + e.shape[1:], dtype=e.dtype, device=e.device)
                 for i, e in enumerate(like))


def _all_gather(group, x: torch.Tensor, n: int) -> list[torch.Tensor]:
    out = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(out, x.contiguous(), group=group)
    return out


def riccati_gains_horizon_sharded(
    mesh: DeviceMesh,
    A, B, lx, lu, lxx, luu, lux, Vx, Vxx,
    axis_name: str = HORIZON_AXIS,
):
    """The distributed twin of `trajopt.solvers._parallel_riccati_gains`.

    The stage arrays are [H, ...] (with or without the port's scenario
    axis, [H, B, ...]) and the same on every rank of the 1-D `mesh` (any
    name of its axis serves, as the JAX package lets a 1-D mesh serve).
    Returns (ks [H, ..., m], Ks [H, ..., m, n]), whole on every rank, equal
    to the sequential Riccati recursion. The communication is two
    all-gathers: the block totals, and each block's gains.

    The all-gathers carry no gradient, so a call that would keep a graph
    (grad mode on and an input requiring grad, as in a graph-keeping
    `ilqr(riccati="horizon_sharded")`) raises before any collective rather
    than return gains cut from it; `riccati="parallel"` differentiates.
    """
    if mesh.ndim != 1:
        raise ValueError(f"the horizon mesh is 1-D, got {mesh.ndim} dimensions")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (A, B, lx, lu, lxx, luu, lux, Vx, Vxx)):
        raise ValueError("the horizon-sharded Riccati's all-gathers carry no gradient: run it "
                         "under torch.no_grad(), or use riccati='parallel' to differentiate")
    group, n_dev, me = mesh.get_group(), mesh.size(), mesh.get_local_rank()
    H = A.shape[0]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    combine = lambda ej, ei: riccati_combine(ej, ei, eye)

    elems = riccati_stage_elements(A, B, lx, lu, lxx, luu, lux, Vx, Vxx)  # [H+1, ...]
    pad = (-(H + 1)) % n_dev
    if pad:
        elems = tuple(torch.cat([e, i]) for e, i in zip(elems, _identity_elements(pad, elems)))
    Hb = elems[0].shape[0] // n_dev
    lo = me * Hb
    block = tuple(e[lo:lo + Hb] for e in elems)

    # 2. the reverse scan over this rank's block: suffix[j] composes j.. of it
    suffix = tuple(s.flip(0) for s in associative_scan(combine, tuple(e.flip(0) for e in block), 0))
    # 3. every block's total
    sizes = [s[0].numel() for s in suffix]
    flat = torch.cat([s[0].reshape(-1) for s in suffix])
    totals = [tuple(t.view_as(s[0]) for t, s in zip(g.split(sizes), suffix))
              for g in _all_gather(group, flat, n_dev)]
    # 4. the later blocks' composition, last first, as the JAX package folds it
    T = tuple(t[0] for t in _identity_elements(1, suffix))
    for i in range(n_dev - 1, me, -1):
        T = combine(T, totals[i])
    full = suffix if me == n_dev - 1 else combine(tuple(t.expand_as(s) for t, s in zip(T, suffix)),
                                                  suffix)
    # 5. V_{k+1} for each stage of the block (its last takes T), and the
    # gains of the block's stages before H; a block's rows past H stay 0
    n_stage = max(0, min(Hb, H - lo))
    P = torch.cat([full[4][1:], T[4][None]])[:n_stage]
    p = torch.cat([full[3][1:], T[3][None]])[:n_stage]
    sl = slice(lo, lo + n_stage)
    ks, Ks = riccati_gains_from_suffix(A[sl], B[sl], lu[sl], luu[sl], lux[sl], P, p)
    m, mn = math.prod(ks.shape[1:]), math.prod(Ks.shape[1:])
    rows = torch.zeros((Hb, m + mn), dtype=A.dtype, device=A.device)
    rows[:n_stage] = torch.cat([ks.reshape(n_stage, m), Ks.reshape(n_stage, mn)], dim=1)
    gains = torch.cat(_all_gather(group, rows, n_dev))[:H]
    return gains[:, :m].reshape((H,) + ks.shape[1:]), gains[:, m:].reshape((H,) + Ks.shape[1:])
