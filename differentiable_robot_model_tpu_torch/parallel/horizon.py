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

The gradient (`_HorizonShardedRiccati`) recomputes the rank's block with
autograd on and makes two `all_reduce` sums. The gains gather's backward
is the rank's own rows of the cotangent, which every rank holds whole. A
block total reaches the gains of every earlier block, so the first sum
adds up, over the ranks, the cotangents that each holds for each block's
total, and each rank takes its own block's. The stage arrays are the same
on every rank, so the second sums the ranks' partial gradients of them:
the whole gradient, equal on every rank.
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


def _combine(stage):
    eye = torch.eye(stage[0].shape[-1], dtype=stage[0].dtype, device=stage[0].device)
    return lambda ej, ei: riccati_combine(ej, ei, eye)


def _block_suffix(stage, n_dev: int, me: int):
    """Steps 1-2: this rank's suffixes (suffix[j] composes j.. of its block),
    the block's first element index and its length."""
    H = stage[0].shape[0]
    elems = riccati_stage_elements(*stage)  # [H+1, ...]
    pad = (-(H + 1)) % n_dev
    if pad:
        elems = tuple(torch.cat([e, i]) for e, i in zip(elems, _identity_elements(pad, elems)))
    Hb = elems[0].shape[0] // n_dev
    lo = me * Hb
    block = tuple(e[lo:lo + Hb] for e in elems)
    suffix = associative_scan(_combine(stage), tuple(e.flip(0) for e in block), 0)
    return tuple(s.flip(0) for s in suffix), lo, Hb


def _total(suffix) -> torch.Tensor:
    """The block's total, flat."""
    return torch.cat([s[0].reshape(-1) for s in suffix])


class _SymmetricGrad(torch.autograd.Function):
    """The identity, whose backward keeps the symmetric part of the
    cotangent of a stack of square matrices."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        return 0.5 * (g + g.mT)


def _gain_rows(stage, suffix, totals, n_dev: int, me: int, lo: int):
    """Steps 4-5 on this rank, given every block's flat total (`totals`
    [n_dev, S]): the gains of the block's stages before H, one row each
    (ks, then Ks, flat).

    The JAX package composes the identity onto the last block's suffixes
    too, which leaves their values but symmetrises the cotangents of their
    J. That changes nothing where a J is a composition's output, which is
    symmetrised already, but the block's last element is the scan's input:
    where it is the terminal element (no padding), the antisymmetric part
    of the gradient w.r.t. Vxx follows. So the last rank symmetrises that
    one cotangent (`_SymmetricGrad`), and the values stay as they are."""
    A, B, _, lu, _, luu, lux, _, _ = stage
    combine = _combine(stage)
    sizes = [s[0].numel() for s in suffix]
    T = tuple(t[0] for t in _identity_elements(1, suffix))
    for i in range(n_dev - 1, me, -1):  # the later blocks' composition, last first
        T = combine(T, tuple(t.view_as(s[0]) for t, s in zip(totals[i].split(sizes), suffix)))
    if me < n_dev - 1:
        full = combine(tuple(t.expand_as(s) for t, s in zip(T, suffix)), suffix)
    else:
        J = suffix[4]
        full = suffix[:4] + (torch.cat([J[:-1], _SymmetricGrad.apply(J[-1:])]),)
    # V_{k+1} for each stage of the block (its last takes T)
    n_stage = max(0, min(suffix[0].shape[0], A.shape[0] - lo))
    P = torch.cat([full[4][1:], T[4][None]])[:n_stage]
    p = torch.cat([full[3][1:], T[3][None]])[:n_stage]
    sl = slice(lo, lo + n_stage)
    ks, Ks = riccati_gains_from_suffix(A[sl], B[sl], lu[sl], luu[sl], lux[sl], P, p)
    m, mn = (math.prod(s) for s in _gain_shapes(stage))
    return torch.cat([ks.reshape(n_stage, m), Ks.reshape(n_stage, mn)], dim=1)


def _gain_shapes(stage):
    """The shapes of one stage's ks and Ks."""
    B, lux = stage[1], stage[6]
    return B.shape[1:-2] + B.shape[-1:], lux.shape[1:]


def _forward(group, n_dev: int, me: int, stage):
    """(ks, Ks, every block's flat total [n_dev, S]), with the two all-gathers."""
    H = stage[0].shape[0]
    suffix, lo, Hb = _block_suffix(stage, n_dev, me)
    totals = torch.stack(_all_gather(group, _total(suffix), n_dev))
    rows = _gain_rows(stage, suffix, totals, n_dev, me, lo)
    k_shape, K_shape = _gain_shapes(stage)
    m = math.prod(k_shape)
    block = rows.new_zeros((Hb, m + math.prod(K_shape)))  # a block's rows past H stay 0
    block[:rows.shape[0]] = rows
    gains = torch.cat(_all_gather(group, block, n_dev))[:H]
    return gains[:, :m].reshape((H,) + k_shape), gains[:, m:].reshape((H,) + K_shape), totals


def _grad(outputs, inputs, grad_outputs, retain_graph=False):
    grads = torch.autograd.grad(outputs, inputs, grad_outputs, retain_graph=retain_graph,
                                allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(grads, inputs)]


class _HorizonShardedRiccati(torch.autograd.Function):
    """The sharded gains with their gradient w.r.t. the nine stage arrays.
    The forward is `_forward`; the backward recomputes the rank's block
    and issues the same two all-reduces on every rank, whatever its block
    holds (none of gains, or no later totals to fold).

    The backward is not differentiable, and raises under create_graph=True.
    `once_differentiable` would not do: its error node hangs off detached
    copies of the gradients, so a second-order `torch.autograd.grad` would
    leave the Riccati's terms out without a word."""

    @staticmethod
    def forward(ctx, group, n_dev, me, *stage):
        ks, Ks, totals = _forward(group, n_dev, me, stage)
        ctx.save_for_backward(*stage, totals)
        ctx.sharding = group, n_dev, me
        return ks, Ks

    @staticmethod
    def backward(ctx, g_ks, g_Ks):
        if torch.is_grad_enabled():  # the engine's grad mode is create_graph
            raise RuntimeError("the horizon-sharded Riccati differentiates once: its backward "
                               "takes no create_graph=True (riccati='parallel' does)")
        *stage, totals = ctx.saved_tensors
        group, n_dev, me = ctx.sharding
        H = stage[0].shape[0]
        with torch.enable_grad():
            leaves = [x.detach().requires_grad_() for x in stage]
            tot = totals.detach().requires_grad_()
            suffix, lo, _ = _block_suffix(leaves, n_dev, me)
            rows = _gain_rows(leaves, suffix, tot, n_dev, me, lo)
            g_rows = torch.cat([g_ks.reshape(H, -1), g_Ks.reshape(H, -1)], dim=1)[lo:lo + rows.shape[0]]
            d_tot, *d_rows = _grad(rows, [tot] + leaves, g_rows, retain_graph=True)
            d_tot = d_tot.contiguous()
            dist.all_reduce(d_tot, group=group)  # each block total's cotangent, over the ranks
            d_own = _grad(_total(suffix), leaves, d_tot[me])
        d = torch.cat([(a + b).reshape(-1) for a, b in zip(d_rows, d_own)])
        dist.all_reduce(d, group=group)  # the ranks' partial gradients of the stage arrays
        grads = [g.view_as(x) for g, x in zip(d.split([x.numel() for x in stage]), stage)]
        return (None, None, None) + tuple(g if need else None
                                          for g, need in zip(grads, ctx.needs_input_grad[3:]))


def _horizon_mesh(mesh: DeviceMesh, axis_name: str) -> DeviceMesh:
    """The 1-D mesh over `axis_name`: a 1-D mesh serves whatever its axis
    is called; a mesh of more dimensions gives its sub-mesh over that axis."""
    if mesh.ndim == 1:
        return mesh
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        raise KeyError(f"mesh has no '{axis_name}' axis (axes: {names})")
    return mesh[axis_name]


def riccati_gains_horizon_sharded(
    mesh: DeviceMesh,
    A, B, lx, lu, lxx, luu, lux, Vx, Vxx,
    axis_name: str = HORIZON_AXIS,
):
    """The distributed twin of `trajopt.solvers._parallel_riccati_gains`.

    The stage arrays are [H, ...] (with or without the port's scenario
    axis, [H, B, ...]) and the same on every rank of `mesh`. The horizon
    shards over the mesh's `axis_name` axis: a 1-D mesh serves whatever its
    axis is called; on a mesh of more dimensions every rank of the other
    axes runs its own replica over its sub-mesh `mesh[axis_name]`, and a
    mesh without that axis raises `KeyError`. Returns (ks [H, ..., m], Ks
    [H, ..., m, n]), whole on every rank, equal to the sequential Riccati
    recursion. The communication is two all-gathers: the block totals, and
    each block's gains.

    Differentiable w.r.t. all nine arrays, once (a backward under
    create_graph=True raises): a call that keeps a graph (grad mode on and an input
    requiring grad) adds two all-reduces to the backward, and the gradient
    is the whole one, equal on every rank. Every rank calls with the same
    arguments and the same `requires_grad` pattern, and differentiates the
    same loss of the gains. A call that keeps no graph saves nothing.
    """
    sub = _horizon_mesh(mesh, axis_name)
    group, n_dev, me = sub.get_group(), sub.size(), sub.get_local_rank()
    stage = (A, B, lx, lu, lxx, luu, lux, Vx, Vxx)
    if torch.is_grad_enabled() and any(t.requires_grad for t in stage):
        return _HorizonShardedRiccati.apply(group, n_dev, me, *stage)
    ks, Ks, _ = _forward(group, n_dev, me, stage)
    return ks, Ks
