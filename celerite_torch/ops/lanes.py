"""Lane-layout lowering: the adjoint kernels' (L, P, B) inputs, built
directly.

Port of ``celerite_tpu/ops/lanes.py:39-185``.  The adjoint pipeline
(:mod:`celerite_torch.ops.adjoint`) streams pre-lowered ``(L, P, B)``
arrays, step ``i`` of lane ``l`` at ``[i, :, l]``.  Everything about their
shape is static per dataset; only the coefficients change between
evaluations.  So :func:`make_plan` lays out the time grid, the spacings,
the double-single lo part of the grid, the mask, the variances and the
data once, on the host in float64, and :func:`lower_lanes` builds
``(U, V, phi, A)`` as elementwise broadcasts of the coefficients against
those arrays: torch ops, differentiated by autograd, or in forward mode
by :func:`lane_tangents` (the ``fast_grad="tangent"`` route).

Padding contract (``fused._to_lanes`` too): pad rows have dt = 0 (so
phi = 1 with no masking), U = V = 0 and A = 1, and y = 0 through the
static ``mask``.

A plan of ``n_chain`` chains tiles the dataset's ``B``-lane layout
``n_chain`` times along the lane axis (as ``lanes4.make_plan4`` does), so
one launch of each kernel serves a batch of parameter vectors; the
coefficients then carry a leading chain axis and the cross-lane glue is
segmented per chain.

The float32 transcendentals are evaluated in float64 and rounded once
(``ds.exp_rn``, ``ds.ds_cos_sin``), as in ``ops/lower.py``: the JAX
package's compensated ``accurate_exp`` exists for the TPU's ~30-ulp exp.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import ds
from .lanes4 import resolve_device
from .lower import Coefficients

__all__ = ["LanePlan", "make_plan", "lower_lanes", "basis_jvp",
           "lane_tangents", "gp_log_likelihood_jac"]


class LanePlan(NamedTuple):
    """Static per-dataset arrays, each ``(L, 1, B)``."""

    t: torch.Tensor      # time grid (hi part in float32)
    t_lo: torch.Tensor   # double-single lo part of the f64 grid
    dt: torch.Tensor     # exact spacings; 0 at the global start and on pad
    diag: torch.Tensor   # per-point variance (yerr^2), 0 on pad
    y: torch.Tensor      # data, 0 on pad
    mask: torch.Tensor   # 1.0 on real rows, 0.0 on pad
    n: int               # unpadded point count
    n_chain: int = 1     # chains tiled along the lanes


def _lane1(x, b, L):
    """(B*L,) host array -> (L, 1, B), lane l owning [l*L, (l+1)*L)."""
    return np.ascontiguousarray(np.asarray(x).reshape(b, L).T[:, None, :])


def make_plan(t, y, diag, num_blocks, dtype=torch.float32, n_chain=1,
              device=None) -> LanePlan:
    """Host-side plan construction from float64 inputs.

    ``num_blocks`` (lanes a chain) and ``n_chain`` must be powers of two.
    Spacings are differenced in float64; every lane's first row keeps its
    true spacing (lanes are seeded by the cross-lane prefix, not by
    resetting the recursion), so only the global first point and pad rows
    get dt = 0.  ``device`` defaults to ``cuda`` (raising without CUDA).
    """
    b, nc = int(num_blocks), int(n_chain)
    if b < 1 or b & (b - 1):
        raise ValueError("num_blocks must be a power of two")
    if nc < 1 or nc & (nc - 1):
        raise ValueError("n_chain must be a power of two")
    device = resolve_device(device)
    t = np.asarray(t, np.float64)
    n = t.shape[0]
    L = -(-n // b)
    pad = b * L - n

    def padded(x, fill):
        base = np.concatenate([np.asarray(x, np.float64),
                               np.full(pad, fill, np.float64)])
        return np.tile(base, nc)

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    t_pad = padded(t, t[-1] if n else 0.0)
    t_hi = t_pad.astype(np_dtype)
    streams = dict(
        t=t_hi,
        t_lo=t_pad - t_hi.astype(np.float64),
        dt=padded(np.concatenate([[0.0], np.diff(t)]), 0.0),
        diag=padded(np.broadcast_to(np.asarray(diag, np.float64), t.shape),
                    0.0),
        y=padded(y, 0.0),
        mask=padded(np.ones(n), 0.0),
    )
    return LanePlan(
        **{k: torch.as_tensor(_lane1(v.astype(np_dtype), b * nc, L),
                              device=device)
           for k, v in streams.items()},
        n=n, n_chain=nc,
    )


def _planes(x, b):
    """Coefficients ``(J,)`` -> ``(1, J, 1)``; one row a chain ``(nc, J)`` ->
    ``(1, J, B)``, chain c's row on its ``B / nc`` lanes."""
    if x.ndim == 1:
        return x[None, :, None]
    return torch.repeat_interleave(x.T, b // x.shape[0], dim=1)[None]


def _interleave(x0, x1):
    """Two ``(L, Jc, B)`` arrays -> ``(L, 2 Jc, B)``, rows x0[0], x1[0], ..."""
    L, jc, b = x0.shape
    return torch.stack([x0, x1], dim=2).reshape(L, 2 * jc, b)


def lower_lanes(coeffs: Coefficients, plan: LanePlan):
    """Elementwise ``(U, V, phi, A)`` in lane layout.

    Returns ``(u, v, ph, a)`` shaped ``(L, P, B)`` and ``(L, 1, B)``, P in
    the standard order (the real block, then interleaved complex pairs).
    The coefficient arrays are ``(J,)`` for one model or ``(n_chain, J)``
    (the jitter ``(n_chain,)``) for a chain-folded plan; they are cast to
    the plan's dtype.  Differentiable with autograd.
    """
    raw = [torch.as_tensor(c) for c in coeffs]
    # The diagonal total is summed in the coefficients' own precision and
    # rounded once, as in the JAX package.
    total = (raw[0].sum(-1) + raw[2].sum(-1) + raw[6]).to(plan.t)
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, _ = (
        c.to(plan.t) for c in raw)
    L, _, b = plan.t.shape
    jr, jc = a_real.shape[-1], a_comp.shape[-1]
    parts_u, parts_v, parts_p = [], [], []
    if jr:
        ar, cr = _planes(a_real, b), _planes(c_real, b)
        parts_u.append(ar * plan.mask)
        parts_v.append(plan.mask.expand(L, jr, b))
        parts_p.append(ds.exp_rn(-cr * plan.dt))
    if jc:
        ac, bc, cc, dc = (_planes(x, b) for x in (a_comp, b_comp, c_comp,
                                                    d_comp))
        cos, sin = ds.ds_cos_sin(*ds.reduced_angle(dc, plan.t, plan.t_lo))
        cos = cos * plan.mask
        sin = sin * plan.mask
        parts_u.append(_interleave(ac * cos + bc * sin, ac * sin - bc * cos))
        parts_v.append(_interleave(cos, sin))
        p_half = ds.exp_rn(-cc * plan.dt)
        parts_p.append(_interleave(p_half, p_half))
    u = torch.cat(parts_u, dim=1)
    v = torch.cat(parts_v, dim=1)
    ph = torch.cat(parts_p, dim=1)
    a = plan.mask * (plan.diag + _planes(total[..., None], b)) \
        + (1.0 - plan.mask)
    return u, v, ph, a



def basis_jvp(fn, theta):
    """``fn(theta)`` and its jvp along each basis direction of ``theta``'s
    last axis (for ``(n_chain, T)`` rows, direction ``k`` moves entry ``k``
    of every row): ``(value, tangents)``, every tangent leaf with a leading
    T axis.  One vmapped ``torch.func.jvp``, in which the value runs
    once."""
    dim = theta.shape[-1]
    eye = torch.eye(dim, dtype=theta.dtype, device=theta.device)
    dirs = eye if theta.ndim == 1 else eye[:, None, :].expand(dim,
                                                              *theta.shape)
    vals, tans = torch.func.vmap(
        lambda d: torch.func.jvp(fn, (theta,), (d,)))(dirs)
    return torch.utils._pytree.tree_map(lambda x: x[0], vals), tans


def lane_tangents(make_inputs, theta):
    """``make_inputs(theta) -> (u, v, ph, a, y)`` in lane layout and their
    tangents along ``theta``'s basis directions as ``(L, T, P, B)`` /
    ``(L, T, 1, B)`` streams (:func:`basis_jvp`)."""
    vals, tans = basis_jvp(make_inputs, theta)
    return tuple(vals), tuple(x.movedim(0, 1) for x in tans)


def gp_log_likelihood_jac(make_inputs, theta, plan_n, n_chain=1,
                          max_tangents=None):
    """Value and forward-mode gradient from a lane-layout input function
    (celerite_tpu/ops/lanes.py:164).

    ``make_inputs(theta) -> (u, v, ph, a, y)`` in lane layout.  The T basis
    directions of ``theta`` push through it in one vmapped
    ``torch.func.jvp`` (:func:`lane_tangents`; its value runs once) into
    the tangent streams of ``tangent.run_jac_kernel``.  ``theta`` is ``(T,)``, or ``(n_chain, T)`` rows of a chain-folded
    plan, direction ``k`` then moving entry ``k`` of every row (the
    chains' segments do not mix).  Returns ``(ll, ok, dll)`` as
    ``run_jac_kernel`` does.
    """
    from . import tangent

    streams, tangents = lane_tangents(make_inputs, theta)
    return tangent.run_jac_kernel(*streams, *tangents, plan_n,
                                  max_tangents=max_tangents,
                                  n_chain=n_chain)
