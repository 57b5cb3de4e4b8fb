"""Two-level block-parallel solver in plain torch, differentiable by autograd.

Port of the parts of ``celerite_tpu/ops/blocked.py`` that
``gp_log_likelihood`` needs (l.82-447; ``factor``, ``solve_lower``,
``solve``, ``dot_L`` and ``matmul`` belong to the GP facade, ROADMAP
queue 1 item 10).  The time axis is cut into B blocks of L steps; each
block runs the sequential recursion locally and the P-dimensional
coupling between blocks is composed exactly by prefixes over the blocks,
in three passes (see that module's docstring for the algebra):

1. each block's Riccati element (A, J, C) from a zero seed
   (:func:`_block_elements`), and the exclusive prefix of the elements,
   whose C is each block's incoming S-hat;
2. the seeded factor, its pivots d and gains w, and the block's affine
   forward-substitution map (M, m) (:func:`_block_factor`), and the
   exclusive prefix of the maps, each block's incoming state h;
3. the forward substitution with Kahan-compensated quad and log-det and
   the minimum pivot (:func:`_block_subst`).

Layout: the JAX package vmaps each pass over ``(B, L, P)`` blocks; here
the passes run on the time-major ``(L, P, B)`` streams of
``pallas_solver`` (step ``i`` of block ``l`` at ``[i, :, l]``), a Python
loop over the L steps with the blocks vectorised.  So they are also the
plain versions of the three ``pallas_solver`` kernels: one copy of the
arithmetic serves both.  ``_pad_blocks`` is the counterpart of both
``blocked._pad_blocks`` (l.90) and ``pallas_solver._to_blocked_layout``
(pallas_solver.py:38).

The cross-block prefixes are ``fused4.prefix_sh0`` and
``fused4.prefix_h0``: the segmented Hillis-Steele rounds over
``fused4._compose`` (the counterpart of ``_compose_full``, l.153, with
``torch.linalg.inv_ex`` for ``_small_inv``) and over the affine maps
(``_affine_compose``, l.316), run in float64 whatever the streams' dtype.
They return only what the passes consume (C of each exclusive prefix
element, m of each exclusive prefix map), where ``_exclusive_prefix_
elements`` (l.234) and ``_exclusive_prefix_affine`` (l.325) return the
whole elements.  The per-block sums of pass 3 leave in float64 (the
Kahan pair summed in float64); the JAX package returns them in the
streams' dtype.
"""

from __future__ import annotations

import math

import torch

from . import fused4
from .lower import SSM

__all__ = ["default_block_size", "gp_log_likelihood",
           "with_blocked_backward"]

# Steps a block on the card: the fastest L of 64-2048 for config[2] with
# three oscillation modes (P = 16) at N = 1e5 in chip_smoke.py's
# lane_sweep_F (PERF.md): the plain passes launch a few dozen kernels a
# step, so the time grows with L.
_CUDA_BLOCK = 64


def default_block_size(n, device="cpu"):
    """Steps a block L for an ``n``-point series: on the card
    ``_CUDA_BLOCK``; on the CPU the JAX package's rule (l.82), so that
    the two packages compare at the same L."""
    if torch.device(device).type == "cuda":
        return _CUDA_BLOCK
    if n <= 4096:
        return max(16, n // 16)
    return 256


def _time_major(ssm: SSM, resid, b, L):
    """Pad to ``b * L`` points with inert rows (A = 1, U = V = 0, phi = 1,
    y = 0) and lay out time-major ``(L, P, B)``, block ``l`` owning points
    ``[l L, (l + 1) L)``; returns ``(u, v, ph, a, y)``, ``a`` and ``y``
    ``(L, 1, B)``."""
    n, p = ssm.U.shape
    pad = b * L - n
    U, V, phi, A = ssm.U, ssm.V, ssm.phi, ssm.A
    if pad:
        zero = U.new_zeros(pad, p)
        U = torch.cat([U, zero])
        V = torch.cat([V, zero])
        phi = torch.cat([phi, torch.ones_like(zero)])
        A = torch.cat([A, A.new_ones(pad)])
        resid = torch.cat([resid, resid.new_zeros(pad)])

    def tm(x):  # (B*L, p) -> (L, p, B)
        return x.reshape(b, L, p).permute(1, 2, 0).contiguous()

    def tm1(x):  # (B*L,) -> (L, 1, B)
        return x.reshape(b, L).T[:, None, :].contiguous()

    return tm(U), tm(V), tm(phi), tm1(A), tm1(resid)


def _pad_blocks(ssm: SSM, resid, L):
    """:func:`_time_major` on ``B = ceil(n / L)`` blocks of ``L`` steps (B
    need not be a power of two); returns ``(u, v, ph, a, y, B)``."""
    b = -(-ssm.U.shape[0] // L)
    return (*_time_major(ssm, resid, b, L), b)


def _kahan_add(s, c, x):
    """One compensated-summation step; returns (new_sum, new_compensation)."""
    y = x - c
    t = s + y
    return t, (t - s) - y


def _block_elements(u, v, ph, a, saves=None):
    """Pass 1: each block's Riccati element ``(A, J, C)``, each ``(P, P,
    B)`` (pallas_solver.py:62): C by the zero-seeded factor recursion, A
    as a product of closed-loop transitions ``(I - w u^T) Phi``, J as a
    sum of rank-1 terms (l.172-231 for why).  With a list ``saves``, each
    step's input ``(C, A)`` is appended to it (``adjoint``'s saves)."""
    L, p, b = u.shape
    A = fused4._eye(p, b, u)
    J = torch.zeros_like(A)
    C = torch.zeros_like(A)
    for i in range(L):
        if saves is not None:
            saves.append((C, A))
        C, d, w = fused4._riccati(C, u[i], v[i], ph[i], a[i])
        ut = ph[i] * u[i]
        uAc = torch.sum(A * ut[:, None, :], dim=0)
        A = ph[i][:, None, :] * A - w[:, None, :] * uAc[None, :, :]
        J = J - uAc[:, None, :] * (uAc / d)[None, :, :]
    return A, J, C


def _block_factor(sh0, u, v, ph, a, y):
    """Pass 2 (pallas_solver.py:114): the factor seeded by ``sh0 (P, P,
    B)``, with the pivots ``d (L, 1, B)`` and gains ``w (L, P, B)``, and
    the block's affine map ``h -> M h + m``, ``M (P, P, B)``, ``m (P,
    B)``."""
    L, p, b = u.shape
    Sh = sh0.to(u.dtype)
    M = fused4._eye(p, b, u)
    m = torch.zeros_like(u[0])
    ds, ws = [], []
    for i in range(L):
        Sh, d, w = fused4._riccati(Sh, u[i], v[i], ph[i], a[i])
        PhM = ph[i][:, None, :] * M
        uPhM = torch.sum(u[i][:, None, :] * PhM, dim=0)
        M = PhM - w[:, None, :] * uPhM[None, :, :]
        mh = ph[i] * m
        m = mh - w * torch.sum(u[i] * mh, dim=0, keepdim=True) + w * y[i]
        ds.append(d)
        ws.append(w)
    return torch.stack(ds), torch.stack(ws), M, m


def _block_subst(h0, u, ph, w, y, d):
    """Pass 3 (pallas_solver.py:154): forward substitution from each
    block's incoming state ``h0 (P, B)``; returns the Kahan-compensated
    ``quad`` and ``logdet`` in float64 and the minimum pivot, each
    ``(B,)``."""
    L = u.shape[0]
    h = h0.to(u.dtype)
    quad = cq = logdet = cl = torch.zeros_like(d[0, 0])
    mind = torch.full_like(quad, math.inf)
    for i in range(L):
        f = ph[i] * h
        z = y[i, 0] - torch.sum(u[i] * f, dim=0)
        h = f + w[i] * z
        di = d[i, 0]
        quad, cq = _kahan_add(quad, cq, z * z / di)
        logdet, cl = _kahan_add(logdet, cl, torch.log(di))
        mind = torch.minimum(mind, di)
    return quad.double() + cq.double(), logdet.double() + cl.double(), mind


_PLAIN_PASSES = (_block_elements, _block_factor, _block_subst)


def _solve(passes, u, v, ph, a, y, n):
    """``(ll, ok)`` from blocked ``(L, P, B)`` streams through ``passes``
    (the three passes, plain or the kernels), the prefixes in float64
    between them; ``n`` is the unpadded point count."""
    elements, factor, subst = passes
    b = u.shape[-1]
    sh0 = fused4.prefix_sh0(*elements(u, v, ph, a), b)
    d, w, M, m = factor(sh0, u, v, ph, a, y)
    quad, logdet, mind = subst(fused4.prefix_h0(M, m, b), u, ph, w, y, d)
    ll = -0.5 * (quad.sum() + logdet.sum() + n * math.log(2.0 * math.pi))
    ok = (mind.min() > 0) & torch.isfinite(ll.detach())
    return torch.where(ok, ll, -math.inf).to(u.dtype), ok


def gp_log_likelihood(ssm: SSM, resid, block_size=None):
    """``(ll, ok)`` for an SSM (``lower.lower``'s output) and residuals,
    the same semantics as ``seq.gp_log_likelihood``; ``block_size`` is L
    (default :func:`default_block_size`).  Differentiable with autograd;
    runs on the tensors' device."""
    n = ssm.U.shape[0]
    L = block_size or default_block_size(n, ssm.U.device)
    u, v, ph, a, y, _ = _pad_blocks(ssm, resid, L)
    return _solve(_PLAIN_PASSES, u, v, ph, a, y, n)


class _BlockedBackward(torch.autograd.Function):
    """``(U, V, phi, A, resid) -> (ll, ok)``: the forward a given function,
    the backward autograd through :func:`gp_log_likelihood`."""

    @staticmethod
    def forward(ctx, forward, block_size, U, V, phi, A, resid):
        ctx.block_size = block_size
        ctx.save_for_backward(U, V, phi, A, resid)
        ll, ok = forward(SSM(U, V, phi, A), resid)
        ctx.mark_non_differentiable(ok)
        return ll, ok

    @staticmethod
    def backward(ctx, gll, _gok):
        xs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            ll, _ = gp_log_likelihood(SSM(*xs[:4]), xs[4], ctx.block_size)
        grads = torch.autograd.grad(ll, xs, gll)
        return (None, None, *(g if need else None for g, need in
                              zip(grads, ctx.needs_input_grad[2:])))


def with_blocked_backward(forward, ssm: SSM, resid, block_size=None):
    """``forward(ssm, resid) -> (ll, ok)`` (kernels, no autograd rule) with
    the backward of :func:`gp_log_likelihood` at ``block_size``: the
    counterpart of the JAX package's ``custom_vjp`` over its Pallas
    primals (pallas_solver.py:347-380, fused.py:386-397), one recomputed
    forward and its reverse pass."""
    return _BlockedBackward.apply(forward, block_size, *ssm, resid)
