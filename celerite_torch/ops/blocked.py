"""Two-level block-parallel solver in plain torch, differentiable by autograd.

Port of ``celerite_tpu/ops/blocked.py``: ``gp_log_likelihood`` (l.82-447)
and the facade's ``factor``, ``solve_lower``, ``solve``, ``dot_L`` and
``matmul`` (l.272-562), which ``solver.CholeskySolver`` takes at
``method="blocked"``.  The time axis is cut into B blocks of L steps; each
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
           "with_blocked_backward", "factor", "solve_lower", "solve",
           "dot_L", "matmul"]

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


# ---------------------------------------------------------------------------
# The factor, solves and products of the facade (blocked.py:272-562).
# Right-hand sides are (N,) or (N, K); the K columns run side by side (the
# JAX package vmaps over them).
# ---------------------------------------------------------------------------


def _unlay(x, n):
    """Time-major ``(L, K, B)`` -> ``(N, K)``: point ``l L + i`` is ``x[i,
    :, l]`` (the inverse of :func:`_time_major`'s layout, padding cut)."""
    L, k, b = x.shape
    return x.permute(2, 0, 1).reshape(b * L, k)[:n]


def _lay(x, b, L):
    """``(N, K)`` -> time-major ``(L, K, B)``, zero padded."""
    n, k = x.shape
    x = torch.cat([x, x.new_zeros(b * L - n, k)])
    return x.reshape(b, L, k).permute(1, 2, 0)


def factor(ssm: SSM, block_size=None):
    """Block-parallel K = L D L^T, exact (matches ``seq.factor``); returns
    ``seq.FactorResult``.

    Passes 1-2 of :func:`gp_log_likelihood` and the prefix between them.
    On the card at padded width 1-16 they are the three-pass kernels'
    ``pallas_solver.elements_cuda`` and ``factor_cuda`` (rows 12-13 of
    PERF.md's table), whose pivots d and gains w are un-laid to ``(N,)``
    and ``(N, P)``; otherwise (a jitter-only model, above width 16, and
    on the CPU) the plain passes.
    """
    from . import pallas_solver
    from .seq import FactorResult

    n, p = ssm.U.shape
    L = block_size or default_block_size(n, ssm.U.device)
    u, v, ph, a, y, b = _pad_blocks(ssm, ssm.A.new_zeros(n), L)
    if ssm.U.device.type == "cuda" and 0 < p <= pallas_solver.MAX_WIDTH:
        elements, factor_pass = pallas_solver.elements, pallas_solver.factor
    else:
        elements, factor_pass = _block_elements, _block_factor
    sh0 = fused4.prefix_sh0(*elements(u, v, ph, a), b)
    d, w, _, _ = factor_pass(sh0, u, v, ph, a, y)
    D = _unlay(d, n)[:, 0]
    W = _unlay(w, n)
    ok = torch.all(D > 0) & torch.all(torch.isfinite(D))
    return FactorResult(D=D, W=W, ok=ok)


def _block_solve_maps(u, ph, w, y):
    """Each block's affine map ``h -> M h + m`` of the forward substitution
    ``h_n = (I - w_n u_n^T) Phi_n h_{n-1} + w_n y_n``: ``M (P, P, B)`` and
    ``m (P, K, B)`` for ``y (L, K, B)``."""
    L, p, b = u.shape
    M = fused4._eye(p, b, u)
    m = y.new_zeros(p, y.shape[1], b)
    for i in range(L):
        PhM = ph[i][:, None, :] * M
        uPhM = torch.sum(u[i][:, None, :] * PhM, dim=0)
        M = PhM - w[i][:, None, :] * uPhM[None, :, :]
        mh = ph[i][:, None, :] * m
        z = y[i] - torch.sum(u[i][:, None, :] * mh, dim=0)
        m = mh + w[i][:, None, :] * z[None]
    return M, m


def _prefix_affine(M, m):
    """Each block's incoming state: the exclusive prefix of the affine maps
    over the blocks, ``M (P, P, B)`` and ``m (P, K, B)`` -> ``h (P, K, B)``
    in float64 (``fused4.prefix_h0`` with K offset columns)."""
    p, k, b = m.shape
    Mm = torch.cat([M.double().permute(2, 0, 1),
                    m.double().permute(2, 0, 1)], -1)[None]
    s = 1
    while s < b:
        c = Mm[:, s:, :, :p] @ Mm[:, :-s]
        c = torch.cat([c[..., :p], c[..., p:] + Mm[:, s:, :, p:]], -1)
        Mm = torch.cat([Mm[:, :s], c], 1)
        s *= 2
    h = fused4._exclusive(Mm[..., p:])[0]
    return h.permute(1, 2, 0)


def _block_forward_pass(u, ph, w, y, h0):
    """z of every step from each block's incoming state ``h0 (P, K, B)``:
    ``(L, K, B)``."""
    h = h0.to(u.dtype)
    zs = []
    for i in range(u.shape[0]):
        f = ph[i][:, None, :] * h
        z = y[i] - torch.sum(u[i][:, None, :] * f, dim=0)
        h = f + w[i][:, None, :] * z[None]
        zs.append(z)
    return torch.stack(zs)


def solve_lower(ssm: SSM, fact, y, block_size=None):
    """Solve L z = y, block-parallel.  y: (N,) or (N, K)."""
    Y = y[:, None] if y.ndim == 1 else y
    n, p = ssm.U.shape
    L = block_size or default_block_size(n, ssm.U.device)
    b = -(-n // L)
    # The zero padding follows the last point: what it computes is cut.
    u, ph, w = (_lay(x, b, L) for x in (ssm.U, ssm.phi, fact.W))
    yb = _lay(Y, b, L)
    M, m = _block_solve_maps(u, ph, w, yb)
    z = _unlay(_block_forward_pass(u, ph, w, yb, _prefix_affine(M, m)), n)
    return z[:, 0] if y.ndim == 1 else z


def solve(ssm: SSM, fact, y, block_size=None):
    """Solve K x = y, block-parallel (``seq.solve`` analog).

    The backward substitution ``x_n = z_n - W_n^T g_n``, ``g_n =
    Phi_{n+1}(g_{n+1} + U_{n+1} x_{n+1})`` is :func:`solve_lower` on the
    index-reversed arrays with (U, W) swapped and phi shifted by one
    (blocked.py:472-498).
    """
    Y = y[:, None] if y.ndim == 1 else y
    z = solve_lower(ssm, fact, Y, block_size) / fact.D[:, None]
    phi_next = torch.cat([ssm.phi[1:], torch.ones_like(ssm.phi[:1])])
    ssm_rev = SSM(U=fact.W.flip(0), V=ssm.V.flip(0), phi=phi_next.flip(0),
                  A=ssm.A.flip(0))
    fact_rev = fact._replace(W=ssm.U.flip(0), D=fact.D.flip(0))
    x = solve_lower(ssm_rev, fact_rev, z.flip(0), block_size).flip(0)
    return x[:, 0] if y.ndim == 1 else x


def _diag_affine_scan(phi, b, reverse=False):
    """All of ``f_n = phi_n * f_{n-1} + b_n`` (a diagonal transition) by
    Hillis-Steele rounds over the N axis: log2(N) rounds of vectorised
    compositions ``(a2 a1, a2 b1 + b2)``.  ``phi`` is ``(N, P)``, ``b``
    ``(N, P)`` or ``(N, P, K)``; ``reverse`` runs from the other end.  The
    running products of phi are only ever multiplied, never divided by, so
    their underflow to 0 is harmless (a cumprod-and-divide form is not)."""
    if reverse:
        return _diag_affine_scan(phi.flip(0), b.flip(0)).flip(0)
    a = phi if b.ndim == phi.ndim else phi[..., None]
    x = b
    s = 1
    while s < x.shape[0]:
        x = torch.cat([x[:s], a[s:] * x[:-s] + x[s:]])
        a = torch.cat([a[:s], a[s:] * a[:-s]])
        s *= 2
    return x


def dot_L(ssm: SSM, fact, z, block_size=None):
    """L sqrt(D) z, parallel (``seq.dot_L`` analog): the carry has a
    diagonal transition, so one scan.  z: (N,) or (N, K)."""
    Z = z[:, None] if z.ndim == 1 else z
    t = torch.sqrt(fact.D)[:, None] * Z
    w_prev = torch.cat([torch.zeros_like(fact.W[:1]), fact.W[:-1]])
    t_prev = torch.cat([torch.zeros_like(t[:1]), t[:-1]])
    # f_n = phi_n (f_{n-1} + W_{n-1} t_{n-1})
    f = _diag_affine_scan(ssm.phi, (ssm.phi * w_prev)[..., None]
                          * t_prev[:, None, :])
    y = t + torch.sum(ssm.U[..., None] * f, dim=1)
    return y[:, 0] if z.ndim == 1 else y


def matmul(ssm: SSM, z, block_size=None):
    """K @ z, parallel (``seq.matmul`` analog): two scans.  z: (N,) or
    (N, K)."""
    Z = z[:, None] if z.ndim == 1 else z
    v_prev = torch.cat([torch.zeros_like(ssm.V[:1]), ssm.V[:-1]])
    z_prev = torch.cat([torch.zeros_like(Z[:1]), Z[:-1]])
    g = _diag_affine_scan(ssm.phi, (ssm.phi * v_prev)[..., None]
                          * z_prev[:, None, :])
    y_low = torch.sum(ssm.U[..., None] * g, dim=1)
    phi_next = torch.cat([ssm.phi[1:], torch.ones_like(ssm.phi[:1])])
    u_next = torch.cat([ssm.U[1:], torch.zeros_like(ssm.U[:1])])
    z_next = torch.cat([Z[1:], torch.zeros_like(Z[:1])])
    h = _diag_affine_scan(phi_next, (phi_next * u_next)[..., None]
                          * z_next[:, None, :], reverse=True)
    y_up = torch.sum(ssm.V[..., None] * h, dim=1)
    y = ssm.A[:, None] * Z + y_low + y_up
    return y[:, 0] if z.ndim == 1 else y
