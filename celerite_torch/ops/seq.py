"""Sequential semiseparable solver: the oracle and the CPU small-N route.

Port of ``celerite_tpu/ops/seq.py:46-441`` (the reference's
Cholesky recursion, cholesky.h:41-698): the factor and the log-likelihood,
and the solves and products on a factor (``solve_lower``, ``solve``,
``dot_solve``, ``dot_L``, ``matmul``, ``predict_mean``) that the facade's
``CholeskySolver`` takes at ``method="scan"``.  A Python loop over the N steps replaces
``lax.scan``; every step is a handful of torch ops on (P,) / (P, P)
tensors, so autograd differentiates it directly.

Factorization: K = L D L^T with L = I + tril(U W~^T, -1):

    S_n = diag(phi_n) (S_{n-1} + D_{n-1} W_{n-1} W_{n-1}^T) diag(phi_n)
    D_n = A_n - U_n^T S_n U_n
    W_n = (V_n - S_n U_n) / D_n

Non-positive pivots become a boolean ``ok`` output instead of an exception;
callers turn them into -inf log-likelihoods (the reference's
``quiet=True`` semantics made total).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .lower import SSM

__all__ = ["FactorResult", "factor", "gp_log_likelihood",
           "gp_log_likelihood_masked", "solve_lower",
           "solve", "dot_solve", "dot_L", "matmul", "predict_mean"]


class FactorResult(NamedTuple):
    D: torch.Tensor  # (N,) Cholesky pivots
    W: torch.Tensor  # (N, P) scaled V rows
    ok: torch.Tensor  # scalar bool: all pivots positive and finite


def _factor_step(S, d_prev, w_prev, u, v, phi, a):
    """One step of the Cholesky recursion."""
    S = (phi[:, None] * phi[None, :]) * (
        S + d_prev * (w_prev[:, None] * w_prev[None, :])
    )
    su = S @ u
    d = a - u @ su
    w = (v - su) / d
    return S, d, w


def _init(ssm):
    p = ssm.U.shape[1]
    z = ssm.U.new_zeros(())
    return ssm.U.new_zeros((p, p)), z, ssm.U.new_zeros((p,))


def factor(ssm: SSM) -> FactorResult:
    """Factor K = L D L^T; O(N P^2) sequential loop."""
    S, d, w = _init(ssm)
    D, W = [], []
    for n in range(ssm.U.shape[0]):
        S, d, w = _factor_step(
            S, d, w, ssm.U[n], ssm.V[n], ssm.phi[n], ssm.A[n]
        )
        D.append(d)
        W.append(w)
    D = torch.stack(D)
    W = torch.stack(W)
    ok = torch.all(D > 0) & torch.all(torch.isfinite(D))
    return FactorResult(D=D, W=W, ok=ok)


def gp_log_likelihood(ssm: SSM, resid: torch.Tensor):
    """Total GP log-likelihood with (ll, ok) semantics.

    ok is False when any pivot D_n <= 0 or non-finite; in that case ll is
    -inf (the reference's ``quiet=True`` behavior, celerite.py:204-219).
    """
    S, d, w = _init(ssm)
    f = torch.zeros_like(w)
    z = torch.zeros_like(d)
    quad = torch.zeros_like(d)
    logdet = torch.zeros_like(d)
    min_d = torch.full_like(d, math.inf)
    for n in range(ssm.U.shape[0]):
        u, phi = ssm.U[n], ssm.phi[n]
        f = phi * (f + w * z)
        S, d, w = _factor_step(S, d, w, u, ssm.V[n], phi, ssm.A[n])
        z = resid[n] - u @ f
        quad = quad + z * z / d
        logdet = logdet + torch.log(d)
        min_d = torch.minimum(min_d, d)
    n = resid.shape[0]
    ll = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    ok = (min_d > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf)), ok


def gp_log_likelihood_masked(ssm: SSM, resid, mask, n_valid):
    """(ll, ok) over padded series, with any leading batch axes.

    The port of seq.py:137-162.  ``ssm``'s arrays are ``(..., N, P)`` /
    ``(..., N)``, ``resid`` and ``mask`` (1/0 validity) ``(..., N)``,
    ``n_valid`` the true counts ``(...)``.  Padded rows are made inert: U =
    V = 0, phi = 1, A = 1, resid = 0, so they add nothing to the quadratic
    form or the log-determinant.  One loop over the N steps serves every
    series of the batch (the JAX package vmaps one scan per series).
    """
    keep = mask > 0
    U = torch.where(keep[..., None], ssm.U, 0.0)
    V = torch.where(keep[..., None], ssm.V, 0.0)
    phi = torch.where(keep[..., None], ssm.phi, 1.0)
    A = torch.where(keep, ssm.A, 1.0)
    resid = torch.where(keep, resid, 0.0)
    batch, p = U.shape[:-2], U.shape[-1]
    S = U.new_zeros(*batch, p, p)
    d = U.new_zeros(batch)
    w = U.new_zeros(*batch, p)
    f = torch.zeros_like(w)
    z = torch.zeros_like(d)
    quad = torch.zeros_like(d)
    logdet = torch.zeros_like(d)
    min_d = torch.full_like(d, math.inf)
    for n in range(U.shape[-2]):
        u, ph = U[..., n, :], phi[..., n, :]
        f = ph * (f + w * z[..., None])
        S = (ph[..., :, None] * ph[..., None, :]) * (
            S + d[..., None, None] * (w[..., :, None] * w[..., None, :]))
        su = torch.sum(S * u[..., None, :], dim=-1)
        d = A[..., n] - torch.sum(u * su, dim=-1)
        w = (V[..., n, :] - su) / d[..., None]
        z = resid[..., n] - torch.sum(u * f, dim=-1)
        quad = quad + z * z / d
        logdet = logdet + torch.log(d)
        min_d = torch.minimum(min_d, d)
    n_valid = torch.as_tensor(n_valid, device=quad.device).to(quad.dtype)
    ll = -0.5 * (quad + logdet + n_valid * math.log(2.0 * math.pi))
    ok = (min_d > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, torch.full_like(ll, -math.inf)), ok


# ---------------------------------------------------------------------------
# Solves and products on a factor (seq.py:165-441): the oracles of the
# facade and its small-N route.  Right-hand sides are (N,) or (N, K); the
# K columns run side by side (the JAX package vmaps over them).
# ---------------------------------------------------------------------------


def _shift_down(x):
    """x[n] -> x[n+1] with zero fill at the end (for backward passes)."""
    return torch.cat([x[1:], torch.zeros_like(x[:1])])


def _columns(y):
    """``(N,)`` or ``(N, K)`` -> ``((N, K), squeeze)``."""
    return (y[:, None], True) if y.ndim == 1 else (y, False)


def solve_lower(ssm: SSM, fact: FactorResult, y):
    """Solve L z = y (forward substitution).  y: (N,) or (N, K)."""
    Y, squeeze = _columns(y)
    p = ssm.U.shape[1]
    f = Y.new_zeros(p, Y.shape[1])
    w_prev = ssm.U.new_zeros(p)
    z_prev = Y.new_zeros(Y.shape[1])
    out = []
    for n in range(Y.shape[0]):
        f = ssm.phi[n][:, None] * (f + w_prev[:, None] * z_prev[None, :])
        z_prev = Y[n] - ssm.U[n] @ f
        w_prev = fact.W[n]
        out.append(z_prev)
    z = torch.stack(out)
    return z[:, 0] if squeeze else z


def solve(ssm: SSM, fact: FactorResult, y):
    """Solve K x = y.  y may be (N,) or (N, K)."""
    Y, squeeze = _columns(y)
    z = solve_lower(ssm, fact, Y) / fact.D[:, None]
    # Backward: L^T x = z, in reverse.  At step n the carry g absorbs
    # (U_{n+1} x_{n+1}) and decays by phi_{n+1}.
    phi_next, u_next = _shift_down(ssm.phi), _shift_down(ssm.U)
    g = Y.new_zeros(ssm.U.shape[1], Y.shape[1])
    x_next = Y.new_zeros(Y.shape[1])
    out = []
    for n in range(Y.shape[0] - 1, -1, -1):
        g = phi_next[n][:, None] * (g + u_next[n][:, None] * x_next[None, :])
        x_next = z[n] - fact.W[n] @ g
        out.append(x_next)
    x = torch.stack(out[::-1])
    return x[:, 0] if squeeze else x


def dot_solve(ssm: SSM, fact: FactorResult, y):
    """y^T K^-1 y via the forward pass only (cholesky.h:326-401 analog)."""
    z = solve_lower(ssm, fact, y)
    return torch.sum(z * z / fact.D)


def dot_L(ssm: SSM, fact: FactorResult, z):
    """y = L sqrt(D) z (prior sampling; cholesky.h:409-431 analog).  z may
    be (N,) or (N, K)."""
    Z, squeeze = _columns(z)
    T = torch.sqrt(fact.D)[:, None] * Z
    p = ssm.U.shape[1]
    f = Z.new_zeros(p, Z.shape[1])
    w_prev = ssm.U.new_zeros(p)
    t_prev = Z.new_zeros(Z.shape[1])
    out = []
    for n in range(Z.shape[0]):
        f = ssm.phi[n][:, None] * (f + w_prev[:, None] * t_prev[None, :])
        out.append(T[n] + ssm.U[n] @ f)
        w_prev, t_prev = fact.W[n], T[n]
    y = torch.stack(out)
    return y[:, 0] if squeeze else y


def matmul(ssm: SSM, z):
    """K @ z without factorizing (cholesky.h:444-590 analog).

    ``ssm.A`` must hold the intended diagonal (for the reference ``dot``
    semantics that is kernel diagonal + jitter, with no yerr).  z may be
    (N,) or (N, K).
    """
    Z, squeeze = _columns(z)
    n_pts, p = ssm.U.shape
    # Lower triangle: y_n += U_n . g_n, g_n = phi_n (g_{n-1} + V_{n-1} z_{n-1})
    g = Z.new_zeros(p, Z.shape[1])
    v_prev = ssm.U.new_zeros(p)
    z_prev = Z.new_zeros(Z.shape[1])
    low = []
    for n in range(n_pts):
        g = ssm.phi[n][:, None] * (g + v_prev[:, None] * z_prev[None, :])
        low.append(ssm.U[n] @ g)
        v_prev, z_prev = ssm.V[n], Z[n]
    # Upper triangle: y_n += V_n . h_n, h_n = phi_{n+1}(h_{n+1} + U_{n+1}
    # z_{n+1})
    phi_next, u_next = _shift_down(ssm.phi), _shift_down(ssm.U)
    z_next = _shift_down(Z)
    h = Z.new_zeros(p, Z.shape[1])
    up = []
    for n in range(n_pts - 1, -1, -1):
        h = phi_next[n][:, None] * (h + u_next[n][:, None] * z_next[n][None, :])
        up.append(ssm.V[n] @ h)
    y = ssm.A[:, None] * Z + torch.stack(low) + torch.stack(up[::-1])
    return y[:, 0] if squeeze else y


def _test_basis(coeffs, x, dtype):
    """The U-side and V-side bases ``(M, J)`` of the kernel at points x."""
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, _ = coeffs
    jr = a_real.shape[0]
    arg = d_comp * x[:, None]
    cos, sin = torch.cos(arg), torch.sin(arg)
    u = torch.cat([a_real.expand(x.shape[0], jr),
                   torch.stack([a_comp * cos + b_comp * sin,
                                a_comp * sin - b_comp * cos],
                               -1).reshape(x.shape[0], -1)], 1)
    v = torch.cat([x.new_ones(x.shape[0], jr, dtype=dtype),
                   torch.stack([cos, sin], -1).reshape(x.shape[0], -1)], 1)
    return u, v


def predict_mean(coeffs, t, alpha, x, parallel=False):
    """Conditional mean K_*(x, t) @ alpha in O((N + M) J).

    Port of seq.py:307-441 (the reference's cholesky.h:599-698 lag-state
    accumulators): per-data-point forward and backward states by two
    recursions, gathered at each test point with ``searchsorted``.  With
    ``parallel=True`` the two recursions (diagonal decays) run as
    Hillis-Steele scans (``blocked._diag_affine_scan``), log2(N) rounds of
    vectorised ops instead of N sequential steps.  ``alpha`` must be K^-1
    resid.  Data points with ``t_k < x`` enter through the forward state,
    points with ``t_k >= x`` through the backward state.
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, _ = coeffs
    dtype = alpha.dtype
    n = t.shape[0]
    dt_next = torch.cat([torch.diff(t), t.new_zeros(1)])
    dt_prev = torch.cat([t.new_zeros(1), torch.diff(t)])
    c_all = torch.cat([c_real, torch.repeat_interleave(c_comp, 2)])
    u_data, v_data = _test_basis(coeffs, t, dtype)
    decay_prev = torch.exp(-c_all * dt_prev[:, None])
    decay_next = torch.exp(-c_all * dt_next[:, None])
    if parallel:
        from .blocked import _diag_affine_scan

        q_fwd = _diag_affine_scan(decay_prev, v_data * alpha[:, None])
        r_bwd = _diag_affine_scan(decay_next, u_data * alpha[:, None],
                                  reverse=True)
    else:
        q = alpha.new_zeros(c_all.shape[0])
        qs = []
        for k in range(n):
            q = q * decay_prev[k] + v_data[k] * alpha[k]
            qs.append(q)
        r = alpha.new_zeros(c_all.shape[0])
        rs = []
        for k in range(n - 1, -1, -1):
            r = r * decay_next[k] + u_data[k] * alpha[k]
            rs.append(r)
        q_fwd, r_bwd = torch.stack(qs), torch.stack(rs[::-1])

    # Gather at test points: i = first data index with t >= x.
    i = torch.searchsorted(t, x, side="left")
    has_prev, has_next = i > 0, i < n
    i_prev, i_next = torch.clamp(i - 1, 0, n - 1), torch.clamp(i, 0, n - 1)
    dxf = (x - t[i_prev])[:, None]
    dxb = (t[i_next] - x)[:, None]
    qf = torch.where(has_prev[:, None],
                     q_fwd[i_prev] * torch.exp(-c_all * dxf), 0.0)
    rb = torch.where(has_next[:, None],
                     r_bwd[i_next] * torch.exp(-c_all * dxb), 0.0)
    u_test, v_test = _test_basis(coeffs, x, dtype)
    return torch.sum(u_test * qf, dim=1) + torch.sum(v_test * rb, dim=1)
