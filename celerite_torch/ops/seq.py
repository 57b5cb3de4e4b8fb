"""Sequential semiseparable solver: the oracle and the CPU small-N route.

Port of ``celerite_tpu/ops/seq.py:46-136`` (the reference's Cholesky
recursion, cholesky.h:41-698).  A Python loop over the N steps replaces
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

__all__ = ["FactorResult", "factor", "gp_log_likelihood"]


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
