"""CARMA(p, q) models: Kalman log-likelihood + celerite conversion.

Port of ``celerite_tpu/ops/carma.py``, the analog of the reference's
complex-diagonalized CARMA solver (carma.h:15-286, following Kelly et al.
2014).  Two roles, as in the reference: a comparison baseline for the
semiseparable solver, and the constructive proof that the celerite kernel
family contains CARMA via :meth:`CARMASolver.get_celerite_coeffs`.

The O(p) root/coefficient setup, the spectrum, the autocovariance and the
conversion are host numpy (a copy of the JAX package's); the sequential
Kalman filter runs in ``torch.complex128`` on ``cuda`` unless the solver
was made with ``device="cpu"``: a Python loop over the time steps, the
transitions of every step computed at once before it.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lanes4 import resolve_device

__all__ = ["CARMASolver", "roots_from_params", "poly_from_roots"]


def roots_from_params(params):
    """Quadratic-factor parameterization -> roots (Kelly et al.).

    Parameters come in pairs (log c, log b) giving the monic quadratic
    z^2 + b z + c; an odd trailing parameter adds the real root -exp(p).
    """
    params = np.atleast_1d(np.asarray(params, dtype=float))
    n = len(params)
    roots = np.zeros(n, dtype=complex)
    if n == 0:
        return roots
    if n % 2 == 1:
        roots[n - 1] = -np.exp(params[n - 1])
    for i in range(0, n - 1, 2):
        b = np.exp(params[i + 1])
        c = np.exp(params[i])
        arg = np.sqrt(complex(b * b - 4.0 * c))
        roots[i] = 0.5 * (-b + arg)
        roots[i + 1] = 0.5 * (-b - arg)
    return roots


def poly_from_roots(roots):
    """Monic polynomial coefficients (ascending order) from its roots."""
    roots = np.atleast_1d(np.asarray(roots, dtype=complex))
    # np.poly gives descending coefficients of prod (z - r); ascending flip.
    return np.poly(roots)[::-1].astype(complex) if len(roots) else np.ones(
        1, dtype=complex
    )


class CARMASolver:
    """CARMA(p, q) Kalman-filter likelihood in the diagonalized basis.

    Args follow the reference binding (solver.cpp:200-235):
    ``log_sigma``, AR parameters (length p), MA parameters (length q < p);
    ``device``: where the filter runs, ``None`` meaning ``"cuda"``.
    """

    def __init__(self, log_sigma, arparams, maparams, device=None):
        arparams = np.atleast_1d(np.asarray(arparams, dtype=float))
        maparams = np.atleast_1d(np.asarray(maparams, dtype=float))
        self.p = len(arparams)
        self.q = len(maparams)
        if self.q >= self.p:
            raise ValueError("q must be smaller than p")
        self.device = device
        self.sigma = float(np.exp(log_sigma))
        self.arroots = roots_from_params(arparams)
        self.maroots = roots_from_params(maparams)
        self.alpha = poly_from_roots(self.arroots)
        beta = poly_from_roots(self.maroots)
        self.beta = beta / beta[0]

        # Rotation into the diagonalized space: U_ij = r_j^i.
        U = np.vander(self.arroots, self.p, increasing=True).T
        b = np.zeros(self.p, dtype=complex)
        b[: self.q + 1] = self.beta[: self.q + 1]
        self.b = b @ U

        e = np.zeros(self.p, dtype=complex)
        e[-1] = self.sigma
        J = np.linalg.solve(U, e)
        self.V = -np.outer(J, np.conj(J)) / (
            self.arroots[:, None] + np.conj(self.arroots)[None, :]
        )

    # -- Kalman filter -------------------------------------------------------
    def log_likelihood(self, t, y, yerr, quiet=False):
        """Exact Gaussian log-likelihood via the Kalman filter (O(N p^2)).

        ``quiet=True`` returns ``(ll, ok)`` instead of raising on a
        negative predictive variance (the generic failure mode of the
        diagonalized-basis filter at large p, carma.h:185-186).
        """
        t = np.atleast_1d(np.asarray(t))
        if len(y) != len(t) or len(yerr) != len(t):
            raise ValueError("dimension mismatch")
        dev = resolve_device(self.device)

        def put(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64),
                                   device=dev)

        t = put(t)
        dt = torch.cat([torch.diff(t), torch.zeros(1, dtype=t.dtype,
                                                   device=dev)])
        ll, ok = _kalman_ll(
            torch.as_tensor(self.b, device=dev),
            torch.as_tensor(self.V, device=dev),
            torch.as_tensor(self.arroots, device=dev),
            put(y), put(yerr) ** 2, dt)
        ll, ok = float(ll), bool(ok)
        if quiet:
            return ll, ok
        if not ok:
            raise RuntimeError("negative predictive variance in CARMA filter")
        return ll

    # -- spectra -------------------------------------------------------------
    def psd(self, f):
        """Power spectrum at ordinary frequency f (reference carma.h:241)."""
        f = np.asarray(f, dtype=float)
        w = 2j * np.pi * f[..., None]
        num = np.sum(self.beta * w ** np.arange(self.q + 1), axis=-1)
        den = np.sum(self.alpha * w ** np.arange(self.p + 1), axis=-1)
        return self.sigma**2 * np.abs(num) ** 2 / np.abs(den) ** 2

    def covariance(self, tau):
        """Autocovariance k(tau) (reference carma.h:250-269)."""
        tau = np.asarray(tau, dtype=float)
        value = np.zeros(tau.shape, dtype=complex)
        for k in range(self.p):
            rk = self.arroots[k]
            n1 = np.sum(self.beta * rk ** np.arange(self.q + 1))
            n2 = np.sum(self.beta * (-rk) ** np.arange(self.q + 1))
            norm = n1 * n2 / rk.real
            for l in range(self.p):
                if l != k:
                    norm /= (self.arroots[l] - rk) * (
                        np.conj(self.arroots[l]) + rk
                    )
            value = value + norm * np.exp(rk * tau)
        return -0.5 * self.sigma**2 * value.real

    # -- the celerite bridge -------------------------------------------------
    def get_celerite_coeffs(self):
        """CARMA -> celerite coefficient conversion with conjugate dedup.

        Returns the 6 arrays (a_real, c_real, a_comp, b_comp, c_comp,
        d_comp); proves celerite contains CARMA (carma.h:72-139).
        """
        ar, cr = [], []
        ac, bc, cc, dc = [], [], [], []

        def isclose(a, b):
            return abs(a - b) <= 1e-6

        for k in range(self.p):
            rk = self.arroots[k]
            term1 = np.sum(self.beta * rk ** np.arange(self.q + 1))
            term2 = np.sum(self.beta * (-rk) ** np.arange(self.q + 1))
            full = self.sigma**2 * term1 * term2 / (-rk.real)
            for l in range(self.p):
                if l != k:
                    full /= (self.arroots[l] - rk) * (
                        np.conj(self.arroots[l]) + rk
                    )

            if isclose(full.imag, 0.0) and isclose(rk.imag, 0.0):
                ar.append(0.5 * full.real)
                cr.append(-rk.real)
            else:
                is_conj = any(
                    isclose(a, full.real)
                    and isclose(b, -full.imag)
                    and isclose(c, -rk.real)
                    and isclose(d, rk.imag)
                    for a, b, c, d in zip(ac, bc, cc, dc)
                )
                if not is_conj:
                    ac.append(full.real)
                    bc.append(full.imag)
                    cc.append(-rk.real)
                    dc.append(-rk.imag)

        return tuple(
            np.asarray(v, dtype=float) for v in (ar, cr, ac, bc, cc, dc)
        )


def _kalman_ll(b, V, roots, y, yvar, dt):
    """Sequential Kalman filter (reference carma.h:221-239) in complex128:
    ``(ll, ok)`` as 0-d tensors, ``ok`` whether every predictive variance
    was positive."""
    n = y.shape[0]
    bc = torch.conj(b)
    # Every step's advance, at once: lam = exp(roots dt) and the
    # covariance's lam_i conj(lam_j).
    lam = torch.exp(roots[None, :] * dt[:, None])
    lam2 = lam[:, :, None] * torch.conj(lam)[:, None, :]
    x = torch.zeros_like(b)
    P = V
    resid = torch.empty_like(y)
    variance = torch.empty_like(y)
    for k in range(n):
        # Predict.
        expectation = torch.real(b @ x)
        var = yvar[k] + torch.real(b @ P @ bc)
        # Update.
        K = P @ bc / var
        r = y[k] - expectation
        x = x + r * K
        P = P - var * torch.outer(K, torch.conj(K))
        # Advance.
        x = x * lam[k]
        P = V + lam2[k] * (P - V)
        resid[k] = r
        variance[k] = var
    ll = -0.5 * (torch.sum(resid * resid / variance + torch.log(variance))
                 + n * math.log(2.0 * math.pi))
    return ll, torch.min(variance) > 0
