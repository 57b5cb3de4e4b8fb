"""State-space (Kalman/RTS) predictive variance in O((N+M) p^2).

Port of ``celerite_tpu/ops/smoother.py``.  celerite kernels are exactly
the covariances of low-dimensional Gauss-Markov processes, so the GP
posterior mean AND variance at any set of points fall out of one Kalman
filter + RTS smoother sweep over the merged (train + test) grid, with
p = J_real + 2 J_complex states; the reference builds the variance densely
instead (an O(N M) matrix and solves, celerite.py:460-474).

Realization (host numpy, per parameter set; a copy of the JAX package's):

- real term ``a e^{-c tau}``: 1-D block, transition ``e^{-c dt}``,
  stationary variance ``a``; a negative coefficient is realized jointly
  with a positive partner through a coupled stationary covariance.
- complex term ``e^{-c tau} (a cos d tau + b sin d tau)``: 2-D block with
  F = [[-c, -d], [d, -c]], output H = [1, 0] and stationary covariance
  Pinf = [[a, -b], [-b, p22]]; a valid process needs the celerite
  single-term condition a c >= b d.  Terms that are only *jointly*
  positive definite have no independent realization: :func:`realize`
  returns None and callers take the dense path.

Per-step discrete noise needs no integral: Q(dt) = Pinf - A Pinf A^T.

The engine here is the sequential one: a Python loop over the steps of
each sweep, a few small torch ops a step (the smoother's gains are solved
for every step at once between the sweeps).  On the card that is bound by
launches; ``ops/pkalman.py`` has the blocked engine for long grids.  Every
entry point computes in float64 (no matmul here can take TF32), on ``cuda``
unless given ``device="cpu"``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lanes4 import resolve_device

__all__ = ["realize", "predict_var", "kalman_log_likelihood", "sample_prior"]


def _host(x):
    """float64 numpy copy of an array, a tensor (on any device) or a
    scalar."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype=float)


class _Realization:
    """Static realization data: per-block structure + stationary cov.

    Real states have diagonal decay transitions e^{-c dt} but may carry
    a *coupled* stationary covariance P_real (negative-coefficient terms
    are realized jointly with a positive partner); complex pairs are
    2-D rotation-decay blocks.
    """

    def __init__(self, c_real, P_real, c_comp, d_comp, P_comp):
        self.c_real = np.asarray(c_real, float)
        self.P_real = np.atleast_2d(np.asarray(P_real, float))
        self.c_comp = np.asarray(c_comp, float)
        self.d_comp = np.asarray(d_comp, float)
        self.P_comp = np.asarray(P_comp, float)  # (Jc, 2, 2)
        self.jr = len(self.c_real)
        self.jc = len(self.c_comp)
        self.p = self.jr + 2 * self.jc

    @property
    def Pinf(self):
        P = np.zeros((self.p, self.p))
        if self.jr:
            P[: self.jr, : self.jr] = self.P_real
        for j in range(self.jc):
            k = self.jr + 2 * j
            P[k:k + 2, k:k + 2] = self.P_comp[j]
        return P

    @property
    def H(self):
        h = np.zeros(self.p)
        h[: self.jr] = 1.0
        h[self.jr::2] = 1.0
        return h


def _pair_coupling(a1, c1, a2, c2, tol):
    """Coupling s realizing a1 e^{-c1 t} + a2 e^{-c2 t}, a2 < 0 <= a1.

    With unit output weights and diagonal decay, the stationary cov
    Sigma = [[a1 - s, s], [s, a2 - s]] reproduces the pair for any s;
    validity needs Sigma >= 0 (s <= a2 and det: a1 a2 - (a1 + a2) s >=
    0) and the Lyapunov noise [[2 c1 (a1-s), (c1+c2) s], [., 2 c2
    (a2-s)]] >= 0 — a concave quadratic in s.  Returns s or None.
    """
    qa = -((c1 - c2) ** 2)
    qb = -4.0 * c1 * c2 * (a1 + a2)
    qc = 4.0 * c1 * c2 * a1 * a2
    disc = qb * qb - 4.0 * qa * qc
    if abs(qa) > tol:
        if disc < 0:
            return None
        r1 = (-qb - np.sqrt(disc)) / (2.0 * qa)
        r2 = (-qb + np.sqrt(disc)) / (2.0 * qa)
        lo, hi = min(r1, r2), max(r1, r2)
    else:
        if qb > tol:
            lo, hi = -qc / qb, np.inf
        elif qb < -tol:
            lo, hi = -np.inf, -qc / qb
        else:
            lo, hi = (-np.inf, np.inf) if qc >= -tol else (None, None)
            if lo is None:
                return None
    # Sigma PSD: s <= a2 (< 0) and s <= a1 a2 / (a1 + a2) when the
    # linear det bound binds.
    ub = a2
    if a1 + a2 > tol:
        ub = min(ub, a1 * a2 / (a1 + a2))
    s = min(hi, ub)
    if s < lo - tol:
        return None
    s = min(s, ub)
    # Verify numerically.
    Sig = np.array([[a1 - s, s], [s, a2 - s]])
    Qc = np.array([
        [2 * c1 * (a1 - s), (c1 + c2) * s],
        [(c1 + c2) * s, 2 * c2 * (a2 - s)],
    ])
    for M in (Sig, Qc):
        w = np.linalg.eigvalsh(M)
        if w[0] < -tol * max(1.0, abs(w[-1])):
            return None
    return s


def realize(coeffs, tol=1e-12):
    """Build the Gauss-Markov realization, or None if not realizable.

    ``coeffs``: a ``Coefficients`` of arrays, tensors or scalars."""
    a_r = np.atleast_1d(_host(coeffs.a_real))
    c_r = np.atleast_1d(_host(coeffs.c_real))
    a_c = np.atleast_1d(_host(coeffs.a_comp))
    b_c = np.atleast_1d(_host(coeffs.b_comp))
    c_c = np.atleast_1d(_host(coeffs.c_comp))
    d_c = np.atleast_1d(_host(coeffs.d_comp))

    # Drop zero-amplitude padding channels.
    keep_r = np.abs(a_r) > tol
    a_r, c_r = a_r[keep_r], c_r[keep_r]
    keep_c = (np.abs(a_c) > tol) | (np.abs(b_c) > tol)
    a_c, b_c = a_c[keep_c], b_c[keep_c]
    c_c, d_c = c_c[keep_c], d_c[keep_c]

    if np.any(c_r <= 0):
        return None

    # Real block: positives are independent OU states; each negative
    # coefficient must pair with a positive partner (e.g. the overdamped
    # SHO lowering) through a coupled stationary covariance.
    neg = list(np.flatnonzero(a_r < -tol))
    pos = list(np.flatnonzero(a_r >= -tol))
    order = []
    blocks = []  # (indices, Sigma) chunks of P_real
    used = set()
    for i in neg:
        found = None
        for j in pos:
            if j in used:
                continue
            s = _pair_coupling(a_r[j], c_r[j], a_r[i], c_r[i], tol)
            if s is not None:
                found = (j, s)
                break
        if found is None:
            return None
        j, s = found
        used.add(j)
        order += [j, i]
        blocks.append(np.array([
            [a_r[j] - s, s], [s, a_r[i] - s]
        ]))
    for j in pos:
        if j not in used:
            order.append(j)
            blocks.append(np.array([[max(a_r[j], 0.0)]]))

    jr = len(order)
    P_real = np.zeros((jr, jr))
    k = 0
    for blk in blocks:
        m = blk.shape[0]
        P_real[k:k + m, k:k + m] = blk
        k += m
    c_states = c_r[np.asarray(order, int)] if jr else np.zeros(0)

    P_blocks = []
    for a, b, c, d in zip(a_c, b_c, c_c, d_c):
        if c <= 0 or a <= 0:
            return None
        if abs(d) < tol:
            # Degenerate oscillation: behaves like a real pair; require
            # the plain decay condition.
            if abs(b) > tol:
                return None
            P_blocks.append(np.array([[a, 0.0], [0.0, a]]))
            continue
        # The SHOTerm sits exactly ON the a c = b d feasibility boundary,
        # so rounded coefficients land an epsilon outside it — use a
        # relative margin and project onto the boundary.
        margin = tol + 1e-5 * (abs(c * a) + abs(d * b))
        if c * a < d * b - margin:
            return None  # individually non-PSD term
        # det Qc(p22) = (2ca - 2db)(2c p22 + 2db) - (2cb + d(a - p22))^2
        # is concave in p22; take its maximizer.
        alpha = max(2.0 * (c * a - d * b), 0.0)
        p22 = (alpha * c + d * (2.0 * c * b + d * a)) / (d * d)
        off = 2.0 * c * b + d * (a - p22)
        detq = alpha * (2.0 * c * p22 + 2.0 * d * b) - off * off
        q22 = 2.0 * c * p22 + 2.0 * d * b
        if (
            detq < -margin * max(1.0, 2.0 * c * p22 + 2.0 * d * b)
            or q22 < -margin
            or p22 <= 0
        ):
            return None
        P = np.array([[a, -b], [-b, p22]])
        if np.linalg.det(P) < -tol or np.trace(P) <= 0:
            return None
        P_blocks.append(P)

    P_comp = (
        np.asarray(P_blocks)
        if P_blocks else np.zeros((0, 2, 2))
    )
    return _Realization(c_states, P_real, c_c, d_c, P_comp)


def _transitions(real_, dt):
    """Per-step block-diagonal transition matrices A(dt): (n, p, p), on
    ``dt``'s device and dtype."""
    n = dt.shape[0]
    p = real_.p
    jr, jc = real_.jr, real_.jc
    A = torch.zeros((n, p, p), dtype=dt.dtype, device=dt.device)
    if jr:
        c = torch.as_tensor(real_.c_real, dtype=dt.dtype, device=dt.device)
        idx = torch.arange(jr, device=dt.device)
        A[:, idx, idx] = torch.exp(-c * dt[:, None])
    for j in range(jc):
        k = jr + 2 * j
        e = torch.exp(-float(real_.c_comp[j]) * dt)
        cs = torch.cos(float(real_.d_comp[j]) * dt)
        sn = torch.sin(float(real_.d_comp[j]) * dt)
        A[:, k, k] = e * cs
        A[:, k, k + 1] = -e * sn
        A[:, k + 1, k] = e * sn
        A[:, k + 1, k + 1] = e * cs
    return A


def _rts_gains(Pf, Pp_next, A_next):
    """Every step's smoother gain G_k = Pf_k A_{k+1}^T (P^-_{k+1})^-1 in
    one batched solve, through the regularized P^-_{k+1} + 1e-12 tr(P^-)
    I of the JAX package's backward step (smoother.py:303-304): without
    it the gain is not finite on duplicate times (dt = 0 gives Q = 0)."""
    p = Pf.shape[-1]
    eye = torch.eye(p, dtype=Pf.dtype, device=Pf.device)
    tr = torch.diagonal(Pp_next, dim1=-2, dim2=-1).sum(-1)
    Ppr = Pp_next + 1e-12 * tr[:, None, None] * eye
    G, _ = torch.linalg.solve_ex(Ppr, A_next @ Pf)
    return G.transpose(1, 2)


def _filter_smoother(real_, dt, yv, rv, obs):
    """Kalman filter + RTS smoother over one merged grid.

    Args (tensors on one device): dt spacings (first 0), yv observed
    values (0 where missing), rv observation variances, obs 1/0 flags.
    Returns (mean, var, ll): the *latent* process's smoothed mean and
    variance at every grid point, and the marginal data log-likelihood
    over observed points.
    """
    dtype, device = yv.dtype, yv.device
    n, p = dt.shape[0], real_.p
    Pinf = torch.as_tensor(real_.Pinf, dtype=dtype, device=device)
    H = torch.as_tensor(real_.H, dtype=dtype, device=device)
    A = _transitions(real_, dt)
    Q = Pinf - A @ Pinf @ A.transpose(1, 2)

    mf = torch.empty((n, p), dtype=dtype, device=device)
    Pf = torch.empty((n, p, p), dtype=dtype, device=device)
    m = torch.zeros(p, dtype=dtype, device=device)
    P = Pinf
    for i in range(n):
        An = A[i]
        mp = An @ m
        Pp = torch.addmm(Q[i], An @ P, An.T)
        PH = Pp @ H
        s = H @ PH + rv[i]
        k = obs[i] * (PH / s)
        m = mp + k * (yv[i] - H @ mp)
        P = Pp - torch.outer(k, k) * s
        mf[i] = m
        Pf[i] = P
    # The predictions again, for every step at once from the filtered
    # moments (fewer launches a step than storing them in the loop), and
    # the per-step likelihood terms.
    m_prev = torch.cat([torch.zeros((1, p), dtype=dtype, device=device),
                        mf[:-1]])
    P_prev = torch.cat([Pinf[None], Pf[:-1]])
    mp = (A @ m_prev[:, :, None])[:, :, 0]
    Pp = A @ P_prev @ A.transpose(1, 2) + Q
    s_all = (Pp @ H) @ H + rv
    innov = yv - mp @ H
    lls = -0.5 * (innov**2 / s_all + torch.log(s_all) + math.log(2 * math.pi))
    ll = torch.sum(obs * lls)

    # RTS backward: state k uses A_{k+1}, P_pred_{k+1}.
    eye = torch.eye(p, dtype=dtype, device=device)
    A_next = torch.cat([A[1:], eye[None]], dim=0)
    mp_next = torch.cat([mp[1:], mp[-1:]], dim=0)
    Pp_next = torch.cat([Pp[1:], Pp[-1:]], dim=0)
    G = _rts_gains(Pf, Pp_next, A_next)
    ms = torch.empty_like(mf)
    Ps = torch.empty_like(Pf)
    m_s, P_s = mf[-1], Pf[-1]
    ms[-1] = m_s
    Ps[-1] = P_s
    for i in range(n - 2, -1, -1):
        Gi = G[i]
        m_s = mf[i] + Gi @ (m_s - mp_next[i])
        P_s = Pf[i] + Gi @ (P_s - Pp_next[i]) @ Gi.T
        ms[i] = m_s
        Ps[i] = P_s

    mean = ms @ H
    var = (Ps @ H) @ H
    return mean, var, ll


def _realized(coeffs):
    """The realization and the jitter of ``coeffs``; raises for a kernel
    with none."""
    real_ = realize(coeffs)
    if real_ is None:
        raise ValueError("kernel is not independently realizable")
    return real_, float(_host(coeffs.jitter))


def kalman_log_likelihood(coeffs, t, diag, y, device=None):
    """Data log-likelihood via the filter (cross-check utility); a 0-d
    float64 tensor on the device."""
    real_, jitter = _realized(coeffs)
    dev = resolve_device(device)

    def put(x):
        return torch.as_tensor(_host(x), dtype=torch.float64, device=dev)

    t = put(t)
    dt = torch.cat([torch.zeros(1, dtype=t.dtype, device=dev), torch.diff(t)])
    rv = put(diag) + jitter
    obs = torch.ones_like(t)
    _, _, ll = _filter_smoother(real_, dt, put(y), rv, obs)
    return ll


def _merge_grid(t_train, diag, resid, t_test, jitter):
    """Host-side merge of the train and test times: a stable sort, ties
    putting the train point first.  Returns the merged grid's spacings,
    observed values, observation variances and 1/0 flags (numpy) and the
    test points' places in it."""
    t_train = _host(t_train)
    t_test = _host(t_test)
    n, m = len(t_train), len(t_test)
    t_all = np.concatenate([t_train, t_test])
    kind = np.concatenate([np.ones(n), np.zeros(m)])
    src = np.concatenate([np.arange(n), np.arange(m)])
    order = np.argsort(t_all, kind="stable")
    t_s = t_all[order]
    obs = kind[order]
    src_s = src[order]

    yv = np.zeros(n + m)
    rv = np.ones(n + m)
    train = obs == 1
    yv[train] = _host(resid)[src_s[train]]
    rv[train] = _host(diag)[src_s[train]] + jitter
    dt = np.concatenate([[0.0], np.diff(t_s)])
    test_pos = np.flatnonzero(obs == 0)
    return dt, yv, rv, obs, test_pos, src_s[test_pos]


def predict_var(coeffs, t_train, diag, resid, t_test, device=None):
    """Posterior mean and variance of the latent GP at ``t_test``.

    O((N+M) p^2); exactly k* K^-1 r and the jitter-free variance k(0) -
    k*^T K^-1 k* in exact arithmetic.  The grid is merged on the host, the
    sequential engine runs on ``device``.  Returns numpy (mean, var) at
    t_test.
    """
    real_, jitter = _realized(coeffs)
    dev = resolve_device(device)
    dt, yv, rv, obs, pos, dst = _merge_grid(t_train, diag, resid, t_test,
                                           jitter)
    mean_s, var_s, _ = _filter_smoother(
        real_, *(torch.as_tensor(x, dtype=torch.float64, device=dev)
                 for x in (dt, yv, rv, obs)))
    m = len(pos)
    out_mean = np.empty(m)
    out_var = np.empty(m)
    out_mean[dst] = mean_s.cpu().numpy()[pos]
    out_var[dst] = var_s.cpu().numpy()[pos]
    return out_mean, out_var


def sample_prior(coeffs, t, seed=None, rng=None, device=None):
    """Exact GP prior sample at ``t`` via the Gauss-Markov realization.

    Host-side float64 and O(N p^2): x_0 ~ N(0, P_inf), x_n = A_n x_{n-1} +
    q_n with Q_n = P_inf - A_n P_inf A_n^T; only the transitions are
    computed with torch, on ``device``.  The normal draws are
    ``np.random.default_rng(seed)``'s (or ``rng``'s), as the JAX
    package's, so a seeded draw agrees with it to float64 rounding.
    Returns the latent kernel process only (no jitter / measurement
    noise).  Requires a realizable kernel (see :func:`realize`).
    """
    real_ = realize(coeffs)
    if real_ is None:
        raise ValueError("kernel is not Gauss-Markov realizable")
    dev = resolve_device(device)
    if rng is None:
        rng = np.random.default_rng(seed)
    t = np.asarray(t, np.float64)
    n = t.shape[0]
    p = real_.p
    Pinf = np.asarray(real_.Pinf, np.float64)
    H = np.asarray(real_.H, np.float64)
    dt = np.concatenate([[0.0], np.diff(t)])
    A = _transitions(real_, torch.as_tensor(dt, device=dev)).cpu().numpy()
    Q = Pinf[None] - A @ Pinf[None] @ np.swapaxes(A, 1, 2)

    # Robust symmetric square roots (Q_0 = 0; near-zero for tiny dt).
    Qs = 0.5 * (Q + np.swapaxes(Q, 1, 2))
    w, V = np.linalg.eigh(Qs)
    L = V * np.sqrt(np.clip(w, 0.0, None))[:, None, :]

    eps = rng.standard_normal((n, p))
    x = np.empty((n, p))
    x[0] = np.linalg.cholesky(
        Pinf + 1e-12 * np.trace(Pinf) / p * np.eye(p)
    ) @ eps[0]
    noise = np.einsum("nij,nj->ni", L, eps)
    for k in range(1, n):
        x[k] = A[k] @ x[k - 1] + noise[k]
    return x @ H
