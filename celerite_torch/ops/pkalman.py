"""Temporal-parallel Kalman filter + RTS smoother (associative scans).

Port of ``celerite_tpu/ops/pkalman.py``.  Filtering and smoothing are
associative over per-step elements (Sarkka & Garcia-Fernandez 2020,
"Temporal parallelization of Bayesian smoothers"), so both sweeps of the
sequential smoother (``ops/smoother.py``) become inclusive scans.  The
scans here are one helper, :func:`_scan`: a Python loop over log2(n)
levels, each level one composition of every element with the one d
places before it (after it, reversed).

Layout: every element array carries the time axis LAST — matrices are
``(p, p, n)``, vectors ``(p, n)`` — so each (p, p) product is one
broadcast multiply and one sum over the time lanes (:func:`_mm`).

Two engines, with the sequential smoother's contract and results:

- :func:`parallel_filter_smoother`: one scan over all N steps;
- :func:`blocked_filter_smoother`, the one ``GP.predict`` takes on the
  card: the N axis splits into B blocks of L steps; Python loops over the
  L steps run the within-block passes over all B blocks at once, and the
  scans run only across the B blocks.  On the H100 it does a third of
  the flat engine's device work; the flat one launches fewer ops, so
  it is faster at 1.1e5 merged points and slower at 1.1e6
  (tools/kalman_tune.py; PERF.md).

Filtering element per step k (model x_k = F_k x_{k-1} + q_k,
q_k ~ N(0, Q_k); observation y_k = H x_k + r_k, r_k ~ N(0, R_k)):

    S_k = H Q_k H^T + R_k          K_k = Q_k H^T / S_k
    A_k = (I - K_k H) F_k          b_k = K_k y_k
    C_k = (I - K_k H) Q_k
    eta_k = F_k^T H^T y_k / S_k    J_k = F_k^T H^T H F_k / S_k

(no-observation steps: A = F, b = 0, C = Q, eta = 0, J = 0), with the
prior as a leading element (A=0, b=m0, C=P0, eta=0, J=0).  Composition
of e_i followed by e_j:

    D = (I + C_i J_j)^-1
    A_ij = A_j D A_i               b_ij = A_j D (b_i + C_i eta_j) + b_j
    C_ij = A_j D C_i A_j^T + C_j
    eta_ij = A_i^T (I + J_j C_i)^-1 (eta_j - J_j b_i) + eta_i
    J_ij = A_i^T (I + J_j C_i)^-1 J_j A_i + J_i

An inclusive prefix scan then yields the filtered moments directly:
m_k = b, P_k = C of the k-th prefix.  Predicted moments (needed for the
smoother gains and the marginal likelihood) follow vectorized from the
shifted filtered moments, with no further scan.

Smoothing element (x_k | x_{k+1} ~ N(E_k x_{k+1} + g_k, L_k)):

    G_k = P_k F_{k+1}^T (P^-_{k+1})^-1
    E_k = G_k    g_k = m_k - G_k m^-_{k+1}    L_k = P_k - G_k P^-_{k+1} G_k^T

(last element: E = 0, g = m_n, L = P_n), composed right-to-left as

    (E_i, g_i, L_i) * (E_j, g_j, L_j)
        = (E_i E_j,  E_i g_j + g_i,  E_i L_j E_i^T + L_i)

so a reverse inclusive scan gives the smoothed moments m^s = g, P^s = L.

Exactness: both engines reproduce the sequential filter/smoother to
floating-point roundoff (tests/test_torch_smoother.py, float64).  Entry
points compute in float64 on ``cuda`` unless given ``device="cpu"``.
"""

from __future__ import annotations

import math

import torch

from .lanes4 import resolve_device
from .smoother import _host, _realized, _transitions

__all__ = [
    "parallel_filter_smoother",
    "blocked_filter_smoother",
    "predict_var_parallel",
]


def _mm(x, y):
    """(p, p, n) @ (p, q, n) -> (p, q, n) over the leading dims."""
    return (x.unsqueeze(2) * y.unsqueeze(0)).sum(1)


def _mv(x, v):
    """(p, p, n) @ (p, n) -> (p, n)."""
    return torch.sum(x * v.unsqueeze(0), dim=1)


def _tr(x):
    return x.transpose(0, 1)


def _solve(M, X):
    """(p, p, n)-batched M^-1 X via unrolled Gauss-Jordan.

    No pivoting, as the JAX package's (and its kernels' in-VMEM inverse):
    M is I + (PSD)(PSD) or a regularized covariance, diagonally dominant
    enough in practice.
    """
    p = M.shape[0]
    aug = torch.cat([M, X], dim=1)  # (p, p + q, n)
    rows = torch.arange(p, device=M.device)[:, None, None]
    for k in range(p):
        piv = aug[k:k + 1] / aug[k:k + 1, k:k + 1]
        elim = aug - aug[:, k:k + 1] * piv
        aug = torch.where(rows == k, piv, elim)
    return aug[:, p:]


def _eye(p, like):
    """The identity as (p, p, 1), broadcasting over the time lanes."""
    return torch.eye(p, dtype=like.dtype, device=like.device)[:, :, None]


def _compose(e1, e2):
    """Associative filtering composition: e1 earlier, e2 later.

    Elements are (A, b, C, eta, J): matrices (p, p, n), vectors (p, n).
    """
    A1, b1, C1, n1, J1 = e1
    A2, b2, C2, n2, J2 = e2
    p = A1.shape[0]
    eye = _eye(p, A1)
    # Left-apply D = (I + C1 J2)^-1 to [A1 | C1 | b1 + C1 eta2] in one
    # Gauss-Jordan pass.
    bn = b1 + _mv(C1, n2)
    sol = _solve(eye + _mm(C1, J2), torch.cat([A1, C1, bn[:, None]], dim=1))
    D_A1, D_C1, D_bn = sol[:, :p], sol[:, p:2 * p], sol[:, 2 * p]
    A12 = _mm(A2, D_A1)
    b12 = _mv(A2, D_bn) + b2
    C12 = _mm(_mm(A2, D_C1), _tr(A2)) + C2
    # Right block: (I + J2 C1)^-1 applied to [J2 | eta2 - J2 b1].
    er = n2 - _mv(J2, b1)
    sol2 = _solve(eye + _mm(J2, C1), torch.cat([J2, er[:, None]], dim=1))
    E_J2, E_r = sol2[:, :p], sol2[:, p]
    A1T = _tr(A1)
    n12 = _mv(A1T, E_r) + n1
    J12 = _mm(_mm(A1T, E_J2), A1) + J1
    return A12, b12, C12, n12, J12


def _compose_smooth(e1, e2):
    """Associative smoothing composition: e1 earlier, e2 later."""
    E1, g1, L1 = e1
    E2, g2, L2 = e2
    g = _mv(E1, g2) + g1
    return _mm(E1, E2), g, _mm(_mm(E1, L2), _tr(E1)) + L1


def _scan(op, elems, reverse=False):
    """Inclusive scan of an associative ``op(earlier, later)`` along the
    last axis of every member of ``elems``: log2(n) levels (Hillis-Steele).

    Forward, element k ends as e_0 * ... * e_k; with ``reverse`` as
    e_k * ... * e_{n-1}.  At each level every element is composed with the
    one ``d`` places before it (forward) or after it (reverse).
    """
    n = elems[0].shape[-1]
    d = 1
    while d < n:
        out = op(tuple(x[..., :n - d] for x in elems),
                 tuple(x[..., d:] for x in elems))
        if reverse:
            elems = tuple(torch.cat([o, x[..., n - d:]], dim=-1)
                          for o, x in zip(out, elems))
        else:
            elems = tuple(torch.cat([x[..., :d], o], dim=-1)
                          for o, x in zip(out, elems))
        d *= 2
    return elems


def _transitions_lanes(real_, dt):
    """Block-diagonal transitions A(dt) in (p, p, n) lane layout."""
    return _transitions(real_, dt).permute(1, 2, 0)


def _smoothing_elements(Pf, mf, Pp, mp, F, last):
    """Per-step smoothing elements (E, g, L) over all n, from the filtered
    and predicted moments; ``last`` is the index of the absorbing element
    (E = 0, g = mf, L = Pf).  The gain solve is regularized as the
    sequential smoother's."""
    p, _, n = Pf.shape
    eye = _eye(p, Pf)
    F_next = torch.cat([F[..., 1:], eye.expand(p, p, 1)], dim=-1)
    mp_next = torch.cat([mp[:, 1:], mp[:, -1:]], dim=-1)
    Pp_next = torch.cat([Pp[..., 1:], Pp[..., -1:]], dim=-1)
    tr_pp = torch.diagonal(Pp_next, dim1=0, dim2=1).sum(-1)
    Pp_r = Pp_next + 1e-12 * tr_pp * eye
    # G_k = Pf_k F_{k+1}^T Pp_r^-1  ->  G^T = Pp_r^-T (F Pf^T)^T.
    PfFT = _mm(Pf, _tr(F_next))
    G = _tr(_solve(_tr(Pp_r), _tr(PfFT)))
    g = mf - _mv(G, mp_next)
    L = Pf - _mm(_mm(G, Pp_next), _tr(G))
    is_last = torch.arange(n, device=Pf.device) == last
    E_s = torch.where(is_last, torch.zeros_like(G), G)
    g_s = torch.where(is_last, mf, g)
    L_s = torch.where(is_last, Pf, L)
    return E_s, g_s, L_s


def _observe(Hv, x):
    """H^T x over the lanes: (p, n) -> (n,)."""
    return torch.sum(x * Hv[:, None], dim=0)


def _observe2(Hv, X):
    """H^T X H over the lanes: (p, p, n) -> (n,)."""
    return torch.sum(X * Hv[:, None, None] * Hv[None, :, None], dim=(0, 1))


def parallel_filter_smoother(real_, dt, yv, rv, obs):
    """Associative-scan twin of ops/smoother._filter_smoother.

    Same contract: ``dt`` spacings (first 0), ``yv`` observed values
    (0 where missing), ``rv`` observation variances, ``obs`` 1/0
    flags, tensors on one device.  Returns (smoothed latent mean,
    smoothed latent var, data log-likelihood over observed points).
    """
    dtype, device = yv.dtype, yv.device
    n = dt.shape[0]
    p = real_.p
    Pinf = torch.as_tensor(real_.Pinf, dtype=dtype, device=device)
    H = torch.as_tensor(real_.H, dtype=dtype, device=device)
    eye3 = _eye(p, yv)
    Pinf3 = Pinf[:, :, None]

    F = _transitions_lanes(real_, dt.to(dtype))  # (p, p, n)
    Q = Pinf3 - _mm(_mm(F, Pinf3.expand(p, p, n)), _tr(F))

    # --- filtering elements (lane layout) -----------------------------------
    Hn = H[:, None].expand(p, n)
    QH = _mv(Q, Hn)  # (p, n) = Q H
    S = torch.sum(QH * H[:, None], dim=0) + rv  # (n,)
    K = QH / S
    ImKH = eye3 - K[:, None, :] * H[None, :, None]
    FTH = _mv(_tr(F), Hn)  # F^T H

    o = obs > 0
    A = torch.where(o, _mm(ImKH, F), F)
    b = torch.where(o, K * yv, torch.zeros((p, n), dtype=dtype,
                                           device=device))
    C = torch.where(o, _mm(ImKH, Q), Q)
    eta = torch.where(o, FTH * (yv / S), torch.zeros_like(b))
    J = torch.where(o, FTH[:, None, :] * (FTH / S)[None, :, :],
                    torch.zeros((p, p, n), dtype=dtype, device=device))

    # Prior element (A=0, b=0, C=Pinf) prepended so every data step uses
    # the generic formulas (the dt=0 first grid step has Q=0 and the
    # composition recovers the standard P^- = Pinf update).
    z1 = torch.zeros((p, 1), dtype=dtype, device=device)
    z2 = torch.zeros((p, p, 1), dtype=dtype, device=device)
    elems = (torch.cat([z2, A], -1), torch.cat([z1, b], -1),
             torch.cat([Pinf3, C], -1), torch.cat([z1, eta], -1),
             torch.cat([z2, J], -1))
    pref = _scan(_compose, elems)
    mf = pref[1][:, 1:]  # filtered means (p, n)
    Pf = pref[2][..., 1:]  # filtered covs (p, p, n)

    # --- predicted moments + marginal likelihood (vectorized) ---------------
    m_prev = torch.cat([z1, mf[:, :-1]], dim=-1)
    P_prev = torch.cat([Pinf3, Pf[..., :-1]], dim=-1)
    mp = _mv(F, m_prev)
    Pp = _mm(_mm(F, P_prev), _tr(F)) + Q
    Sp = _observe2(H, Pp) + rv
    innov = yv - _observe(H, mp)
    lls = -0.5 * (innov**2 / Sp + torch.log(Sp) + math.log(2 * math.pi))
    ll = torch.sum(torch.where(o, lls, torch.zeros_like(lls)))

    # --- smoothing: elements, then a reverse scan ---------------------------
    E_s, g_s, L_s = _smoothing_elements(Pf, mf, Pp, mp, F, n - 1)
    _, ms, Ps = _scan(_compose_smooth, (E_s, g_s, L_s), reverse=True)
    return _observe(H, ms), _observe2(H, Ps), ll


# The blocked engine's within-block length L.  Each torch op is a launch
# of its own and the card idles between them, so time follows launches:
# ~120 a step of the within-block passes, ~105 a level of the cross-block
# scans, fewest at the smallest L.  On the H100, L = 4 and 8 were the
# fastest of L = 4-512 from 512 to 1.1e6 merged points
# (tools/kalman_tune.py; PERF.md).
_BLOCK = 4


def blocked_filter_smoother(real_, dt, yv, rv, obs, block_size=None):
    """Two-level (blocked) Kalman filter + RTS smoother.

    Same contract and results as :func:`parallel_filter_smoother`, but
    the N axis splits into B blocks of L steps (``block_size``):

    1. a within-block sequential pass accumulates each block's
       cumulative filtering element (per-step cost O(p^2): the step's
       information matrix is rank-1, so every (I + C J)^-1 is a
       Sherman-Morrison update);
    2. a scan composes the B block elements (log2(B) levels);
    3. a second within-block pass runs the plain Kalman recursion from
       each block's incoming filtered moments;
    4-6. the same three-pass structure, mirrored, for the RTS smoother
       (per-step smoothing gains are computed vectorized over all N).

    Each within-block pass is a Python loop over the L steps, every step a
    few torch ops over the B block lanes; L defaults to ``_BLOCK``.
    Exact: agrees with the sequential filter/smoother to roundoff.
    """
    L = int(block_size or _BLOCK)
    return _blocked_fs_impl(real_, dt, yv, rv, obs, L)


def _blocked_fs_impl(real_, dt, yv, rv, obs, L):
    """Lane-layout (p, p, B) implementation of the blocked engine."""
    dtype, device = yv.dtype, yv.device
    n0 = dt.shape[0]
    p = real_.p
    b = -(-n0 // L)
    padn = b * L - n0
    if padn:
        # Inert steps: dt=0 (F=I, Q=0), unobserved.
        def pad(x, v):
            return torch.cat([x, torch.full((padn,), v, dtype=x.dtype,
                                            device=device)])

        dt, yv, rv, obs = (pad(dt, 0.0), pad(yv, 0.0), pad(rv, 1.0),
                           pad(obs, 0.0))
    n = b * L

    Pinf = torch.as_tensor(real_.Pinf, dtype=dtype, device=device)
    Hv = torch.as_tensor(real_.H, dtype=dtype, device=device)
    Pinf3 = Pinf[:, :, None]

    # Per-step quantities, lane layout (time axis LAST).
    F = _transitions_lanes(real_, dt.to(dtype))  # (p, p, n)
    Q = Pinf3 - _mm(_mm(F, Pinf3.expand(p, p, n)), _tr(F))
    Hn = Hv[:, None].expand(p, n)
    u = _mv(_tr(F), Hn)  # F^T H, (p, n)
    qh = _mv(Q, Hn)  # Q H, (p, n)
    s = torch.sum(qh * Hn, dim=0) + rv  # (n,)
    K = qh / s
    o = obs.to(dtype)

    # (.., n) -> (L, .., B): step j of block k lives at index k*L + j.
    def blkT(x):
        return x.reshape(x.shape[:-1] + (b, L)).movedim(-1, 0)

    FL, QL, uL, qhL, sL, KL, yL, rL, oL = map(
        blkT, (F, Q, u, qh, s, K, yv, rv, o))

    eyeB = _eye(p, yv).expand(p, p, b)
    zvB = torch.zeros((p, b), dtype=dtype, device=device)
    zmB = torch.zeros((p, p, b), dtype=dtype, device=device)

    # ---- pass 1: per-block cumulative filtering elements -------------------
    # Carry (A, b, C, eta, J) over the B lanes; each step composes one
    # rank-1-information element via Sherman-Morrison (O(p^2) lane ops
    # plus three (p, p) products).
    Ac, bc, Cc, ec, Jc = eyeB, zvB, zmB, zvB, zmB
    for j in range(L):
        Fn, un, qhn, sn, Kn, yn, on, Qn = (
            FL[j], uL[j], qhL[j], sL[j], KL[j], yL[j], oL[j], QL[j])
        Cu = _mv(Cc, un)  # (p, B)
        f = on / (sn + on * torch.sum(un * Cu, dim=0))  # (B,)
        uA = torch.sum(un[:, None, :] * Ac, dim=0)  # u^T A, (p, B)
        A_mid = Ac - Cu[:, None, :] * (uA * f)[None, :, :]
        bz = bc + Cu * (on * yn / sn)
        b_mid = bz - Cu * (torch.sum(un * bz, dim=0) * f)
        C_mid = Cc - Cu[:, None, :] * (Cu * f)[None, :, :]
        # A_n X = F X - o K (u^T X)   (A_n = (I - o K H) F).
        FA = _mm(Fn, A_mid)
        uAm = torch.sum(un[:, None, :] * A_mid, dim=0)
        Anew = FA - Kn[:, None, :] * (on * uAm)[None, :, :]
        Fb_ = _mv(Fn, b_mid)
        bnew = Fb_ - Kn * (on * torch.sum(un * b_mid, dim=0)) \
            + Kn * (on * yn)
        Y = _mm(Fn, C_mid)
        uCm = torch.sum(un[:, None, :] * C_mid, dim=0)
        Y = Y - Kn[:, None, :] * (on * uCm)[None, :, :]
        Yt = _tr(Y)
        Z = _mm(Fn, Yt)
        uYt = torch.sum(un[:, None, :] * Yt, dim=0)
        Z = Z - Kn[:, None, :] * (on * uYt)[None, :, :]
        Cnew = _tr(Z) + Qn - Kn[:, None, :] * (on * qhn)[None, :, :]
        Au = torch.sum(Ac * un[:, None, :], dim=0)  # A^T u, (p, B)
        enew = ec + Au * ((yn - torch.sum(un * bc, dim=0)) * f)
        Jnew = Jc + Au[:, None, :] * (Au * f)[None, :, :]
        Ac, bc, Cc, ec, Jc = Anew, bnew, Cnew, enew, Jnew

    # ---- cross-block prefix (prior prepended) ------------------------------
    z1 = torch.zeros((p, 1), dtype=dtype, device=device)
    z2 = torch.zeros((p, p, 1), dtype=dtype, device=device)
    elems = (torch.cat([z2, Ac], -1), torch.cat([z1, bc], -1),
             torch.cat([Pinf3, Cc], -1), torch.cat([z1, ec], -1),
             torch.cat([z2, Jc], -1))
    pref = _scan(_compose, elems)
    # Incoming filtered moments for block k = prefix over [prior,
    # blocks 0..k-1] = inclusive prefix at index k.
    m = pref[1][:, :b]  # (p, B)
    P = pref[2][..., :b]  # (p, p, B)

    # ---- pass 2: plain Kalman recursion from each block's incoming ---------
    HB = Hv[:, None].expand(p, b)
    mfL, PfL, mpL, PpL, llL = [], [], [], [], []
    for j in range(L):
        Fn, Qn, yn, rn, on = FL[j], QL[j], yL[j], rL[j], oL[j]
        mp = _mv(Fn, m)
        Pp = _mm(_mm(Fn, P), _tr(Fn)) + Qn
        Ph = _mv(Pp, HB)
        sn = torch.sum(HB * Ph, dim=0) + rn
        k = Ph / sn
        innov = yn - torch.sum(HB * mp, dim=0)
        m = mp + k * (on * innov)
        P = Pp - k[:, None, :] * (on * sn * k)[None, :, :]
        ll = -0.5 * (innov**2 / sn + torch.log(sn) + math.log(2 * math.pi))
        mfL.append(m)
        PfL.append(P)
        mpL.append(mp)
        PpL.append(Pp)
        llL.append(on * ll)
    ll = torch.sum(torch.stack(llL))

    # [(.., B)] * L -> (.., n)
    def unblk(xs):
        return torch.stack(xs, dim=-1).reshape(xs[0].shape[:-1] + (n,))

    mf, Pf, mp, Pp = map(unblk, (mfL, PfL, mpL, PpL))

    # ---- smoothing elements, vectorized over all n (lane layout) -----------
    # Absorbing element at the last REAL index; padded steps beyond it are
    # inert (their output is discarded).
    EL, gL, LL = map(blkT, _smoothing_elements(Pf, mf, Pp, mp, F, n0 - 1))

    # ---- pass S1: per-block cumulative smoothing elements ------------------
    Se, Sg, Sl = eyeB, zvB, zmB
    for j in range(L - 1, -1, -1):
        En, gn, Ln = EL[j], gL[j], LL[j]
        Se, Sg, Sl = (_mm(En, Se), _mv(En, Sg) + gn,
                      _mm(_mm(En, Sl), _tr(En)) + Ln)

    # ---- cross-block reverse scan -> incoming right states -----------------
    _, sg, sl = _scan(_compose_smooth, (Se, Sg, Sl), reverse=True)
    # Incoming for block k = (g, L) of the suffix over blocks k+1..;
    # zeros for the last block (its absorbing element ignores them).
    ms = torch.cat([sg[:, 1:], z1], dim=-1)
    Ps = torch.cat([sl[..., 1:], z2], dim=-1)

    # ---- pass S2: apply per-step elements from the right -------------------
    meanL, varL = [None] * L, [None] * L
    for j in range(L - 1, -1, -1):
        En, gn, Ln = EL[j], gL[j], LL[j]
        ms = _mv(En, ms) + gn
        Ps = _mm(_mm(En, Ps), _tr(En)) + Ln
        meanL[j] = _observe(Hv, ms)
        varL[j] = _observe2(Hv, Ps)
    return unblk(meanL)[:n0], unblk(varL)[:n0], ll


def _predict_var_device(real_, t_train, diag, resid, t_test, jitter, engine,
                        sorted_test=False):
    """Merged-grid predict on the tensors' device: merge + scatter +
    ``engine`` + gather, no host round trip.

    ``engine(real_, dt, yv, rv, obs)`` is a filter-smoother with the
    contract of :func:`parallel_filter_smoother`.  With ``sorted_test``
    (test times sorted, as the caller knows) the merge is two
    ``searchsorted`` binary searches and scatters; otherwise a stable
    argsort of all n + m times.  Ties place the train point first in
    both, so the two give the same grid bit for bit.  Returns the
    smoothed (mean, var) at the test points, in their order.
    """
    n = t_train.shape[0]
    m = t_test.shape[0]
    dtype, device = t_train.dtype, t_train.device
    if sorted_test:
        # Global position of train[i]: i + #{test < train[i]} (test
        # ties go after train); of test[j]: j + #{train <= test[j]}.
        pos_train = torch.arange(n, device=device) + torch.searchsorted(
            t_test, t_train, side="left")
        test_pos = torch.arange(m, device=device) + torch.searchsorted(
            t_train, t_test, side="right")
        nm = n + m
        t_s = torch.zeros(nm, dtype=dtype, device=device)
        t_s[pos_train] = t_train
        t_s[test_pos] = t_test
        yv = torch.zeros(nm, dtype=resid.dtype, device=device)
        yv[pos_train] = resid
        rv = torch.ones(nm, dtype=dtype, device=device)
        rv[pos_train] = diag + jitter
        obs = torch.zeros(nm, dtype=dtype, device=device)
        obs[pos_train] = 1.0
    else:
        t_all = torch.cat([t_train, t_test])
        order = torch.argsort(t_all, stable=True)
        t_s = t_all[order]
        is_train = order < n
        src = torch.where(is_train, order, 0)
        yv = torch.where(is_train, resid[src], 0.0)
        rv = torch.where(is_train, diag[src] + jitter, 1.0)
        obs = is_train.to(dtype)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(n + m, device=device)
        test_pos = inv[n:]
    dt = torch.cat([torch.zeros(1, dtype=dtype, device=device),
                    torch.diff(t_s)])
    mean_s, var_s, _ = engine(real_, dt, yv, rv, obs)
    return mean_s[test_pos], var_s[test_pos]


def predict_var_parallel(coeffs, t_train, diag, resid, t_test,
                         block_size=None, device=None):
    """Parallel twin of ops/smoother.predict_var (same contract).

    Uses the two-level blocked filter/smoother, with the grid merge on
    the device too (:func:`_predict_var_device`): the stable argsort, as
    in the JAX package, whatever the order of the test times.  Returns
    numpy (mean, var) at ``t_test``.
    """
    real_, jitter = _realized(coeffs)
    dev = resolve_device(device)
    L = int(block_size or _BLOCK)

    def put(x):
        return torch.as_tensor(_host(x), dtype=torch.float64, device=dev)

    mean, var = _predict_var_device(
        real_, put(t_train), put(diag), put(resid), put(t_test), jitter,
        lambda *grid: _blocked_fs_impl(*grid, L))
    return mean.cpu().numpy(), var.cpu().numpy()
