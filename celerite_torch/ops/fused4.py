"""Fused log-likelihood and its gradient over a lane plan: CUDA kernels and
their plain versions.

Port of ``celerite_tpu/ops/fused4.py``.  Each of the B virtual lanes owns a
contiguous chunk of the series.  Phase 0 lowers the packed coefficients per
step and accumulates each lane's Riccati element (A, J, C); a segmented
Hillis-Steele prefix over lanes composes them into every lane's seed.
Phase 1 reruns each lane from its seed and accumulates the affine
forward-substitution map (M, m) and the statistics (Kahan-summed quad and
log-det, qv, Qm, min pivot); a second prefix over (M, m) gives each lane its
incoming state h and ``quad_l = q0 - 2 qv.h + h^T Qm h``.

The value (``run_primal``):

- :func:`primal_cuda` launches ``celerite_torch/csrc/fused4_primal.cu``;
- :func:`primal_reference` is the plain torch version (Python loop over the
  L steps, vectorised over lanes), differentiable with autograd.

The gradient (``build_ll_and_grad``, the port of fused4.py:1057-1150): the
same two phases split into four per-lane kernels with per-step saves, and
the cross-lane prefixes as torch glue in float64 between them::

    elem_fwd -> prefix_sh0 -> factor_fwd -> lane_quad / assemble  (forward)
    factor_bwd -> VJP of prefix_sh0 -> elem_bwd                   (backward)

Each kernel has a ``*_cuda`` wrapper (``celerite_torch/csrc/fused4_grad.cu``,
CUDA tensors only, with a ``.launches`` counter) and a ``*_reference``
plain version; the dispatchers ``elem_fwd`` etc. take the kernel for CUDA
plans and the plain version for CPU plans.  The backward kernels are the
hand-written transposes of the forward steps (the F1-F9 / E1-E12 comments
follow the Pallas bodies) and accumulate the packed-coefficient cotangent
per lane through :func:`chain_step`.

Float32 plans keep the per-lane recursions in float32; the cross-lane glue
(prefixes, assembly, their VJPs and the per-segment cotangent sums) runs in
float64: a float32 prefix loses runs of lanes to non-positive pivots
(PERF.md).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import ds
from .lanes4 import Plan4, cf_len, pack_cf

__all__ = ["primal_reference", "primal_cuda", "run_primal", "build_ll",
           "gp_log_likelihood", "MAX_WIDTH", "chain_step",
           "elem_fwd_reference", "factor_fwd_reference",
           "factor_bwd_reference", "elem_bwd_reference", "elem_fwd_cuda",
           "factor_fwd_cuda", "factor_bwd_cuda", "elem_bwd_cuda", "elem_fwd",
           "factor_fwd", "factor_bwd", "elem_bwd", "prefix_sh0", "prefix_h0",
           "lane_quad", "assemble_ll", "build_ll_and_grad", "GRAD_KERNELS"]

MAX_WIDTH = 12


# ---------------------------------------------------------------------------
# Plain version: lane-batched helpers on (P, P, B) / (P, B) tensors
# ---------------------------------------------------------------------------


def _mm(x, y):
    """(P, P, B) batched matmul over the two leading dims."""
    acc = x[:, 0:1] * y[0:1, :]
    for k in range(1, x.shape[0]):
        acc = acc + x[:, k:k + 1] * y[k:k + 1, :]
    return acc


def _tr(x):
    return x.transpose(0, 1)


def _eye(p, b, like):
    return torch.eye(p, dtype=like.dtype, device=like.device)[:, :, None].expand(
        p, p, b
    )


def _inv(m):
    """Unrolled Gauss-Jordan inverse over the leading (P, P) dims."""
    p, b = m.shape[0], m.shape[-1]
    aug = torch.cat([m, _eye(p, b, m)], dim=1)  # (P, 2P, B)
    for k in range(p):
        row = aug[k:k + 1] / aug[k:k + 1, k:k + 1]
        elim = aug - aug[:, k:k + 1] * row
        aug = torch.cat([elim[:k], row, elim[k + 1:]])
    return aug[:, p:]


def _compose_elem(a1, j1, c1, a2, j2, c2, eye):
    """Riccati (A, J, C) composition, e1 first."""
    e = _inv(eye + _mm(c1, j2))
    j2e = _mm(j2, e)
    a12 = _mm(a2, _mm(e, a1))
    c12 = _mm(_mm(a2, e), _mm(c1, _tr(a2))) + c2
    j12 = j1 + _mm(_tr(a1), _mm(j2e, a1))
    return a12, j12, c12


def _lane_planes(cf, b):
    """(C,) or (n_chain, C) coefficients -> (C, B) per-lane planes."""
    if cf.ndim == 1:
        return cf[:, None].expand(cf.shape[0], b)
    nc = cf.shape[0]
    return torch.repeat_interleave(cf.T, b // nc, dim=1)


def _lower_step(cfp, jr, jc, t, tl, dt, dg, m):
    """(u, v, ph) as (P, B) and a as (B,) for one step (fused4._lower_step)."""
    cols_u, cols_v, cols_p = [], [], []
    for j in range(jr):
        cols_u.append(cfp[j] * m)
        cols_v.append(m)
        cols_p.append(ds.exp_rn(-cfp[jr + j] * dt))
    for j in range(jc):
        ac = cfp[2 * jr + j]
        bc = cfp[2 * jr + jc + j]
        cc = cfp[2 * jr + 2 * jc + j]
        dc = cfp[2 * jr + 3 * jc + j]
        cs, sn = ds.ds_cos_sin(*ds.reduced_angle(dc, t, tl))
        cm = cs * m
        sm = sn * m
        ph = ds.exp_rn(-cc * dt)
        cols_u += [ac * cm + bc * sm, ac * sm - bc * cm]
        cols_v += [cm, sm]
        cols_p += [ph, ph]
    a = m * (dg + cfp[2 * jr + 4 * jc]) + (1.0 - m)
    return torch.stack(cols_u), torch.stack(cols_v), torch.stack(cols_p), a


def _riccati(Sh, u, v, ph, a):
    S = ph[:, None] * Sh * ph[None, :]
    su = torch.sum(S * u[None, :], dim=1)
    d = a - torch.sum(u * su, dim=0)
    w = (v - su) / d
    return S + d * w[:, None] * w[None, :], d, w


def primal_reference(cf, plan: Plan4, jr, jc, y=None, seg=None):
    """Per-lane ``(quad, ld, mind)``, each ``(B,)``: the plain torch version.

    ``cf`` is a ``(C,)`` vector or an ``(n_chain, C)`` batch on a
    chain-folded plan; ``seg`` (default ``B / n_chain``) is the lane count
    of one independent segment.  Differentiable with autograd.
    """
    L, b = plan.t.shape
    p = jr + 2 * jc
    nc = 1 if cf.ndim == 1 else cf.shape[0]
    if seg is None:
        seg = b // nc
    y = plan.y if y is None else y
    dtype = plan.t.dtype
    cfp = _lane_planes(cf.to(dtype), b)
    eye = _eye(p, b, plan.t)
    lidx = torch.arange(b, device=plan.t.device) % seg  # lane in segment

    def step(i):
        return _lower_step(cfp, jr, jc, plan.t[i], plan.t_lo[i], plan.dt[i],
                           plan.diag[i], plan.mask[i])

    # Phase 0: each lane's Riccati element.
    Sh = torch.zeros_like(eye)
    Ac, Jc = eye, torch.zeros_like(eye)
    for i in range(L):
        u, v, ph, a = step(i)
        Sh, d, w = _riccati(Sh, u, v, ph, a)
        uAc = torch.sum(Ac * (ph * u)[:, None], dim=0)
        Ac = ph[:, None] * Ac - w[:, None] * uAc[None, :]
        Jc = Jc - uAc[:, None] * (uAc / d)[None, :]

    # Segmented Hillis-Steele prefix; exclusive shift gives the seeds.  The
    # cross-lane work runs in float64 for float32 streams too, as in the
    # kernel (csrc/fused4_primal.cu).
    A_s, J_s, C_s = Ac.double(), Jc.double(), Sh.double()
    eye64 = eye.double()
    s = 1
    while s < seg:
        ca, cj, cc = _compose_elem(
            torch.roll(A_s, s, -1), torch.roll(J_s, s, -1),
            torch.roll(C_s, s, -1), A_s, J_s, C_s, eye64,
        )
        keep = lidx < s
        A_s = torch.where(keep, A_s, ca)
        J_s = torch.where(keep, J_s, cj)
        C_s = torch.where(keep, C_s, cc)
        s *= 2
    Sh = torch.where(lidx == 0, torch.zeros_like(C_s),
                     torch.roll(C_s, 1, -1)).to(dtype)

    # Phase 1: seeded factorization + affine map + statistics.
    Mc = eye
    mc = torch.zeros_like(eye[0])
    Qm = torch.zeros_like(eye)
    qv = torch.zeros_like(mc)
    q0 = cq0 = ld = cld = torch.zeros_like(mc[0])
    mind = torch.full_like(q0, math.inf)
    for i in range(L):
        u, v, ph, a = step(i)
        Sh, d, w = _riccati(Sh, u, v, ph, a)
        PhM = ph[:, None] * Mc
        g = torch.sum(PhM * u[:, None], dim=0)
        Mc = PhM - w[:, None] * g[None, :]
        mh = ph * mc
        z0 = y[i] - torch.sum(u * mh, dim=0)
        mc = mh + w * z0
        x1 = z0 * z0 / d - cq0
        t1 = q0 + x1
        cq0 = (t1 - q0) - x1
        q0 = t1
        x2 = torch.log(d) - cld
        t2 = ld + x2
        cld = (t2 - ld) - x2
        ld = t2
        qv = qv + (z0 / d) * g
        Qm = Qm + g[:, None] * (g / d)[None, :]
        mind = torch.minimum(mind, d)

    # Affine prefix over lanes, then the quadratic-form assembly.
    M_s, m_s = Mc.double(), mc.double()
    s = 1
    while s < seg:
        cm = _mm(M_s, torch.roll(M_s, s, -1))
        cv = torch.sum(M_s * torch.roll(m_s, s, -1)[None, :], dim=1) + m_s
        keep = lidx < s
        M_s = torch.where(keep, M_s, cm)
        m_s = torch.where(keep, m_s, cv)
        s *= 2
    h = torch.where(lidx == 0, torch.zeros_like(m_s), torch.roll(m_s, 1, -1))
    Qh = torch.sum(Qm.double() * h[None, :], dim=1)
    quad = (q0.double() + cq0.double()) - 2.0 * torch.sum(qv.double() * h, dim=0) \
        + torch.sum(h * Qh, dim=0)
    return quad.to(dtype), (ld.double() + cld.double()).to(dtype), mind


# ---------------------------------------------------------------------------
# Gradient pipeline, plain versions: the four per-lane sweeps with saves
# ---------------------------------------------------------------------------


def _step_fn(cf, plan, jr, jc):
    """Per-step lowering closure and the (C, B) coefficient planes."""
    cfp = _lane_planes(cf.to(plan.t.dtype), plan.t.shape[1])

    def step(i):
        return _lower_step(cfp, jr, jc, plan.t[i], plan.t_lo[i], plan.dt[i],
                           plan.diag[i], plan.mask[i])

    return cfp, step


def _front(Shin, u, v, ph, a):
    """The Riccati step's intermediates (S, su, d, w) from its input."""
    S = ph[:, None] * Shin * ph[None, :]
    su = torch.sum(S * u[None, :], dim=1)
    d = a - torch.sum(u * su, dim=0)
    w = (v - su) / d
    return S, su, d, w


def _riccati_adjoint(Shin, S, su, d, w, u, ph, hSh, hw, hd, hu, hph):
    """Steps 5-1 of both backward sweeps (F5-F1 = E5-E1).

    Transposes ``Sh_out = S + d w w^T``, ``w = (v - su)/d``,
    ``d = a - u.su``, ``su = S u`` and ``S = Phi Shin Phi``; returns
    ``(hu, hv, hph, ha, hShin)``.
    """
    hS = hSh
    hd = hd + torch.sum(hSh * w[:, None] * w[None, :], dim=(0, 1))
    hw = hw + d * torch.sum((hSh + _tr(hSh)) * w[None, :], dim=1)
    hv = hw / d
    hsu = -hw / d
    hd = hd - torch.sum(hw * w, dim=0) / d
    ha = hd
    hu = hu - hd * su
    hsu = hsu - hd * u
    hu = hu + torch.sum(S * hsu[:, None], dim=0)
    hS = hS + hsu[:, None] * u[None, :]
    X = hS * Shin
    hph = hph + torch.sum((X + _tr(X)) * ph[None, :], dim=1)
    return hu, hv, hph, ha, ph[:, None] * hS * ph[None, :]


def chain_step(cfp, jr, jc, hu, hv, hph, ha, v, ph, t, tl, dt, m, hcf):
    """Add one step's packed-coefficient cotangent into ``hcf`` (C, B).

    Hand-written transpose of :func:`_lower_step` (fused4.py:239-267).  The
    decay and the phase are the forward step's own rounded values: a
    complex pair's ``(cos, sin) * m`` are its columns of ``v`` and its decay
    is ``ph``, so d(phi)/d(c) = -dt phi and d(angle)/d(d) = t + t_lo use
    the same transcendentals as the value.
    """
    for j in range(jr):
        hcf[j] += hu[j] * m
        hcf[jr + j] += hph[j] * ph[j] * (-dt)
    for j in range(jc):
        p0 = jr + 2 * j
        p1 = p0 + 1
        ac = cfp[2 * jr + j]
        bc = cfp[2 * jr + jc + j]
        cm, sm = v[p0], v[p1]
        hcf[2 * jr + j] += hu[p0] * cm + hu[p1] * sm
        hcf[2 * jr + jc + j] += hu[p0] * sm - hu[p1] * cm
        hcf[2 * jr + 2 * jc + j] += (hph[p0] + hph[p1]) * ph[p0] * (-dt)
        hcm = ac * hu[p0] - bc * hu[p1] + hv[p0]
        hsm = bc * hu[p0] + ac * hu[p1] + hv[p1]
        # cm = cos(ang) m, sm = sin(ang) m: d cm/d ang = -sm, d sm/d ang = cm.
        hcf[2 * jr + 3 * jc + j] += (hsm * cm - hcm * sm) * (t + tl)
    hcf[2 * jr + 4 * jc] += ha * m


def elem_fwd_reference(cf, plan: Plan4, jr, jc, seg=None, keep_saves=True):
    """Phase 0 with saves (fused4.py:499 ``_elem_fwd_kernel``).

    Returns each lane's element ``(A, J, C)``, each ``(P, P, B)``, and the
    saves ``(L, 2P^2, B)``: the step's input ``[Sh, A]`` (None with
    ``keep_saves=False``).  ``seg`` is accepted for the wrappers' common
    signature; phase 0 is per lane.
    """
    L, b = plan.t.shape
    _, step = _step_fn(cf, plan, jr, jc)
    p = jr + 2 * jc
    eye = _eye(p, b, plan.t)
    Sh, A, J = torch.zeros_like(eye), eye, torch.zeros_like(eye)
    saves = []
    for i in range(L):
        u, v, ph, a = step(i)
        if keep_saves:
            saves.append(torch.cat([Sh.reshape(p * p, b),
                                    A.reshape(p * p, b)]))
        Sh, d, w = _riccati(Sh, u, v, ph, a)
        uA = torch.sum(A * (ph * u)[:, None], dim=0)
        A = ph[:, None] * A - w[:, None] * uA[None, :]
        J = J - uA[:, None] * (uA / d)[None, :]
    return A, J, Sh, torch.stack(saves) if keep_saves else None


def factor_fwd_reference(cf, plan: Plan4, jr, jc, y, sh0, seg=None,
                         keep_saves=True):
    """Phase 1 with saves (fused4.py:619 ``_factor_fwd_kernel``).

    ``sh0`` is each lane's float64 seed ``(P, P, B)``.  Returns ``(M, m,
    Qm, qv, q0, ld, mind, saves)``: the affine map and statistics per lane
    in the plan's dtype, except ``q0`` and ``ld``, whose Kahan pairs are
    added in float64; the saves ``(L, 2P^2 + P, B)`` are the step's input
    ``[Sh, M, m]`` (None with ``keep_saves=False``).
    """
    L, b = plan.t.shape
    _, step = _step_fn(cf, plan, jr, jc)
    p = jr + 2 * jc
    eye = _eye(p, b, plan.t)
    Sh = sh0.to(plan.t.dtype)
    M, mv = eye, torch.zeros_like(eye[0])
    Qm, qv = torch.zeros_like(eye), torch.zeros_like(mv)
    q0 = cq0 = ld = cld = torch.zeros_like(mv[0])
    mind = torch.full_like(q0, math.inf)
    saves = []
    for i in range(L):
        u, v, ph, a = step(i)
        if keep_saves:
            saves.append(torch.cat([Sh.reshape(p * p, b),
                                    M.reshape(p * p, b), mv]))
        Sh, d, w = _riccati(Sh, u, v, ph, a)
        PhM = ph[:, None] * M
        g = torch.sum(PhM * u[:, None], dim=0)
        M = PhM - w[:, None] * g[None, :]
        mh = ph * mv
        z0 = y[i] - torch.sum(u * mh, dim=0)
        mv = mh + w * z0
        x1 = z0 * z0 / d - cq0
        t1 = q0 + x1
        cq0 = (t1 - q0) - x1
        q0 = t1
        x2 = torch.log(d) - cld
        t2 = ld + x2
        cld = (t2 - ld) - x2
        ld = t2
        qv = qv + (z0 / d) * g
        Qm = Qm + g[:, None] * (g / d)[None, :]
        mind = torch.minimum(mind, d)
    return (M, mv, Qm, qv, q0.double() + cq0.double(),
            ld.double() + cld.double(), mind,
            torch.stack(saves) if keep_saves else None)


def factor_bwd_reference(cf, plan: Plan4, jr, jc, y, saves, hM, hm, hQm, hqv,
                         hq0, hld, seg=None):
    """Reversed phase 1 (fused4.py:686 ``_factor_bwd_kernel``).

    Takes the cotangents of ``factor_fwd``'s outputs (float64 from the
    glue; cast to the plan's dtype here, as the kernel does) and returns
    the per-lane coefficient cotangent rows ``hcf (C, B)``, the data
    cotangent ``hy (L, B)`` and the seed cotangent ``hsh0 (P, P, B)``.
    """
    L, b = plan.t.shape
    dtype = plan.t.dtype
    cfp, step = _step_fn(cf, plan, jr, jc)
    p = jr + 2 * jc
    hM, hm, hQm, hqv, hq0, hld = (x.to(dtype)
                                  for x in (hM, hm, hQm, hqv, hq0, hld))
    hQs = hQm + _tr(hQm)  # hQm enters only symmetrised
    hSh = torch.zeros_like(hM)
    hcf = torch.zeros(cf_len(jr, jc), b, dtype=dtype, device=plan.t.device)
    hy = torch.empty(L, b, dtype=dtype, device=plan.t.device)
    for i in range(L - 1, -1, -1):
        u, v, ph, a = step(i)
        sv = saves[i]
        Shin = sv[:p * p].reshape(p, p, b)
        Mprev = sv[p * p:2 * p * p].reshape(p, p, b)
        mprev = sv[2 * p * p:]
        S, su, d, w = _front(Shin, u, v, ph, a)
        PhM = ph[:, None] * Mprev
        g = torch.sum(PhM * u[:, None], dim=0)
        mh = ph * mprev
        z0 = y[i] - torch.sum(u * mh, dim=0)
        # E12: the statistics (constant cotangents, one term a step).
        hqv_g = torch.sum(hqv * g, dim=0)
        hQs_g = torch.sum(hQs * g[None, :], dim=1)
        gQg = 0.5 * torch.sum(g * hQs_g, dim=0)  # g^T hQm g
        hz0 = hq0 * (2.0 * z0 / d) + hqv_g / d
        hd = (-hq0 * z0 * z0 / (d * d) + hld / d - hqv_g * z0 / (d * d)
              - gQg / (d * d))
        hg = hqv * (z0 / d) + hQs_g / d
        # E11: m_out = mh + w z0
        hw = hm * z0
        hz0 = hz0 + torch.sum(hm * w, dim=0)
        # E10: z0 = y - u.mh
        hy[i] = hz0
        hu = -hz0 * mh
        hmh = hm - hz0 * u
        # E9: mh = ph * mprev
        hph = hmh * mprev
        hm = hmh * ph
        # E8: M_out = PhM - w g^T
        hw = hw - torch.sum(hM * g[None, :], dim=1)
        hg = hg - torch.sum(hM * w[:, None], dim=0)
        # E7: g = PhM^T u
        hu = hu + torch.sum(PhM * hg[None, :], dim=1)
        hPhM = hM + u[:, None] * hg[None, :]
        # E6: PhM = Phi Mprev
        hph = hph + torch.sum(hPhM * Mprev, dim=1)
        hM = ph[:, None] * hPhM
        # E5-E1: the Riccati step.
        hu, hv, hph, ha, hSh = _riccati_adjoint(Shin, S, su, d, w, u, ph,
                                                hSh, hw, hd, hu, hph)
        chain_step(cfp, jr, jc, hu, hv, hph, ha, v, ph, plan.t[i],
                   plan.t_lo[i], plan.dt[i], plan.mask[i], hcf)
    return hcf, hy, hSh


def elem_bwd_reference(cf, plan: Plan4, jr, jc, saves, hA0, hJ0, hC0,
                       seg=None):
    """Reversed phase 0 (fused4.py:533 ``_elem_bwd_kernel``).

    Takes the cotangents of each lane's element (float64 from the prefix
    VJP; cast here, as the kernel does) and returns the per-lane
    coefficient cotangent rows ``hcf (C, B)``.
    """
    L, b = plan.t.shape
    dtype = plan.t.dtype
    cfp, step = _step_fn(cf, plan, jr, jc)
    p = jr + 2 * jc
    hA, hJ, hSh = (x.to(dtype) for x in (hA0, hJ0, hC0))
    hJs = hJ + _tr(hJ)  # constant through the sweep, enters symmetrised
    hcf = torch.zeros(cf_len(jr, jc), b, dtype=dtype, device=plan.t.device)
    for i in range(L - 1, -1, -1):
        u, v, ph, a = step(i)
        sv = saves[i]
        Shin = sv[:p * p].reshape(p, p, b)
        A_in = sv[p * p:].reshape(p, p, b)
        S, su, d, w = _front(Shin, u, v, ph, a)
        ut = ph * u
        uAc = torch.sum(A_in * ut[:, None], dim=0)
        # F9: J_out = J_in - uAc (uAc/d)^T
        hJs_u = torch.sum(hJs * uAc[None, :], dim=1)
        huAc = -hJs_u / d
        hd = 0.5 * torch.sum(uAc * hJs_u, dim=0) / (d * d)
        # F8: A_out = Phi A_in - w uAc^T
        hph = torch.sum(hA * A_in, dim=1)
        hw = -torch.sum(hA * uAc[None, :], dim=1)
        huAc = huAc - torch.sum(hA * w[:, None], dim=0)
        # F7: uAc = A_in^T ut
        hut = torch.sum(A_in * huAc[None, :], dim=1)
        hA = ph[:, None] * hA + ut[:, None] * huAc[None, :]
        # F6: ut = ph * u
        hph = hph + hut * u
        hu = hut * ph
        # F5-F1: the Riccati step.
        hu, hv, hph, ha, hSh = _riccati_adjoint(Shin, S, su, d, w, u, ph,
                                                hSh, hw, hd, hu, hph)
        chain_step(cfp, jr, jc, hu, hv, hph, ha, v, ph, plan.t[i],
                   plan.t_lo[i], plan.dt[i], plan.mask[i], hcf)
    return hcf


# ---------------------------------------------------------------------------
# Gradient pipeline glue: the cross-lane prefixes in float64, torch ops
# differentiated by autograd.  Layout (n_seg, seg, P, P): a Hillis-Steele
# round composes lanes [s, seg) of every segment with lanes [0, seg - s)
# by slicing, so no composition crosses a segment boundary (a non-finite
# segment cannot reach another's gradient), and one round is a fixed
# handful of batched matmuls and one inverse whatever B and P.
# ---------------------------------------------------------------------------


def _segments(x, seg):
    """(P, P, B) -> (B / seg, seg, P, P), or (P, B) -> (B / seg, seg, P);
    float64."""
    x = x.double().movedim(-1, 0)
    return x.reshape(x.shape[0] // seg, seg, *x.shape[1:])


def _lanes_last(x):
    """(n_seg, seg, ...) -> (..., B): the inverse of :func:`_segments`."""
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]).movedim(0, -1)


def _exclusive(x):
    """out[:, l] = x[:, l - 1] inside a segment, 0 at its first lane."""
    return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], 1)


def _compose(a1, j1, c1, a2, j2, c2, eye, last=False):
    """Riccati (A, J, C) composition, e1 first, with E = (I + C1 J2)^-1:
    A = A2 E A1, C = A2 E C1 A2^T + C2, J = J1 + A1^T J2 E A1.  ``last``:
    only C is needed."""
    p = eye.shape[0]
    e = torch.linalg.inv_ex(eye + c1 @ j2).inverse
    if last:
        return None, None, a2 @ (e @ (c1 @ a2.mT)) + c2
    r = e @ torch.cat([a1, c1 @ a2.mT], -1)  # [E A1 | E C1 A2^T]
    ar = a2 @ r
    return ar[..., :p], j1 + a1.mT @ (j2 @ r[..., :p]), ar[..., p:] + c2


def prefix_sh0(A, J, C, seg):
    """Each lane's seed: the exclusive segmented prefix of the elements.

    The port of fused4.py:972 ``_prefix_sh0``.  Takes ``(P, P, B)``
    elements of any float dtype and returns the float64 seeds ``(P, P,
    B)``.  Differentiable with autograd.
    """
    A, J, C = (_segments(x, seg) for x in (A, J, C))
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    s = 1
    while s < seg:
        a12, j12, c12 = _compose(A[:, :-s], J[:, :-s], C[:, :-s], A[:, s:],
                                 J[:, s:], C[:, s:], eye, last=2 * s >= seg)
        C = torch.cat([C[:, :s], c12], 1)
        if a12 is not None:
            A = torch.cat([A[:, :s], a12], 1)
            J = torch.cat([J[:, :s], j12], 1)
        s *= 2
    return _lanes_last(_exclusive(C))


def prefix_h0(M, m, seg):
    """Each lane's incoming state ``h``: the exclusive segmented prefix of
    the affine maps ``h -> M h + m``.

    Takes ``(P, P, B)`` and ``(P, B)`` of any float dtype and returns the
    float64 ``(P, B)``.  Differentiable with autograd.
    """
    p = M.shape[0]
    # [M | m] per lane: one matmul composes the map and its offset.
    Mm = torch.cat([_segments(M, seg), _segments(m, seg)[..., None]], -1)
    s = 1
    while s < seg:
        c = Mm[:, s:, :, :p] @ Mm[:, :-s]
        c = torch.cat([c[..., :p], c[..., p:] + Mm[:, s:, :, p:]], -1)
        Mm = torch.cat([Mm[:, :s], c], 1)
        s *= 2
    return _lanes_last(_exclusive(Mm[..., p]))


def lane_quad(M, m, Qm, qv, q0, seg):
    """Per-lane ``quad_l = q0 - 2 qv.h + h^T Qm h`` in float64 ``(B,)``.

    ``h`` is each lane's incoming state (:func:`prefix_h0`;
    fused4.py:1003 ``_assemble_ll``).  Differentiable with autograd.
    """
    h = prefix_h0(M, m, seg)
    Qm, qv = Qm.double(), qv.double()
    Qh = torch.sum(Qm * h[None, :], dim=1)
    return q0.double() - 2.0 * torch.sum(qv * h, dim=0) \
        + torch.sum(h * Qh, dim=0)


def _n_term(n, like):
    """``n log 2 pi`` in ``like``'s dtype: ``n`` is a point count, or a
    tensor of them per segment (a fleet plan's ``Plan4.n``)."""
    if isinstance(n, torch.Tensor):
        n = n.to(device=like.device, dtype=like.dtype)
    return n * math.log(2.0 * math.pi)


def assemble_ll(quad, ld, n, seg):
    """Per-segment ``ll = -0.5 (sum quad + sum ld + n log 2 pi)``; ``n`` is
    the plan's count, per segment for a fleet plan."""
    nseg = quad.shape[0] // seg
    quad = quad.double()
    return -0.5 * (quad.reshape(nseg, seg).sum(1)
                   + ld.double().reshape(nseg, seg).sum(1)
                   + _n_term(n, quad))


# ---------------------------------------------------------------------------
# The CUDA kernels: ctypes entry points and their wrappers
# ---------------------------------------------------------------------------

# Pointer arguments of each entry point; every one then takes (L, B, jr,
# seg, stream).
_NPTR = {"primal": 11, "elem_fwd": 10, "factor_fwd": 16, "factor_bwd": 17,
         "elem_bwd": 11}
_SOURCE = {"primal": "fused4_primal.cu"}
GRAD_KERNELS = ("elem_fwd", "factor_fwd", "factor_bwd", "elem_bwd")


@functools.lru_cache(maxsize=None)
def _kernel_fn(name, p, dtype):
    """The ctypes entry point ``name`` for width ``p`` and ``dtype``."""
    lib = _build.load(_SOURCE.get(name, "fused4_grad.cu"), {"CELERITE_P": p})
    fn = getattr(lib, "celerite_fused4_{0}_{1}".format(
        name, "f32" if dtype == torch.float32 else "f64"))
    fn.argtypes = ([ctypes.c_void_p] * _NPTR[name] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch_setup(what, cf, plan: Plan4, jr, jc, seg, streams):
    """Check a launch's inputs; returns ``(cf rows, streams, seg)``.

    The kernels take padded widths 1..12, float32 or float64 CUDA streams
    of one dtype shaped ``(L, B)``, and one coefficient row per state
    segment of ``seg`` lanes.  ``cf`` is ``(C,)`` or one row per chain
    (chain ``c`` owns lanes ``[c B / n_chain, (c + 1) B / n_chain)``); each
    row is repeated over its chain's state segments, so the segments of the
    prefixes and the coefficient rows need not coincide (a fleet plan: one
    chain of many one-lane segments).
    """
    L, b = plan.t.shape
    p = jr + 2 * jc
    dtype = plan.t.dtype
    if not (1 <= p <= MAX_WIDTH):
        raise NotImplementedError(
            "fused4 {0} kernel takes padded widths 1..12, got P = {1} "
            "(ROADMAP queue 2)".format(what, p)
        )
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("fused4 kernels take float32 or float64")
    for x in streams:
        if x.device.type != "cuda" or x.dtype != dtype or x.shape != (L, b):
            raise ValueError("plan streams must be CUDA tensors of one dtype "
                             "shaped (L, B)")
    cf2 = cf.reshape(-1, cf_len(jr, jc)).to(device=plan.t.device, dtype=dtype)
    nc = cf2.shape[0]
    if b % nc:
        raise ValueError("lane count must be a multiple of the chain count")
    if seg is None:
        seg = b // nc
    if (b // nc) % seg:
        raise ValueError("state segments must tile each chain's lanes")
    cf2 = torch.repeat_interleave(cf2, b // nc // seg, dim=0)
    return cf2.contiguous(), [x.contiguous() for x in streams], seg


def _cuda_tensor(x, shape, dtype, device):
    """A contiguous operand of a launch: on the card, shape and dtype
    checked (float64 cotangents and seeds stay float64)."""
    if x.device.type != "cuda" or tuple(x.shape) != tuple(shape):
        raise ValueError("kernel operand must be a CUDA tensor shaped "
                         "{0}, got {1} on {2}".format(tuple(shape),
                                                      tuple(x.shape),
                                                      x.device))
    return x.to(device=device, dtype=dtype).contiguous()


def _launch(name, p, dtype, device, ptrs, L, b, jr, seg):
    fn = _kernel_fn(name, p, dtype)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*[x.data_ptr() for x in ptrs], L, b, jr, seg, stream)
    if err != 0:
        raise RuntimeError(
            "fused4 {0} kernel launch failed: CUDA error {1}".format(name, err)
        )


@functools.lru_cache(maxsize=None)
def _workspace_fn(p):
    """The primal's float64 workspace words for B lanes at width ``p``
    (``celerite_fused4_primal_ws``)."""
    fn = _build.load("fused4_primal.cu", {"CELERITE_P": p}).celerite_fused4_primal_ws
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn


def primal_cuda(cf, plan: Plan4, jr, jc, y=None, seg=None):
    """Per-lane ``(quad, ld, mind)`` from the Hopper kernel (CUDA tensors).

    Same contract as :func:`primal_reference`.  ``primal_cuda.launches``
    counts the launches.
    """
    L, b = plan.t.shape
    p = jr + 2 * jc
    y = plan.y if y is None else y
    cf2, streams, seg = _launch_setup(
        "primal", cf, plan, jr, jc, seg,
        [plan.t, plan.t_lo, plan.dt, plan.diag, plan.mask, y])
    dev = plan.t.device
    ws = torch.empty(_workspace_fn(p)(b), dtype=torch.float64, device=dev)
    quad, ld, mind = (torch.empty(b, dtype=plan.t.dtype, device=dev)
                      for _ in range(3))
    _launch("primal", p, plan.t.dtype, dev,
            [cf2, *streams, ws, quad, ld, mind], L, b, jr, seg)
    primal_cuda.launches += 1
    return quad, ld, mind


primal_cuda.launches = 0


def elem_fwd_cuda(cf, plan: Plan4, jr, jc, seg=None):
    """:func:`elem_fwd_reference` on the card (``fused4_grad.cu``)."""
    L, b = plan.t.shape
    p = jr + 2 * jc
    cf2, streams, seg = _launch_setup(
        "elem_fwd", cf, plan, jr, jc, seg,
        [plan.t, plan.t_lo, plan.dt, plan.diag, plan.mask])
    new = functools.partial(torch.empty, dtype=plan.t.dtype,
                            device=plan.t.device)
    A, J, C = new(p, p, b), new(p, p, b), new(p, p, b)
    saves = new(L, 2 * p * p, b)
    _launch("elem_fwd", p, plan.t.dtype, plan.t.device,
            [cf2, *streams, A, J, C, saves], L, b, jr, seg)
    elem_fwd_cuda.launches += 1
    return A, J, C, saves


def factor_fwd_cuda(cf, plan: Plan4, jr, jc, y, sh0, seg=None):
    """:func:`factor_fwd_reference` on the card (``fused4_grad.cu``)."""
    L, b = plan.t.shape
    p = jr + 2 * jc
    dev, dtype = plan.t.device, plan.t.dtype
    cf2, streams, seg = _launch_setup(
        "factor_fwd", cf, plan, jr, jc, seg,
        [plan.t, plan.t_lo, plan.dt, plan.diag, plan.mask, y])
    sh0 = _cuda_tensor(sh0, (p, p, b), torch.float64, dev)
    new = functools.partial(torch.empty, dtype=dtype, device=dev)
    M, mv, Qm, qv = new(p, p, b), new(p, b), new(p, p, b), new(p, b)
    q0, ld = (torch.empty(b, dtype=torch.float64, device=dev)
              for _ in range(2))
    mind = new(b)
    saves = new(L, 2 * p * p + p, b)
    _launch("factor_fwd", p, dtype, dev,
            [cf2, *streams, sh0, M, mv, Qm, qv, q0, ld, mind, saves],
            L, b, jr, seg)
    factor_fwd_cuda.launches += 1
    return M, mv, Qm, qv, q0, ld, mind, saves


def factor_bwd_cuda(cf, plan: Plan4, jr, jc, y, saves, hM, hm, hQm, hqv, hq0,
                    hld, seg=None):
    """:func:`factor_bwd_reference` on the card (``fused4_grad.cu``)."""
    L, b = plan.t.shape
    p = jr + 2 * jc
    dev, dtype = plan.t.device, plan.t.dtype
    cf2, streams, seg = _launch_setup(
        "factor_bwd", cf, plan, jr, jc, seg,
        [plan.t, plan.t_lo, plan.dt, plan.diag, plan.mask, y])
    saves = _cuda_tensor(saves, (L, 2 * p * p + p, b), dtype, dev)
    cots = [_cuda_tensor(x, s, torch.float64, dev) for x, s in
            zip((hM, hm, hQm, hqv, hq0, hld),
                ((p, p, b), (p, b), (p, p, b), (p, b), (b,), (b,)))]
    new = functools.partial(torch.empty, dtype=dtype, device=dev)
    hcf, hy, hsh0 = new(cf_len(jr, jc), b), new(L, b), new(p, p, b)
    _launch("factor_bwd", p, dtype, dev,
            [cf2, *streams, saves, *cots, hcf, hy, hsh0], L, b, jr, seg)
    factor_bwd_cuda.launches += 1
    return hcf, hy, hsh0


def elem_bwd_cuda(cf, plan: Plan4, jr, jc, saves, hA0, hJ0, hC0, seg=None):
    """:func:`elem_bwd_reference` on the card (``fused4_grad.cu``)."""
    L, b = plan.t.shape
    p = jr + 2 * jc
    dev, dtype = plan.t.device, plan.t.dtype
    cf2, streams, seg = _launch_setup(
        "elem_bwd", cf, plan, jr, jc, seg,
        [plan.t, plan.t_lo, plan.dt, plan.diag, plan.mask])
    saves = _cuda_tensor(saves, (L, 2 * p * p, b), dtype, dev)
    cots = [_cuda_tensor(x, (p, p, b), torch.float64, dev)
            for x in (hA0, hJ0, hC0)]
    hcf = torch.empty(cf_len(jr, jc), b, dtype=dtype, device=dev)
    _launch("elem_bwd", p, dtype, dev, [cf2, *streams, saves, *cots, hcf],
            L, b, jr, seg)
    elem_bwd_cuda.launches += 1
    return hcf


for _f in (elem_fwd_cuda, factor_fwd_cuda, factor_bwd_cuda, elem_bwd_cuda):
    _f.launches = 0


def _by_device(cuda_fn, plain_fn):
    """The kernel for a CUDA plan, the plain version for a CPU plan."""

    def fn(cf, plan, *args, **kwargs):
        kind = plan.t.device.type
        if kind == "cuda":
            return cuda_fn(cf, plan, *args, **kwargs)
        if kind == "cpu":
            return plain_fn(cf, plan, *args, **kwargs)
        raise ValueError("unsupported device {0}".format(plan.t.device))

    fn.__name__ = cuda_fn.__name__[:-len("_cuda")]
    fn.__doc__ = "{0} on a CUDA plan, {1} on a CPU plan.".format(
        cuda_fn.__name__, plain_fn.__name__)
    return fn


elem_fwd = _by_device(elem_fwd_cuda, elem_fwd_reference)
factor_fwd = _by_device(factor_fwd_cuda, factor_fwd_reference)
factor_bwd = _by_device(factor_bwd_cuda, factor_bwd_reference)
elem_bwd = _by_device(elem_bwd_cuda, elem_bwd_reference)


# ---------------------------------------------------------------------------
# The gradient pipeline as one autograd node (fused4.py:1087-1128)
# ---------------------------------------------------------------------------


class _GradCore(torch.autograd.Function):
    """``(cf, y) -> (M, m, Qm, qv, q0, ld, mind)`` per lane.

    Forward: elem_fwd -> prefix_sh0 -> factor_fwd, keeping the saves and
    the prefix's autograd graph.  Backward: factor_bwd -> the prefix's VJP
    -> elem_bwd; the per-lane coefficient rows are summed per segment in
    float64 (fused4.py:1119-1126).
    """

    @staticmethod
    def forward(ctx, cf, y, plan, jr, jc, seg):
        A, J, C, sv0 = elem_fwd(cf, plan, jr, jc, seg=seg)
        with torch.enable_grad():
            els = [x.detach().double().requires_grad_() for x in (A, J, C)]
            sh0 = prefix_sh0(*els, seg)
        M, mv, Qm, qv, q0, ld, mind, sv1 = factor_fwd(
            cf, plan, jr, jc, y, sh0.detach(), seg=seg)
        ctx.save_for_backward(cf, y, sv0, sv1)
        ctx.prefix = (els, sh0)
        ctx.args = (plan, jr, jc, seg)
        ctx.mark_non_differentiable(mind)
        return M, mv, Qm, qv, q0, ld, mind

    @staticmethod
    def backward(ctx, hM, hm, hQm, hqv, hq0, hld, _hmind):
        cf, y, sv0, sv1 = ctx.saved_tensors
        plan, jr, jc, seg = ctx.args
        p, b = jr + 2 * jc, plan.t.shape[1]
        dev = plan.t.device
        cots = [torch.zeros(s, dtype=torch.float64, device=dev) if h is None
                else h.double()
                for h, s in zip((hM, hm, hQm, hqv, hq0, hld),
                                ((p, p, b), (p, b), (p, p, b), (p, b), (b,),
                                 (b,)))]
        hcf1, hy, hsh0 = factor_bwd(cf, plan, jr, jc, y, sv1, *cots, seg=seg)
        els, sh0 = ctx.prefix
        hA0, hJ0, hC0 = torch.autograd.grad(sh0, els, hsh0.double(),
                                            allow_unused=True)
        hA0, hJ0, hC0 = (torch.zeros_like(e) if h is None else h
                         for h, e in zip((hA0, hJ0, hC0), els))
        hcf0 = elem_bwd(cf, plan, jr, jc, sv0, hA0, hJ0, hC0, seg=seg)
        rows = hcf0.double() + hcf1.double()
        if cf.ndim == 1:
            hcf = rows.sum(1)
        else:
            hcf = rows.reshape(rows.shape[0], cf.shape[0], -1).sum(2).T
        return hcf.to(cf.dtype), hy.to(y.dtype), None, None, None, None


def _check_seg(cf, plan):
    b = plan.t.shape[1]
    nc = 1 if cf.ndim == 1 else cf.shape[0]
    if b % nc:
        raise ValueError("lane count must be a multiple of the chain count")
    return nc, b // nc


def _segments_of(cf, plan, n_seg, state_seg):
    """``(seg, state_seg, scalar)`` of a call (fused4.py:437-446).

    ``n_seg`` (default: the coefficient rows) is the number of
    log-likelihoods returned, one per ``seg = B / n_seg`` lanes;
    ``state_seg`` (default ``seg``) the lanes of one independent prefix
    segment, which must tile the output segments.  A batched ``cf``
    requires ``n_seg == n_chain``.  ``scalar``: one model, one output.
    """
    b = plan.t.shape[1]
    nc = 1 if cf.ndim == 1 else cf.shape[0]
    if n_seg is None:
        n_seg = nc
    elif nc != 1 and nc != n_seg:
        raise ValueError("batched cf requires n_seg == n_chain")
    if b % n_seg:
        raise ValueError("lane count must be a multiple of the segment count")
    seg = b // n_seg
    if state_seg is None:
        state_seg = seg
    if seg % state_seg:
        raise ValueError("state segments must tile the output segments")
    return seg, state_seg, cf.ndim == 1 and n_seg == 1


def _ll_ok(ll, mind, seg):
    """``(ll, ok)`` per output segment: ``ok`` needs every pivot of the
    segment positive and ``ll`` finite; ``ll`` is -inf where not ok."""
    ok = (mind.reshape(-1, seg).amin(1) > 0) & torch.isfinite(ll.detach())
    return torch.where(ok, ll, torch.full_like(ll, -math.inf)), ok


def build_ll_and_grad(plan: Plan4, jr, jc, n_chain=1, n_seg=None,
                      state_seg=None):
    """``(cf, y4=None) -> (ll, ok)`` differentiable w.r.t. ``cf`` and ``y4``.

    The port of fused4.py:1057 ``build_ll_and_grad``: the forward runs the
    split kernels with saves and the backward the reversed kernels (CUDA
    on a CUDA plan, the plain versions on a CPU plan).  With ``n_chain >
    1`` the plan is chain-folded (``make_plan4(..., n_chain=n_chain)``),
    ``cf`` is ``(n_chain, C)`` and ``(ll, ok)`` come back per chain.

    ``n_seg`` (default ``n_chain``) decouples the outputs from the
    coefficient rows, and ``state_seg`` the prefixes' segments from both:
    a fleet plan (``make_plan4_curves``) holds one light curve a lane
    (``state_seg = 1``) sharing one ``(C,)`` row, and ``(ll, ok)`` come
    back per curve (``n_seg`` = lanes) or, folded, per chain; the
    coefficient cotangent sums over every lane of its row.
    """
    if n_seg is not None and n_chain != 1 and n_chain != n_seg:
        raise ValueError("batched cf requires n_seg == n_chain")

    def fn(cf, y4=None):
        y4 = plan.y if y4 is None else y4
        nc = 1 if cf.ndim == 1 else cf.shape[0]
        if nc != n_chain:
            raise ValueError("expected {0} coefficient rows, got {1}".format(
                n_chain, nc))
        seg, sseg, scalar = _segments_of(cf, plan, n_seg, state_seg)
        M, mv, Qm, qv, q0, ld, mind = _GradCore.apply(cf, y4, plan, jr, jc,
                                                      sseg)
        ll = assemble_ll(lane_quad(M, mv, Qm, qv, q0, sseg), ld, plan.n, seg)
        ll, ok = _ll_ok(ll, mind, seg)
        ll = ll.to(plan.t.dtype)
        return (ll[0], ok[0]) if scalar else (ll, ok)

    return fn


class _PrimalKernel(torch.autograd.Function):
    """The primal kernel as an autograd node.

    A ctypes launch is invisible to autograd.  The backward recomputes
    through the gradient pipeline (as JAX's ``_l4bwd`` does, gp.py:615-636)
    and pulls the per-lane ``(quad, ld)`` cotangents back to ``cf`` and
    ``y`` through the gradient kernels.
    """

    @staticmethod
    def forward(ctx, cf, y, plan, jr, jc, seg):
        ctx.save_for_backward(cf, y)
        ctx.args = (plan, jr, jc, seg)
        quad, ld, mind = primal_cuda(cf, plan, jr, jc, y=y, seg=seg)
        ctx.mark_non_differentiable(mind)
        return quad, ld, mind

    @staticmethod
    def backward(ctx, gquad, gld, _gmind):
        cf, y = ctx.saved_tensors
        plan, jr, jc, seg = ctx.args
        with torch.enable_grad():
            cf_ = cf.detach().requires_grad_()
            y_ = y.detach().requires_grad_()
            M, mv, Qm, qv, q0, ld, _ = _GradCore.apply(cf_, y_, plan, jr, jc,
                                                       seg)
            outs, cots = [], []
            for out, g in ((lane_quad(M, mv, Qm, qv, q0, seg), gquad),
                           (ld, gld)):
                if g is not None:
                    outs.append(out)
                    cots.append(g.double())
            hcf, hy = torch.autograd.grad(outs, (cf_, y_), cots)
        return hcf, hy, None, None, None, None


def run_primal(cf, plan: Plan4, jr, jc, y=None, n_seg=None, state_seg=None):
    """(ll, ok) from the packed coefficient vector and a plan.

    ``cf`` is a ``(C,)`` vector for a single model, or an ``(n_chain, C)``
    batch on a chain-folded plan (``make_plan4(..., n_chain=...)``); then
    (ll, ok) come back per chain.  ``n_seg`` and ``state_seg`` split the
    outputs and the prefixes' segments as in :func:`build_ll_and_grad`
    (fused4.py:419-491; a fleet plan takes ``state_seg = 1``).  ``y``
    overrides the plan's data stream (mean-model residuals), shaped ``(L,
    B)``.  CPU plans take the plain version, CUDA plans the kernel.
    """
    seg, sseg, scalar = _segments_of(cf, plan, n_seg, state_seg)
    y = plan.y if y is None else y
    if plan.t.device.type == "cuda":
        quad, ld, mind = _PrimalKernel.apply(cf, y, plan, jr, jc, sseg)
    elif plan.t.device.type == "cpu":
        quad, ld, mind = primal_reference(cf, plan, jr, jc, y=y, seg=sseg)
    else:
        raise ValueError("unsupported device {0}".format(plan.t.device))
    llv = -0.5 * (quad.reshape(-1, seg).sum(1) + ld.reshape(-1, seg).sum(1)
                  + _n_term(plan.n, quad))
    llv, okv = _ll_ok(llv, mind, seg)
    return (llv[0], okv[0]) if scalar else (llv, okv)


def build_ll(plan: Plan4, jr, jc):
    """``(cf, y) -> (ll, ok)`` through the fused primal."""

    def fn(cf, y=None):
        return run_primal(cf, plan, jr, jc, y=y)

    return fn


def gp_log_likelihood(coeffs, plan: Plan4, y=None):
    """(ll, ok) for lowered coefficients through the fused primal."""
    jr = coeffs.a_real.shape[0]
    jc = coeffs.a_comp.shape[0]
    cf = pack_cf(coeffs, dtype=plan.t.dtype).to(plan.t.device)
    return run_primal(cf, plan, jr, jc, y=y)
