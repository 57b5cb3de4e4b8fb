"""Fused primal log-likelihood over a lane plan: the CUDA kernel and its plain version.

Port of ``celerite_tpu/ops/fused4.py:64-236, 275-491, 1048-1054,
1153-1158``.  Each of the B virtual lanes owns a contiguous chunk of the
series.  Phase 0 lowers the packed coefficients per step and accumulates
each lane's Riccati element (A, J, C); a segmented Hillis-Steele prefix over
lanes composes them into every lane's seed.  Phase 1 reruns each lane from
its seed and accumulates the affine forward-substitution map (M, m) and the
statistics (Kahan-summed quad and log-det, qv, Qm, min pivot); a second
prefix over (M, m) gives each lane its incoming state h and
``quad_l = q0 - 2 qv.h + h^T Qm h``.

Two implementations of the same function ``(cf, plan) -> per-lane (quad,
ld, mind)``:

- :func:`primal_cuda` launches the hand-written Hopper kernel
  (``celerite_torch/csrc/fused4_primal.cu``) on CUDA tensors;
- :func:`primal_reference` is the plain torch version: a Python loop over
  the L steps, vectorised over lanes.  The CPU takes it (with autograd);
  on the card only tests and ``chip_smoke.py`` call it, as the kernel's
  reference.

:func:`run_primal` picks by the plan's device and reduces per segment to
``(ll, ok)``.  On the card the kernel sits in a ``torch.autograd.Function``
whose backward raises: the gradient kernels are the next slice.
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
           "gp_log_likelihood", "MAX_WIDTH"]

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
# The CUDA kernel
# ---------------------------------------------------------------------------

_ARGTYPES = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _kernel_fn(p, dtype):
    """The ctypes entry point for width ``p`` and ``dtype`` (built once)."""
    lib = _build.load("fused4_primal.cu", {"CELERITE_P": p})
    name = "celerite_fused4_primal_{0}".format(
        "f32" if dtype == torch.float32 else "f64"
    )
    fn = getattr(lib, name)
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def _workspace_len(p, b):
    """Float64 workspace the kernel needs for width ``p`` on ``b`` lanes."""
    return (6 * p * p + 2 * (p * p + p) + p * p + p + 3) * b


def primal_cuda(cf, plan: Plan4, jr, jc, y=None, seg=None):
    """Per-lane ``(quad, ld, mind)`` from the Hopper kernel (CUDA tensors).

    Same contract as :func:`primal_reference`.  ``primal_cuda.launches``
    counts the launches.
    """
    L, b = plan.t.shape
    p = jr + 2 * jc
    y = plan.y if y is None else y
    streams = [plan.t, plan.t_lo, plan.dt, plan.diag, plan.mask, y]
    dtype = plan.t.dtype
    if not (1 <= p <= MAX_WIDTH):
        raise NotImplementedError(
            "fused primal kernel takes padded widths 1..12, got P = "
            "{0} (ROADMAP queue 2)".format(p)
        )
    if dtype not in (torch.float32, torch.float64):
        raise TypeError("fused primal kernel takes float32 or float64")
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
    if b % seg or nc not in (1, b // seg):
        raise ValueError("segments must tile the lanes, one cf row each")
    # The kernel reads one coefficient row per segment.
    cf2 = cf2.expand(b // seg, cf2.shape[1]).contiguous()
    streams = [x.contiguous() for x in streams]
    fn = _kernel_fn(p, dtype)
    ws = torch.empty(_workspace_len(p, b), dtype=torch.float64,
                     device=plan.t.device)
    quad, ld, mind = (torch.empty(b, dtype=dtype, device=plan.t.device)
                      for _ in range(3))
    stream = torch.cuda.current_stream(plan.t.device).cuda_stream
    err = fn(cf2.data_ptr(), *[x.data_ptr() for x in streams],
             ws.data_ptr(), quad.data_ptr(), ld.data_ptr(), mind.data_ptr(),
             L, b, jr, seg, stream)
    if err != 0:
        raise RuntimeError(
            "fused4 primal kernel launch failed: CUDA error {0}".format(err)
        )
    primal_cuda.launches += 1
    return quad, ld, mind


primal_cuda.launches = 0


class _PrimalKernel(torch.autograd.Function):
    """The kernel as an autograd node: a ctypes launch is invisible to
    autograd, so without this node a backward pass would silently drop the
    likelihood's gradient."""

    @staticmethod
    def forward(ctx, cf, y, plan, jr, jc, seg):
        return primal_cuda(cf, plan, jr, jc, y=y, seg=seg)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "gradient kernels: next slice (ROADMAP queue 2, items 2-3); "
            "the CPU path differentiates with autograd"
        )


def run_primal(cf, plan: Plan4, jr, jc, y=None):
    """(ll, ok) from the packed coefficient vector and a plan.

    ``cf`` is a ``(C,)`` vector for a single model, or an ``(n_chain, C)``
    batch on a chain-folded plan (``make_plan4(..., n_chain=...)``); then
    (ll, ok) come back per chain.  ``y`` overrides the plan's data stream
    (mean-model residuals), shaped ``(L, B)``.  CPU plans take the plain
    version, CUDA plans the kernel.
    """
    b = plan.t.shape[1]
    nc = 1 if cf.ndim == 1 else cf.shape[0]
    seg = b // nc
    y = plan.y if y is None else y
    if plan.t.device.type == "cuda":
        quad, ld, mind = _PrimalKernel.apply(cf, y, plan, jr, jc, seg)
    elif plan.t.device.type == "cpu":
        quad, ld, mind = primal_reference(cf, plan, jr, jc, y=y, seg=seg)
    else:
        raise ValueError("unsupported device {0}".format(plan.t.device))
    llv = -0.5 * (
        quad.reshape(nc, seg).sum(1) + ld.reshape(nc, seg).sum(1)
        + plan.n * math.log(2.0 * math.pi)
    )
    okv = (mind.reshape(nc, seg).amin(1) > 0) & torch.isfinite(llv)
    llv = torch.where(okv, llv, torch.full_like(llv, -math.inf))
    if cf.ndim == 1:
        return llv[0], okv[0]
    return llv, okv


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
