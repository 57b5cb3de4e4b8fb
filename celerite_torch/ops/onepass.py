"""The one-pass solver: the GP log-likelihood from one zero-seeded sweep.

Port of ``celerite_tpu/ops/onepass.py`` (l.76-533).  Each lane runs the
factor recursion once from a zero seed and accumulates its summaries

    C              the zero-seed end state of the S-hat recursion
    M0, m0         the lane's affine solve map
    Qm, qv         the information matrix and cross statistic
    q0, ld0, mind0 the zero-seed quadratic form, log-determinant, min pivot

and the seeded quantities follow in closed form (that module's docstring;
``K = (I - S Qm)^-1 S``, ``r = qv - Qm h``)::

    sum log d(S) = ld0 + log det(I - S Qm)
    quad(S, h)   = q0 - 2 qv.h + h^T Qm h + r^T K r
    h_out        = M0 h + m0 - M0 K r

The seeds S are the exclusive prefix of the elements ``(M0, -Qm, C)``
(``fused4.prefix_sh0``) and the incoming states h the exclusive prefix of
the corrected maps (``fused4.prefix_h0``), the per-lane corrections
``torch.linalg.inv_ex`` and :func:`_small_det` in float64 glue.  The
identities are ill-conditioned in float32 by design (the JAX module's
caveat, onepass.py:36-49): the float32 sweep runs, its ``(ll, ok)`` is what
the TPU computed.  No GP route takes this solver, as in the JAX package.

The sweep has three kernels (``celerite_torch/csrc/onepass.cu``), each with
a plain version and a ``*_cuda`` wrapper (CUDA tensors only, padded width
1..16, a ``.launches`` counter):

- row 19, ``_onepass_kernel`` (onepass.py:111): :func:`sweep_cuda`, plain
  :func:`sweep_reference` with ``keep_saves=False``;
- row 20, ``_onepass_fwd_kernel`` (onepass.py:162): :func:`sweep_fwd_cuda`,
  the same with the per-step saves ``[Shin, Mprev, mprev]`` (``adjoint``'s
  layout, ``(L, B, 2 P^2 + P)``);
- row 21, ``_onepass_bwd_kernel`` (onepass.py:219): :func:`sweep_bwd_cuda`,
  plain :func:`sweep_bwd_reference`.

The plain versions are ``adjoint.factor_fwd_reference`` at a zero seed
with its end state, and ``adjoint.factor_bwd_reference`` with the carried
S-hat cotangent seeded by the C output's: one copy of the arithmetic with
the adjoint route.  ``_SweepOp`` is the ``torch.autograd.Function`` of the
JAX ``custom_vjp`` (onepass.py:287-420).  Outputs ``q0`` and ``ld0`` leave
as the float64 sums of their Kahan pairs, as the adjoint route's do.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import fused, fused4
from .adjoint import (_by_device, _operands, factor_bwd_reference,
                      factor_fwd_reference)
from .lower import SSM

__all__ = ["ONEPASS_KERNELS", "sweep_reference", "sweep_fwd_reference",
           "sweep_bwd_reference",
           "sweep_cuda", "sweep_fwd_cuda", "sweep_bwd_cuda", "sweep",
           "sweep_fwd", "sweep_bwd", "run_kernel", "gp_log_likelihood"]

ONEPASS_KERNELS = ("sweep", "sweep_fwd", "sweep_bwd")


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def sweep_reference(u, v, ph, a, y, keep_saves=False):
    """The zero-seeded sweep: ``(C, M0, m0, Qm, qv, q0, ld0, mind0)``,
    ``(P, P, B)`` three times and ``(P, B)`` twice, float64 ``(B,)`` twice
    and ``(B,)``; with ``keep_saves`` the saves ``(L, B, 2 P^2 + P)``
    follow."""
    out = factor_fwd_reference(None, u, v, ph, a, y, keep_saves=keep_saves,
                               end_state=True)
    M, m, Qm, qv, q0, ld, mind, C = out[:8]
    return (C, M, m, Qm, qv, q0, ld, mind) + tuple(out[8:])


def sweep_bwd_reference(u, v, ph, a, y, saves, hC, hM0, hm0, hQm, hqv, hq0,
                        hld):
    """The transpose of :func:`sweep_reference`, streamed in reverse:
    ``(hu, hv, hph)`` each ``(L, P, B)``, ``ha`` and ``hy`` each ``(L, 1,
    B)``.  The sweep is zero-seeded, so it has no seed cotangent."""
    return factor_bwd_reference(u, v, ph, a, y, saves, hM0, hm0, hQm, hqv,
                                hq0, hld, hC=hC)[:5]


# ---------------------------------------------------------------------------
# The CUDA kernels: ctypes entry points and their wrappers
# ---------------------------------------------------------------------------

# Pointer arguments of each entry point; every one then takes (L, B,
# stream).
_NPTR = {"sweep": 13, "sweep_fwd": 14, "sweep_bwd": 18}
_SYMBOL = {"sweep": "sweep", "sweep_fwd": "fwd", "sweep_bwd": "bwd"}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name, p, dtype):
    """The ctypes entry point ``name`` for width ``p`` and ``dtype``."""
    lib = _build.load("onepass.cu", {"CELERITE_P": p})
    fn = getattr(lib, "celerite_onepass_{0}_{1}".format(
        _SYMBOL[name], "f32" if dtype == torch.float32 else "f64"))
    fn.argtypes = [ctypes.c_void_p] * _NPTR[name] + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(name, u, ptrs):
    L, p, b = u.shape
    fn = _kernel_fn(name, p, u.dtype)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(*[x.data_ptr() for x in ptrs], L, b, stream)
    if err != 0:
        raise RuntimeError("onepass {0} kernel launch failed: CUDA error "
                           "{1}".format(name, err))


def _summaries(u):
    """Empty outputs of a sweep: C, M0, m0, Qm, qv, q0, ld0, mind0."""
    L, p, b = u.shape
    new = u.new_empty
    return [new(p, p, b), new(p, p, b), new(p, b), new(p, p, b), new(p, b),
            new(b, dtype=torch.float64), new(b, dtype=torch.float64),
            new(b)]


def _stream_operands(name, u, v, ph, a, y):
    L, p, b = u.shape
    return _operands(name, u, [(v, u.shape), (ph, u.shape), (a, (L, 1, b)),
                               (y, (L, 1, b))])


def sweep_cuda(u, v, ph, a, y):
    """:func:`sweep_reference` on the card (``csrc/onepass.cu``, row 19)."""
    ins = _stream_operands("onepass sweep", u, v, ph, a, y)
    outs = _summaries(u)
    _launch("sweep", u, ins + outs)
    sweep_cuda.launches += 1
    return tuple(outs)


def sweep_fwd_cuda(u, v, ph, a, y):
    """:func:`sweep_reference` with ``keep_saves=True`` on the card
    (``csrc/onepass.cu``, row 20)."""
    L, p, b = u.shape
    ins = _stream_operands("onepass sweep_fwd", u, v, ph, a, y)
    outs = _summaries(u) + [u.new_empty(L, b, 2 * p * p + p)]
    _launch("sweep_fwd", u, ins + outs)
    sweep_fwd_cuda.launches += 1
    return tuple(outs)


def sweep_bwd_cuda(u, v, ph, a, y, saves, hC, hM0, hm0, hQm, hqv, hq0, hld):
    """:func:`sweep_bwd_reference` on the card (``csrc/onepass.cu``, row
    21)."""
    L, p, b = u.shape
    ins = _operands("onepass sweep_bwd", u, [
        (v, u.shape), (ph, u.shape), (a, (L, 1, b)), (y, (L, 1, b)),
        (saves, (L, b, 2 * p * p + p)), (hC, (p, p, b)), (hM0, (p, p, b)),
        (hm0, (p, b)), (hQm, (p, p, b)), (hqv, (p, b)), (hq0, (b,)),
        (hld, (b,))])
    hu, hv, hph = (torch.empty_like(ins[0]) for _ in range(3))
    ha, hy = u.new_empty(L, 1, b), u.new_empty(L, 1, b)
    _launch("sweep_bwd", u, ins + [hu, hv, hph, ha, hy])
    sweep_bwd_cuda.launches += 1
    return hu, hv, hph, ha, hy


for _f in (sweep_cuda, sweep_fwd_cuda, sweep_bwd_cuda):
    _f.launches = 0


def sweep_fwd_reference(u, v, ph, a, y):
    """:func:`sweep_reference` with the saves (the plain row 20)."""
    return sweep_reference(u, v, ph, a, y, keep_saves=True)


sweep = _by_device(sweep_cuda, sweep_reference, 0)
sweep_fwd = _by_device(sweep_fwd_cuda, sweep_fwd_reference, 0)
sweep_bwd = _by_device(sweep_bwd_cuda, sweep_bwd_reference, 0)


class _SweepOp(torch.autograd.Function):
    """``(u, v, ph, a, y) -> (C, M0, m0, Qm, qv, q0, ld0, mind0)``: forward
    row 20 (with saves) when a gradient is asked for, row 19 otherwise;
    backward row 21."""

    @staticmethod
    def forward(ctx, u, v, ph, a, y):
        if any(ctx.needs_input_grad):
            *outs, saves = sweep_fwd(u, v, ph, a, y)
            ctx.save_for_backward(u, v, ph, a, y, saves)
        else:
            outs = sweep(u, v, ph, a, y)
        ctx.mark_non_differentiable(outs[7])
        return tuple(outs)

    @staticmethod
    def backward(ctx, hC, hM, hm, hQm, hqv, hq0, hld, _hmind):
        u, v, ph, a, y, saves = ctx.saved_tensors
        p, b = u.shape[1:]
        shapes = ((p, p, b), (p, p, b), (p, b), (p, p, b), (p, b), (b,),
                  (b,))
        cots = [u.new_zeros(s) if h is None else h
                for h, s in zip((hC, hM, hm, hQm, hqv, hq0, hld), shapes)]
        return sweep_bwd(u, v, ph, a, y, saves, *cots)


# ---------------------------------------------------------------------------
# The assembly: prefixes and the closed-form seed corrections (float64)
# ---------------------------------------------------------------------------


def _small_det(X):
    """Determinants of ``(..., P, P)`` matrices by elimination without
    pivoting, the product of the pivots (onepass.py:444-461), so that the
    ``ok`` flag reads the same pivots as the JAX package's."""
    det = torch.ones(X.shape[:-2], dtype=X.dtype, device=X.device)
    for k in range(X.shape[-1]):
        piv = X[..., k, k]
        det = det * piv
        # Row k leaves as zeros, which no later pivot reads.
        X = X - X[..., :, k:k + 1] * (X[..., k, :] / piv[..., None])[
            ..., None, :]
    return det


def run_kernel(u, v, ph, a, y, n):
    """``(ll, ok)`` from pre-laned ``(L, P, B)`` streams in one sweep, ``n``
    the unpadded point count; differentiable with autograd (the sweep's
    backward is row 21, the float64 assembly autograd's).  ``ll`` in the
    streams' dtype; ``ok`` needs positive zero-seed pivots, positive
    correction determinants and a finite result (onepass.py:510-515)."""
    b = u.shape[-1]
    # Under no_grad needs_input_grad still reads the inputs' flags: take
    # row 19 directly there.
    sweep_op = _SweepOp.apply if torch.is_grad_enabled() else sweep
    C, M0, m0, Qm, qv, q0, ld0, mind0 = sweep_op(u, v, ph, a, y)
    Qm64 = Qm.double()
    S = fused4.prefix_sh0(M0, -Qm64, C, b)
    # Lane layout -> a batch of small matrices, float64.
    Sb, Qb, Mb = (x.double().permute(2, 0, 1) for x in (S, Qm64, M0))
    m0b, qvb = m0.double().T, qv.double().T
    eye = torch.eye(u.shape[1], dtype=torch.float64, device=u.device)
    X = eye - Sb @ Qb
    K = torch.linalg.inv_ex(X).inverse @ Sb
    det = _small_det(X)
    M_eff = Mb @ (eye + K @ Qb)
    m_eff = m0b - (Mb @ (K @ qvb[..., None]))[..., 0]
    h = fused4.prefix_h0(M_eff.permute(1, 2, 0), m_eff.T, b).T
    r = qvb - (Qb @ h[..., None])[..., 0]
    Kr = (K @ r[..., None])[..., 0]
    quad = torch.sum(q0 - 2.0 * torch.sum(qvb * h, -1)
                     + torch.sum(h * (Qb @ h[..., None])[..., 0], -1)
                     + torch.sum(r * Kr, -1))
    logdet = torch.sum(ld0) + torch.sum(torch.log(det))
    ll = -0.5 * (quad + logdet + n * math.log(2.0 * math.pi))
    ok = ((mind0.detach().min() > 0) & (det.detach().min() > 0)
          & torch.isfinite(ll.detach()))
    return torch.where(ok, ll, -math.inf).to(u.dtype), ok


def gp_log_likelihood(ssm: SSM, resid, num_blocks=None):
    """``(ll, ok)`` for an SSM and residuals through the one-pass solver on
    ``num_blocks`` lanes (default ``fused.default_num_blocks``);
    differentiable with autograd.  The kernels on CUDA tensors (padded
    width 1..16), the plain versions on CPU tensors."""
    n = ssm.U.shape[0]
    b = num_blocks or fused.default_num_blocks(n, ssm.U.device)
    u, v, ph, a, y, _ = fused._to_lanes(ssm, resid, b)
    return run_kernel(u, v, ph, a, y, n)
