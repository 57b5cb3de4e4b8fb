"""Exact mode (``precision="ds"``): the log-likelihood and its forward-mode
gradient in one sweep, on the card in float64.

Port of ``celerite_tpu/ops/dsfused.py``.  The JAX package computes exact
mode in double-single arithmetic because the TPU has no float64; the card
computes float64 natively, so here the same two-kernel pipeline runs in
float64 and no double-single arithmetic is ported.  What carries over is
the shape of the computation:

- **Forward mode, no saves.**  Every stream and every recursion carry is a
  dual: a value and T tangents, one per packed coefficient ``toff + j``
  with a unit seed.  One forward sweep gives the value and T directions of
  the gradient; nothing is saved for a backward sweep.
- **The raw-jitter layout.**  :func:`pack_cf_ds` keeps the jitter in the
  last slot and the kernels re-sum the diagonal ``sum(a_real) +
  sum(a_comp) + jitter`` per step (dsfused.py:346-357), so the gradient is
  taken with respect to a different vector than ``lanes4.pack_cf``'s.
- **Two kernels and torch glue between them**::

      elem_ds -> prefix_sh0_ds -> factor_ds -> assemble_ds

  ``elem_ds`` (``_elem_kernel``, dsfused.py:379) gives each lane's
  Riccati element (A, J, C) with tangents; ``factor_ds``
  (``_factor_kernel``, dsfused.py:432) reruns each lane from its seed and
  gives the affine map and statistics with tangents.  The glue is the
  value and T tangents of the float64 glue of :mod:`fused4`
  (``prefix_sh0``, ``lane_quad``, ``assemble_ll``) by ``torch.func.jvp``,
  vmapped over the tangent axis, and runs once a call over all directions.

Each kernel has a ``*_cuda`` wrapper (``celerite_torch/csrc/dsfused.cu``,
CUDA tensors only, with a ``.launches`` counter) and a ``*_reference``
plain version: ``torch.func.jvp`` of the plain fused4 forward sweeps
(``fused4.elem_fwd_reference``, ``factor_fwd_reference``) with the
re-summed diagonal, vmapped over the unit seeds.  The dispatchers
``elem_ds`` / ``factor_ds`` take the kernel for a CUDA plan and the plain
version for a CPU plan.  A kernel launch covers ``T`` directions: a block
holds a few lanes, lowers each step once in shared memory, carries the
value once in one warp and each direction in a warp of its own; the
directions of a call go ``tan_chunk`` to a launch.

Outputs carry a leading word axis: word 0 is the value, word ``1 + j`` the
tangent along coefficient ``toff + j``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import fused4
from .lanes4 import Plan4, make_plan4

__all__ = ["cf_len", "pack_cf_ds", "make_plan_ds", "elem_ds_reference",
           "factor_ds_reference", "elem_ds_cuda", "factor_ds_cuda",
           "elem_ds", "factor_ds", "prefix_sh0_ds", "assemble_ds",
           "build_ll_ds", "build_ll_and_grad_ds", "DS_KERNELS"]

DS_KERNELS = ("elem_ds", "factor_ds")


def cf_len(jr, jc):
    """Length of the packed coefficient vector for (jr, jc) term counts."""
    return 2 * jr + 4 * jc + 1


def pack_cf_ds(coeffs, dtype=torch.float64):
    """Packed coefficient vector of the exact-mode kernels.

    Layout [a_real(jr), c_real(jr), a_c, b_c, c_c, d_c (jc each), jitter]:
    the last slot is the raw jitter, not ``lanes4.pack_cf``'s diagonal
    total; the kernels re-sum the diagonal.  Differentiable with autograd.
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = coeffs
    parts = [a_real, c_real, a_comp, b_comp, c_comp, d_comp,
             torch.as_tensor(jitter).reshape(1)]
    return torch.cat([torch.as_tensor(p).reshape(-1) for p in parts]).to(dtype)


def _fused4_layout(cf, jr, jc):
    """``pack_cf_ds`` rows -> ``lanes4.pack_cf`` rows: the diagonal total
    ``a_real + a_comp + jitter`` summed in the kernels' order."""
    terms = list(range(jr)) + list(range(2 * jr, 2 * jr + jc)) \
        + [2 * jr + 4 * jc]
    total = cf[..., terms[0]]
    for k in terms[1:]:
        total = total + cf[..., k]
    return torch.cat([cf[..., :-1], total[..., None]], -1)


def make_plan_ds(t, y, diag, num_blocks, n_chain=1, device=None) -> Plan4:
    """The exact-mode lane plan: a float64 :class:`Plan4`.

    The JAX package's ``PlanDS`` adds the lo words of the spacings, since
    its float32 ``dt`` would round every decay argument.  Here the plan is
    float64: ``dt`` is the float64 difference of the float64 times, more
    exact than the JAX package's 48-bit pair, so no ``dt_lo`` is needed
    (``t_lo`` is 0 on a float64 plan).
    """
    return make_plan4(t, y, diag, num_blocks, dtype=torch.float64,
                      n_chain=n_chain, device=device)


def _count(cf, jr, jc, toff, T):
    c = cf_len(jr, jc)
    if T is None:
        T = c - toff
    if toff < 0 or T < 0 or toff + T > c:
        raise ValueError("directions [{0}, {1}) outside the {2} packed "
                         "coefficients".format(toff, toff + T, c))
    return T


def _seeds(cf, toff, T):
    """(T, *cf.shape) unit seeds on coefficients toff .. toff + T - 1."""
    eye = torch.eye(cf.shape[-1], dtype=cf.dtype, device=cf.device)
    rows = eye[toff:toff + T]
    if cf.ndim == 2:
        rows = rows[:, None].expand(T, *cf.shape)
    return rows


def _dual(fn, primals, tangents):
    """Value and jvp of ``fn`` along each of T tangent sets, stacked:
    ``(1 + T, ...)`` per output (word 0 the value)."""

    def one(*tans):
        return torch.func.jvp(fn, primals, tans)

    vals, tans = torch.func.vmap(one)(*tangents)
    return [torch.cat([v[:1], t]) for v, t in zip(vals, tans)]


# ---------------------------------------------------------------------------
# Plain versions: forward mode of the plain fused4 sweeps
# ---------------------------------------------------------------------------


def elem_ds_reference(cf, plan: Plan4, jr, jc, toff=0, T=None, seg=None):
    """Each lane's element ``(A, J, C)``, each ``(1 + T, P, P, B)``.

    The plain version of dsfused.py:379 ``_elem_kernel``: word 0 of each
    is ``fused4.elem_fwd_reference``'s output for the re-summed diagonal,
    word ``1 + j`` its jvp along coefficient ``toff + j``.  ``cf`` is a
    ``pack_cf_ds`` row or one row per chain of a folded plan.  ``seg`` is
    accepted for the wrappers' common signature; phase 0 is per lane.
    """
    T = _count(cf, jr, jc, toff, T)

    def fn(c):
        return fused4.elem_fwd_reference(_fused4_layout(c, jr, jc), plan, jr,
                                         jc, keep_saves=False)[:3]

    if T == 0:
        return tuple(x[None] for x in fn(cf))
    return tuple(_dual(fn, (cf,), (_seeds(cf, toff, T),)))


def factor_ds_reference(cf, plan: Plan4, jr, jc, y, sh0, toff=0, T=None,
                        seg=None):
    """Phase 1 from the dual seeds ``sh0`` ``(1 + T, P, P, B)``.

    The plain version of dsfused.py:432 ``_factor_kernel``: returns ``(M,
    m, Qm, qv, q0, ld)``, each with the word axis (``(1 + T, P, P, B)``,
    ``(1 + T, P, B)`` or ``(1 + T, B)``), and the value's minimum pivot
    ``mind (B,)``.
    """
    T = _count(cf, jr, jc, toff, T)
    if sh0.shape[0] != 1 + T:
        raise ValueError("sh0 must carry the value and {0} tangents".format(T))

    def fn(c, s):
        return fused4.factor_fwd_reference(_fused4_layout(c, jr, jc), plan,
                                           jr, jc, y, s, keep_saves=False)[:7]

    if T == 0:
        out = fn(cf, sh0[0])
        return (*(x[None] for x in out[:6]), out[6])
    out = _dual(fn, (cf, sh0[0]), (_seeds(cf, toff, T), sh0[1:]))
    return (*out[:6], out[6][0])


# ---------------------------------------------------------------------------
# The CUDA kernels (celerite_torch/csrc/dsfused.cu)
# ---------------------------------------------------------------------------

# Pointer arguments of each entry point; each then takes (L, B, jr, seg,
# toff, T, stream).
_NPTR = {"elem": 9, "factor": 15}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name, p):
    lib = _build.load("dsfused.cu", {"CELERITE_P": p})
    fn = getattr(lib, "celerite_dsfused_" + name)
    fn.argtypes = ([ctypes.c_void_p] * _NPTR[name] + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _launch(name, p, device, ptrs, L, b, jr, seg, toff, T):
    fn = _kernel_fn(name, p)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(*[x.data_ptr() for x in ptrs], L, b, jr, seg, toff, T, stream)
    if err != 0:
        raise RuntimeError(
            "dsfused {0} kernel launch failed: CUDA error {1}".format(name,
                                                                   err))


def _setup(what, cf, plan, jr, jc, seg, streams):
    if plan.t.dtype != torch.float64:
        raise TypeError("the exact-mode kernels take float64 plans")
    return fused4._launch_setup(what, cf, plan, jr, jc, seg, streams)


def elem_ds_cuda(cf, plan: Plan4, jr, jc, toff=0, T=None, seg=None):
    """:func:`elem_ds_reference` on the card (``dsfused.cu``)."""
    L, b = plan.t.shape
    p = jr + 2 * jc
    T = _count(cf, jr, jc, toff, T)
    cf2, streams, seg = _setup("elem_ds", cf, plan, jr, jc, seg,
                               [plan.t, plan.t_lo, plan.dt, plan.diag,
                                plan.mask])
    new = functools.partial(torch.empty, 1 + T, p, p, b, dtype=torch.float64,
                            device=plan.t.device)
    A, J, C = new(), new(), new()
    _launch("elem", p, plan.t.device, [cf2, *streams, A, J, C], L, b, jr, seg,
            toff, T)
    elem_ds_cuda.launches += 1
    return A, J, C


def factor_ds_cuda(cf, plan: Plan4, jr, jc, y, sh0, toff=0, T=None, seg=None):
    """:func:`factor_ds_reference` on the card (``dsfused.cu``)."""
    L, b = plan.t.shape
    p = jr + 2 * jc
    dev = plan.t.device
    T = _count(cf, jr, jc, toff, T)
    cf2, streams, seg = _setup("factor_ds", cf, plan, jr, jc, seg,
                               [plan.t, plan.t_lo, plan.dt, plan.diag,
                                plan.mask, y])
    sh0 = fused4._cuda_tensor(sh0, (1 + T, p, p, b), torch.float64, dev)
    new = functools.partial(torch.empty, dtype=torch.float64, device=dev)
    M, Qm = new(1 + T, p, p, b), new(1 + T, p, p, b)
    mv, qv = new(1 + T, p, b), new(1 + T, p, b)
    q0, ld, mind = new(1 + T, b), new(1 + T, b), new(b)
    _launch("factor", p, dev, [cf2, *streams, sh0, M, mv, Qm, qv, q0, ld,
                               mind], L, b, jr, seg, toff, T)
    factor_ds_cuda.launches += 1
    return M, mv, Qm, qv, q0, ld, mind


elem_ds_cuda.launches = 0
factor_ds_cuda.launches = 0
elem_ds = fused4._by_device(elem_ds_cuda, elem_ds_reference)
factor_ds = fused4._by_device(factor_ds_cuda, factor_ds_reference)


# ---------------------------------------------------------------------------
# The dual glue: fused4's float64 glue in forward mode
# ---------------------------------------------------------------------------


def prefix_sh0_ds(A, J, C, seg):
    """Each lane's dual seed ``(1 + T, P, P, B)`` from dual elements.

    The value and T tangents of ``fused4.prefix_sh0``, the counterpart of
    dsfused.py:601 ``_ds_prefix_sh0``; one vmapped jvp for every direction.
    """

    def fn(a, j, c):
        return (fused4.prefix_sh0(a, j, c, seg),)

    if A.shape[0] == 1:
        return fn(A[0], J[0], C[0])[0][None]
    return _dual(fn, (A[0], J[0], C[0]), (A[1:], J[1:], C[1:]))[0]


def assemble_ds(M, m, Qm, qv, q0, ld, n, seg):
    """Per-segment ``ll`` and its T tangents, ``(1 + T, B / seg)``.

    The value and tangents of ``fused4.assemble_ll(lane_quad(...))``, the
    counterpart of dsfused.py:622 ``_ds_assemble``.
    """

    def fn(*xs):
        M_, m_, Qm_, qv_, q0_, ld_ = xs
        return (fused4.assemble_ll(fused4.lane_quad(M_, m_, Qm_, qv_, q0_,
                                                    seg), ld_, n, seg),)

    xs = (M, m, Qm, qv, q0, ld)
    if M.shape[0] == 1:
        return fn(*(x[0] for x in xs))[0][None]
    return _dual(fn, tuple(x[0] for x in xs), tuple(x[1:] for x in xs))[0]


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------


def _words(parts, k):
    """Output ``k`` of every chunk joined on the word axis: chunk 0's value
    word, then every chunk's tangent words in order."""
    return torch.cat([parts[0][k][:1]] + [p[k][1:] for p in parts])


def build_ll_and_grad_ds(plan: Plan4, jr, jc, n_chain=1, tan_count=None,
                         tan_chunk=None):
    """``(cf, y4=None) -> (ll, ok, d ll / d cf)`` in forward mode.

    The port of dsfused.py:753 ``build_ll_and_grad_ds``.  ``cf`` is a
    ``(C,)`` :func:`pack_cf_ds` vector, or ``(n_chain, C)`` on a folded
    plan (``make_plan_ds(..., n_chain=n_chain)``), and then every output
    is per chain.  The gradient covers the first ``tan_count`` packed
    coefficients (default all C, the rest 0), ``tan_chunk`` directions a
    launch (default all of them, the fastest in chip_smoke.py's
    tan_chunk sweep, PERF.md); the glue runs once over all directions.
    ``ok`` comes from the value's minimum pivot and a finite ``ll``; where
    it is False, ``ll`` is -inf and the gradient 0.
    """
    c = cf_len(jr, jc)
    tan_count = c if tan_count is None else int(tan_count)
    tan_chunk = tan_chunk or max(tan_count, 1)
    chunks = [(o, min(tan_chunk, tan_count - o))
              for o in range(0, tan_count, tan_chunk)] or [(0, 0)]

    def fn(cf, y4=None):
        y4 = plan.y if y4 is None else y4
        nc, seg = fused4._check_seg(cf, plan)
        if nc != n_chain:
            raise ValueError("expected {0} coefficient rows, got {1}".format(
                n_chain, nc))
        els = [elem_ds(cf, plan, jr, jc, toff=o, T=T, seg=seg)
               for o, T in chunks]
        sh0 = prefix_sh0_ds(*(_words(els, k) for k in range(3)), seg)
        parts, w = [], 1
        for o, T in chunks:
            seeds = torch.cat([sh0[:1], sh0[w:w + T]])
            parts.append(factor_ds(cf, plan, jr, jc, y4, seeds, toff=o, T=T,
                                   seg=seg))
            w += T
        tot = assemble_ds(*(_words(parts, k) for k in range(6)), plan.n,
                          seg)
        mind = parts[0][6]
        ll = tot[0]
        ok = (mind.reshape(nc, seg).amin(1) > 0) & torch.isfinite(ll)
        ll = torch.where(ok, ll, -math.inf)
        grad = torch.zeros(nc, c, dtype=ll.dtype, device=ll.device)
        grad[:, :tan_count] = tot[1:].T
        grad = torch.where(ok[:, None], grad, 0.0)
        if cf.ndim == 1:
            return ll[0], ok[0], grad[0]
        return ll, ok, grad

    return fn


def build_ll_ds(plan: Plan4, jr, jc, n_chain=1):
    """``(cf, y4=None) -> (ll, ok)``: the value kernels alone (no
    tangents)."""
    fn = build_ll_and_grad_ds(plan, jr, jc, n_chain=n_chain, tan_count=0)

    def ll_fn(cf, y4=None):
        ll, ok, _ = fn(cf, y4)
        return ll, ok

    return ll_fn
