"""The log-likelihood and its forward-mode gradient along T directions, on
pre-lowered streams: CUDA kernels and their plain versions.

Port of ``celerite_tpu/ops/tangent.py``.  The T tangent recursions ride in
the same sweeps as the value, so the chain of dependent steps does not
grow with the parameter count; the gradient of ``ll`` with respect to the
parameters is ``dll`` along the T basis directions (``fast_grad=
"tangent"``).  Tangent streams are ``(L, T, P, B)`` and ``(L, T, 1, B)``.

Two implementations, dispatched on the padded width P
(:func:`run_jac_kernel`):

1. **The single-sweep kernel with tangents** (P <= 8; ``_jac_kernel``,
   tangent.py:591): :func:`jac_cuda` launches ``csrc/tangent.cu``'s four
   jac launches (the elements and factor sweeps with tangents, and the
   seed and affine scans with their JVPs, on the card, nothing between
   them); :func:`jac_reference` is ``torch.func.jvp`` of
   ``fused.kernel_reference`` along each direction (vmapped).
2. **The split pair** (P = 9..16; :func:`_jac_impl`, tangent.py:346):
   :func:`elements_jvp` (``_elements_jvp_kernel``, tangent.py:71) gives
   each lane's (A, J, C) and its T tangents; the cross-lane prefix and its
   tangents are ``dsfused.prefix_sh0_ds`` (``fused4.prefix_sh0`` in forward
   mode, float64); :func:`factor_jvp` (``_factor_jvp_kernel``,
   tangent.py:138) gives the affine map, the statistics and their
   tangents; the assembly is ``dsfused.assemble_ds``.  Their plain
   versions are ``torch.func.jvp`` of ``blocked._block_elements`` and
   ``adjoint.factor_fwd_reference`` (vmapped over the directions).

Each kernel's wrapper (``*_cuda``) takes CUDA tensors only and counts its
calls in ``.launches``; the dispatchers take the kernel for CUDA streams
and the plain version for CPU streams.

The launch plan.  The JAX package sizes the lane count and the direction
chunk from a TPU's scoped-VMEM budget (``_VMEM_BUDGET``,
``_fused_per_lane``); none of those constants means anything here.  The
port's rule: P <= 8 the single-sweep kernel, 9..16 the split pair; every
call takes all T directions (``max_tangents`` still splits them into
pipeline runs).  The split pair's two kernels are the jac call's two
sweeps, which give a block of lanes a value warp and a warp a direction;
the host entries of ``csrc/tangent.cu`` split T into chunks of at most
seven directions, one row of blocks a chunk, each redoing the value once.
The lanes a chain
(:func:`default_jac_blocks`) on the card are ``_CUDA_LANES``, from
chip_smoke.py's lane_sweep_G (PERF.md), and on the CPU
``fused.default_num_blocks``.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import adjoint, blocked, dsfused, fused

__all__ = ["TANGENT_KERNELS", "FUSED_MAX_WIDTH", "default_jac_blocks",
           "elements_jvp_reference",
           "factor_jvp_reference", "jac_reference", "elements_jvp_cuda",
           "factor_jvp_cuda", "jac_cuda", "elements_jvp", "factor_jvp",
           "jac", "run_jac_kernel", "gp_log_likelihood_jac"]

TANGENT_KERNELS = ("elements_jvp", "factor_jvp", "jac")
# Widths of the single-sweep kernel with tangents; the split pair above.
FUSED_MAX_WIDTH = fused.MAX_WIDTH

# Lanes a chain on the card: of 32-512 in chip_smoke.py's lane_sweep_G
# (config[2], P = 8, T = 7, N = 1e5), the fastest for one theta and for 4
# folded chains, within 3% of the fastest for 16 (PERF.md).
_CUDA_LANES = 256


def default_jac_blocks(n, device):
    """Lanes a chain of the tangent route for an ``n``-point series: on the
    card at most ``_CUDA_LANES``, on the CPU ``fused.default_num_blocks``
    (about sqrt(n) lanes)."""
    b = fused.default_num_blocks(n, device)
    if torch.device(device).type == "cuda":
        b = min(b, _CUDA_LANES)
    return b


# ---------------------------------------------------------------------------
# Plain versions: forward mode of the plain sweeps
# ---------------------------------------------------------------------------


def _jvp_dirs(fn, primals, tangents, in_dims):
    """``fn(*primals)`` and its jvp along each of T tangent sets, whose
    direction axes are ``in_dims``: ``(values, tangents)``, each tangent
    output with a leading T axis.  The values are computed once."""

    def one(*tans):
        return torch.func.jvp(fn, primals, tans)

    vals, tans = torch.func.vmap(one, in_dims=in_dims)(*tangents)
    return [x[0] for x in vals], list(tans)


def elements_jvp_reference(u, v, ph, a, du, dv, dph, da):
    """Each lane's element ``(A, J, C)`` ``(P, P, B)`` and its tangents
    ``(DA, DJ, DC)`` ``(T, P, P, B)``: the plain version of tangent.py:71."""
    vals, tans = _jvp_dirs(blocked._block_elements, (u, v, ph, a),
                           (du, dv, dph, da), (1, 1, 1, 1))
    return (*vals, *tans)


def factor_jvp_reference(sh0, dsh0, u, v, ph, a, y, du, dv, dph, da, dy):
    """The seeded factor from ``sh0 (P, P, B)`` and its tangents ``dsh0 (T,
    P, P, B)``: ``(M, m, Qm, qv, q0, ld, mind, DM, Dm, DQm, Dqv, Dq0,
    Dld)``, the plain version of tangent.py:138 (``q0``, ``ld``, ``Dq0``,
    ``Dld`` in float64, ``(B,)`` and ``(T, B)``)."""

    def fn(s, *streams):
        return adjoint.factor_fwd_reference(s, *streams, keep_saves=False)

    vals, tans = _jvp_dirs(fn, (sh0.to(u.dtype), u, v, ph, a, y),
                           (dsh0.to(u.dtype), du, dv, dph, da, dy),
                           (0, 1, 1, 1, 1, 1))
    return (*vals, *tans[:6])


def jac_reference(u, v, ph, a, y, du, dv, dph, da, dy, seg=None):
    """``(quad, ld, mind, dquad, dld)`` of each segment of ``seg`` lanes:
    ``fused.kernel_reference``'s outputs and the tangents of the first two,
    ``(T, B / seg)`` float64.  The plain version of tangent.py:591."""

    def fn(*streams):
        return fused.kernel_reference(*streams, seg=seg)

    vals, tans = _jvp_dirs(fn, (u, v, ph, a, y), (du, dv, dph, da, dy),
                           (1, 1, 1, 1, 1))
    return (*vals, tans[0], tans[1])


# ---------------------------------------------------------------------------
# The CUDA kernels (celerite_torch/csrc/tangent.cu)
# ---------------------------------------------------------------------------

_NPTR = {"elements": 14, "factor": 25, "jac": 16}
_JAC_SCRATCH = 21


@functools.lru_cache(maxsize=None)
def _kernel_fn(name, p, dtype):
    lib = _build.load("tangent.cu", {"CELERITE_P": p})
    fn = getattr(lib, "celerite_tangent_{0}_{1}".format(
        name, "f32" if dtype == torch.float32 else "f64"))
    nint = 4 if name == "jac" else 3
    fn.argtypes = [ctypes.c_void_p] * _NPTR[name] + [ctypes.c_int] * nint \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _tangent_operands(name, u, du, pairs):
    """Check a launch: the streams of :func:`adjoint._operands` and the
    tangent streams ``(L, T, P, B)`` / ``(L, T, 1, B)`` with T >= 1."""
    L, p, b = u.shape
    T = du.shape[1] if du.ndim == 4 else 0
    if T < 1:
        raise ValueError("{0} kernel needs at least one tangent direction, "
                         "shaped (L, T, P, B)".format(name))
    shapes = {"P": (L, p, b), "1": (L, 1, b), "TP": (L, T, p, b),
              "T1": (L, T, 1, b), "PP": (p, p, b), "TPP": (T, p, p, b)}
    return adjoint._operands(name, u, [(x, shapes[k]) for x, k in pairs]), T


def _launch(name, u, ptrs, *ints):
    fn = _kernel_fn(name, u.shape[1], u.dtype)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(*ptrs, u.shape[0], u.shape[2], *ints, stream)
    if err != 0:
        raise RuntimeError("tangent {0} kernel launch failed: CUDA error "
                           "{1}".format(name, err))


def _ptrs(xs):
    return [x.data_ptr() for x in xs]


def elements_jvp_cuda(u, v, ph, a, du, dv, dph, da):
    """:func:`elements_jvp_reference` on the card (``csrc/tangent.cu``)."""
    L, p, b = u.shape
    ins, T = _tangent_operands("tangent elements_jvp", u, du, [
        (v, "P"), (ph, "P"), (a, "1"), (du, "TP"), (dv, "TP"), (dph, "TP"),
        (da, "T1")])
    outs = [u.new_empty(p, p, b) for _ in range(3)]
    outs += [u.new_empty(T, p, p, b) for _ in range(3)]
    _launch("elements", u, _ptrs(ins + outs), T)
    elements_jvp_cuda.launches += 1
    return tuple(outs)


def _factor_outputs(u, T):
    L, p, b = u.shape
    f64 = dict(dtype=torch.float64)
    return [u.new_empty(p, p, b), u.new_empty(p, b), u.new_empty(p, p, b),
            u.new_empty(p, b), u.new_empty(b, **f64), u.new_empty(b, **f64),
            u.new_empty(b), u.new_empty(T, p, p, b), u.new_empty(T, p, b),
            u.new_empty(T, p, p, b), u.new_empty(T, p, b),
            u.new_empty(T, b, **f64), u.new_empty(T, b, **f64)]


def factor_jvp_cuda(sh0, dsh0, u, v, ph, a, y, du, dv, dph, da, dy):
    """:func:`factor_jvp_reference` on the card (``csrc/tangent.cu``)."""
    ins, T = _tangent_operands("tangent factor_jvp", u, du, [
        (v, "P"), (ph, "P"), (a, "1"), (y, "1"), (du, "TP"), (dv, "TP"),
        (dph, "TP"), (da, "T1"), (dy, "T1"), (sh0, "PP"), (dsh0, "TPP")])
    outs = _factor_outputs(u, T)
    _launch("factor", u, _ptrs(ins + outs), T)
    factor_jvp_cuda.launches += 1
    return tuple(outs)


def jac_cuda(u, v, ph, a, y, du, dv, dph, da, dy, seg=None):
    """:func:`jac_reference` on the card (``csrc/tangent.cu``): four
    launches, the per-lane states between them in scratch tensors."""
    L, p, b = u.shape
    seg = fused._segment(b, seg)
    ins, T = _tangent_operands("tangent jac", u, du, [
        (v, "P"), (ph, "P"), (a, "1"), (y, "1"), (du, "TP"), (dv, "TP"),
        (dph, "TP"), (da, "T1"), (dy, "T1")])
    scratch = [u.new_empty(p, p, b) for _ in range(3)]
    scratch += [u.new_empty(T, p, p, b) for _ in range(3)]
    scratch += [u.new_empty(p, p, b), u.new_empty(T, p, p, b)]
    scratch += _factor_outputs(u, T)
    assert len(scratch) == _JAC_SCRATCH
    work = (ctypes.c_void_p * _JAC_SCRATCH)(*_ptrs(scratch))
    nseg = b // seg
    f64 = dict(dtype=torch.float64)
    outs = [u.new_empty(nseg, **f64), u.new_empty(nseg, **f64),
            u.new_empty(nseg), u.new_empty(T, nseg, **f64),
            u.new_empty(T, nseg, **f64)]
    _launch("jac", u, _ptrs(ins) + [ctypes.addressof(work)] + _ptrs(outs),
            seg, T)
    jac_cuda.launches += 1
    return tuple(outs)


for _f in (elements_jvp_cuda, factor_jvp_cuda, jac_cuda):
    _f.launches = 0

elements_jvp = adjoint._by_device(elements_jvp_cuda, elements_jvp_reference,
                                  0)
factor_jvp = adjoint._by_device(factor_jvp_cuda, factor_jvp_reference, 2)
jac = adjoint._by_device(jac_cuda, jac_reference, 0)


# ---------------------------------------------------------------------------
# The two pipelines and the entry points
# ---------------------------------------------------------------------------


def _finish(ll, mind, dll, dtype):
    """``(ll, ok, dll)`` of each segment: -inf and a zero gradient where the
    minimum pivot is not positive or ``ll`` is not finite."""
    ok = (mind > 0) & torch.isfinite(ll)
    return (torch.where(ok, ll, -math.inf).to(dtype), ok,
            torch.where(ok, dll, 0.0))


def _jac_impl(u, v, ph, a, y, du, dv, dph, da, dy, n, n_chain=1):
    """The split pair and the forward-mode float64 glue (tangent.py:346):
    ``(ll, ok)`` of each of the ``n_chain`` segments and ``dll (T,
    n_chain)``."""
    seg = u.shape[-1] // n_chain
    A, J, C, DA, DJ, DC = elements_jvp(u, v, ph, a, du, dv, dph, da)
    sh = dsfused.prefix_sh0_ds(torch.cat([A[None], DA]),
                               torch.cat([J[None], DJ]),
                               torch.cat([C[None], DC]), seg)
    (M, m, Qm, qv, q0, ld, mind, DM, Dm, DQm, Dqv, Dq0, Dld) = factor_jvp(
        sh[0], sh[1:], u, v, ph, a, y, du, dv, dph, da, dy)
    tot = dsfused.assemble_ds(*(torch.cat([x[None], dx]) for x, dx in (
        (M, DM), (m, Dm), (Qm, DQm), (qv, Dqv), (q0, Dq0), (ld, Dld))), n,
        seg)
    return _finish(tot[0], mind.reshape(n_chain, seg).amin(1), tot[1:],
                   u.dtype)


def _run_fused_jac(u, v, ph, a, y, du, dv, dph, da, dy, n, n_chain=1):
    """The single-sweep kernel with tangents (tangent.py:808): ``(ll, ok)``
    of each segment and ``dll (T, n_chain)``."""
    quad, ld, mind, dquad, dld = jac(u, v, ph, a, y, du, dv, dph, da, dy,
                                     seg=u.shape[-1] // n_chain)
    ll = -0.5 * (quad + ld + n * math.log(2.0 * math.pi))
    return _finish(ll, mind, -0.5 * (dquad + dld), u.dtype)


def run_jac_kernel(u, v, ph, a, y, du, dv, dph, da, dy, n, max_tangents=None,
                   n_chain=1):
    """``(ll, ok, dll)`` from pre-laned streams and their tangents.

    Primal streams ``(L, P, B)`` / ``(L, 1, B)``, tangents ``(L, T, P, B)``
    / ``(L, T, 1, B)`` (the kernels on CUDA streams, the plain versions on
    CPU streams).  P <= 8 takes the single-sweep kernel, 9..16 the split
    pair.  ``max_tangents`` splits the directions into chunks of at most
    that many, one pipeline run each (tangent.py:496).  With ``n_chain >
    1`` the lanes hold that many segments (a chain-folded plan, ``n`` the
    points of one chain) and ``ll``, ``ok`` come back ``(n_chain,)``,
    ``dll`` ``(n_chain, T)``; else scalars and ``(T,)``.  ``dll`` is
    float64 and 0 where ``ok`` is False.
    """
    b, tdim = u.shape[-1], du.shape[1]
    if b % n_chain:
        raise ValueError("lane count must be a multiple of the chain count")
    chunk = max_tangents or tdim
    impl = _run_fused_jac if u.shape[1] <= FUSED_MAX_WIDTH else _jac_impl
    parts = [impl(u, v, ph, a, y, *(x[:, s:s + chunk]
                                     for x in (du, dv, dph, da, dy)),
                  n, n_chain) for s in range(0, tdim, chunk)]
    ll, ok = parts[0][:2]
    dll = torch.cat([p[2] for p in parts])
    if n_chain == 1:
        return ll[0], ok[0], dll[:, 0]
    return ll, ok, dll.T


def _to_lanes_tan(x, num_blocks, L, pad):
    """``(T, N, P)`` or ``(T, N)`` tangents -> ``(L, T, P, B)`` / ``(L, T,
    1, B)`` (tangent.py:880); pad rows get zero tangents."""
    if x.ndim == 2:
        x = x[:, :, None]
    tdim, _, p = x.shape
    if pad:
        x = torch.cat([x, x.new_zeros(tdim, pad, p)], dim=1)
    return x.reshape(tdim, num_blocks, L, p).permute(2, 0, 3, 1).contiguous()


def gp_log_likelihood_jac(ssm, resid, dssm, dresid, num_blocks=None,
                          max_tangents=None):
    """Value and forward-mode jacobian of the GP ll (tangent.py:894).

    ``dssm`` / ``dresid`` carry a leading tangent axis T on every array.
    Returns ``(ll, ok, dll)`` with ``dll`` of shape ``(T,)``, float64.
    ``num_blocks`` (a power of two) defaults to
    :func:`default_jac_blocks`'s.
    """
    n = ssm.U.shape[0]
    b = int(num_blocks or default_jac_blocks(n, ssm.U.device))
    if b & (b - 1):
        raise ValueError("num_blocks must be a power of two")
    L = -(-n // b)
    pad = b * L - n
    u, v, ph, a, y = blocked._time_major(ssm, resid, b, L)
    du, dv, dph = (_to_lanes_tan(x, b, L, pad)
                   for x in (dssm.U, dssm.V, dssm.phi))
    da, dy = (_to_lanes_tan(x, b, L, pad) for x in (dssm.A, dresid))
    return run_jac_kernel(u, v, ph, a, y, du, dv, dph, da, dy, n,
                          max_tangents=max_tangents)
