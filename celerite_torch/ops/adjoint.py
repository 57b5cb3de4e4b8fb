"""The adjoint pipeline on pre-lowered streams: the log-likelihood and its
reverse-mode gradient for padded widths up to 16.

Port of ``celerite_tpu/ops/adjoint.py``.  Two streaming sweeps carry the
recursion over each lane's steps, each with per-step saves, and two
reversed sweeps transpose them::

    elements_fwd -> prefix_sh0 -> factor_fwd -> lane_quad / assemble_ll
    elements_bwd <- VJP of prefix_sh0 <- factor_bwd       (backward)

``elements_fwd`` (``_elements_fwd_kernel``, adjoint.py:63) gives each lane's
Riccati element (A, J, C); ``factor_fwd`` (``_factor_fwd_kernel``,
adjoint.py:188) reruns each lane from its seed and gives the affine map
(M, m) and the statistics (Qm, qv, Kahan-summed q0 and log-det, min
pivot).  The backward kernels (adjoint.py:98, :253) are the hand-written
transposes of those steps and emit per-step stream cotangents (hu, hv,
hph, ha, hy), which autograd chains through the lowering
(``lanes.lower_lanes``).  Unlike ``fused4``'s gradient kernels nothing is
lowered in-kernel, so the kernels take the streams of any model of
padded width 1..16.

The cross-lane glue between the kernels is ``fused4``'s float64 glue
(``prefix_sh0``, ``lane_quad``, ``assemble_ll``), segmented per chain; for
float32 streams it runs in float64 too.

Each kernel has a ``*_reference`` plain version (a Python loop over the L
steps following the Pallas body line by line) and a ``*_cuda`` wrapper
(``celerite_torch/csrc/adjoint.cu``, CUDA tensors only, with a
``.launches`` counter); the dispatchers ``elements_fwd`` etc. take the
kernel for CUDA streams and the plain version for CPU streams.
``_ElementsOp`` and ``_FactorOp`` are the ``torch.autograd.Function``
counterparts of the ``jax.custom_vjp`` pair (adjoint.py:396-558).

Layout: streams ``(L, P, B)`` and ``(L, 1, B)``, per-lane outputs ``(P, P,
B)``, ``(P, B)`` and ``(B,)``.  The per-step saves are ``(L, B, NSV)``:
at step ``s`` lane ``l`` holds its NSV words contiguously, each saved
matrix column-major (word ``j * P + i`` is entry ``(i, j)``) and then the
saved vector, so a group of threads that owns one row each writes and
reads consecutive words.  Elements: ``[Shin, A_in]``, NSV = 2 P^2;
factor: ``[Shin, Mprev, mprev]``, NSV = 2 P^2 + P.  Cotangents and seeds
arrive in float64 from the glue and are rounded to the streams' dtype on
entry; ``q0`` and ``ld`` leave in float64 (their Kahan pairs summed in
float64).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import blocked, fused, fused4
from .fused4 import _eye, _front, _riccati, _riccati_adjoint, _tr

__all__ = ["MAX_WIDTH", "ADJOINT_KERNELS", "elements_fwd_reference",
           "elements_bwd_reference", "factor_fwd_reference",
           "factor_bwd_reference", "elements_fwd_cuda", "elements_bwd_cuda",
           "factor_fwd_cuda", "factor_bwd_cuda", "elements_fwd",
           "elements_bwd", "factor_fwd", "factor_bwd", "run_kernel",
           "gp_log_likelihood", "value_and_grad_fn",
           "default_adjoint_blocks"]

MAX_WIDTH = 16
ADJOINT_KERNELS = ("elements_fwd", "elements_bwd", "factor_fwd",
                   "factor_bwd")

# Lanes a chain on the card: the fastest count for 16 folded chains in
# chip_smoke.py's lane sweep of main path E (config[2] with three modes,
# P = 16, N = 1e5; PERF.md).
_CUDA_LANES = 128


def default_adjoint_blocks(n, device):
    """Lanes a chain of the adjoint route for an ``n``-point series: on the
    card at most ``_CUDA_LANES``, on the CPU :func:`fused.default_num_blocks`
    (about sqrt(n), which balances the plain versions' Python loop over
    the steps against the glue's log2(B) prefix rounds)."""
    b = fused.default_num_blocks(n, device)
    if torch.device(device).type == "cuda":
        b = min(b, _CUDA_LANES)
    return b


# ---------------------------------------------------------------------------
# Plain versions: Python loops over the steps, lanes vectorised
# ---------------------------------------------------------------------------


def _bi(x):
    return x[:, None, :]


def _bj(x):
    return x[None, :, :]


def _save(*xs):
    """One step's saves ``(B, NSV)``: each ``(P, P, B)`` matrix
    column-major, then each ``(P, B)`` vector."""
    b = xs[0].shape[-1]
    return torch.cat([x.permute(2, 1, 0).reshape(b, -1) if x.ndim == 3
                      else x.T for x in xs], dim=1)


def _load(sv, p, nmat):
    """Inverse of :func:`_save` on one step ``(B, NSV)``: ``nmat``
    matrices ``(P, P, B)``, then the vector ``(P, B)`` if any words remain."""
    b = sv.shape[0]
    out = [sv[:, k * p * p:(k + 1) * p * p].reshape(b, p, p).permute(2, 1, 0)
           for k in range(nmat)]
    if sv.shape[1] > nmat * p * p:
        out.append(sv[:, nmat * p * p:].T)
    return out


def elements_fwd_reference(u, v, ph, a):
    """Each lane's Riccati element ``(A, J, C)``, each ``(P, P, B)``, and
    the saves ``(L, B, 2 P^2)`` (``[Shin, A_in]`` of every step): the
    elements pass of ``blocked``, keeping each step's input."""
    steps = []
    A, J, C = blocked._block_elements(u, v, ph, a, saves=steps)
    return A, J, C, torch.stack([_save(*s) for s in steps])


def elements_bwd_reference(u, v, ph, a, saves, hA0, hJ0, hC0):
    """The transpose of :func:`elements_fwd_reference`, streamed in
    reverse: ``(hu, hv, hph)`` each ``(L, P, B)`` and ``ha (L, 1, B)``."""
    L, p, b = u.shape
    hA, hJ, hSh = (x.to(u.dtype) for x in (hA0, hJ0, hC0))
    hJs = hJ + _tr(hJ)  # J_in enters additively: hJ is constant
    hu_out, hv_out, hph_out = (torch.empty_like(u) for _ in range(3))
    ha_out = torch.empty_like(a)
    for i in range(L - 1, -1, -1):
        ui, phi = u[i], ph[i]
        Shin, A_in = _load(saves[i], p, 2)
        S, su, d, w = _front(Shin, ui, v[i], phi, a[i])
        ut = phi * ui
        uAc = torch.sum(A_in * _bi(ut), dim=-3)
        # F9: J_out = J_in - uAc (uAc/d)^T
        huAc = -torch.sum(hJs * _bj(uAc), dim=-2) / d
        hd = torch.sum(hJ * _bi(uAc) * _bj(uAc), dim=(-3, -2)) / (d * d)
        # F8: A_out = Phi A_in - w uAc^T
        hph = torch.sum(hA * A_in, dim=-2)
        hA_in = _bi(phi) * hA
        hw = -torch.sum(hA * _bj(uAc), dim=-2)
        huAc = huAc - torch.sum(hA * _bi(w), dim=-3)
        # F7: uAc = A_in^T ut
        hut = torch.sum(A_in * _bj(huAc), dim=-2)
        hA = hA_in + _bi(ut) * _bj(huAc)
        # F6: ut = ph * u
        hph = hph + hut * ui
        hu = hut * phi
        # F5-F1: the Riccati step.
        hu, hv, hph, ha, hSh = _riccati_adjoint(Shin, S, su, d, w, ui, phi,
                                                hSh, hw, hd, hu, hph)
        hu_out[i], hv_out[i], hph_out[i], ha_out[i] = hu, hv, hph, ha
    return hu_out, hv_out, hph_out, ha_out


def factor_fwd_reference(sh0, u, v, ph, a, y, keep_saves=True,
                         end_state=False):
    """Seeded factor, affine map and statistics with saves.

    ``sh0`` is each lane's seed ``(P, P, B)``, ``None`` for the zero seed.
    Returns ``(M, m, Qm, qv, q0, ld, mind, saves)``: ``(P, P, B)``, ``(P,
    B)``, ``(P, P, B)``, ``(P, B)``, float64 ``(B,)`` twice, ``(B,)`` and
    ``(L, B, 2 P^2 + P)`` (``[Shin, Mprev, mprev]`` of every step).  With
    ``keep_saves=False`` the saves are neither kept nor returned: the phase
    1 of the single-sweep value (``fused.kernel_reference``) and, in
    forward mode, of the tangent kernels (``tangent.factor_jvp_reference``).
    With ``end_state`` the end state ``Sh (P, P, B)`` follows ``mind``:
    the one-pass sweep (``onepass.sweep_reference``).
    """
    L, p, b = u.shape
    Sh = (torch.zeros(p, p, b, dtype=u.dtype, device=u.device)
          if sh0 is None else sh0.to(u.dtype))
    M = _eye(p, b, u)
    m = torch.zeros_like(u[0])
    Qm = torch.zeros_like(Sh)
    qv = torch.zeros_like(m)
    q0 = cq0 = ld = cld = torch.zeros_like(a[0, 0])
    mind = torch.full_like(q0, math.inf)
    saves = []
    for i in range(L):
        ui, phi = u[i], ph[i]
        if keep_saves:
            saves.append(_save(Sh, M, m))
        Sh, d, w = _riccati(Sh, ui, v[i], phi, a[i])
        d = d[0]
        PhM = _bi(phi) * M
        g = torch.sum(PhM * _bi(ui), dim=-3)
        M = PhM - _bi(w) * _bj(g)
        mh = phi * m
        z0 = y[i, 0] - torch.sum(ui * mh, dim=-2)
        m = mh + w * z0
        x1 = z0 * z0 / d - cq0
        t1 = q0 + x1
        cq0 = (t1 - q0) - x1
        q0 = t1
        x2 = torch.log(d) - cld
        t2 = ld + x2
        cld = (t2 - ld) - x2
        ld = t2
        qv = qv + (z0 / d) * g
        Qm = Qm + _bi(g) * _bj(g / d)
        mind = torch.minimum(mind, d)
    out = (M, m, Qm, qv, q0.double() + cq0.double(),
           ld.double() + cld.double(), mind) + ((Sh,) if end_state else ())
    return (*out, torch.stack(saves)) if keep_saves else out


def factor_bwd_reference(u, v, ph, a, y, saves, hM0, hm0, hQm, hqv, hq0,
                         hld, hC=None):
    """The transpose of :func:`factor_fwd_reference`, streamed in reverse:
    ``(hu, hv, hph)`` each ``(L, P, B)``, ``ha`` and ``hy`` each ``(L, 1,
    B)``, and the seed cotangent ``hsh0 (P, P, B)``.  ``hC (P, P, B)`` is
    the end state's cotangent, where the end state is an output (the
    one-pass sweep, ``onepass.sweep_bwd_reference``): the carried S-hat
    cotangent starts from it instead of zero."""
    L, p, b = u.shape
    hM, hm, hQm, hqv, hq0, hld = (x.to(u.dtype) for x in
                                  (hM0, hm0, hQm, hqv, hq0, hld))
    hQs = hQm + _tr(hQm)  # the statistics' cotangents are constant
    hSh = torch.zeros_like(hM) if hC is None else hC.to(u.dtype)
    hu_out, hv_out, hph_out = (torch.empty_like(u) for _ in range(3))
    ha_out, hy_out = torch.empty_like(a), torch.empty_like(y)
    for i in range(L - 1, -1, -1):
        ui, phi = u[i], ph[i]
        Shin, Mprev, mprev = _load(saves[i], p, 2)
        S, su, d, w = _front(Shin, ui, v[i], phi, a[i])
        d = d[0]
        PhM = _bi(phi) * Mprev
        g = torch.sum(PhM * _bi(ui), dim=-3)
        mh = phi * mprev
        z0 = y[i, 0] - torch.sum(ui * mh, dim=-2)
        # E12: the statistics (constant cotangents, one term a step).
        hqv_g = torch.sum(hqv * g, dim=-2)
        gQg = torch.sum(hQm * _bi(g) * _bj(g), dim=(-3, -2))
        hz0 = hq0 * (2.0 * z0 / d) + hqv_g / d
        hd = (-hq0 * z0 * z0 / (d * d) + hld / d - hqv_g * z0 / (d * d)
              - gQg / (d * d))
        hg = hqv * (z0 / d) + torch.sum(hQs * _bj(g), dim=-2) / d
        # E11: m_out = mh + w z0
        hw = hm * z0
        hz0 = hz0 + torch.sum(hm * w, dim=-2)
        # E10: z0 = y - u . mh
        hy = hz0
        hu = -hz0 * mh
        hmh = hm - hz0 * ui
        # E9: mh = ph * mprev
        hph = hmh * mprev
        hm = hmh * phi
        # E8: M_out = PhM - w g^T
        hw = hw - torch.sum(hM * _bj(g), dim=-2)
        hg = hg - torch.sum(hM * _bi(w), dim=-3)
        # E7: g = PhM^T u
        hu = hu + torch.sum(PhM * _bj(hg), dim=-2)
        hPhM = hM + _bi(ui) * _bj(hg)
        # E6: PhM = Phi Mprev (row scale)
        hph = hph + torch.sum(hPhM * Mprev, dim=-2)
        hM = _bi(phi) * hPhM
        # E5-E1: the Riccati step.
        hu, hv, hph, ha, hSh = _riccati_adjoint(Shin, S, su, d, w, ui, phi,
                                                hSh, hw, hd, hu, hph)
        hu_out[i], hv_out[i], hph_out[i] = hu, hv, hph
        ha_out[i, 0], hy_out[i, 0] = ha, hy
    return hu_out, hv_out, hph_out, ha_out, hy_out, hSh


# ---------------------------------------------------------------------------
# The CUDA kernels: ctypes entry points and their wrappers
# ---------------------------------------------------------------------------

# Pointer arguments of each entry point; every one then takes (L, B,
# stream).
_NPTR = {"elements_fwd": 8, "elements_bwd": 12, "factor_fwd": 14,
         "factor_bwd": 18}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name, p, dtype):
    """The ctypes entry point ``name`` for width ``p`` and ``dtype``."""
    lib = _build.load("adjoint.cu", {"CELERITE_P": p})
    fn = getattr(lib, "celerite_adjoint_{0}_{1}".format(
        name, "f32" if dtype == torch.float32 else "f64"))
    fn.argtypes = [ctypes.c_void_p] * _NPTR[name] + [ctypes.c_int] * 2 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _operands(name, u, pairs):
    """Check a launch of kernel ``name`` (e.g. "adjoint factor_fwd"): ``u``
    a float32 or float64 CUDA stream ``(L, P, B)`` with 1 <= P <= 16;
    every ``(tensor, shape)`` on the card with that shape.  Returns the
    tensors contiguous in ``u``'s dtype."""
    L, p, b = u.shape
    if not 1 <= p <= MAX_WIDTH:
        raise NotImplementedError(
            "{0} kernel takes padded widths 1..16, got P = {1} "
            "(ROADMAP queue 2, item 10)".format(name, p))
    if u.dtype not in (torch.float32, torch.float64):
        raise TypeError("{0} kernel takes float32 or float64".format(name))
    out = []
    for x, shape in [(u, (L, p, b))] + pairs:
        if x.device.type != "cuda" or tuple(x.shape) != tuple(shape):
            raise ValueError(
                "{0} operand must be a CUDA tensor shaped {1}, got {2} on "
                "{3}".format(name, tuple(shape), tuple(x.shape), x.device))
        out.append(x.to(u.dtype).contiguous())
    return out


def _launch(name, u, ptrs):
    L, p, b = u.shape
    fn = _kernel_fn(name, p, u.dtype)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(*[x.data_ptr() for x in ptrs], L, b, stream)
    if err != 0:
        raise RuntimeError("adjoint {0} kernel launch failed: CUDA error "
                           "{1}".format(name, err))


def elements_fwd_cuda(u, v, ph, a):
    """:func:`elements_fwd_reference` on the card (``csrc/adjoint.cu``)."""
    L, p, b = u.shape
    ins = _operands("adjoint elements_fwd", u,
                    [(v, u.shape), (ph, u.shape), (a, (L, 1, b))])
    A, J, C = (u.new_empty(p, p, b) for _ in range(3))
    saves = u.new_empty(L, b, 2 * p * p)
    _launch("elements_fwd", u, ins + [A, J, C, saves])
    elements_fwd_cuda.launches += 1
    return A, J, C, saves


def elements_bwd_cuda(u, v, ph, a, saves, hA0, hJ0, hC0):
    """:func:`elements_bwd_reference` on the card (``csrc/adjoint.cu``)."""
    L, p, b = u.shape
    ins = _operands("adjoint elements_bwd", u, [
        (v, u.shape), (ph, u.shape), (a, (L, 1, b)),
        (saves, (L, b, 2 * p * p)), (hA0, (p, p, b)), (hJ0, (p, p, b)),
        (hC0, (p, p, b))])
    hu, hv, hph = (torch.empty_like(ins[0]) for _ in range(3))
    ha = u.new_empty(L, 1, b)
    _launch("elements_bwd", u, ins + [hu, hv, hph, ha])
    elements_bwd_cuda.launches += 1
    return hu, hv, hph, ha


def factor_fwd_cuda(sh0, u, v, ph, a, y):
    """:func:`factor_fwd_reference` on the card (``csrc/adjoint.cu``)."""
    L, p, b = u.shape
    ins = _operands("adjoint factor_fwd", u, [
        (v, u.shape), (ph, u.shape), (a, (L, 1, b)), (y, (L, 1, b)),
        (sh0, (p, p, b))])
    M, Qm = u.new_empty(p, p, b), u.new_empty(p, p, b)
    m, qv = u.new_empty(p, b), u.new_empty(p, b)
    q0, ld = (u.new_empty(b, dtype=torch.float64) for _ in range(2))
    mind = u.new_empty(b)
    saves = u.new_empty(L, b, 2 * p * p + p)
    _launch("factor_fwd", u, ins + [M, m, Qm, qv, q0, ld, mind, saves])
    factor_fwd_cuda.launches += 1
    return M, m, Qm, qv, q0, ld, mind, saves


def factor_bwd_cuda(u, v, ph, a, y, saves, hM0, hm0, hQm, hqv, hq0, hld):
    """:func:`factor_bwd_reference` on the card (``csrc/adjoint.cu``)."""
    L, p, b = u.shape
    ins = _operands("adjoint factor_bwd", u, [
        (v, u.shape), (ph, u.shape), (a, (L, 1, b)), (y, (L, 1, b)),
        (saves, (L, b, 2 * p * p + p)), (hM0, (p, p, b)), (hm0, (p, b)),
        (hQm, (p, p, b)), (hqv, (p, b)), (hq0, (b,)), (hld, (b,))])
    hu, hv, hph = (torch.empty_like(ins[0]) for _ in range(3))
    ha, hy = u.new_empty(L, 1, b), u.new_empty(L, 1, b)
    hsh0 = u.new_empty(p, p, b)
    _launch("factor_bwd", u, ins + [hu, hv, hph, ha, hy, hsh0])
    factor_bwd_cuda.launches += 1
    return hu, hv, hph, ha, hy, hsh0


for _f in (elements_fwd_cuda, elements_bwd_cuda, factor_fwd_cuda,
           factor_bwd_cuda):
    _f.launches = 0


def _by_device(cuda_fn, plain_fn, arg):
    """The kernel for CUDA streams, the plain version for CPU streams;
    ``arg`` is the position of the ``(L, P, B)`` stream ``u``."""

    def fn(*args, **kwargs):
        kind = args[arg].device.type
        if kind == "cuda":
            return cuda_fn(*args, **kwargs)
        if kind == "cpu":
            return plain_fn(*args, **kwargs)
        raise ValueError("unsupported device {0}".format(args[arg].device))

    fn.__name__ = cuda_fn.__name__[:-len("_cuda")]
    fn.__doc__ = "{0} on CUDA streams, {1} on CPU streams.".format(
        cuda_fn.__name__, plain_fn.__name__)
    return fn


elements_fwd = _by_device(elements_fwd_cuda, elements_fwd_reference, 0)
elements_bwd = _by_device(elements_bwd_cuda, elements_bwd_reference, 0)
factor_fwd = _by_device(factor_fwd_cuda, factor_fwd_reference, 1)
factor_bwd = _by_device(factor_bwd_cuda, factor_bwd_reference, 0)


# ---------------------------------------------------------------------------
# The kernels as autograd nodes, and the end-to-end log-likelihood
# ---------------------------------------------------------------------------


class _ElementsOp(torch.autograd.Function):
    """``(u, v, ph, a) -> (A, J, C)``: forward the elements kernel with its
    saves, backward the reversed kernel."""

    @staticmethod
    def forward(ctx, u, v, ph, a):
        A, J, C, saves = elements_fwd(u, v, ph, a)
        ctx.save_for_backward(u, v, ph, a, saves)
        return A, J, C

    @staticmethod
    def backward(ctx, hA, hJ, hC):
        u, v, ph, a, saves = ctx.saved_tensors
        p, b = u.shape[1:]
        cots = [u.new_zeros(p, p, b) if h is None else h
                for h in (hA, hJ, hC)]
        return elements_bwd(u, v, ph, a, saves, *cots)


class _FactorOp(torch.autograd.Function):
    """``(sh0, u, v, ph, a, y) -> (M, m, Qm, qv, q0, ld, mind)``: forward
    the factor kernel with its saves, backward the reversed kernel."""

    @staticmethod
    def forward(ctx, sh0, u, v, ph, a, y):
        *outs, saves = factor_fwd(sh0, u, v, ph, a, y)
        ctx.save_for_backward(u, v, ph, a, y, saves)
        ctx.sh0_dtype = sh0.dtype
        ctx.mark_non_differentiable(outs[6])
        return tuple(outs)

    @staticmethod
    def backward(ctx, hM, hm, hQm, hqv, hq0, hld, _hmind):
        u, v, ph, a, y, saves = ctx.saved_tensors
        p, b = u.shape[1:]
        cots = [u.new_zeros(s) if h is None else h
                for h, s in zip((hM, hm, hQm, hqv, hq0, hld),
                                ((p, p, b), (p, b), (p, p, b), (p, b), (b,),
                                 (b,)))]
        hu, hv, hph, ha, hy, hsh0 = factor_bwd(u, v, ph, a, y, saves, *cots)
        return hsh0.to(ctx.sh0_dtype), hu, hv, hph, ha, hy


def run_kernel(u, v, ph, a, y, n, n_chain=1):
    """``(ll, ok)`` from pre-laned streams; differentiable with autograd.

    ``u, v, ph`` are ``(L, P, B)``, ``a, y`` ``(L, 1, B)`` (the kernels on
    CUDA streams, the plain versions on CPU streams).  With ``n_chain >
    1`` the lanes hold ``n_chain`` independent segments (a chain-folded
    plan) and ``(ll, ok)`` come back per chain; ``n`` is the unpadded
    point count of one chain.  ``ok`` is not differentiable.
    """
    b = u.shape[-1]
    if b % n_chain:
        raise ValueError("lane count must be a multiple of the chain count")
    seg = b // n_chain
    A, J, C = _ElementsOp.apply(u, v, ph, a)
    sh0 = fused4.prefix_sh0(A, J, C, seg)
    M, m, Qm, qv, q0, ld, mind = _FactorOp.apply(sh0, u, v, ph, a, y)
    ll = fused4.assemble_ll(fused4.lane_quad(M, m, Qm, qv, q0, seg), ld, n,
                            seg)
    ok = (mind.reshape(n_chain, seg).amin(1) > 0) & torch.isfinite(
        ll.detach())
    ll = torch.where(ok, ll, -math.inf).to(u.dtype)
    if n_chain == 1:
        return ll[0], ok[0]
    return ll, ok


def gp_log_likelihood(ssm, resid, num_blocks=None):
    """``(ll, ok)`` for an SSM (``lower.lower``'s output) and residuals
    through the adjoint pipeline; differentiable with autograd."""
    n = ssm.U.shape[0]
    b = num_blocks or default_adjoint_blocks(n, ssm.U.device)
    u, v, ph, a, y, _ = fused._to_lanes(ssm, resid, b)
    return run_kernel(u, v, ph, a, y, n)


def value_and_grad_fn(make_inputs, n, n_chain=1):
    """Build ``theta -> (ll, ok, grad)`` with the adjoint backward.

    ``make_inputs(theta) -> (u, v, ph, a, y)`` in lane layout (built by
    ``lanes.lower_lanes``).  The whole chain (lowering, kernels,
    glue) differentiates in one reverse pass, whose cost does not grow
    with the parameter count.  With ``n_chain > 1``, ``theta`` holds one
    row a chain of a folded plan and ``(ll, ok, grad)`` come back per row.
    """

    def fn(theta):
        th = theta.detach().requires_grad_()
        with torch.enable_grad():
            ll, ok = run_kernel(*make_inputs(th), n, n_chain=n_chain)
            (grad,) = torch.autograd.grad(ll.sum(), th)
        return ll.detach(), ok, grad

    return fn
