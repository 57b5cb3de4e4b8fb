"""The lane layout of pre-lowered streams, and the value on it.

Port of ``celerite_tpu/ops/fused.py``: :func:`default_num_blocks`
(fused.py:47-63), :func:`_to_lanes` (fused.py:273-294), :func:`run_kernel`
(fused.py:297) and :func:`gp_log_likelihood` (fused.py:367-397).

At padded width 8 or less the value is the single-sweep kernel
(``_kernel``, fused.py:130): phase 0 gives each lane's Riccati element
(A, J, C), a scan over the lanes seeds every lane with the prefix before
it, phase 1 reruns each lane from its seed for the affine map (M, m) and
the statistics (Qm, qv, Kahan-summed q0 and log-det, min pivot), and a
second scan gives each lane its incoming state h and assembles ``quad =
sum q0 - 2 qv.h + h^T Qm h``:

- :func:`kernel_cuda` launches ``celerite_torch/csrc/fused.cu`` (seven
  launches from one host call: the two sweeps and the chunked scans on the
  card, nothing between them; a ``.launches`` counter counts the calls);
- :func:`kernel_reference` is its plain version: the elements pass of
  ``blocked``, ``fused4.prefix_sh0``, ``adjoint.factor_fwd_reference``
  without saves and ``fused4.lane_quad``, one copy of the arithmetic with
  the routes that already run it;
- :func:`kernel` takes the kernel for CUDA streams and the plain version
  for CPU streams.

Above width 8 :func:`run_kernel` takes the three-pass pipeline of
:mod:`celerite_torch.ops.pallas_solver`, as fused.py:312-315 does.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import _build
from . import adjoint, blocked, fused4
from .lanes4 import default_num_blocks4
from .lower import SSM

__all__ = ["MAX_WIDTH", "default_num_blocks", "kernel_reference",
           "kernel_cuda", "kernel", "assemble", "run_kernel",
           "gp_log_likelihood"]

# Padded widths of the single-sweep kernel; wider models take the
# three-pass kernels (fused.py:312-315).
MAX_WIDTH = 8


def default_num_blocks(n, device):
    """Lane count B (a power of two) for an ``n``-point series.

    The JAX package's rule is sized by the TPU's vector memory and carries
    no meaning here: this takes the port's own lane rule for the value path
    (``lanes4.default_num_blocks4``, measured on the card; about sqrt(n)
    lanes on the CPU).
    """
    return default_num_blocks4(n, device)


def _to_lanes(ssm: SSM, resid, num_blocks):
    """Pad with inert rows and lay out time-major ``(L, P, B)`` on
    ``num_blocks`` lanes of ``L = ceil(n / B)`` steps
    (``blocked._time_major``); returns ``(u, v, ph, a, y, L)``."""
    b = int(num_blocks)
    L = -(-ssm.U.shape[0] // b)
    return (*blocked._time_major(ssm, resid, b, L), L)


def _segment(b, seg):
    """Lanes a segment: ``seg`` (default all ``b``), which must divide b."""
    seg = int(seg or b)
    if seg < 1 or b % seg:
        raise ValueError("segment of {0} lanes does not divide {1} "
                         "lanes".format(seg, b))
    return seg


def kernel_reference(u, v, ph, a, y, seg=None):
    """``(quad, ld, mind)`` of each segment of ``seg`` lanes (default one
    segment of all B): float64 ``(B / seg,)`` twice and ``(B / seg,)`` in
    the streams' dtype.  The plain version of fused.py:130 ``_kernel``;
    differentiable with autograd and ``torch.func``."""
    b = u.shape[-1]
    seg = _segment(b, seg)
    nseg = b // seg
    sh0 = fused4.prefix_sh0(*blocked._block_elements(u, v, ph, a), seg)
    M, m, Qm, qv, q0, ld, mind = adjoint.factor_fwd_reference(
        sh0, u, v, ph, a, y, keep_saves=False)
    quad = fused4.lane_quad(M, m, Qm, qv, q0, seg)
    return (quad.reshape(nseg, seg).sum(1),
            ld.double().reshape(nseg, seg).sum(1),
            mind.reshape(nseg, seg).amin(1))


@functools.lru_cache(maxsize=None)
def _kernel_fn(p, dtype):
    lib = _build.load("fused.cu", {"CELERITE_P": p})
    fn = getattr(lib, "celerite_fused_ll_{0}".format(
        "f32" if dtype == torch.float32 else "f64"))
    fn.argtypes = [ctypes.c_void_p] * 20 + [ctypes.c_int] * 3 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _work_fn(p):
    """The float64 words of scratch the chunked scans take for B lanes in
    segments of ``seg`` (``celerite_fused_work``)."""
    fn = _build.load("fused.cu", {"CELERITE_P": p}).celerite_fused_work
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    return fn


def kernel_cuda(u, v, ph, a, y, seg=None):
    """:func:`kernel_reference` on the card (``csrc/fused.cu``): seven
    launches, the per-lane states and the chunks' sums between them in
    scratch tensors."""
    L, p, b = u.shape
    seg = _segment(b, seg)
    ins = adjoint._operands("fused", u, [
        (v, u.shape), (ph, u.shape), (a, (L, 1, b)), (y, (L, 1, b))])
    new = u.new_empty
    scratch = [new(p, p, b) for _ in range(4)]            # A, J, C, sh0
    scratch += [new(p, p, b), new(p, b), new(p, p, b), new(p, b)]  # M m Qm qv
    scratch += [new(b, dtype=torch.float64), new(b, dtype=torch.float64),
                new(b)]                                    # q0, ld, mind
    scratch.append(new(_work_fn(p)(b, seg), dtype=torch.float64))  # chunks
    nseg = b // seg
    quad, ld = (new(nseg, dtype=torch.float64) for _ in range(2))
    mind = new(nseg)
    fn = _kernel_fn(p, u.dtype)
    stream = torch.cuda.current_stream(u.device).cuda_stream
    err = fn(*[x.data_ptr() for x in ins + scratch + [quad, ld, mind]], L, b,
             seg, stream)
    if err != 0:
        raise RuntimeError("fused kernel launch failed: CUDA error "
                           "{0}".format(err))
    kernel_cuda.launches += 1
    return quad, ld, mind


kernel_cuda.launches = 0
kernel = adjoint._by_device(kernel_cuda, kernel_reference, 0)


def assemble(quad, ld, mind, n, dtype):
    """``(ll, ok)`` of each segment from its sums: ``ll = -0.5 (quad + ld +
    n log 2 pi)``, -inf where the minimum pivot is not positive or ``ll``
    is not finite; ``ll`` in ``dtype``."""
    ll = -0.5 * (quad + ld + n * math.log(2.0 * math.pi))
    ok = (mind > 0) & torch.isfinite(ll)
    return torch.where(ok, ll, -math.inf).to(dtype), ok


def run_kernel(u, v, ph, a, y, n):
    """``(ll, ok)`` from pre-laned ``(L, P, B)`` streams, ``n`` the unpadded
    point count.  No autograd rule: wrap it as :func:`gp_log_likelihood`
    does, or supply one (``gp.py``'s value closures).

    Padded width P <= 8 takes the single-sweep kernel (:func:`kernel`),
    P > 8 ``pallas_solver.run_from_lanes``: the CUDA kernels on CUDA
    streams, their plain versions on CPU streams.
    """
    if u.shape[1] > MAX_WIDTH:
        from . import pallas_solver

        return pallas_solver.run_from_lanes(u, v, ph, a, y, n)
    ll, ok = assemble(*kernel(u, v, ph, a, y), n, u.dtype)
    return ll[0], ok[0]


def gp_log_likelihood(ssm: SSM, resid, num_blocks=None):
    """``(ll, ok)`` through :func:`run_kernel` on ``num_blocks`` lanes
    (default :func:`default_num_blocks`), at every padded width up to 16
    on the card; differentiable with autograd, whose backward runs through
    ``blocked.gp_log_likelihood`` at its default block size
    (fused.py:386-397)."""
    n = ssm.U.shape[0]
    b = num_blocks or default_num_blocks(n, ssm.U.device)

    def forward(ssm, resid):
        u, v, ph, a, y, _ = _to_lanes(ssm, resid, b)
        return run_kernel(u, v, ph, a, y, n)

    return blocked.with_blocked_backward(forward, ssm, resid)
