"""The three-pass primal on pre-lowered streams: CUDA kernels and their plain
versions.

Port of ``celerite_tpu/ops/pallas_solver.py``.  The passes of
:mod:`celerite_torch.ops.blocked` with each pass one kernel over
time-major ``(L, P, B)`` streams (lanes = blocks of consecutive points,
B any count)::

    elements -> prefix_sh0 -> factor -> prefix_h0 -> subst -> (ll, ok)

``elements`` (``_elements_kernel``, pallas_solver.py:62) gives each lane's
Riccati element (A, J, C); ``factor`` (``_factor_kernel``, :114) reruns
each lane from its seed and streams out the pivots d and gains w with the
lane's affine map (M, m); ``subst`` (``_subst_kernel``, :154) runs the
forward substitution from each lane's incoming state and Kahan-sums the
quad and log-det.  The prefixes between them are ``fused4``'s float64
glue; seeds and states are rounded to the streams' dtype on entry.

Each kernel has a ``*_reference`` plain version (``blocked``'s pass: a
Python loop over the L steps, lanes vectorised) and a ``*_cuda`` wrapper
(``celerite_torch/csrc/pallas_solver.cu``, CUDA tensors only, padded width
1..16, with a ``.launches`` counter); the dispatchers ``elements`` etc.
take the kernel for CUDA streams and the plain version for CPU streams.

:func:`run_from_lanes` is the value on pre-laned streams (``fused.
run_kernel`` above width 8, and the wide route's value closure);
:func:`gp_log_likelihood` the value of an SSM, whose autograd backward
runs through ``blocked.gp_log_likelihood`` (pallas_solver.py:347-380).
``_to_blocked_layout`` (pallas_solver.py:38) is ``blocked._pad_blocks``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import _build
from . import blocked, fused
from .adjoint import _by_device, _operands

__all__ = ["MAX_WIDTH", "SOLVER_KERNELS", "default_lanes",
           "default_block_size",
           "elements_reference", "factor_reference", "subst_reference",
           "elements_cuda", "factor_cuda", "subst_cuda", "elements",
           "factor", "subst", "run_from_lanes", "gp_log_likelihood"]

MAX_WIDTH = 16
SOLVER_KERNELS = ("elements", "factor", "subst")

# Lanes of the wide route's value plan on the card (gp.py): the fastest
# count of 64-4096 for one theta of config[2] with three oscillation modes
# (P = 16) at N = 1e5 in chip_smoke.py's lane_sweep_F, where the call is
# bound by the host (PERF.md).  It is the adjoint route's count, so the
# value closure shares that route's plan.
_CUDA_LANES = 128
# Steps a block of solver="pallas" on the card: the fastest L of 64-2048
# for config[2] with three oscillation modes (P = 16) at N = 1e5 in
# chip_smoke.py's lane_sweep_F (PERF.md; 256-1024 lie within 12% of each
# other, the call being bound by the host).  The JAX package's 256 was the
# TPU's.
_CUDA_BLOCK = 512


def default_block_size(device):
    """Steps a block L: ``_CUDA_BLOCK`` on the card, the JAX package's 256
    on the CPU."""
    return _CUDA_BLOCK if torch.device(device).type == "cuda" else 256


def default_lanes(n, device):
    """Lanes of a value plan for an ``n``-point series: on the card at most
    ``_CUDA_LANES``, on the CPU ``fused.default_num_blocks`` (the adjoint
    route's count there, so one plan serves both)."""
    b = fused.default_num_blocks(n, device)
    if torch.device(device).type == "cuda":
        b = min(b, _CUDA_LANES)
    return b


elements_reference = blocked._block_elements
factor_reference = blocked._block_factor
subst_reference = blocked._block_subst


# ---------------------------------------------------------------------------
# The CUDA kernels: ctypes entry points and their wrappers
# ---------------------------------------------------------------------------

# Pointer arguments of each entry point; every one then takes (L, B, stream).
_NPTR = {"elements": 7, "factor": 10, "subst": 9}


@functools.lru_cache(maxsize=None)
def _kernel_fn(name, p, dtype):
    """The ctypes entry point ``name`` for width ``p`` and ``dtype``."""
    lib = _build.load("pallas_solver.cu", {"CELERITE_P": p})
    fn = getattr(lib, "celerite_solver_{0}_{1}".format(
        name, "f32" if dtype == torch.float32 else "f64"))
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
        raise RuntimeError("pallas_solver {0} kernel launch failed: CUDA "
                           "error {1}".format(name, err))


def elements_cuda(u, v, ph, a):
    """:func:`elements_reference` on the card (``csrc/pallas_solver.cu``)."""
    L, p, b = u.shape
    ins = _operands("pallas_solver elements", u,
                    [(v, u.shape), (ph, u.shape), (a, (L, 1, b))])
    A, J, C = (u.new_empty(p, p, b) for _ in range(3))
    _launch("elements", u, ins + [A, J, C])
    elements_cuda.launches += 1
    return A, J, C


def factor_cuda(sh0, u, v, ph, a, y):
    """:func:`factor_reference` on the card (``csrc/pallas_solver.cu``)."""
    L, p, b = u.shape
    ins = _operands("pallas_solver factor", u, [
        (v, u.shape), (ph, u.shape), (a, (L, 1, b)), (y, (L, 1, b)),
        (sh0, (p, p, b))])
    d, w = u.new_empty(L, 1, b), u.new_empty(L, p, b)
    M, m = u.new_empty(p, p, b), u.new_empty(p, b)
    _launch("factor", u, ins + [d, w, M, m])
    factor_cuda.launches += 1
    return d, w, M, m


def subst_cuda(h0, u, ph, w, y, d):
    """:func:`subst_reference` on the card (``csrc/pallas_solver.cu``)."""
    L, p, b = u.shape
    ins = _operands("pallas_solver subst", u, [
        (ph, u.shape), (w, u.shape), (y, (L, 1, b)), (d, (L, 1, b)),
        (h0, (p, b))])
    quad, logdet = (u.new_empty(b, dtype=torch.float64) for _ in range(2))
    mind = u.new_empty(b)
    _launch("subst", u, ins + [quad, logdet, mind])
    subst_cuda.launches += 1
    return quad, logdet, mind


for _f in (elements_cuda, factor_cuda, subst_cuda):
    _f.launches = 0


elements = _by_device(elements_cuda, elements_reference, 0)
factor = _by_device(factor_cuda, factor_reference, 1)
subst = _by_device(subst_cuda, subst_reference, 1)


def run_from_lanes(u, v, ph, a, y, n):
    """``(ll, ok)`` from pre-laned ``(L, P, B)`` streams (pallas_solver.py:
    280), ``n`` the unpadded point count: the three kernels on CUDA
    streams, their plain versions on CPU streams.  No autograd rule."""
    return blocked._solve((elements, factor, subst), u, v, ph, a, y, n)


def gp_log_likelihood(ssm, resid, block_size=None):
    """``(ll, ok)`` for an SSM and residuals on ``B = ceil(N / L)`` lanes of
    ``L = block_size`` steps (default :func:`default_block_size`).
    Differentiable with autograd: the backward is autograd through
    ``blocked.gp_log_likelihood``, at the same L when ``block_size`` is
    given (as the JAX package's backward is), else at ``blocked``'s own
    default: the kernels and the plain passes are fastest at different L
    on the card, and L does not change the result."""
    n = ssm.U.shape[0]
    L = block_size or default_block_size(ssm.U.device)

    def forward(ssm, resid):
        u, v, ph, a, y, _ = blocked._pad_blocks(ssm, resid, L)
        return run_from_lanes(u, v, ph, a, y, n)

    return blocked.with_blocked_backward(forward, ssm, resid, block_size)
