"""The lane layout of pre-lowered streams, and the value on it.

Port of ``celerite_tpu/ops/fused.py``: :func:`default_num_blocks`
(fused.py:47-63), :func:`_to_lanes` (fused.py:273-294), :func:`run_kernel`
(fused.py:297) and :func:`gp_log_likelihood` (fused.py:367-397).  The
single-launch kernel of that module (``_kernel``, fused.py:130), the JAX
package's value at padded width 8 or less, is not ported yet (ROADMAP
queue 2, item 7): :func:`run_kernel` raises there.  Above width 8 it takes
the three-pass pipeline of :mod:`celerite_torch.ops.pallas_solver`, as
fused.py:312-315 does.
"""

from __future__ import annotations

import torch

from . import blocked
from .lanes4 import default_num_blocks4
from .lower import SSM

__all__ = ["default_num_blocks", "run_kernel", "gp_log_likelihood"]


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


def run_kernel(u, v, ph, a, y, n):
    """``(ll, ok)`` from pre-laned ``(L, P, B)`` streams, ``n`` the unpadded
    point count.  No autograd rule: wrap it as :func:`gp_log_likelihood`
    does, or supply one (``gp.py``'s value closures).

    Padded width P > 8 takes ``pallas_solver.run_from_lanes`` (the CUDA
    kernels on CUDA streams, their plain versions on CPU streams).  At P
    <= 8 the JAX package runs its single fused kernel, which is not ported
    yet: this raises rather than run the three-pass kernels in its place.
    """
    p = u.shape[1]
    if p <= 8:
        raise NotImplementedError(
            "fused.run_kernel at padded width P = {0} <= 8: the single fused "
            "kernel (celerite_tpu/ops/fused.py:130 _kernel) is not ported "
            "yet (ROADMAP queue 2, item 7)".format(p))
    from . import pallas_solver

    return pallas_solver.run_from_lanes(u, v, ph, a, y, n)


def gp_log_likelihood(ssm: SSM, resid, num_blocks=None):
    """``(ll, ok)`` through :func:`run_kernel` on ``num_blocks`` lanes
    (default :func:`default_num_blocks`); differentiable with autograd,
    whose backward runs through ``blocked.gp_log_likelihood`` at its
    default block size (fused.py:386-397)."""
    n = ssm.U.shape[0]
    b = num_blocks or default_num_blocks(n, ssm.U.device)

    def forward(ssm, resid):
        u, v, ph, a, y, _ = _to_lanes(ssm, resid, b)
        return run_kernel(u, v, ph, a, y, n)

    return blocked.with_blocked_backward(forward, ssm, resid)
