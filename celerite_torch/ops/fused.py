"""The lane layout of pre-lowered streams, for the SSM-level entry points.

Port of the parts of ``celerite_tpu/ops/fused.py`` that the adjoint route
needs: :func:`default_num_blocks` (fused.py:47-63) and :func:`_to_lanes`
(fused.py:273-294).  The single-launch kernel of that module
(``_kernel``, fused.py:130) is not ported yet (ROADMAP queue 2).
"""

from __future__ import annotations

import torch

from .lanes4 import default_num_blocks4
from .lower import SSM

__all__ = ["default_num_blocks"]


def default_num_blocks(n, device):
    """Lane count B (a power of two) for an ``n``-point series.

    The JAX package's rule is sized by the TPU's vector memory and carries
    no meaning here: this takes the port's own lane rule for the value path
    (``lanes4.default_num_blocks4``, measured on the card; about sqrt(n)
    lanes on the CPU).
    """
    return default_num_blocks4(n, device)


def _to_lanes(ssm: SSM, resid, num_blocks):
    """Pad to B * L points and lay out time-major ``(L, P, B)``, lanes =
    blocks of consecutive points; returns ``(u, v, ph, a, y, L)``."""
    n, p = ssm.U.shape
    b = int(num_blocks)
    L = -(-n // b)
    pad = b * L - n
    U, V, phi, A = ssm.U, ssm.V, ssm.phi, ssm.A
    if pad:
        zero = U.new_zeros(pad, p)
        U = torch.cat([U, zero])
        V = torch.cat([V, zero])
        phi = torch.cat([phi, torch.ones_like(zero)])
        A = torch.cat([A, A.new_ones(pad)])
        resid = torch.cat([resid, resid.new_zeros(pad)])

    def tm(x):  # (B*L, p) -> (L, p, B)
        return x.reshape(b, L, p).permute(1, 2, 0).contiguous()

    def tm1(x):  # (B*L,) -> (L, 1, B)
        return x.reshape(b, L).T[:, None, :].contiguous()

    return tm(U), tm(V), tm(phi), tm1(A), tm1(resid), L
