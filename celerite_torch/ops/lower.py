"""Lowering: coefficient arrays -> semiseparable (U, V, phi, A) arrays.

Port of ``celerite_tpu/ops/lower.py:35-144``.  Conventions (matching the
reference recursion, cholesky.h:103-152):

- ``P = J_real + 2 * J_complex + J_general`` semiseparable rank.
- ``U[n]``: real j: ``a_r[j]``; complex pair: ``(a cos(d t_n) + b sin(d t_n),
  a sin(d t_n) - b cos(d t_n))``; general j: ``U_gen[j, n]``.
- ``V[n]``: real: 1; complex pair: ``(cos(d t_n), sin(d t_n))``; general:
  ``V_gen[j, n]``.
- ``phi[n]`` decays state from ``t_{n-1}`` to ``t_n``; ``phi[0] = 1``:
  real: ``exp(-c dt)``; complex pair: the same value twice; general: 1.
- ``A[n] = diag[n] + sum(a_r) + sum(a_c) + jitter (+ A_gen[n])``.

The symmetric matrix represented is
``K = diag(A) + tril(U~ V~^T, -1) + triu(V~ U~^T, 1)`` where the tilde denotes
the decay products accumulated through ``phi``.  General columns are data:
no parameter moves them, so their tangents are zero and every solver, kernel
or plain, takes them as any other phi = 1 column.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from . import ds

__all__ = ["SSM", "Coefficients", "lower"]


class Coefficients(NamedTuple):
    """The 6 coefficient arrays + scalar jitter (terms lowering contract)."""

    a_real: torch.Tensor
    c_real: torch.Tensor
    a_comp: torch.Tensor
    b_comp: torch.Tensor
    c_comp: torch.Tensor
    d_comp: torch.Tensor
    jitter: torch.Tensor


class SSM(NamedTuple):
    """Semiseparable representation consumed by the solver scans."""

    U: torch.Tensor  # (N, P)
    V: torch.Tensor  # (N, P)
    phi: torch.Tensor  # (N, P), phi[0] == 1
    A: torch.Tensor  # (N,)


def lower(
    coeffs: Coefficients,
    t: torch.Tensor,
    diag: torch.Tensor,
    dt: Optional[torch.Tensor] = None,
    t_lo: Optional[torch.Tensor] = None,
    A_gen: Optional[torch.Tensor] = None,
    U_gen: Optional[torch.Tensor] = None,
    V_gen: Optional[torch.Tensor] = None,
) -> SSM:
    """Build the (U, V, phi, A) arrays for sorted input coordinates ``t``.

    ``diag`` is the per-point variance added to the diagonal (yerr**2).  The
    arrays take ``t``'s dtype and device.  Optional general semiseparable
    blocks follow the reference convention: ``A_gen`` is (N,),
    ``U_gen`` / ``V_gen`` are (J_general, N); their columns follow the
    complex pairs with phi = 1 and ``A_gen`` adds to ``A``.

    Accuracy options for float32 (both static per dataset, see ops/ds.py):
    ``dt``: precomputed spacings (dt[0] == 0) — differencing a rounded f32
    ``t`` loses up to percent-level relative accuracy on the spacings;
    ``t_lo``: the low part of a double-single split of ``t``, enabling
    exact-mod-2pi phase reduction for the oscillatory terms.
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = (
        torch.as_tensor(c, dtype=t.dtype, device=t.device) for c in coeffs
    )
    n = t.shape[0]
    if dt is None:
        dt = torch.cat([t.new_zeros(1), torch.diff(t)])
    else:
        dt = dt.to(t.dtype)

    # Real block.
    u_r = a_real.expand(n, a_real.shape[0])
    v_r = t.new_ones((n, a_real.shape[0]))
    p_r = ds.exp_rn(-c_real * dt[:, None])

    # Complex block: interleave the (cos, sin) channel pair per term so the
    # layout matches the reference ordering (real, then complex pairs).
    if t_lo is not None:
        r_hi, r_lo = ds.reduced_angle(
            d_comp, t[:, None], t_lo.to(t.dtype)[:, None]
        )
        cos, sin = ds.ds_cos_sin(r_hi, r_lo)
    else:
        arg = d_comp * t[:, None]
        cos, sin = torch.cos(arg), torch.sin(arg)
    jc = a_comp.shape[0]
    u_c = torch.stack(
        [a_comp * cos + b_comp * sin, a_comp * sin - b_comp * cos], -1
    ).reshape(n, 2 * jc)
    v_c = torch.stack([cos, sin], -1).reshape(n, 2 * jc)
    p_half = ds.exp_rn(-c_comp * dt[:, None])
    p_c = torch.stack([p_half, p_half], -1).reshape(n, 2 * jc)

    a = diag.to(t.dtype) + torch.sum(a_real) + torch.sum(a_comp) + jitter
    parts_u, parts_v, parts_p = [u_r, u_c], [v_r, v_c], [p_r, p_c]
    if U_gen is not None and U_gen.shape[0] > 0:
        def gen(x):
            return torch.as_tensor(x, dtype=t.dtype, device=t.device)

        parts_u.append(gen(U_gen).T)
        parts_v.append(gen(V_gen).T)
        parts_p.append(t.new_ones((n, U_gen.shape[0])))
        a = a + gen(A_gen)
    return SSM(
        U=torch.cat(parts_u, dim=1),
        V=torch.cat(parts_v, dim=1),
        phi=torch.cat(parts_p, dim=1),
        A=a,
    )
