"""Polynomial algebra and the Sturm-theorem PSD positivity check.

The port's own copy of ``celerite_tpu/ops/poly.py`` (numpy only).
Host-side numpy analog of the reference's poly.h + ``check_coefficients``
(/root/reference/cpp/include/celerite/poly.h:13-138,
/root/reference/cpp/include/celerite/utils.h:27-104).  This runs at parameter
validation time (outside jit), so plain numpy is the right tool: the root
counting is branch-heavy and value-dependent.

Polynomials are 1-D numpy arrays of coefficients, highest degree first.  The
PSD of a celerite kernel is a rational function of x = omega^2 with positive
denominator; the kernel is everywhere positive-definite iff the combined
numerator polynomial has no roots on (0, inf) and is non-negative at 0.
Sturm's theorem counts the roots exactly from sign changes of the Sturm
sequence evaluated at 0 and +inf.
"""

from __future__ import annotations

import numpy as np

POLYTOL = 1e-10

__all__ = [
    "polyval",
    "polyadd",
    "polymul",
    "polyrem",
    "polyder",
    "polysturm",
    "polycountroots",
    "check_coefficients",
]


def polyval(p, x):
    return np.polyval(np.asarray(p, dtype=float), x)


def polyadd(p1, p2):
    return np.polyadd(
        np.asarray(p1, dtype=float), np.asarray(p2, dtype=float)
    )


def polymul(p1, p2):
    return np.polymul(
        np.asarray(p1, dtype=float), np.asarray(p2, dtype=float)
    )


def _strip(p):
    """Drop (near-)zero leading coefficients, keeping at least one entry."""
    p = np.asarray(p, dtype=float)
    nz = np.flatnonzero(np.abs(p) >= POLYTOL)
    if len(nz) == 0:
        return p[-1:]
    return p[nz[0]:]


def polyrem(u, v):
    """Remainder of u / v, with tiny leading coefficients stripped."""
    _, r = np.polydiv(np.asarray(u, dtype=float), np.asarray(v, dtype=float))
    return _strip(r)


def polyder(p):
    return np.polyder(np.asarray(p, dtype=float))


def polysturm(p):
    """The Sturm sequence of p: [p, p', -rem(p, p'), ...]."""
    p0 = np.asarray(p, dtype=float)
    seq = [p0]
    p1 = polyder(p0)
    seq.append(p1)
    for _ in range(len(p0) - 1):
        p0, p1 = p1, -polyrem(p0, p1)
        seq.append(p1)
        if len(p1) == 1:
            break
    return seq


def _sign_changes_at(seq, at_zero):
    def sgn(x):
        return int(x > 0) - int(x < 0)

    signs = [
        sgn(p[-1]) if at_zero else sgn(p[0]) for p in seq
    ]
    count = 0
    prev = signs[0]
    for s in signs[1:]:
        count += prev != s
        prev = s
    return count


def polycountroots(p):
    """Number of real roots of p in (0, inf), by Sturm's theorem."""
    p = np.asarray(p, dtype=float)
    if len(p) <= 1:
        return 0
    seq = polysturm(p)
    return _sign_changes_at(seq, at_zero=True) - _sign_changes_at(
        seq, at_zero=False
    )


def check_coefficients(
    a_real, c_real, a_comp, b_comp, c_comp, d_comp
):
    """True iff the summed PSD is non-negative for all frequencies.

    Builds the common-denominator numerator polynomial in x = omega^2:
    each real term contributes numerator ``a c (x + c^2)`` over denominator
    ``(x + c^2)^2``; each complex term contributes
    ``(a c - b d) x + (a c + b d)(c^2 + d^2)`` over
    ``x^2 + 2(c^2 - d^2) x + (c^2 + d^2)^2``.
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp = (
        np.atleast_1d(np.asarray(v, dtype=float))
        for v in (a_real, c_real, a_comp, b_comp, c_comp, d_comp)
    )
    if a_real.shape != c_real.shape:
        return False
    if not (
        a_comp.shape == b_comp.shape == c_comp.shape == d_comp.shape
    ):
        return False

    nums, denoms = [], []
    for a, c in zip(a_real, c_real):
        c2 = c * c
        nums.append(np.array([a * c, a * c * c2]))
        denoms.append(np.array([1.0, 2.0 * c2, c2 * c2]))
    for a, b, c, d in zip(a_comp, b_comp, c_comp, d_comp):
        c2, d2 = c * c, d * d
        w0 = c2 + d2
        nums.append(np.array([a * c - b * d, (a * c + b * d) * w0]))
        denoms.append(np.array([1.0, 2.0 * (c2 - d2), w0 * w0]))

    total = np.zeros(1)
    for i, num in enumerate(nums):
        part = num
        for j, den in enumerate(denoms):
            if i != j:
                part = polymul(part, den)
        total = polyadd(total, part)

    total = _strip(total)
    if polyval(total, 0.0) < 0.0:
        return False
    return polycountroots(total) == 0
