"""Double-single (two-float) helpers for the float32 lowering, in torch.

Port of ``celerite_tpu/ops/ds.py:38-118``.  When ``t`` is stored in float32
the lowering loses accuracy in two places: ``diff(f32(t))`` (fixed by exact
float64 spacings computed on the host) and the phase ``d * t`` of the
oscillatory terms (~1e4 rad carries an absolute error ~6e-4 rad).  The phase
is fixed here: an exact two-float product and sum reduce ``d * t`` modulo
2 pi, with ``t = t_hi + t_lo`` split once on the host, before the hardware
cos/sin.

No compensated float32 exp.  The JAX package's ``accurate_exp`` exists
because the TPU's float32 exp is ~30 ulp off.  The card computes float64
natively, so the float32 transcendentals of the lowering are evaluated in
float64 and rounded once (:func:`exp_rn`, :func:`ds_cos_sin`).  CUDA's
``expf``/``sincosf`` are within 2 ulp, but the pivots of a smooth kernel
over dense data cancel catastrophically and amplify any bias in the decay
factors ~1e3 times: plain ``expf`` put the float32 log-likelihood of the
bench configuration 9.7e-5 off float64 on the H100 (PERF.md).

``two_prod`` here uses Dekker's split; the CUDA kernel computes the same
exact error term with one ``fma`` (celerite_torch/csrc/fused4_primal.cu).

References: Dekker (1971), Knuth TAOCP 4.2.2.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["two_sum", "split", "two_prod", "host_ds", "reduced_angle",
           "ds_cos_sin", "exp_rn"]


def two_sum(a, b):
    """Exact addition: s + e == a + b with s = fl(a + b)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def _split_factor(dtype):
    # 2^ceil(p/2) + 1 for p-bit significands.
    return 4097.0 if dtype == torch.float32 else 134217729.0


def split(a):
    """Dekker split: a == hi + lo with hi, lo half-width significands."""
    c = _split_factor(a.dtype) * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a, b):
    """Exact product: p + e == a * b with p = fl(a * b)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def host_ds(x64, dtype=np.float32):
    """Host-side split of a float64 array into (hi, lo) pairs."""
    hi = np.asarray(x64, dtype)
    lo = np.asarray(np.asarray(x64, np.float64) - hi, dtype)
    return hi, lo


def _two_pi_split(dtype):
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    pi2 = 2.0 * np.pi
    hi = np.asarray(pi2, np_dtype)
    lo = np.asarray(pi2 - np.float64(hi), np_dtype)
    return float(hi), float(lo)


def reduced_angle(d, t_hi, t_lo):
    """(d * t) mod 2 pi as a ds pair with |r_hi| <= ~pi.

    ``d`` broadcasts against ``t_hi``/``t_lo``.  Valid while the reduction
    integer k = round(d t / 2 pi) stays exactly representable (k < 2^23 in
    f32, i.e. d * t < ~5e7 rad).  Under autograd the reduction integer is
    locally constant, so d(r)/d(d) = t follows from the arithmetic.
    """
    pi2_hi, pi2_lo = _two_pi_split(t_hi.dtype)
    p_hi, p_lo = two_prod(d, t_hi)
    p_lo = p_lo + d * t_lo
    k = torch.round(p_hi / pi2_hi).detach()
    q_hi, q_lo = two_prod(k, torch.full_like(k, pi2_hi))
    r_hi, r_e = two_sum(p_hi, -q_hi)
    r_lo = r_e + p_lo - q_lo - k * pi2_lo
    return two_sum(r_hi, r_lo)


def _rounded(fn, x):
    """fn(x), for float32 evaluated in float64 and rounded once."""
    if x.dtype == torch.float32:
        return fn(x.double()).float()
    return fn(x)


def exp_rn(x):
    """exp; a float32 input is evaluated in float64 and rounded once."""
    return _rounded(torch.exp, x)


def ds_cos_sin(r_hi, r_lo):
    """cos/sin of a ds angle: first-order correction on the lo part."""
    c = _rounded(torch.cos, r_hi)
    s = _rounded(torch.sin, r_hi)
    return c - r_lo * s, s + r_lo * c
