"""Closed-form celerite kernel and PSD evaluation (torch).

Port of ``celerite_tpu/ops/kernels.py``.  The celerite kernel is

    k(tau) = sum_j a_r[j] exp(-c_r[j] |tau|)
           + sum_j exp(-c_c[j] |tau|) (a_c[j] cos(d_c[j] |tau|)
                                       + b_c[j] sin(d_c[j] |tau|))

and its power spectral density is

    S(omega) = sqrt(2/pi) * [
        sum_j a_r c_r / (c_r^2 + omega^2)
      + sum_j ((a_c c_c + b_c d_c)(c_c^2 + d_c^2)
               + (a_c c_c - b_c d_c) omega^2)
            / (omega^4 + 2 (c_c^2 - d_c^2) omega^2 + (c_c^2 + d_c^2)^2) ]

Both broadcast over the shape of their last argument.
"""

from __future__ import annotations

import math

import torch

__all__ = ["kernel_value", "psd_value"]


def kernel_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, tau):
    """Evaluate k(tau); broadcasts over the shape of ``tau``."""
    t = torch.abs(torch.as_tensor(tau, dtype=a_real.dtype))[..., None]
    k_real = torch.sum(a_real * torch.exp(-c_real * t), dim=-1)
    k_comp = torch.sum(
        torch.exp(-c_comp * t)
        * (a_comp * torch.cos(d_comp * t) + b_comp * torch.sin(d_comp * t)),
        dim=-1,
    )
    return k_real + k_comp


def psd_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, omega):
    """Evaluate S(omega); broadcasts over the shape of ``omega``."""
    w2 = torch.square(torch.as_tensor(omega, dtype=a_real.dtype))[..., None]
    p_real = torch.sum(a_real * c_real / (c_real**2 + w2), dim=-1)
    c2pd2 = c_comp**2 + d_comp**2
    num = (a_comp * c_comp + b_comp * d_comp) * c2pd2 + (
        a_comp * c_comp - b_comp * d_comp
    ) * w2
    den = w2 * w2 + 2.0 * (c_comp**2 - d_comp**2) * w2 + c2pd2 * c2pd2
    p_comp = torch.sum(num / den, dim=-1)
    return math.sqrt(2.0 / math.pi) * (p_real + p_comp)
