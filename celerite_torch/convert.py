"""Carry parameters and lane plans across from the JAX package.

Both functions take plain numpy arrays, so this module needs neither JAX
nor ``celerite_tpu``: a caller reads the arrays off the JAX objects
(``get_parameter_names(include_frozen=True)``,
``get_parameter_vector(include_frozen=True)``, ``unfrozen_mask``; the
fields of a ``Plan4``) and hands them over, so that the two packages
compute on identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.lanes4 import Plan4

__all__ = ["load_parameters", "plan_from_numpy"]


def load_parameters(gp, names, values, unfrozen_mask):
    """Set ``gp``'s full parameter vector and freeze mask from numpy.

    ``names`` must equal ``gp.get_parameter_names(include_frozen=True)``.
    """
    names = tuple(names)
    own = gp.get_parameter_names(include_frozen=True)
    if names != own:
        raise ValueError(
            "parameter names differ: {0} != {1}".format(names, own)
        )
    values = np.asarray(values, dtype=np.float64)
    unfrozen_mask = np.asarray(unfrozen_mask, dtype=bool)
    if values.shape != (len(own),) or unfrozen_mask.shape != (len(own),):
        raise ValueError("values and mask must have one entry per name")
    gp.set_parameter_vector(values, include_frozen=True)
    for name, free in zip(own, unfrozen_mask):
        if free:
            gp.thaw_parameter(name)
        else:
            gp.freeze_parameter(name)
    return gp


def plan_from_numpy(t, t_lo, dt, diag, y, mask, n, num_blocks,
                    device="cpu") -> Plan4:
    """A port plan from a JAX ``Plan4``'s arrays.

    Streams come shaped ``(L, 8, W)`` (the TPU layout) or ``(L, B)``; lane
    ``l = r*W + c`` of the former is column ``l`` of the latter, so a
    reshape carries them over.
    """
    b = int(num_blocks)

    def lanes(x):
        x = np.asarray(x)
        return torch.as_tensor(
            np.ascontiguousarray(x.reshape(x.shape[0], b)), device=device
        )

    return Plan4(t=lanes(t), t_lo=lanes(t_lo), dt=lanes(dt),
                 diag=lanes(diag), y=lanes(y), mask=lanes(mask), n=int(n),
                 num_blocks=b)
