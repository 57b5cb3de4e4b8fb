"""Carry parameters, lane plans and packed coefficients across from the JAX
package.

Every function takes plain numpy arrays, so this module needs neither JAX
nor ``celerite_tpu``: a caller reads the arrays off the JAX objects
(``get_parameter_names(include_frozen=True)``,
``get_parameter_vector(include_frozen=True)``, ``unfrozen_mask``; the
fields of a ``Plan4``, a ``PlanDS`` or a ``LanePlan``; a ``pack_cf_ds``
vector) and hands them over, so that the two packages compute on
identical inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops.lanes import LanePlan
from .ops.lanes4 import Plan4, resolve_device

__all__ = ["load_parameters", "plan_from_numpy", "plan_ds_from_numpy",
           "cf_ds_from_numpy", "lane_plan_from_numpy"]


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
                    device=None) -> Plan4:
    """A port plan from a JAX ``Plan4``'s arrays.

    Streams come shaped ``(L, 8, W)`` (the TPU layout) or ``(L, B)``; lane
    ``l = r*W + c`` of the former is column ``l`` of the latter, so a
    reshape carries them over.  ``device`` defaults to ``cuda`` (raising
    without CUDA), as :func:`celerite_torch.ops.lanes4.make_plan4` does.
    """
    b = int(num_blocks)
    device = resolve_device(device)

    def lanes(x):
        x = np.asarray(x)
        return torch.as_tensor(
            np.ascontiguousarray(x.reshape(x.shape[0], b)), device=device
        )

    return Plan4(t=lanes(t), t_lo=lanes(t_lo), dt=lanes(dt),
                 diag=lanes(diag), y=lanes(y), mask=lanes(mask), n=int(n),
                 num_blocks=b)


def plan_ds_from_numpy(t, t_lo, dt, dt_lo, diag, y, mask, n, num_blocks,
                       device=None) -> Plan4:
    """The port's exact-mode plan from a JAX ``PlanDS``'s arrays.

    The JAX plan holds the time grid and the spacings as double-single
    pairs of float32 words; each pair is summed in float64, which holds it
    exactly, so the port's float64 plan carries the same numbers (its
    ``t_lo`` is 0).  The float32 ``diag`` and ``y`` widen exactly.
    """
    def f64(x):
        return np.asarray(x, np.float64)

    zero = np.zeros_like(f64(t))
    return plan_from_numpy(f64(t) + f64(t_lo), zero, f64(dt) + f64(dt_lo),
                           f64(diag), f64(y), f64(mask), n, num_blocks,
                           device=device)


def cf_ds_from_numpy(cf, device=None):
    """A ``pack_cf_ds`` vector (or rows) as a float64 tensor."""
    return torch.as_tensor(np.asarray(cf, np.float64),
                           device=resolve_device(device))


def lane_plan_from_numpy(t, t_lo, dt, diag, y, mask, n, device=None):
    """A port ``LanePlan`` from a JAX ``LanePlan``'s arrays.

    Both packages lay the plan out ``(L, 1, B)`` with the same lanes, so
    the arrays carry over as they are.  ``device`` defaults to ``cuda``
    (raising without CUDA), as :func:`celerite_torch.ops.lanes.make_plan`
    does.
    """
    device = resolve_device(device)
    arrays = (torch.as_tensor(np.array(x), device=device)
              for x in (t, t_lo, dt, diag, y, mask))
    return LanePlan(*arrays, n=int(n))
