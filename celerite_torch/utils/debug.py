"""Debug modes: NaN checking and cross-backend agreement assertions.

Port of ``celerite_tpu/utils/debug.py``.  Determinism and NaN issues on
an accelerator surface as value disagreements, so the first tool is an
assertion that every solver backend computes the same log-likelihood.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["debug_mode", "check_backends_agree"]


@contextlib.contextmanager
def debug_mode(nans=True, disable_jit=False):
    """Context manager enabling autograd's anomaly detection (the NaN
    check of backward passes, ``torch.autograd.set_detect_anomaly``).

    ``disable_jit`` is accepted for the JAX package's signature and
    ignored: the port has nothing compiled to turn off.
    """
    with torch.autograd.set_detect_anomaly(bool(nans)):
        yield


def check_backends_agree(ssm, resid, rtol=1e-6, include_native=True,
                         include_pallas=False):
    """Assert seq / blocked (/ native / pallas) agree on the ll.

    ``ssm`` and ``resid`` are tensors on one device.  ``include_pallas``
    runs the three-pass solver (``ops.pallas_solver``): its CUDA kernels
    on the card, their plain versions on the CPU; ``include_native`` the
    host C++ core when g++ is there.  Returns the dict of per-backend
    values; raises AssertionError with the values on disagreement.
    """
    from .. import native
    from ..ops import blocked, seq

    values = {}
    ll, ok = seq.gp_log_likelihood(ssm, resid)
    values["seq"] = float(ll)
    ll_b, _ = blocked.gp_log_likelihood(ssm, resid)
    values["blocked"] = float(ll_b)
    if include_native and native.available():
        ll_n, _ = native.loglike(
            *[v.detach().cpu().numpy().astype(np.float64) for v in ssm],
            resid.detach().cpu().numpy().astype(np.float64),
        )
        values["native"] = float(ll_n)
    if include_pallas:
        from ..ops import pallas_solver

        ll_p, _ = pallas_solver.gp_log_likelihood(ssm, resid)
        values["pallas"] = float(ll_p)

    base = values["seq"]
    scale = max(abs(base), 1.0)
    for name, v in values.items():
        if abs(v - base) > rtol * scale:
            raise AssertionError(
                "backend disagreement: {0}".format(values)
            )
    return values
