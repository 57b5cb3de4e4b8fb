"""Shared numpy data makers for tests and ``chip_smoke.py``.

Everything here is numpy (or takes a ``terms`` module as an argument), so the
same inputs can be fed to this package and to the JAX reference package.
"""

from __future__ import annotations

import numpy as np

__all__ = ["make_data", "CASES", "pack_values", "bench_kernel",
           "config2_kernel"]

# (jr, jc, coefficient values) of the fused primal tests: packed as
# [a_real, c_real, a_comp, b_comp, c_comp, d_comp]; complex terms keep
# a*c > b*d (PSD).  (4, 2) is the padded shape of two SHO terms (config[2]).
CASES = [
    (1, 0, [0.8, 0.7]),
    (0, 1, [0.9, 0.2, 0.8, 1.7]),
    (2, 1, [0.5, 0.3, 1.1, 0.6, 0.7, 0.2, 0.8, 2.3]),
    (4, 2, [0.5, 0.3, 0.2, 0.1, 1.1, 0.6, 0.9, 2.0,
            0.7, 0.4, 0.2, 0.1, 0.8, 0.5, 2.3, 0.9]),
]


def make_data(n, seed=0, t_max=10.0):
    """Sorted times, noisy sinusoid and per-point errors."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, t_max, n))
    yerr = 0.1 + 0.05 * rng.random(n)
    y = np.sin(t) + 0.1 * rng.standard_normal(n)
    return t, y, yerr


def pack_values(jr, jc, vals, jitter=0.05):
    """Packed coefficient vector: the values, then their diagonal total."""
    vals = np.asarray(vals, np.float64)
    total = vals[:jr].sum() + vals[2 * jr: 2 * jr + jc].sum() + jitter
    return np.concatenate([vals, [total]])


def bench_kernel(terms):
    """bench.py's model: SHOTerm(0.1, 1.0, 0.5) as its rank-2 ComplexTerm."""
    sho = terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
    a, b, c, d = [float(x[0]) for x in sho.coefficients[2:6]]
    return terms.ComplexTerm(log_a=np.log(a), log_b=np.log(b),
                             log_c=np.log(c), log_d=np.log(d))


def config2_kernel(terms):
    """config[2]'s fitted model: two SHO terms plus jitter (P = 8)."""
    return (
        terms.SHOTerm(log_S0=0.2, log_Q=-0.3, log_omega0=0.2)
        + terms.SHOTerm(log_S0=-0.7, log_Q=2.0, log_omega0=1.6)
        + terms.JitterTerm(log_sigma=-1.0)
    )
