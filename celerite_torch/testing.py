"""Shared data makers and checks for tests and ``chip_smoke.py``.

The data makers are numpy (or take a ``terms`` module as an argument), so
the same inputs can be fed to this package and to the JAX reference
package.  :func:`compare_grad_kernels` holds the gradient kernels against
their plain versions on the card.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["make_data", "CASES", "pack_values", "bench_kernel",
           "config2_kernel", "compare_grad_kernels"]

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


def _errors(got, want, summed=False, seg=None):
    """(max abs error, error relative to the largest reference value).

    ``summed``: coefficient rows ``(C, B)``, compared as their per-segment
    sums (the gradient the pipeline returns) against the sums' norm.
    """
    got, want = got.double(), want.double()
    if summed:
        c, b = want.shape
        got = got.reshape(c, b // seg, seg).sum(2)
        want = want.reshape(c, b // seg, seg).sum(2)
        scale = float(torch.linalg.vector_norm(want))
    else:
        scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return err, err / scale if scale > 0 else err


def compare_grad_kernels(cf, plan, jr, jc, seg=None):
    """Each gradient kernel against its plain version on the same inputs.

    ``plan`` lies on the card.  The plain versions run there too; the
    factor kernels take the seeds ``prefix_sh0`` makes from the plain
    elements, the backward kernels the plain forward saves and float64
    cotangents drawn from a seeded generator.  Returns ``{kernel:
    {"max_abs_err", "max_rel_err", "outputs": {name: rel}}}``.
    """
    from .ops import fused4

    b = plan.t.shape[1]
    p = jr + 2 * jc
    nc = 1 if cf.ndim == 1 else cf.shape[0]
    seg = b // nc if seg is None else seg
    dev = plan.t.device
    gen = torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           device=dev)

    A, J, C, sv0 = fused4.elem_fwd_reference(cf, plan, jr, jc, seg=seg)
    sh0 = fused4.prefix_sh0(A, J, C, seg)
    fwd1 = fused4.factor_fwd_reference(cf, plan, jr, jc, plan.y, sh0, seg=seg)
    cots1 = [randn(p, p, b), randn(p, b), randn(p, p, b), randn(p, b),
             randn(b), randn(b)]
    cots0 = [randn(p, p, b) for _ in range(3)]
    runs = {
        "elem_fwd": (("A", "J", "C", "saves"),
                     fused4.elem_fwd_cuda(cf, plan, jr, jc, seg=seg),
                     (A, J, C, sv0)),
        "factor_fwd": (("M", "m", "Qm", "qv", "q0", "ld", "mind", "saves"),
                       fused4.factor_fwd_cuda(cf, plan, jr, jc, plan.y, sh0,
                                              seg=seg),
                       fwd1),
        "factor_bwd": (("hcf", "hy", "hsh0"),
                       fused4.factor_bwd_cuda(cf, plan, jr, jc, plan.y,
                                              fwd1[7], *cots1, seg=seg),
                       fused4.factor_bwd_reference(cf, plan, jr, jc, plan.y,
                                                   fwd1[7], *cots1, seg=seg)),
        "elem_bwd": (("hcf",),
                     (fused4.elem_bwd_cuda(cf, plan, jr, jc, sv0, *cots0,
                                           seg=seg),),
                     (fused4.elem_bwd_reference(cf, plan, jr, jc, sv0,
                                                *cots0, seg=seg),)),
    }
    out = {}
    for name, (names, got, want) in runs.items():
        errs = {n: _errors(g, w, summed=n == "hcf", seg=seg)
                for n, g, w in zip(names, got, want)}
        out[name] = {"max_abs_err": max(e[0] for e in errs.values()),
                     "max_rel_err": max(e[1] for e in errs.values()),
                     "outputs": {n: e[1] for n, e in errs.items()}}
    return out
