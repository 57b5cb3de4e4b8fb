"""Shared data makers and checks for tests and ``chip_smoke.py``.

The data makers are numpy (or take a ``terms`` module as an argument), so
the same inputs can be fed to this package and to the JAX reference
package.  :func:`compare_grad_kernels`, :func:`compare_ds_kernels`,
:func:`compare_adjoint_kernels` and :func:`compare_solver_kernels` hold the
gradient, the exact-mode, the adjoint and the three-pass kernels against
their plain versions on the card; :func:`compare_fused_kernel` and
:func:`compare_tangent_kernels` the single-sweep kernel and the tangent
kernels, on the streams :func:`blocked_streams` and
:func:`lane_tangent_streams` make.  :func:`general_problem` and
:func:`general_kernel` make a model with general (A, U, V) blocks, and
:func:`general_lane_streams` its phi = 1 lane streams.
"""

from __future__ import annotations

import time

import numpy as np
import torch

__all__ = ["make_data", "CASES", "pack_values", "pack_values_ds",
           "bench_kernel", "config2_kernel", "wide_kernel", "width_kernel",
           "blocked_streams", "lane_tangent_streams", "compare_grad_kernels",
           "compare_ds_kernels", "compare_adjoint_kernels",
           "compare_solver_kernels", "compare_fused_kernel",
           "compare_tangent_kernels", "general_kernel", "general_problem",
           "general_lane_streams"]

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


def pack_values_ds(vals, jitter=0.05):
    """``pack_cf_ds`` vector: the values, then the raw jitter."""
    return np.concatenate([np.asarray(vals, np.float64), [jitter]])


def bench_kernel(terms):
    """bench.py's model: SHOTerm(0.1, 1.0, 0.5) as its rank-2 ComplexTerm."""
    sho = terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
    a, b, c, d = [float(x[0]) for x in sho.coefficients[2:6]]
    return terms.ComplexTerm(log_a=np.log(a), log_b=np.log(b),
                             log_c=np.log(c), log_d=np.log(d))


def config2_kernel(terms, modes=1):
    """config[2]'s fitted model (examples/config2_asteroseismic.py:65-73):
    the granulation SHO term, ``modes`` oscillation SHO terms and jitter.
    Each SHO term pads to (2, 1): P = 8 at one mode, 12 at two, 16 at
    three (13 parameters)."""
    kernel = (
        terms.SHOTerm(log_S0=0.2, log_Q=-0.3, log_omega0=0.2)
        + terms.SHOTerm(log_S0=-0.7, log_Q=2.0, log_omega0=1.6)
        + terms.JitterTerm(log_sigma=-1.0)
    )
    for k in range(1, modes):
        kernel = kernel + terms.SHOTerm(log_S0=-0.8 - 0.3 * k, log_Q=2.0,
                                        log_omega0=1.7 + 0.25 * k)
    return kernel


def wide_kernel(terms, width):
    """A model of padded width 13 (a RealTerm plus three SHO terms), 14 (13
    and a second RealTerm) or 16 (:func:`config2_kernel` with three
    modes)."""
    if width == 16:
        return config2_kernel(terms, modes=3)
    if width in (13, 14):
        kernel = terms.RealTerm(log_a=-0.5, log_c=-1.0)
        for k in range(3):
            kernel = kernel + terms.SHOTerm(log_S0=0.2 - 0.5 * k,
                                            log_Q=-0.3 + 1.2 * k,
                                            log_omega0=0.2 + 0.7 * k)
        if width == 14:
            kernel = kernel + terms.RealTerm(log_a=-1.0, log_c=0.5)
        return kernel
    raise ValueError("width must be 13, 14 or 16")


def width_kernel(terms, width):
    """A model of padded width 2 (:func:`bench_kernel`), 3 (a RealTerm plus
    bench.py's ComplexTerm), 5 (a RealTerm plus an SHO term), 8
    (:func:`config2_kernel`), 13 or 16 (:func:`wide_kernel`) or 20
    (config[2] with four modes)."""
    if width == 2:
        return bench_kernel(terms)
    if width == 3:
        return terms.RealTerm(log_a=-0.5, log_c=-1.0) + bench_kernel(terms)
    if width == 5:
        return (terms.RealTerm(log_a=-0.5, log_c=-1.0)
                + terms.SHOTerm(log_S0=0.2, log_Q=-0.3, log_omega0=0.2))
    if width in (8, 20):
        return config2_kernel(terms, modes=1 if width == 8 else 4)
    return wide_kernel(terms, width)


def general_kernel(terms):
    """benchmarks/general_row.py:49-52's two SHO terms (Q = e and e^0.7,
    both underdamped) as two ComplexTerms at their coefficients: the same
    covariance at padded width 4, where each SHO term pads to (2, 1).  An
    SHO term sits on the box prior's edge a c = b d, so log b is lowered
    by 1e-12 for the prior to hold in rounding."""
    out = []
    for log_s0, log_q, log_w0 in ((-0.7, 1.0, 0.0), (-0.9, 0.7, 0.3)):
        sho = terms.SHOTerm(log_S0=log_s0, log_Q=log_q, log_omega0=log_w0)
        a, b, c, d = [float(x[0]) for x in sho.coefficients[2:6]]
        out.append(terms.ComplexTerm(log_a=np.log(a),
                                     log_b=np.log(b) - 1e-12,
                                     log_c=np.log(c), log_d=np.log(d)))
    return out[0] + out[1]


def general_problem(n, rank, seed=11):
    """benchmarks/general_row.py:27-36's data and general blocks at ``n``
    points and general rank ``rank``: ``(t, y, yerr, A, U, V)``, ``A``
    (n,), ``U`` and ``V`` (rank, n).  Its noise in V (0.01 N(0, 1)) makes
    the covariance indefinite above ~8,000 points (the noise part of
    ``tril(U^T V, -1)`` grows like n: K's least eigenvalue 0.33 at 4096
    points, 0.16 at 8192, negative at 16384), so here it is scaled by
    min(1, 4096 / n)."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, n / 100.0, n))
    y = rng.standard_normal(n)
    yerr = np.full(n, 0.316227766)
    U = np.vander((t - t.min()) / (t.max() - t.min()), rank).T * 0.1
    V = 0.5 * U + 0.01 * min(1.0, 4096 / n) * rng.standard_normal(U.shape)
    A = np.sum(U * V, axis=0) + 0.3
    return t, y, yerr, A, U, V


def _ssm_resid_fn(kernel, t, y, yerr, general):
    """``theta -> (lower(...), resid)`` of a kernel, with the general
    blocks ``(A, U, V)`` where given, in float64 on the CPU."""
    from .ops.lower import Coefficients, lower

    def f64(x):
        return torch.as_tensor(np.asarray(x, np.float64))

    gen = {} if general is None else dict(zip(("A_gen", "U_gen", "V_gen"),
                                              map(f64, general)))
    t64, diag, y64 = f64(t), f64(yerr) ** 2, f64(y)

    def ssm_resid(th):
        coeffs = Coefficients(*kernel.get_padded_coefficients(th),
                              jitter=kernel.get_jitter(th))
        return lower(coeffs, t64, diag, **gen), y64

    return ssm_resid


def general_lane_streams(kernel, t, y, yerr, general, num_blocks,
                         dtype=torch.float64, device="cpu"):
    """Lane streams ``(u, v, ph, a, y)`` ``(L, P, B)`` / ``(L, 1, B)`` of a
    model with general blocks ``(A, U, V)`` on ``num_blocks`` lanes
    (``blocked._time_major``, as the SSM-level routes lay them out), and
    their tangents along the kernel's parameters ``(L, T, P, B)`` /
    ``(L, T, 1, B)`` (``lanes.basis_jvp``; zero on the general columns),
    lowered in float64 and then cast."""
    from .ops import blocked, lanes, tangent

    th = torch.as_tensor(kernel.get_parameter_vector())
    (ssm, resid), (dssm, dresid) = lanes.basis_jvp(
        _ssm_resid_fn(kernel, t, y, yerr, general), th)
    n, b = ssm.U.shape[0], int(num_blocks)
    L = -(-n // b)
    streams = blocked._time_major(ssm, resid, b, L)
    tangents = [tangent._to_lanes_tan(x, b, L, b * L - n)
                for x in (dssm.U, dssm.V, dssm.phi, dssm.A, dresid)]

    def cast(x):
        return x.to(dtype=dtype, device=device).contiguous()

    return tuple(map(cast, streams)), tuple(map(cast, tangents))


def blocked_streams(kernel, t, y, yerr, L, dtype=torch.float64,
                    device="cpu", general=None):
    """The ``(u, v, ph, a, y)`` blocks of ``L`` steps (``blocked.
    _pad_blocks``, a padded tail unless L divides N) of a ``celerite_torch``
    kernel at its parameters, with the general blocks ``(A, U, V)`` where
    given, lowered in float64 and then cast."""
    from .ops import blocked

    th = torch.as_tensor(kernel.get_parameter_vector())
    ssm, resid = _ssm_resid_fn(kernel, t, y, yerr, general)(th)
    streams = blocked._pad_blocks(ssm, resid, L)[:5]
    return tuple(x.to(dtype=dtype, device=device) for x in streams)


def lane_tangent_streams(kernel, t, y, yerr, num_blocks, n_chain=1,
                         dtype=torch.float64, device="cpu", seed=0):
    """Lane-plan streams of a ``celerite_torch`` kernel and their tangents
    along the T parameters' basis directions: ``((u, v, ph, a, y), (du,
    dv, dph, da, dy))``, ``(L, P, B)`` / ``(L, 1, B)`` and ``(L, T, P, B)``
    / ``(L, T, 1, B)``, lowered in float64 (``lanes.lower_lanes``, one
    vmapped ``torch.func.jvp``) and then cast.  With ``n_chain > 1`` the
    plan folds that many chains, each at the parameters plus 0.01 N(0, 1)
    (numpy, ``seed``; chain 0 unmoved), and direction k moves parameter k
    of every chain."""
    from .ops import lanes
    from .ops.lower import Coefficients

    th0 = np.asarray(kernel.get_parameter_vector(), np.float64)
    rng = np.random.default_rng(seed)
    rows = th0[None] + 0.01 * rng.standard_normal((n_chain, th0.size))
    rows[0] = th0
    rows = torch.as_tensor(rows)
    plan = lanes.make_plan(t, y, np.asarray(yerr, np.float64) ** 2,
                           num_blocks, dtype=torch.float64, n_chain=n_chain,
                           device="cpu")

    def coeffs_of(x):
        return tuple(Coefficients(*kernel.get_padded_coefficients(x),
                                  jitter=kernel.get_jitter(x)))

    def make(th):
        return (*lanes.lower_lanes(torch.func.vmap(coeffs_of)(th), plan),
                plan.y)

    streams, tangents = lanes.lane_tangents(make, rows)

    def cast(x):
        return x.to(dtype=dtype, device=device).contiguous()

    return tuple(map(cast, streams)), tuple(map(cast, tangents))


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


def _word_errors(got, want):
    """For an output with a leading word axis (value, then the tangents):
    (max abs error, max abs error relative to the output's largest
    reference value, the largest error of a word relative to that word's
    largest reference value)."""
    got, want = got.double(), want.double()
    err = (got - want).abs().reshape(want.shape[0], -1).amax(1)
    scale = want.abs().reshape(want.shape[0], -1).amax(1)
    per_word = torch.where(scale > 0, err / scale, err)
    top = float(scale.max())
    rel = float(err.max()) / top if top > 0 else float(err.max())
    return float(err.max()), rel, float(per_word.max())


def compare_ds_kernels(cf, plan, jr, jc, toff=0, T=None):
    """Both exact-mode kernels against their plain versions on the same
    inputs (the plan lies on the card; the plain versions run there too).

    The factor kernels take the dual seeds ``prefix_sh0_ds`` makes from the
    plain elements.  Every output is compared against its largest
    reference value, as :func:`compare_grad_kernels` does (``mind`` has no
    word axis); ``max_rel_err_word`` also gives the largest error of one
    word (the value or one tangent) against that word's own scale.
    Returns ``{kernel: {"max_abs_err", "max_rel_err", "max_rel_err_word",
    "outputs": {name: rel}, "plain_ms"}}``, ``plain_ms`` the plain
    version's one run on a synchronized host clock.
    """
    from .ops import dsfused

    b = plan.t.shape[1]
    seg = b // (1 if cf.ndim == 1 else cf.shape[0])

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn(*args)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3

    elems, elem_ms = timed(dsfused.elem_ds_reference, cf, plan, jr, jc, toff,
                           T)
    sh0 = dsfused.prefix_sh0_ds(*elems, seg)
    factor, factor_ms = timed(dsfused.factor_ds_reference, cf, plan, jr, jc,
                              plan.y, sh0, toff, T)
    runs = {
        "elem_ds": (("A", "J", "C"),
                    dsfused.elem_ds_cuda(cf, plan, jr, jc, toff, T), elems,
                    elem_ms),
        "factor_ds": (("M", "m", "Qm", "qv", "q0", "ld", "mind"),
                      dsfused.factor_ds_cuda(cf, plan, jr, jc, plan.y, sh0,
                                             toff, T), factor, factor_ms),
    }
    out = {}
    for name, (names, got, want, ms) in runs.items():
        errs = {n: _word_errors(g if n != "mind" else g[None],
                                w if n != "mind" else w[None])
                for n, g, w in zip(names, got, want)}
        out[name] = {"max_abs_err": max(e[0] for e in errs.values()),
                     "max_rel_err": max(e[1] for e in errs.values()),
                     "max_rel_err_word": max(e[2] for e in errs.values()),
                     "outputs": {n: e[1] for n, e in errs.items()},
                     "plain_ms": ms}
    return out


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


def compare_adjoint_kernels(u, v, ph, a, y, seg=None):
    """Each adjoint kernel against its plain version on the same streams.

    The streams lie on the card; the plain versions run there too.  The
    factor kernels take the seeds ``fused4.prefix_sh0`` makes from the
    plain elements, the backward kernels the plain forward saves and
    float64 cotangents drawn from a seeded generator.  Every output is
    compared against its largest reference value.  Returns ``{kernel:
    {"max_abs_err", "max_rel_err", "outputs": {name: rel}}}``.
    """
    from .ops import adjoint, fused4

    L, p, b = u.shape
    seg = b if seg is None else seg
    gen = torch.Generator(device=u.device).manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen, dtype=torch.float64,
                           device=u.device)

    elems = adjoint.elements_fwd_reference(u, v, ph, a)
    sh0 = fused4.prefix_sh0(*elems[:3], seg)
    factor = adjoint.factor_fwd_reference(sh0, u, v, ph, a, y)
    cots1 = [randn(p, p, b), randn(p, b), randn(p, p, b), randn(p, b),
             randn(b), randn(b)]
    cots0 = [randn(p, p, b) for _ in range(3)]
    fwd_names = ("M", "m", "Qm", "qv", "q0", "ld", "mind", "saves")
    runs = {
        "elements_fwd": (("A", "J", "C", "saves"),
                         adjoint.elements_fwd_cuda(u, v, ph, a), elems),
        "elements_bwd": (("hu", "hv", "hph", "ha"),
                         adjoint.elements_bwd_cuda(u, v, ph, a, elems[3],
                                                   *cots0),
                         adjoint.elements_bwd_reference(u, v, ph, a,
                                                        elems[3], *cots0)),
        "factor_fwd": (fwd_names,
                       adjoint.factor_fwd_cuda(sh0, u, v, ph, a, y), factor),
        "factor_bwd": (("hu", "hv", "hph", "ha", "hy", "hsh0"),
                       adjoint.factor_bwd_cuda(u, v, ph, a, y, factor[7],
                                               *cots1),
                       adjoint.factor_bwd_reference(u, v, ph, a, y,
                                                    factor[7], *cots1)),
    }
    out = {}
    for name, (names, got, want) in runs.items():
        errs = {n: _errors(g, w) for n, g, w in zip(names, got, want)}
        out[name] = {"max_abs_err": max(e[0] for e in errs.values()),
                     "max_rel_err": max(e[1] for e in errs.values()),
                     "outputs": {n: e[1] for n, e in errs.items()}}
    return out


def compare_solver_kernels(u, v, ph, a, y):
    """Each three-pass kernel against its plain version on the same streams
    (one segment of B lanes, on the card; the plain versions run there
    too).  The factor kernel takes the seeds
    ``fused4.prefix_sh0`` makes from the plain elements, subst the plain
    factor's d and w and the states ``fused4.prefix_h0`` makes from its
    maps.  Every output is compared against its largest reference value.
    Returns ``{kernel: {"max_abs_err", "max_rel_err", "outputs": {name:
    rel}}}``.
    """
    from .ops import fused4, pallas_solver as ps

    b = u.shape[-1]
    elems = ps.elements_reference(u, v, ph, a)
    sh0 = fused4.prefix_sh0(*elems, b)
    fac = ps.factor_reference(sh0, u, v, ph, a, y)
    d, w, M, m = fac
    h0 = fused4.prefix_h0(M, m, b)
    sub = ps.subst_reference(h0, u, ph, w, y, d)
    runs = {
        "elements": (("A", "J", "C"), ps.elements_cuda(u, v, ph, a), elems),
        "factor": (("d", "w", "M", "m"), ps.factor_cuda(sh0, u, v, ph, a, y),
                   fac),
        "subst": (("quad", "logdet", "mind"),
                  ps.subst_cuda(h0, u, ph, w, y, d), sub),
    }
    out = {}
    for name, (names, got, want) in runs.items():
        errs = {n: _errors(g, x) for n, g, x in zip(names, got, want)}
        out[name] = {"max_abs_err": max(e[0] for e in errs.values()),
                     "max_rel_err": max(e[1] for e in errs.values()),
                     "outputs": {n: e[1] for n, e in errs.items()}}
    return out


def _compare(runs):
    out = {}
    for name, (names, got, want) in runs.items():
        errs = {n: _errors(g, x) for n, g, x in zip(names, got, want)}
        out[name] = {"max_abs_err": max(e[0] for e in errs.values()),
                     "max_rel_err": max(e[1] for e in errs.values()),
                     "outputs": {n: e[1] for n, e in errs.items()}}
    return out


def onepass_cotangents(u, seed=0):
    """Float64 cotangents of the one-pass sweep's seven differentiable
    outputs (C, M0, m0, Qm, qv, q0, ld0) for streams shaped like ``u``,
    from a seeded generator on ``u``'s device."""
    p, b = u.shape[1:]
    gen = torch.Generator(device=u.device).manual_seed(seed)
    return [torch.randn(s, generator=gen, dtype=torch.float64,
                        device=u.device)
            for s in ((p, p, b), (p, p, b), (p, b), (p, p, b), (p, b), (b,),
                      (b,))]


def onepass_plain_outputs(u, v, ph, a, y, cots):
    """The plain versions of rows 19-21 on the same streams: ``{kernel:
    outputs}``; row 21 takes row 20's saves and ``cots``."""
    from .ops import onepass

    fwd = onepass.sweep_fwd_reference(u, v, ph, a, y)
    return {"sweep": fwd[:8], "sweep_fwd": fwd,
            "sweep_bwd": onepass.sweep_bwd_reference(u, v, ph, a, y, fwd[8],
                                                     *cots)}


ONEPASS_OUTPUTS = {
    "sweep": ("C", "M0", "m0", "Qm", "qv", "q0", "ld0", "mind0"),
    "sweep_fwd": ("C", "M0", "m0", "Qm", "qv", "q0", "ld0", "mind0",
                  "saves"),
    "sweep_bwd": ("hu", "hv", "hph", "ha", "hy"),
}


def compare_onepass_kernels(u, v, ph, a, y):
    """The three one-pass kernels against their plain versions on the same
    streams (on the card; the plain versions run there too): the bwd
    kernel takes the plain fwd saves and float64 cotangents from a seeded
    generator.  Every output is compared against its largest reference
    value.  Returns ``{kernel: {"max_abs_err", "max_rel_err", "outputs":
    {name: rel}}}``."""
    from .ops import onepass

    cots = onepass_cotangents(u)
    want = onepass_plain_outputs(u, v, ph, a, y, cots)
    got = {"sweep": onepass.sweep_cuda(u, v, ph, a, y),
           "sweep_fwd": onepass.sweep_fwd_cuda(u, v, ph, a, y),
           "sweep_bwd": onepass.sweep_bwd_cuda(
               u, v, ph, a, y, want["sweep_fwd"][8], *cots)}
    return _compare({k: (ONEPASS_OUTPUTS[k], got[k], want[k]) for k in got})


def onepass_f32_floor(streams64):
    """Each one-pass kernel's plain version in float32 against float64 on
    the same float64-lowered streams, the largest distance of its outputs
    relative to each output's largest float64 value (the saves left out):
    the rounding floor under a float32 kernel-vs-plain reading."""
    cots = onepass_cotangents(streams64[0])
    want = onepass_plain_outputs(*streams64, cots)
    got = onepass_plain_outputs(*(x.float() for x in streams64), cots)
    return {k: max(_errors(g, w)[1] for g, w in zip(got[k][:8], want[k]))
            for k in want}


def compare_fused_kernel(u, v, ph, a, y, seg=None):
    """The single-sweep kernel against its plain version on the same
    streams (on the card; the plain version runs there too), per segment
    of ``seg`` lanes: ``quad``, ``ld`` and ``mind``, each against its
    largest reference value.  Returns ``{"fused": {"max_abs_err",
    "max_rel_err", "outputs": {name: rel}}}``."""
    from .ops import fused

    return _compare({"fused": (("quad", "ld", "mind"),
                               fused.kernel_cuda(u, v, ph, a, y, seg),
                               fused.kernel_reference(u, v, ph, a, y, seg))})


def compare_tangent_kernels(streams, tangents, seg=None,
                            kernels=("elements_jvp", "factor_jvp", "jac")):
    """The tangent kernels named in ``kernels`` against their plain versions
    on the same streams and tangents (on the card; the plain versions run
    there too).  The factor kernel takes the seeds and their tangents that
    ``dsfused.prefix_sh0_ds`` makes from the plain elements; ``jac`` runs
    over segments of ``seg`` lanes.  Every output is compared against its
    largest reference value.  Returns ``{kernel: {"max_abs_err",
    "max_rel_err", "outputs": {name: rel}}}``."""
    from .ops import dsfused, tangent

    u, v, ph, a, y = streams
    du, dv, dph, da, dy = tangents
    b = u.shape[-1]
    runs = {}
    if {"elements_jvp", "factor_jvp"} & set(kernels):
        el = tangent.elements_jvp_reference(u, v, ph, a, du, dv, dph, da)
    if "elements_jvp" in kernels:
        runs["elements_jvp"] = (
            ("A", "J", "C", "DA", "DJ", "DC"),
            tangent.elements_jvp_cuda(u, v, ph, a, du, dv, dph, da), el)
    if "factor_jvp" in kernels:
        sh = dsfused.prefix_sh0_ds(*(torch.cat([x[None], dx])
                                     for x, dx in zip(el[:3], el[3:])),
                                   seg or b)
        args = (sh[0], sh[1:], u, v, ph, a, y, du, dv, dph, da, dy)
        runs["factor_jvp"] = (
            ("M", "m", "Qm", "qv", "q0", "ld", "mind", "DM", "Dm", "DQm",
             "Dqv", "Dq0", "Dld"),
            tangent.factor_jvp_cuda(*args),
            tangent.factor_jvp_reference(*args))
    if "jac" in kernels:
        args = (u, v, ph, a, y, du, dv, dph, da, dy)
        runs["jac"] = (("quad", "ld", "mind", "dquad", "dld"),
                       tangent.jac_cuda(*args, seg=seg),
                       tangent.jac_reference(*args, seg=seg))
    return _compare(runs)
