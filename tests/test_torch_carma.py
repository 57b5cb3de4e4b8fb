"""The port's CARMA solver against the JAX package's (CPU, float64).

``celerite_torch.CARMASolver(..., device="cpu")`` and
``celerite_tpu.ops.carma.CARMASolver`` on the same parameters and data,
made from a seed with numpy, at p = 1-4 and q < p: the log-likelihood
against both of JAX's filters (the complex scan and the TPU's real /
imaginary split, jitted), the spectrum, the autocovariance and the
celerite coefficients within 1e-10; the converted kernel's
log-likelihood through the port's ``CholeskySolver`` (1e-8, the JAX
suite's bar); ``quiet=True`` on the p = 256 filter whose predictive
variance goes negative, as JAX's; the q >= p error; the re-exports.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from benchmarks.carma import make_problem
from celerite_tpu.ops import carma as jcarma
import celerite_torch
from celerite_torch.ops.carma import CARMASolver

TOL = 1e-10


def _data(n=100, seed=42):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10, n))
    yerr = rng.uniform(0.1, 0.2, n)
    y = np.sin(t) + yerr * rng.standard_normal(n)
    return t, yerr, y


CASES = {
    "car1": (0.1, [0.1], []),
    "car2": (0.1, [1.0, 0.5], []),
    "carma21": (0.0, [1.0, 0.5], [0.1]),
    "carma31": (0.1, [1.3, 0.4, 0.1], [0.5]),
    "carma42": (0.1, [np.log(4.0), np.log(0.5), np.log(1.5), np.log(0.8)],
                [np.log(1.0), np.log(0.9)]),
}


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * max(float(np.abs(want).max()),
                                              1e-300))


@pytest.mark.parametrize("case", list(CASES))
def test_carma_matches_jax(case):
    log_sigma, ar, ma = CASES[case]
    t, yerr, y = _data()
    js = jcarma.CARMASolver(log_sigma, ar, ma)
    ts = CARMASolver(log_sigma, ar, ma, device="cpu")
    ll = ts.log_likelihood(t, y, yerr)
    args = js._scan_args(t, y, yerr)
    ll_c, ok_c = jcarma._kalman_ll(jnp.asarray(js.b), jnp.asarray(js.V),
                                   jnp.asarray(js.arroots), *args)
    ll_r, ok_r = jcarma._kalman_ll_real(
        jnp.asarray(js.b.real), jnp.asarray(js.b.imag),
        jnp.asarray(js.V.real), jnp.asarray(js.V.imag),
        jnp.asarray(js.arroots.real), jnp.asarray(js.arroots.imag), *args)
    assert bool(ok_c) and bool(ok_r)
    _close(ll, float(ll_c))
    _close(ll, float(ll_r))
    f = np.linspace(0, 5, 200)
    _close(ts.psd(f), js.psd(f))
    tau = np.linspace(0, 5, 40)
    _close(ts.covariance(tau), js.covariance(tau))
    for got, want in zip(ts.get_celerite_coeffs(), js.get_celerite_coeffs()):
        assert got.shape == want.shape
        if want.size:
            _close(got, want)


@pytest.mark.parametrize("case", ["carma21", "carma31"])
def test_converted_kernel_loglike(case):
    """The Kalman ll equals the semiseparable ll after conversion."""
    log_sigma, ar, ma = CASES[case]
    t, yerr, y = _data()
    ts = CARMASolver(log_sigma, ar, ma, device="cpu")
    chol = celerite_torch.CholeskySolver(device="cpu")
    chol.compute(0.0, *ts.get_celerite_coeffs(), t=t, diag=yerr**2)
    ll_chol = -0.5 * (chol.dot_solve(y) + chol.log_determinant()
                      + len(t) * np.log(2 * np.pi))
    np.testing.assert_allclose(ll_chol, ts.log_likelihood(t, y, yerr),
                               rtol=1e-8)


def test_quiet_negative_variance():
    """At p = 256 the diagonalized filter's predictive variance goes
    negative: ``quiet=True`` gives ``ok=False`` where JAX's does, and
    without it the filter raises."""
    ls, ar, ma, t, y, yerr = make_problem(256, 256)
    _, ok_jax = jcarma.CARMASolver(ls, ar, ma).log_likelihood(
        t, y, yerr, quiet=True)
    s = CARMASolver(ls, ar, ma, device="cpu")
    _, ok = s.log_likelihood(t, y, yerr, quiet=True)
    assert ok == bool(ok_jax) is False
    with pytest.raises(RuntimeError):
        s.log_likelihood(t, y, yerr)


def test_errors_and_exports():
    with pytest.raises(ValueError):
        CARMASolver(0.0, [0.1], [0.1], device="cpu")
    s = CARMASolver(0.1, [0.1], [], device="cpu")
    t, yerr, y = _data(10)
    with pytest.raises(ValueError):
        s.log_likelihood(t, y[:5], yerr)
    assert celerite_torch.solver.CARMASolver is CARMASolver
    assert celerite_torch.CARMASolver is CARMASolver
