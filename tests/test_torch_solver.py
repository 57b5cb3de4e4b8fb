"""The port's CholeskySolver against the JAX package's.

``celerite_torch.solver.CholeskySolver(method, device="cpu")`` and
``celerite_tpu.solver.CholeskySolver(method)`` on the same model (padded
width 5) and data, for methods "scan", "blocked", "native" and "auto" at
N = 300 and 5000: ``log_determinant``, ``solve`` with 1 and 7 right-hand
sides, ``dot_solve``, ``dot_L``, ``dot`` and ``predict``, each within 1e-10
of the JAX package's value relative to its largest entry (both compute in
float64; the routes agree to ~1e-14).  A kernel that is not positive
definite raises LinAlgError with the JAX package's message; a computed
solver survives a pickle round trip.
"""

import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celerite_tpu import solver as jsolver
from celerite_tpu import terms as jterms
from celerite_torch import native, solver
from celerite_torch.testing import make_data, width_kernel

TOL = 1e-10


def _args(kernel):
    th = jnp.asarray(kernel.get_parameter_vector())
    cs = [np.asarray(c) for c in kernel.get_padded_coefficients(th)]
    return float(kernel.get_jitter(th)), cs


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


@pytest.mark.parametrize("n", [300, 5000])
@pytest.mark.parametrize("method", ["scan", "blocked", "native", "auto"])
def test_solver_matches_jax(method, n):
    if method == "native" and not native.available():
        pytest.skip("needs g++ for the native core")
    jitter, cs = _args(width_kernel(jterms, 5))
    t, y, yerr = make_data(n, seed=2, t_max=n / 10.0)
    rng = np.random.default_rng(4)
    Y = rng.standard_normal((n, 7))
    x = np.sort(rng.uniform(-1.0, n / 10.0 + 1.0, 50))
    js, ts = jsolver.CholeskySolver(method), solver.CholeskySolver(
        method, device="cpu")
    for s in (js, ts):
        s.compute(jitter, *cs, t=t, diag=yerr**2)
    want_route = {"auto": "native" if n < 4096 else "scan"}.get(method,
                                                                 method)
    if want_route == "native" and not native.available():
        want_route = "scan"
    assert ts._route == want_route
    np.testing.assert_allclose(ts.log_determinant(), js.log_determinant(),
                               rtol=TOL)
    _close(ts.solve(y), js.solve(y))
    _close(ts.solve(Y), js.solve(Y))
    np.testing.assert_allclose(ts.dot_solve(y), js.dot_solve(y), rtol=TOL)
    _close(ts.dot_L(Y[:, :3]), js.dot_L(Y[:, :3]))
    _close(ts.dot(jitter, *cs, None, None, None, t, Y[:, :2]),
           js.dot(jitter, *cs, None, None, None, t, Y[:, :2]))
    _close(ts.predict(y, x), js.predict(y, x))


def test_non_pd_raises_and_pickles():
    """The non-PD fixture of tests/test_torch_gp.py raises LinAlgError in
    both packages, at every method; a computed solver pickles."""
    bad = jterms.ComplexTerm(log_a=0.0, log_b=1.0, log_c=-1.0, log_d=0.5,
                             quiet=True)
    jitter, cs = float(bad.jitter), [np.asarray(c) for c in bad.coefficients]
    t, y, yerr = make_data(200, seed=2)
    methods = ["scan", "blocked", "auto"] + (["native"] if native.available()
                                             else [])
    for method in methods:
        with pytest.raises(solver.LinAlgError) as err:
            solver.CholeskySolver(method, device="cpu").compute(
                jitter, *cs, t=t, diag=np.full(200, 1e-6))
        with pytest.raises(jsolver.LinAlgError) as jerr:
            jsolver.CholeskySolver(method).compute(
                jitter, *cs, t=t, diag=np.full(200, 1e-6))
        assert str(err.value) == str(jerr.value)

    jitter, cs = _args(width_kernel(jterms, 5))
    for method in methods:
        s = solver.CholeskySolver(method, device="cpu")
        s.compute(jitter, *cs, t=t, diag=yerr**2)
        s2 = pickle.loads(pickle.dumps(s))
        assert s2.computed() and s2._route == s._route
        assert s2.log_determinant() == s.log_determinant()
        np.testing.assert_array_equal(s2.solve(y), s.solve(y))
    empty = pickle.loads(pickle.dumps(solver.CholeskySolver("scan",
                                                            device="cpu")))
    assert not empty.computed()
    with pytest.raises(RuntimeError):
        empty.solve(y)


def test_free_functions_and_grad_match_jax():
    """``get_kernel_value``, ``get_psd_value``, ``check_coefficients`` and
    ``grad_log_likelihood`` against the JAX package's."""
    jitter, cs = _args(width_kernel(jterms, 5))
    tau = np.linspace(-3.0, 3.0, 11)
    _close(solver.get_kernel_value(*cs, tau), jsolver.get_kernel_value(*cs,
                                                                       tau))
    _close(solver.get_psd_value(*cs, tau), jsolver.get_psd_value(*cs, tau))
    assert solver.check_coefficients(*cs) == jsolver.check_coefficients(*cs)
    assert solver.has_autodiff() and solver.get_library_version()
    t, y, yerr = make_data(200, seed=3)
    args = (jitter, *cs, None, None, None, t, y, yerr**2)
    ll, g = solver.CholeskySolver(device="cpu").grad_log_likelihood(*args)
    ll_j, g_j = jsolver.CholeskySolver().grad_log_likelihood(*args)
    np.testing.assert_allclose(ll, ll_j, rtol=TOL)
    _close(g, g_j)


def test_general_blocks_and_no_cuda_raise():
    """A 50-point factor with general (A, U, V) blocks matches the dense K
    (``tril(U^T V, -1) + triu(V^T U, 1) + diag(A)`` on the kernel's);
    without ``device="cpu"`` the solver raises when CUDA is missing."""
    jitter, cs = _args(width_kernel(jterms, 5))
    t, y, yerr = make_data(50)
    rng = np.random.default_rng(6)
    U = 0.1 * np.vander(t / t.max(), 2).T
    V = 0.5 * U + 0.01 * rng.standard_normal(U.shape)
    A = np.sum(U * V, axis=0) + 0.3
    tau = np.abs(t[:, None] - t[None, :])
    K = np.asarray(jsolver.get_kernel_value(*cs, tau)) + np.diag(
        yerr**2 + jitter)
    low = U.T @ V
    K = K + np.tril(low, -1) + np.triu(low.T, 1) + np.diag(A)
    s = solver.CholeskySolver(device="cpu")
    s.compute(jitter, *cs, A=A, U=U, V=V, t=t, diag=yerr**2)
    _close(s.log_determinant(), np.linalg.slogdet(K)[1])
    _close(s.solve(y).reshape(-1), np.linalg.solve(K, y))
    _close(s.dot_L(y).reshape(-1), np.linalg.cholesky(K) @ y)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        solver.CholeskySolver().compute(jitter, *cs, t=t, diag=yerr**2)
