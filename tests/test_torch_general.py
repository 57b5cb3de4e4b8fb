"""General (A, U, V) semiseparable blocks in the port, against the JAX
package and the dense oracle.

General blocks lower to phi = 1 columns after the complex pairs, with ``A``
on the diagonal (celerite_tpu/ops/lower.py:133-137), so every solver of the
port takes them as any other column.  On the CPU:

- ``lower`` against JAX's jitted ``lower`` (float64, equal but for the
  ulps of the kernel's cos / sin; the general columns exactly), the
  float32 options leaving the general columns alone and their tangents
  zero; ``build_matrix`` against JAX's;
- ``CholeskySolver`` at ``"scan"``, ``"blocked"`` and ``"native"``:
  ``log_determinant``, ``solve``, ``dot_solve``, ``dot_L`` and ``dot``
  against the dense K (tests/test_solver.py's ``general`` cases), its shape
  checks and a pickle round trip;
- the GP: ``log_likelihood``, ``get_matrix`` and ``predict`` (mean,
  ``return_var``, ``return_cov``) against JAX's GP on the same model
  (tests/test_gp.py:183-200, :325-345), and ``dot`` at the computed
  coordinates with the stored blocks;
- ``build_loglik`` at N = 4096 for every solver against the dense oracle
  (the kernels' plain versions run here), ``"fused"`` not the kernel-only
  value, and exact mode on its float64 route; the gradients at N = 1024 against autograd through the dense
  oracle, ``fast_grad=True`` and ``"tangent"`` against the plain one
  (tests/test_general_fast.py:128-188); padded width 18, where the kernel
  routes raise; ``sample_nuts`` on a general model.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_tpu.ops import dense as jdense, lower as jlower
import celerite_torch
from celerite_torch import inference, native, solver, terms as tterms
from celerite_torch.ops import dense as tdense, lanes, lower as tlower


def make_kernel(terms):
    return (terms.RealTerm(log_a=0.1, log_c=0.5)
            + terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3))


def make_data(n, seed=42):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 40, n))
    yerr = rng.uniform(0.1, 0.2, n)
    y = np.sin(t) + yerr * rng.standard_normal(n)
    return t, yerr, y


def make_general(t, seed=3, rank=3):
    """Vandermonde general blocks (tests/test_general_fast.py:38-45)."""
    rng = np.random.default_rng(seed)
    U = np.vander((t - t.min()) / (t.max() - t.min()), rank).T * 0.1
    V = 0.5 * U + 0.01 * rng.standard_normal(U.shape)
    A = np.sum(U * V, axis=0) + 0.3
    return A, U, V


def _jax_coeffs(kernel):
    th = jnp.asarray(kernel.get_parameter_vector())
    return jlower.Coefficients(*kernel.get_padded_coefficients(th),
                               jitter=kernel.get_jitter(th))


def _torch_coeffs(kernel, th=None):
    th = torch.as_tensor(kernel.get_parameter_vector()) if th is None else th
    return tlower.Coefficients(*kernel.get_padded_coefficients(th),
                               jitter=kernel.get_jitter(th))


def _dense_ll(K, y):
    _, logdet = np.linalg.slogdet(K)
    return -0.5 * (y @ np.linalg.solve(K, y) + logdet
                   + len(y) * np.log(2 * np.pi))


def _jax_dense(t, yerr, general):
    A, U, V = general
    return np.asarray(jdense.build_matrix(
        _jax_coeffs(make_kernel(jterms)), jnp.asarray(t), diag=yerr**2,
        A_gen=jnp.asarray(A), U_gen=jnp.asarray(U), V_gen=jnp.asarray(V)))


@pytest.mark.parametrize("rank", [1, 3])
def test_lower_matches_jax(rank):
    t, yerr, _ = make_data(200)
    A, U, V = make_general(t, rank=rank)
    sj = jax.jit(jlower.lower)(
        _jax_coeffs(make_kernel(jterms)), jnp.asarray(t),
        jnp.asarray(yerr**2), A_gen=jnp.asarray(A), U_gen=jnp.asarray(U),
        V_gen=jnp.asarray(V))
    kern = make_kernel(tterms)
    st = tlower.lower(_torch_coeffs(kern), torch.as_tensor(t),
                      torch.as_tensor(yerr**2), A_gen=torch.as_tensor(A),
                      U_gen=torch.as_tensor(U), V_gen=torch.as_tensor(V))
    p0 = sum(np.multiply(kern.padded_size, (1, 2)))
    assert st.U.shape == (200, p0 + rank)
    for a, b in zip(sj, st):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-14,
                                   atol=1e-15)
    # The general columns, their phi and A exactly.
    for a, b in zip(sj[:3], st[:3]):
        np.testing.assert_array_equal(b.numpy()[:, p0:], np.asarray(a)[:, p0:])
    np.testing.assert_array_equal(st.phi.numpy()[:, p0:], 1.0)
    np.testing.assert_array_equal(st.A.numpy(), np.asarray(sj.A))

    # The float32 grid options leave the general columns alone.
    t32 = torch.as_tensor(t, dtype=torch.float32)
    s32 = tlower.lower(
        _torch_coeffs(kern), t32, torch.as_tensor(yerr**2, dtype=torch.float32),
        dt=torch.as_tensor(np.concatenate([[0.0], np.diff(t)]),
                           dtype=torch.float32),
        t_lo=torch.as_tensor(t - t.astype(np.float32), dtype=torch.float32),
        A_gen=torch.as_tensor(A), U_gen=torch.as_tensor(U),
        V_gen=torch.as_tensor(V))
    assert s32.U.dtype == torch.float32
    np.testing.assert_array_equal(s32.U.numpy()[:, p0:],
                                  U.T.astype(np.float32))
    np.testing.assert_array_equal(s32.V.numpy()[:, p0:],
                                  V.T.astype(np.float32))

    # Tangents along the parameters are zero on the general columns.
    def ssm_of(th):
        return tuple(tlower.lower(
            _torch_coeffs(kern, th), torch.as_tensor(t),
            torch.as_tensor(yerr**2), A_gen=torch.as_tensor(A),
            U_gen=torch.as_tensor(U), V_gen=torch.as_tensor(V)))

    th = torch.as_tensor(kern.get_parameter_vector())
    _, (dU, dV, dphi, _) = lanes.basis_jvp(ssm_of, th)
    assert dU.shape == (len(th), 200, p0 + rank)
    for d in (dU, dV, dphi):
        assert float(d[..., p0:].abs().max()) == 0.0
        assert float(d[..., :p0].abs().max()) > 0.0


def test_build_matrix_matches_jax():
    t, yerr, _ = make_data(120)
    general = make_general(t)
    got = tdense.build_matrix(
        _torch_coeffs(make_kernel(tterms)), torch.as_tensor(t),
        diag=torch.as_tensor(yerr**2),
        **dict(zip(("A_gen", "U_gen", "V_gen"), map(torch.as_tensor,
                                                    general))))
    np.testing.assert_allclose(got.numpy(), _jax_dense(t, yerr, general),
                               rtol=1e-13, atol=1e-15)
    # The rectangular case takes kernel values only.
    t2 = np.linspace(0.0, 40.0, 17)
    np.testing.assert_allclose(
        tdense.build_matrix(_torch_coeffs(make_kernel(tterms)),
                            torch.as_tensor(t), t2=torch.as_tensor(t2),
                            A_gen=torch.as_tensor(general[0])).numpy(),
        np.asarray(jdense.build_matrix(_jax_coeffs(make_kernel(jterms)),
                                       jnp.asarray(t), t2=jnp.asarray(t2))),
        rtol=1e-13, atol=1e-15)


def _solver_args():
    kern = make_kernel(tterms)
    th = torch.as_tensor(kern.get_parameter_vector())
    cs = [c.numpy() for c in kern.get_padded_coefficients(th)]
    return float(kern.get_jitter(th)), cs


@pytest.mark.parametrize("method", ["scan", "blocked", "native"])
def test_solver_general_matches_dense(method):
    if method == "native" and not native.available():
        pytest.skip("needs g++ for the native core")
    n = 300
    t, yerr, y = make_data(n)
    A, U, V = make_general(t)
    K = _jax_dense(t, yerr, (A, U, V))
    jitter, cs = _solver_args()
    s = solver.CholeskySolver(method, device="cpu")
    s.compute(jitter, *cs, A=A, U=U, V=V, t=t, diag=yerr**2)
    p0 = sum(np.multiply(make_kernel(tterms).padded_size, (1, 2)))
    assert s._route == method and s._ssm.U.shape[1] == p0 + 3
    _, logdet = np.linalg.slogdet(K)
    np.testing.assert_allclose(s.log_determinant(), logdet, rtol=1e-10)
    B = np.stack([y, np.cos(t), t / 10], axis=1)
    np.testing.assert_allclose(s.solve(B), np.linalg.solve(K, B), rtol=1e-8,
                               atol=1e-10)
    np.testing.assert_allclose(s.dot_solve(y), y @ np.linalg.solve(K, y),
                               rtol=1e-10)
    z = np.random.default_rng(1).standard_normal((n, 2))
    np.testing.assert_allclose(s.dot_L(z), np.linalg.cholesky(K) @ z,
                               rtol=1e-8, atol=1e-10)
    # K z without the yerr diagonal.
    K0 = K - np.diag(yerr**2)
    np.testing.assert_allclose(
        s.dot(jitter, *cs, A, U, V, t, z), K0 @ z, rtol=1e-10,
        atol=1e-12 * np.abs(K0 @ z).max())
    ll, grad = s.grad_log_likelihood(jitter, *cs, A, U, V, t, y, yerr**2)
    np.testing.assert_allclose(ll, _dense_ll(K, y), rtol=1e-10)
    assert np.all(np.isfinite(grad))
    # A pickled general factor round-trips.
    s2 = pickle.loads(pickle.dumps(s))
    assert s2.computed() and s2._route == s._route
    assert s2.log_determinant() == s.log_determinant()
    np.testing.assert_array_equal(s2.solve(y), s.solve(y))
    np.testing.assert_array_equal(s2.dot_L(z), s.dot_L(z))


def test_shape_checks_raise():
    n = 50
    t, yerr, _ = make_data(n)
    A, U, V = make_general(t, rank=2)
    jitter, cs = _solver_args()
    s = solver.CholeskySolver(device="cpu")
    bad = [dict(A=A[:-1], U=U, V=V), dict(A=A, U=U[:, :-1], V=V),
           dict(A=A, U=U, V=V[:, :-1]), dict(A=A, U=U, V=V[:1])]
    for kw in bad:
        with pytest.raises(ValueError, match="dimension mismatch"):
            s.compute(jitter, *cs, t=t, diag=yerr**2, **kw)
        with pytest.raises(ValueError, match="dimension mismatch"):
            celerite_torch.GP(make_kernel(tterms), device="cpu").compute(
                t, yerr, **kw)
        with pytest.raises(ValueError, match="dimension mismatch"):
            jsolve = celerite_tpu.solver.CholeskySolver()
            jsolve.compute(jitter, *cs, t=t, diag=yerr**2, **kw)


def test_gp_general_matches_jax():
    n = 60
    t, yerr, y = make_data(n)
    scale = 0.1
    U = np.vander((t - t.min()) / (t.max() - t.min()), 2).T * scale
    V = 0.5 * U
    A = np.sum(U * V, axis=0)
    jgp = celerite_tpu.GP(jterms.RealTerm(log_a=0.1, log_c=0.5), mean=0.2)
    tgp = celerite_torch.GP(tterms.RealTerm(log_a=0.1, log_c=0.5), mean=0.2,
                            device="cpu")
    for g in (jgp, tgp):
        g.compute(t, yerr, A=A, U=U, V=V)
    np.testing.assert_allclose(tgp.log_likelihood(y), jgp.log_likelihood(y),
                               rtol=1e-10)
    K = tgp.get_matrix(include_diagonal=True, include_general=True)
    np.testing.assert_allclose(
        K, jgp.get_matrix(include_diagonal=True, include_general=True),
        rtol=1e-13, atol=1e-15)
    np.testing.assert_allclose(tgp.log_likelihood(y), _dense_ll(K, y - 0.2),
                               rtol=1e-9)
    for kw in (dict(include_general=False), dict(include_diagonal=False)):
        np.testing.assert_allclose(tgp.get_matrix(**kw), jgp.get_matrix(**kw),
                                   rtol=1e-13, atol=1e-15)
    # dot at the computed coordinates takes the stored blocks.
    z = np.random.default_rng(5).standard_normal(n)
    np.testing.assert_allclose(tgp.dot(z), jgp.dot(z), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(tgp.dot(z), (K - np.diag(yerr**2)) @ z,
                               rtol=1e-10, atol=1e-12)
    x = np.linspace(-1.0, 41.0, 25)
    for xs in (None, x):
        mu, cov = tgp.predict(y, xs)
        mu_j, cov_j = jgp.predict(y, xs)
        np.testing.assert_allclose(mu, mu_j, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(cov, cov_j, rtol=1e-9, atol=1e-12)
        mu, var = tgp.predict(y, xs, return_var=True)
        mu_j, var_j = jgp.predict(y, xs, return_var=True)
        np.testing.assert_allclose(mu, mu_j, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(var, var_j, rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(
            tgp.predict(y, xs, return_cov=False),
            jgp.predict(y, xs, return_cov=False), rtol=1e-9, atol=1e-12)
    # The mean at new points is K(x, t) K^-1 r, not the kernel's lag-state
    # recursion.
    np.testing.assert_allclose(
        tgp.predict(y, x, return_cov=False),
        0.2 + tgp.get_matrix(x, t) @ np.linalg.solve(K, y - 0.2),
        rtol=1e-9, atol=1e-12)
    s = tgp.sample(size=3, seed=4)
    assert s.shape == (3, n) and np.all(np.isfinite(s))
    np.testing.assert_allclose(s, jgp.sample(size=3, seed=4), rtol=1e-9,
                               atol=1e-12)


@pytest.fixture(scope="module")
def problem4096():
    t, yerr, y = make_data(4096)
    general = make_general(t)
    return t, yerr, y, general, _dense_ll(_jax_dense(t, yerr, general), y)


@pytest.mark.parametrize("solver_name", ["auto", "seq", "blocked", "fused",
                                         "pallas"])
def test_build_loglik_general_routes(solver_name, problem4096):
    t, yerr, y, (A, U, V), want = problem4096
    gp = celerite_torch.GP(make_kernel(tterms), device="cpu")
    gp.compute(t, yerr, A=A, U=U, V=V)
    fn = gp.build_loglik(t, y, yerr=yerr, solver=solver_name)
    assert fn.route == {"auto": "blocked"}.get(solver_name, solver_name)
    assert not hasattr(fn, "value_ok_grad")
    ll, ok = fn(torch.as_tensor(gp.get_parameter_vector()))
    assert bool(ok)
    np.testing.assert_allclose(float(ll), want, rtol=1e-9)
    if solver_name == "fused":
        # Not the kernel-only likelihood a lane route would give.
        kernel_only = celerite_torch.GP(make_kernel(tterms), device="cpu")
        kernel_only.compute(t, yerr)
        assert abs(kernel_only.log_likelihood(y) - want) > 1.0


def test_exact_mode_general_takes_float64_route(problem4096):
    """``precision="ds"`` with general blocks: the dsfused gate excludes
    them (celerite_tpu/gp.py:421), so the float64 route runs, on the
    dense oracle's ll."""
    t, yerr, y, (A, U, V), want = problem4096
    gp = celerite_torch.GP(make_kernel(tterms), device="cpu")
    gp.compute(t, yerr, A=A, U=U, V=V)
    fn = gp.build_loglik(t, y, yerr=yerr, precision="ds",
                         dtype=torch.float32)
    assert fn.route == "blocked"
    ll, ok = fn(torch.as_tensor(gp.get_parameter_vector()))
    assert bool(ok) and ll.dtype == torch.float64
    np.testing.assert_allclose(float(ll), want, rtol=1e-9)


def _dense_ll_torch(kernel, t, yerr, y, general):
    """theta -> the dense oracle's ll, differentiable by torch autograd."""
    gen = dict(zip(("A_gen", "U_gen", "V_gen"), map(torch.as_tensor,
                                                   general)))

    def ll(th):
        K = tdense.build_matrix(_torch_coeffs(kernel, th), torch.as_tensor(t),
                                diag=torch.as_tensor(yerr**2), **gen)
        L = torch.linalg.cholesky(K)
        z = torch.linalg.solve_triangular(L, torch.as_tensor(y)[:, None],
                                          upper=False)[:, 0]
        return -0.5 * (z @ z + 2 * torch.log(torch.diagonal(L)).sum()
                       + len(t) * np.log(2 * np.pi))

    return ll


@pytest.fixture(scope="module")
def problem1024():
    t, yerr, y = make_data(1024)
    general = make_general(t)
    gp = celerite_torch.GP(make_kernel(tterms), device="cpu")
    gp.compute(t, yerr, A=general[0], U=general[1], V=general[2])
    theta = torch.as_tensor(gp.get_parameter_vector())
    th = theta.clone().requires_grad_()
    ll = _dense_ll_torch(gp.kernel, t, yerr, y, general)(th)
    (grad,) = torch.autograd.grad(ll, th)
    plain = gp.build_loglik(t, y, yerr=yerr, solver="blocked")
    th = theta.clone().requires_grad_()
    ll_p, _ = plain(th)
    (grad_p,) = torch.autograd.grad(ll_p, th)
    return gp, t, y, yerr, theta, (float(ll), grad), (float(ll_p), grad_p)


def test_general_gradient_matches_dense_autograd(problem1024):
    *_, (ll_d, g_d), (ll_p, g_p) = problem1024
    np.testing.assert_allclose(ll_p, ll_d, rtol=1e-9)
    np.testing.assert_allclose(g_p.numpy(), g_d.numpy(), rtol=1e-6,
                               atol=1e-8)


@pytest.mark.parametrize("solver_name,fast_grad", [
    ("blocked", True), ("blocked", "tangent"), ("pallas", True),
    ("pallas", "tangent"), ("fused", False), ("fused", True),
    ("fused", "tangent")])
def test_general_fast_grad_matches_plain(solver_name, fast_grad, problem1024):
    gp, t, y, yerr, theta, _, (ll_p, g_p) = problem1024
    fn = gp.build_loglik(t, y, yerr=yerr, solver=solver_name,
                         fast_grad=fast_grad)
    assert fn.route == solver_name
    th = theta.clone().requires_grad_()
    ll, ok = fn(th)
    (grad,) = torch.autograd.grad(ll, th)
    assert bool(ok)
    np.testing.assert_allclose(float(ll), ll_p, rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), g_p.numpy(), rtol=1e-6,
                               atol=1e-9)


def test_general_above_width_16():
    """Kernel width 3 plus general rank 15: P = 18.  The kernel routes
    raise naming queue 2 item 10; "auto" runs and matches the dense
    oracle."""
    n = 256
    t, yerr, y = make_data(n)
    general = make_general(t, rank=15)
    gp = celerite_torch.GP(make_kernel(tterms), device="cpu")
    gp.compute(t, yerr, A=general[0], U=general[1], V=general[2])
    for kw in (dict(solver="fused"), dict(solver="pallas"),
               dict(solver="blocked", fast_grad=True),
               dict(solver="fused", fast_grad="tangent"),
               dict(fast_grad="tangent")):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 2, item 10"):
            gp.build_loglik(t, y, yerr=yerr, **kw)
    want = _dense_ll(_jax_dense(t, yerr, general), y)
    for name in ("auto", "blocked"):
        fn = gp.build_loglik(t, y, yerr=yerr, solver=name)
        ll, ok = fn(torch.as_tensor(gp.get_parameter_vector()))
        assert bool(ok)
        np.testing.assert_allclose(float(ll), want, rtol=1e-9)
    np.testing.assert_allclose(gp.log_likelihood(y), want, rtol=1e-9)


def test_sample_nuts_on_general_model():
    n = 256
    t, yerr, y = make_data(n)
    A, U, V = make_general(t)
    gp = celerite_torch.GP(make_kernel(tterms), device="cpu")
    gp.compute(t, yerr, A=A, U=U, V=V)
    theta = torch.as_tensor(gp.get_parameter_vector())

    def prior(th):
        return -0.5 * torch.sum((th / 3.0) ** 2)

    lp = gp.build_logprob(t, y, yerr=yerr, log_prior=prior)
    assert not hasattr(lp, "value_and_grad")
    init = theta[None] + 0.01 * torch.randn(
        2, theta.shape[0], generator=torch.Generator().manual_seed(1),
        dtype=torch.float64)
    samples, info = inference.sample_nuts(
        lp, init, torch.Generator().manual_seed(2), num_warmup=4,
        num_samples=3, max_tree_depth=3)
    assert samples.shape == (2, 3, theta.shape[0])
    assert bool(torch.isfinite(samples).all())
    assert float(info["accept_prob"].mean()) > 0.0
