"""celerite_torch.GP against celerite_tpu.GP on the same data and parameters.

Golden values (tests/test_golden.py) at 1e-9; ``build_loglik`` and
``build_logprob`` values against the JAX package at N = 300 (both
packages' sequential route) and N = 5000 (the port's plain fused primal,
JAX's CPU blocked route) at 1e-10; the CPU gradient by autograd against
``jax.grad`` at 1e-8.  N = 700 is avoided (an XLA:CPU fault, ROADMAP
queue 3).  Everything runs with ``device="cpu"``.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_torch import GP, LinAlgError, convert, terms as tterms
from celerite_torch.ops import fused
from celerite_torch.testing import (bench_kernel, config2_kernel, make_data,
                                    width_kernel)
from test_golden import GOLDEN

KERNELS = {"bench": bench_kernel, "config2": config2_kernel,
           "wide16": lambda T: width_kernel(T, 16),
           "wide20": lambda T: width_kernel(T, 20)}


def golden_kernel(T, name):
    return {
        "real": lambda: T.RealTerm(log_a=0.1, log_c=0.5),
        "sho_under": lambda: T.SHOTerm(log_S0=0.1, log_Q=1.0,
                                       log_omega0=0.5),
        "sho_over": lambda: T.SHOTerm(log_S0=0.1, log_Q=-1.0,
                                      log_omega0=0.5),
        "mix": lambda: (
            T.RealTerm(log_a=0.1, log_c=0.5)
            + T.ComplexTerm(log_a=0.0, log_b=-0.3, log_c=0.4, log_d=0.2)
            + T.JitterTerm(log_sigma=-1.0)
        ),
        "matern": lambda: T.Matern32Term(log_sigma=0.1, log_rho=0.5),
        "product": lambda: (
            T.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
            * T.RealTerm(log_a=0.1, log_c=0.4)
        ),
    }[name]()


@pytest.mark.parametrize("name", sorted(GOLDEN))
def test_golden_log_likelihood(name):
    rng = np.random.default_rng(2026)
    t = np.sort(rng.uniform(0, 10, 100))
    gp = GP(golden_kernel(tterms, name), device="cpu")
    gp.compute(t, np.full(100, 0.25))
    np.testing.assert_allclose(gp.log_likelihood(np.sin(t)), GOLDEN[name],
                               rtol=1e-9)


def _pair(kname, fit_mean=False, perturb=0.0, seed=0):
    """The same model in both packages, parameters carried across."""
    jgp = celerite_tpu.GP(KERNELS[kname](jterms), mean=0.3, fit_mean=fit_mean)
    if perturb:
        rng = np.random.default_rng(seed)
        v = jgp.get_parameter_vector()
        jgp.set_parameter_vector(v + perturb * rng.standard_normal(v.size))
    tgp = GP(KERNELS[kname](tterms), mean=0.3, fit_mean=fit_mean,
             device="cpu")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask,
    )
    return jgp, tgp


@pytest.mark.parametrize("kname", ["bench", "config2"])
@pytest.mark.parametrize("n", [300, 5000])
def test_build_loglik_matches_jax(kname, n):
    jgp, tgp = _pair(kname, perturb=0.05)
    t, y, yerr = make_data(n, seed=n, t_max=n / 10.0)
    theta = jgp.get_parameter_vector()
    llj, okj = jax.jit(jgp.build_loglik(t, y, yerr=yerr))(jnp.asarray(theta))
    fn = tgp.build_loglik(t, y, yerr=yerr)
    llt, okt = fn(torch.as_tensor(theta))
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(float(llt), float(llj), rtol=1e-10)
    # The route: sequential below 4096 points on the CPU, the plan above.
    assert hasattr(fn, "plan") == (n >= 4096)


@pytest.mark.parametrize("kname", ["bench", "config2"])
def test_build_logprob_matches_jax(kname):
    jgp, tgp = _pair(kname, fit_mean=True)
    t, y, yerr = make_data(300, seed=3, t_max=30.0)
    theta = jgp.get_parameter_vector()
    lpj = jax.jit(jgp.build_logprob(t, y, yerr=yerr))(jnp.asarray(theta))
    lpt = tgp.build_logprob(t, y, yerr=yerr)(torch.as_tensor(theta))
    np.testing.assert_allclose(float(lpt), float(lpj), rtol=1e-10)


@pytest.mark.parametrize("kname,n", [("bench", 300), ("config2", 300),
                                     ("bench", 5000)])
def test_cpu_gradient_matches_jax(kname, n):
    jgp, tgp = _pair(kname, fit_mean=True, perturb=0.05, seed=1)
    t, y, yerr = make_data(n, seed=4, t_max=n / 10.0)
    theta = jgp.get_parameter_vector()
    fj = jgp.build_loglik(t, y, yerr=yerr)
    gj = jax.jit(jax.grad(lambda th: fj(th)[0]))(jnp.asarray(theta))
    th = torch.tensor(theta, requires_grad=True)
    ll, _ = tgp.build_loglik(t, y, yerr=yerr)(th)
    ll.backward()
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gj), rtol=1e-8,
                               atol=1e-8 * float(np.abs(gj).max()))


def test_float32_plan_close_to_float64():
    _, tgp = _pair("config2")
    t, y, yerr = make_data(5000, seed=6, t_max=500.0)
    theta = torch.as_tensor(tgp.get_parameter_vector())
    ll64, _ = tgp.build_loglik(t, y, yerr=yerr)(theta)
    ll32, ok32 = tgp.build_loglik(t, y, yerr=yerr, dtype=torch.float32)(theta)
    assert bool(ok32) and ll32.dtype == torch.float32
    assert abs(float(ll32) - float(ll64)) < 1e-4 * abs(float(ll64))


def test_precision_ds_is_float64():
    _, tgp = _pair("bench")
    t, y, yerr = make_data(5000, seed=6, t_max=500.0)
    fn = tgp.build_loglik(t, y, yerr=yerr, dtype=torch.float32,
                          precision="ds")
    assert fn.plan.t.dtype == torch.float64


def test_unsorted_t_raises():
    gp = GP(tterms.RealTerm(log_a=0.1, log_c=0.5), device="cpu")
    with pytest.raises(ValueError):
        gp.compute([0.0, 2.0, 1.0], 0.1)


def test_log_likelihood_requires_compute():
    gp = GP(tterms.RealTerm(log_a=0.1, log_c=0.5), device="cpu")
    with pytest.raises(RuntimeError):
        gp.log_likelihood(np.zeros(3))


def test_non_pd_quiet_and_raise():
    """A kernel that is not positive definite: ``compute`` lowers, factors
    and raises LinAlgError with the JAX package's message on the same
    input; with ``_t`` and ``_diag`` set by hand (as
    tests/test_gp.py::test_non_pd_quiet does) ``log_likelihood`` gives -inf
    with ``quiet=True`` and raises without."""
    def bad(T):
        return T.ComplexTerm(log_a=0.0, log_b=1.0, log_c=-1.0, log_d=0.5,
                             quiet=True)

    t, y, _ = make_data(200, seed=2)
    gp = GP(bad(tterms), device="cpu")
    with pytest.raises(LinAlgError) as err:
        gp.compute(t, 1e-6)
    with pytest.raises(celerite_tpu.LinAlgError) as jerr:
        celerite_tpu.GP(bad(jterms)).compute(t, 1e-6)
    assert str(err.value) == str(jerr.value)
    gp2 = GP(bad(tterms), device="cpu")
    gp2._t = t
    gp2._diag = np.full_like(t, 1e-12)
    assert gp2.log_likelihood(y, quiet=True) == -np.inf
    with pytest.raises(LinAlgError):
        gp2.log_likelihood(y)


def test_no_cuda_raises_instead_of_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    gp = GP(tterms.RealTerm(log_a=0.1, log_c=0.5))
    t, y, yerr = make_data(50)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp.build_loglik(t, y, yerr=yerr)
    # compute factors on the GP's device.
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp.compute(t, yerr)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gp.log_likelihood(y)


def test_out_of_slice_options_raise():
    gp = GP(bench_kernel(tterms), device="cpu")
    t, y, yerr = make_data(50)
    # General (A, U, V) blocks are ported: the rank-1 block of ones adds
    # the all-ones matrix, and the ll is the dense K's.
    gp.compute(t, yerr, A=np.ones(50), U=np.ones((1, 50)),
               V=np.ones((1, 50)))
    K = gp.get_matrix()
    np.testing.assert_allclose(K - gp.get_matrix(include_general=False),
                               np.ones((50, 50)), atol=1e-14)
    _, logdet = np.linalg.slogdet(K)
    np.testing.assert_allclose(
        gp.log_likelihood(y), -0.5 * (y @ np.linalg.solve(K, y) + logdet
                                      + 50 * np.log(2 * np.pi)),
        rtol=1e-10)
    wide = GP(sum([tterms.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=w)
                   for w in (0.1, 0.5, 0.9, 1.3)], tterms.JitterTerm(-1.0)),
              device="cpu")
    assert sum(np.multiply(wide.kernel.padded_size, (1, 2))) == 16
    # Width 16 builds the adjoint route, whose value closure runs; width
    # 20 has the blocked solver alone: the kernels stop at width 16.
    fn = wide.build_loglik(t, y, yerr=yerr, solver="fused")
    _, ok = fn(torch.as_tensor(wide.get_parameter_vector()))
    assert bool(ok)
    wider = GP(sum([tterms.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=w)
                    for w in (0.1, 0.5, 0.9, 1.3, 1.7)],
                   tterms.JitterTerm(-1.0)), device="cpu")
    for kw in (dict(solver="fused"), dict(solver="pallas"),
               dict(solver="blocked", fast_grad=True)):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 2, item 10"):
            wider.build_loglik(t, y, yerr=yerr, **kw)


def test_load_parameters_checks_names():
    jgp, tgp = _pair("bench")
    with pytest.raises(ValueError):
        convert.load_parameters(tgp, ("kernel:log_a",), [0.0], [True])
    jgp.freeze_parameter("kernel:log_b")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask,
    )
    assert tgp.get_parameter_names() == jgp.get_parameter_names()
    np.testing.assert_array_equal(tgp.get_parameter_vector(),
                                  jgp.get_parameter_vector())


def test_default_box_prior():
    gp = GP(tterms.RealTerm(log_a=0.1, log_c=0.5,
                            bounds={"log_a": (-1.0, 1.0)}), device="cpu")
    t, y, yerr = make_data(100)
    lp = gp.build_logprob(t, y, yerr=yerr)
    inside = float(lp(torch.tensor([0.1, 0.5], dtype=torch.float64)))
    assert math.isfinite(inside)
    assert float(lp(torch.tensor([2.0, 0.5], dtype=torch.float64))) == -math.inf


@pytest.mark.parametrize("kname", ["config2", "wide16"])
@pytest.mark.parametrize("solver", ["pallas", "blocked"])
def test_pallas_and_blocked_closures_match_jax(kname, solver):
    """``solver="pallas"`` (the plain three-pass kernels, L = 256) and
    ``"blocked"`` (L = 62 by the JAX package's rule) at N = 1000 against
    JAX's blocked route at 1e-10, with an active mean."""
    jgp, tgp = _pair(kname, fit_mean=True, perturb=0.02, seed=5)
    t, y, yerr = make_data(1000, seed=8, t_max=100.0)
    theta = jgp.get_parameter_vector()
    llj, okj = jax.jit(jgp.build_loglik(t, y, yerr=yerr, solver="blocked"))(
        jnp.asarray(theta))
    fn = tgp.build_loglik(t, y, yerr=yerr, solver=solver)
    assert fn.route == solver
    llt, okt = fn(torch.as_tensor(theta))
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(float(llt), float(llj), rtol=1e-10)


def test_auto_above_width_16_is_blocked():
    """Padded width 20 (config[2] with four modes) at N = 4096 takes
    ``blocked`` at ``solver="auto"``, as the JAX package's CPU route does:
    the value at 1e-10 and its autograd gradient at 1e-8."""
    jgp, tgp = _pair("wide20", fit_mean=True, perturb=0.02, seed=6)
    assert sum(np.multiply(tgp.kernel.padded_size, (1, 2))) == 20
    t, y, yerr = make_data(4096, seed=9, t_max=400.0)
    theta = jgp.get_parameter_vector()
    fj = jgp.build_loglik(t, y, yerr=yerr)
    llj, gj = jax.jit(jax.value_and_grad(lambda th: fj(th)[0]))(
        jnp.asarray(theta))
    fn = tgp.build_loglik(t, y, yerr=yerr)
    assert fn.route == "blocked"
    th = torch.tensor(theta, requires_grad=True)
    ll, ok = fn(th)
    ll.backward()
    assert bool(ok)
    np.testing.assert_allclose(float(ll.detach()), float(llj), rtol=1e-10)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(gj), rtol=1e-8,
                               atol=1e-8 * float(np.abs(gj).max()))


@pytest.mark.parametrize("p", [2, 8])
def test_run_kernel_raises_at_width_8_or_less(p):
    """At padded width 8 or less ``fused.run_kernel`` runs the single-sweep
    kernel (its plain version on CPU streams) instead of raising, and
    equals the JAX package's ``run_kernel`` (the Pallas kernel in
    interpret mode) on the same streams at 1e-10: N = 300 on 8 lanes."""
    from celerite_tpu.ops import fused as jfused
    from celerite_tpu.ops.lower import Coefficients as JCoefficients
    from celerite_tpu.ops.lower import lower as jlower

    k = width_kernel(jterms, p)
    th = jnp.asarray(k.get_parameter_vector())
    t, y, yerr = make_data(300, seed=11, t_max=30.0)
    ssm = jlower(JCoefficients(*k.get_padded_coefficients(th),
                               jitter=k.get_jitter(th)), jnp.asarray(t),
                 jnp.asarray(yerr**2))
    streams = jfused._to_lanes(ssm, jnp.asarray(y), 8)[:5]
    ll_j, ok_j = jfused.run_kernel(*streams, 300, interpret=True)
    ll, ok = fused.run_kernel(*(torch.tensor(np.asarray(x))
                                for x in streams), 300)
    assert bool(ok) and bool(ok_j)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-10)
