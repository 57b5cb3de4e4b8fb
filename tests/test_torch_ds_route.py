"""``precision="ds"`` in the port's GP, against the JAX package.

- The exact-mode pipeline against JAX's exact mode on the CPU (its lax
  double-single solver): the same plan carried over from JAX's
  ``make_plan_ds`` and the same ``pack_cf_ds`` vector, 1e-8 relative (the
  ds bar of tests/test_ds.py).
- ``build_logprob(precision="ds")`` at N = 2048 routes to the exact-mode
  closure, whose ``value_and_grad`` matches the same GP's float64 closure
  (the sequential solver on the CPU below 4096 points) at 1e-10 (value)
  and 1e-8 (gradient norm); autograd through the closure gives the same
  gradient; an active mean, 8 < P <= 12, N < 2048 or a ``block_size``
  takes the float64 route instead.
- ``value_ok_grad_batch`` of 3 rows equals three one-row calls at 1e-12.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_tpu.ops import dsa, dsblocked, dslower
from celerite_tpu.ops import dsfused as jdsf
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_torch import GP, convert, terms as tterms
from celerite_torch.ops import dsfused
from celerite_torch.testing import config2_kernel, make_data

N_ROUTE = 2048


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the tests run in
    several worker processes at once, and per-op thread hand-offs then
    cost more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _prior(th):
    return -0.5 * torch.sum((th / 3.0) ** 2)


def test_exact_mode_matches_jax_ds_route():
    """JAX's exact mode rounds the coefficients, the variances and the
    data to float32 (celerite_tpu/gp.py:435-449) and returns ll in
    float32; its double-single total is read before that rounding.  The
    port computes in float64 on the same numbers."""
    jgp = celerite_tpu.GP(config2_kernel(jterms))
    t, y, yerr = make_data(256, seed=4, t_max=30.0)
    th = jnp.asarray(jgp.get_parameter_vector())
    k = jgp.kernel
    co32 = JCoefficients(*[jnp.asarray(c, jnp.float32) for c in JCoefficients(
        *k.get_padded_coefficients(th), jitter=k.get_jitter(th))])
    diag32 = np.asarray(yerr**2, np.float32)
    y32 = np.asarray(y, np.float32)
    ssm = dslower.lower_ds(co32, dsa.from_f64(t),
                           dsa.from_f64(np.concatenate([[0.0], np.diff(t)])),
                           jnp.asarray(diag32))
    total, _, n, _ = dsblocked._total_ds(ssm, jnp.asarray(y32), None)
    want = -0.5 * (float(total.hi) + float(total.lo)
                   + n * math.log(2.0 * math.pi))

    jplan = jdsf.make_plan_ds(t, y32.astype(np.float64),
                              diag32.astype(np.float64), 16)
    plan = convert.plan_ds_from_numpy(
        jplan.t, jplan.t_lo, jplan.dt, jplan.dt_lo, jplan.diag, jplan.y,
        jplan.mask, jplan.n, jplan.num_blocks, device="cpu")
    cf = convert.cf_ds_from_numpy(jdsf.pack_cf_ds(co32), device="cpu")
    pr, pc = jgp.kernel.padded_size
    ll, ok = dsfused.build_ll_ds(plan, pr, pc)(cf)
    assert bool(ok) and plan.t.dtype == torch.float64
    np.testing.assert_allclose(float(ll), want, rtol=1e-8)


@functools.lru_cache(maxsize=None)
def _route_gp():
    gp = GP(config2_kernel(tterms), device="cpu")
    t, y, yerr = make_data(N_ROUTE, seed=4, t_max=200.0)
    lpd = gp.build_logprob(t, y, yerr=yerr, log_prior=_prior, precision="ds")
    return gp, (t, y, yerr), lpd


def test_build_logprob_ds_routes_and_matches_f64():
    gp, (t, y, yerr), lpd = _route_gp()
    assert lpd.loglik.route == "dsfused"
    assert lpd.loglik.plan.t.dtype == torch.float64
    theta = torch.as_tensor(gp.get_parameter_vector())
    val, grad = lpd.value_and_grad(theta)
    lp64 = gp.build_logprob(t, y, yerr=yerr, log_prior=_prior,
                            dtype=torch.float64)
    assert lp64.loglik.route == "seq"
    x = theta.clone().requires_grad_()
    v64 = lp64(x)
    (g64,) = torch.autograd.grad(v64, x)
    np.testing.assert_allclose(float(val), float(v64.detach()), rtol=1e-10)
    assert float(torch.linalg.vector_norm(grad - g64)) \
        <= 1e-8 * float(torch.linalg.vector_norm(g64))
    # Autograd through the closure: the forward-mode gradient.
    x = theta.clone().requires_grad_()
    (ga,) = torch.autograd.grad(lpd(x), x)
    np.testing.assert_allclose(ga.numpy(), grad.numpy(), rtol=1e-12,
                               atol=1e-12 * float(grad.abs().max()))
    np.testing.assert_allclose(float(lpd(theta)), float(val), rtol=1e-14)


def test_value_ok_grad_batch_matches_one_row_calls():
    gp, _, lpd = _route_gp()
    theta = torch.as_tensor(gp.get_parameter_vector())
    rows = theta[None] + 0.01 * torch.arange(3, dtype=theta.dtype)[:, None]
    ll, ok, grad = lpd.loglik.value_ok_grad_batch(rows)
    assert ll.shape == (3,) and grad.shape == rows.shape and bool(ok.all())
    for r in range(3):
        l1, o1, g1 = lpd.loglik.value_ok_grad(rows[r])
        assert bool(o1)
        np.testing.assert_allclose(float(ll[r]), float(l1), rtol=1e-12)
        np.testing.assert_allclose(grad[r].numpy(), g1.numpy(), rtol=1e-12,
                                   atol=1e-12 * float(g1.abs().max()))


@pytest.mark.parametrize("case", ["mean", "wide", "short", "block_size"])
def test_other_exact_mode_calls_take_the_f64_route(case):
    kernel = config2_kernel(tterms)
    n, kw, gp_kw = N_ROUTE, {}, {}
    if case == "mean":
        gp_kw = dict(mean=0.1, fit_mean=True)
    elif case == "wide":  # three SHO terms: P = 12
        kernel = kernel + tterms.SHOTerm(log_S0=0.0, log_Q=1.0,
                                         log_omega0=0.8)
    elif case == "short":
        n = N_ROUTE - 1
    else:
        kw = dict(block_size=32)
    gp = GP(kernel, device="cpu", **gp_kw)
    t, y, yerr = make_data(n, seed=4, t_max=200.0)
    fn = gp.build_loglik(t, y, yerr=yerr, precision="ds", solver="fused",
                         dtype=torch.float32, **kw)
    assert fn.route == "fused" and fn.plan.t.dtype == torch.float64
    assert gp.build_loglik(t, y, yerr=yerr, precision="ds",
                           **kw).route == "seq"
