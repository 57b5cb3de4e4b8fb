"""The port's wide-model route (padded width 13-16) against the JAX package.

``lanes.make_plan`` is held against the JAX package's exactly and
``lanes.lower_lanes`` at 1e-13 in float64 (relative, and absolute against
each output's largest value: the two packages' sin and cos differ by an
ulp, which an oscillation's ``a cos + b sin`` can leave in a small
value).  config[2] with three oscillation modes
(four SHO terms and jitter, P = 16, 13 parameters) at N = 4096 takes the
adjoint route on the CPU (the plain versions of ``ops/adjoint``); its
``value_ok_grad`` is held against ``jax.value_and_grad`` of the JAX
package's ``build_loglik(solver="blocked")`` at tests/test_adjoint.py's
tolerances (ll 1e-10, gradient rtol 1e-7 / atol 1e-9).  The folded batch
entry equals one-row calls, and NUTS runs on the route.  The value
closure at widths 13 and 16 (the three-pass kernels' plain versions over
the value plan) is held against JAX's ``build_loglik`` at 1e-10 and its
own ``value_ok_grad`` at 1e-12, its autograd gradient (``fast_grad`` True
and False) against ``value_ok_grad``'s at 1e-8 (norm), and
``GP.log_likelihood`` / ``grad_log_likelihood`` against the JAX ``GP``'s.
The CUDA kernels are held against the plain versions by
tests/test_torch_kernels.py and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_tpu.ops import lanes as jlanes
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_torch import GP, convert, inference, terms as tterms
from celerite_torch.ops import lanes
from celerite_torch.ops.lower import Coefficients
from celerite_torch.testing import config2_kernel, make_data, wide_kernel


def _config2_data(n, seed=2):
    """Cell B's data (a sinusoid plus noise, yerr 0.3) at its density."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100.0 * n / 1e5, n))
    yerr = np.full(n, 0.3)
    y = np.sin(t) + 0.5 * np.sin(3.1 * t) + yerr * rng.standard_normal(n)
    return t, y, yerr


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


@pytest.mark.parametrize("width", [13, 16])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_plan_and_lowering_match_jax(width, dtype):
    """The plan's arrays, and the lowering in float64, equal JAX's; a
    two-chain plan tiles the one-chain plan, and a batch of two rows
    lowers each chain's lanes as one row does."""
    t, y, yerr = make_data(203, seed=3, t_max=40.0)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    pj = jlanes.make_plan(t, y, yerr**2, 16, dtype=dtype)
    pt = lanes.make_plan(t, y, yerr**2, 16, dtype=tdt, device="cpu")
    for got, want in zip(pt[:6], pj[:6]):
        assert got.dtype == tdt
        _close(got, want, rtol=0)
    assert pt.n == pj.n
    carried = convert.lane_plan_from_numpy(*pj[:6], pj.n, device="cpu")
    for got, want in zip(carried, pt):
        assert torch.equal(got, want) if torch.is_tensor(got) else got == want
    folded = lanes.make_plan(t, y, yerr**2, 16, dtype=tdt, n_chain=2,
                             device="cpu")
    for got, want in zip(folded[:6], pt[:6]):
        assert torch.equal(got, torch.cat([want, want], -1))
    if dtype == np.float32:
        return
    jk, tk = wide_kernel(jterms, width), wide_kernel(tterms, width)
    theta = jk.get_parameter_vector()
    jc = JCoefficients(*jk.get_padded_coefficients(jnp.asarray(theta)),
                       jitter=jk.get_jitter(jnp.asarray(theta)))
    th = torch.as_tensor(theta)
    tc = Coefficients(*tk.get_padded_coefficients(th),
                      jitter=tk.get_jitter(th))
    want = jlanes.lower_lanes(jc, pj)
    got = lanes.lower_lanes(tc, pt)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        _close(g, w, rtol=1e-13, atol=1e-13 * float(np.abs(w).max()))
    th2 = torch.stack([th, th + 0.05])
    rows = torch.func.vmap(lambda x: tuple(Coefficients(
        *tk.get_padded_coefficients(x), jitter=tk.get_jitter(x))))(th2)
    both = lanes.lower_lanes(rows, folded)
    shifted = lanes.lower_lanes(Coefficients(
        *tk.get_padded_coefficients(th2[1]), jitter=tk.get_jitter(th2[1])),
        pt)
    for g, w0, w1 in zip(both, got, shifted):
        assert torch.equal(g, torch.cat([w0, w1], -1))


def _pair(fit_mean=False):
    jgp = celerite_tpu.GP(config2_kernel(jterms, modes=3), mean=0.1,
                          fit_mean=fit_mean)
    tgp = GP(config2_kernel(tterms, modes=3), mean=0.1, fit_mean=fit_mean,
             device="cpu")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask)
    return jgp, tgp


def test_config2_three_modes_matches_jax_blocked():
    """N = 4096 at solver="auto" on the CPU: the adjoint route's
    ``value_ok_grad`` against the JAX blocked solver's value and gradient,
    and ``grad_log_likelihood`` takes that entry."""
    t, y, yerr = _config2_data(4096)
    jgp, tgp = _pair()
    assert tgp.vector_size == 13
    fn = tgp.build_loglik(t, y, yerr=yerr)
    assert fn.route == "adjoint"
    theta = tgp.get_parameter_vector()
    ll, ok, grad = fn.value_ok_grad(torch.as_tensor(theta))
    assert bool(ok)
    fl = jgp.build_loglik(t, y, yerr=yerr, solver="blocked")
    ll_j, g_j = jax.jit(jax.value_and_grad(lambda x: fl(x)[0]))(
        jnp.asarray(theta))
    _close(float(ll), float(ll_j), rtol=1e-10)
    _close(grad, g_j, rtol=1e-7, atol=1e-9)
    tgp.compute(t, yerr)
    ll2, grad2 = tgp.grad_log_likelihood(y)
    assert ll2 == float(ll)
    _close(grad2, grad, rtol=0)


@pytest.mark.parametrize("fit_mean", [False, True])
def test_batch_entry_equals_single_rows(fit_mean):
    """Three rows fold onto the lanes of one 4-chain plan (padded with a
    copy of the first row) and give what three one-row calls give."""
    t, y, yerr = _config2_data(600)
    _, tgp = _pair(fit_mean)
    fn = tgp.build_loglik(t, y, yerr=yerr, solver="fused", block_size=16)
    assert fn.route == "adjoint"
    v = torch.as_tensor(tgp.get_parameter_vector())
    rows = v[None] + 0.02 * torch.as_tensor(
        np.random.default_rng(5).standard_normal((3, v.numel())))
    ll, ok, grad = fn.value_ok_grad_batch(rows)
    assert ll.shape == (3,) and grad.shape == (3, v.numel())
    assert fn.value_ok_grad_batch.folded_plan(4).n_chain == 4
    for r in range(3):
        l1, o1, g1 = fn.value_ok_grad(rows[r])
        assert bool(ok[r]) and bool(o1)
        _close(float(ll[r]), float(l1), rtol=1e-12)
        _close(grad[r], g1, rtol=1e-12, atol=1e-12 * float(g1.abs().max()))


def _wide_pair(width):
    """The width-``width`` model in both packages, with an active mean."""
    jgp = celerite_tpu.GP(wide_kernel(jterms, width), mean=0.1,
                          fit_mean=True)
    tgp = GP(wide_kernel(tterms, width), mean=0.1, fit_mean=True,
             device="cpu")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask)
    return jgp, tgp


@pytest.mark.parametrize("width", [13, 16])
def test_value_closure_matches_jax(width):
    """N = 4096: the value closure (``fused.run_kernel`` over the value
    plan, the plain three-pass kernels on the CPU) against JAX's
    ``build_loglik`` (its CPU route is ``blocked``) at 1e-10, and against
    the closure's own ``value_ok_grad`` at 1e-12; ``build_logprob`` adds
    the prior to it."""
    t, y, yerr = _config2_data(4096)
    jgp, tgp = _wide_pair(width)
    theta = jgp.get_parameter_vector()
    ll_j, ok_j = jax.jit(jgp.build_loglik(t, y, yerr=yerr))(
        jnp.asarray(theta))
    fn = tgp.build_loglik(t, y, yerr=yerr)
    assert fn.route == "adjoint" and fn.value_plan is fn.plan
    ll, ok = fn(torch.as_tensor(theta))
    assert bool(ok) and bool(ok_j)
    _close(float(ll), float(ll_j), rtol=1e-10)
    ll_vog, _, _ = fn.value_ok_grad(torch.as_tensor(theta))
    _close(float(ll), float(ll_vog), rtol=1e-12)
    prior = lambda th: -0.5 * torch.sum(th ** 2)  # noqa: E731
    lp = tgp.build_logprob(t, y, yerr=yerr, log_prior=prior)
    th = torch.as_tensor(theta)
    _close(float(lp(th)), float(ll) + float(prior(th)), rtol=1e-14)


@pytest.mark.parametrize("width", [13, 16])
@pytest.mark.parametrize("fast_grad", [False, True])
def test_value_closure_gradient_equals_value_ok_grad(width, fast_grad):
    """Under autograd the value closure's backward (the adjoint pipeline
    with ``fast_grad``, else autograd through ``blocked``) gives
    ``value_ok_grad``'s gradient at 1e-8 (norm), at N = 1000 on the route
    (``solver="fused"``)."""
    t, y, yerr = _config2_data(1000)
    _, tgp = _wide_pair(width)
    fn = tgp.build_loglik(t, y, yerr=yerr, solver="fused",
                          fast_grad=fast_grad)
    assert fn.route == "adjoint"
    theta = torch.tensor(tgp.get_parameter_vector(), requires_grad=True)
    ll, ok = fn(theta)
    (grad,) = torch.autograd.grad(ll, theta)
    _, _, want = fn.value_ok_grad(theta.detach())
    assert bool(ok)
    assert float((grad - want).norm() / want.norm()) <= 1e-8


def test_gp_entry_points_on_the_wide_model():
    """``GP.log_likelihood`` and ``grad_log_likelihood`` of config[2] with
    three modes at N = 4096 against the JAX ``GP``'s: its
    ``log_likelihood``, and for the gradient what its
    ``grad_log_likelihood`` computes (``jax.value_and_grad`` of its
    ``build_loglik``), jitted."""
    t, y, yerr = _config2_data(4096, seed=3)
    jgp, tgp = _pair(fit_mean=True)
    jgp.compute(t, yerr)
    tgp.compute(t, yerr)
    _close(tgp.log_likelihood(y), jgp.log_likelihood(y), rtol=1e-10)
    ll, grad = tgp.grad_log_likelihood(y)
    fl = jgp.build_loglik(t, y, yerr=yerr)
    ll_j, grad_j = jax.jit(jax.value_and_grad(lambda x: fl(x)[0]))(
        jnp.asarray(jgp.get_parameter_vector()))
    _close(ll, float(ll_j), rtol=1e-10)
    _close(grad, grad_j, rtol=1e-7, atol=1e-9)


def test_nuts_on_the_route_stays_finite():
    """Dense-mass NUTS through ``build_logprob(...).value_and_grad_batch``
    on the adjoint route: a few transitions, every draw finite."""
    t, y, yerr = _config2_data(64)
    _, tgp = _pair()
    lp = tgp.build_logprob(t, y, yerr=yerr, solver="fused", block_size=8,
                           log_prior=lambda th: -0.5 * torch.sum(
                               (th / 3.0) ** 2))
    assert lp.loglik.route == "adjoint"
    gen = torch.Generator().manual_seed(3)
    v = torch.as_tensor(tgp.get_parameter_vector())
    init = v[None] + 0.02 * torch.randn(2, v.numel(), generator=gen,
                                        dtype=v.dtype)
    draws, info = inference.sample_nuts(
        lp, init, gen, num_warmup=4, num_samples=2, max_tree_depth=3,
        dense_mass=True)
    assert draws.shape == (2, 2, 13)
    assert bool(torch.isfinite(draws).all())
    assert bool(torch.isfinite(info["energy"]).all())
