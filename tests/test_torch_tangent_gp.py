"""``fast_grad="tangent"``'s GP routes on the CPU against the JAX package.

config[2] (P = 8, 7 parameters) and a width-13 model at N = 4096 with an
active mean through ``build_loglik(solver="fused", fast_grad="tangent")``
(the tangent route: the plain single-sweep kernel and the plain kernels
with tangents) against JAX's ``blocked`` value and its ``jacfwd``, jitted,
at 1e-10 and 1e-8; the batch entry, the autograd backward and
``build_logprob``'s entries against the single entry.  ``solver="pallas"``,
``"blocked"`` and ``"seq"`` with the forward-mode backward against the
adjoint backward within 1e-8.  Width 20 raises at every solver.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_torch import GP, convert
from celerite_torch import terms as tterms
from celerite_torch.testing import config2_kernel, make_data, width_kernel


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


def _pair(kernel_fn, fit_mean=True):
    jgp = celerite_tpu.GP(kernel_fn(jterms), mean=0.3, fit_mean=fit_mean)
    tgp = GP(kernel_fn(tterms), mean=0.3, fit_mean=fit_mean, device="cpu")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask)
    return jgp, tgp


@pytest.mark.parametrize("width", [8, 13])
def test_tangent_route_matches_jax(width):
    """``solver="fused", fast_grad="tangent"`` at N = 4096 with an active
    mean: the route, the value and ``value_ok_grad`` against JAX's
    ``blocked`` and its ``jacfwd`` (1e-10, 1e-8); each row of
    ``value_ok_grad_batch`` equals the single entry; the autograd
    backward equals ``value_ok_grad``; ``build_logprob``'s entries wrap
    them."""
    jgp, tgp = _pair(lambda T: width_kernel(T, width))
    t, y, yerr = make_data(4096, seed=9, t_max=400.0)
    theta = jgp.get_parameter_vector()
    fl = jgp.build_loglik(t, y, yerr=yerr, solver="blocked")
    ll_j, g_j = jax.jit(lambda x: (fl(x)[0], jax.jacfwd(
        lambda z: fl(z)[0])(x)))(jnp.asarray(theta))
    fn = tgp.build_loglik(t, y, yerr=yerr, solver="fused",
                          fast_grad="tangent")
    assert fn.route == "tangent"
    th = torch.as_tensor(theta)
    ll, ok = fn(th)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-10)
    ll1, ok1, g1 = fn.value_ok_grad(th)
    assert bool(ok1)
    np.testing.assert_allclose(float(ll1), float(ll), rtol=1e-12)
    _close(g1, g_j, 1e-8)
    rows = th[None] + 0.01 * torch.arange(3, dtype=th.dtype)[:, None]
    llb, okb, gb = fn.value_ok_grad_batch(rows)
    for r in range(3):
        lr, _, gr = fn.value_ok_grad(rows[r])
        np.testing.assert_allclose(float(llb[r]), float(lr), rtol=1e-12)
        _close(gb[r], gr.numpy(), 1e-12)
    x = th.clone().requires_grad_()
    (ga,) = torch.autograd.grad(fn(x)[0], x)
    _close(ga, g1.numpy(), 1e-12)
    lp = tgp.build_logprob(t, y, yerr=yerr, fast_grad="tangent",
                           solver="fused",
                           log_prior=lambda p: -0.5 * torch.sum(p * p))
    v, g = lp.value_and_grad(th)
    np.testing.assert_allclose(float(v), float(ll1) - 0.5 * float(th @ th),
                               rtol=1e-12)
    _close(g, (g1 - th).numpy(), 1e-12)
    vb, gbb = lp.value_and_grad_batch(rows)
    _close(gbb, (gb - rows).numpy(), 1e-12)


def test_ssm_routes_tangent_backward():
    """``solver="pallas"``, ``"blocked"`` and ``"seq"`` with
    ``fast_grad="tangent"``: the autograd gradient through the forward-mode
    backward equals the adjoint backward's (``fast_grad=True``) within
    1e-8, config[2] at N = 2048 with an active mean, 64 lanes."""
    _, tgp = _pair(config2_kernel)
    t, y, yerr = make_data(2048, seed=10, t_max=200.0)
    th = torch.as_tensor(tgp.get_parameter_vector())
    for solver in ("pallas", "blocked", "seq"):
        grads = []
        for fast_grad in ("tangent", True):
            fn = tgp.build_loglik(t, y, yerr=yerr, solver=solver,
                                  fast_grad=fast_grad, block_size=64)
            assert fn.route == solver
            x = th.clone().requires_grad_()
            ll, ok = fn(x)
            (g,) = torch.autograd.grad(ll, x)
            grads.append(g.numpy())
        _close(grads[0], grads[1], 1e-8)


def test_above_width_16_raises():
    wide = GP(config2_kernel(tterms, modes=4), device="cpu")
    t, y, yerr = make_data(64)
    for solver in ("auto", "fused", "seq", "blocked", "pallas"):
        with pytest.raises(NotImplementedError,
                           match="ROADMAP queue 2, item 10"):
            wide.build_loglik(t, y, yerr=yerr, solver=solver,
                              fast_grad="tangent")
