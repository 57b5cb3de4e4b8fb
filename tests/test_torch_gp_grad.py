"""The port's value-and-gradient entries against the JAX package's gradient.

``GP.build_loglik(..., solver="fused", block_size=32)``'s ``value_ok_grad``
and ``value_ok_grad_batch`` and ``build_logprob``'s ``value_and_grad`` and
``value_and_grad_batch`` run the gradient pipeline's plain versions on the
CPU.  They are held against ``jax.grad`` of the JAX package's
``build_loglik(solver="blocked")`` (plus the same prior for the log
probability) at 1e-8, the bar of tests/test_fused4.py's facade test.  The
JAX fused facade runs interpret mode (marked slow there), so the cheap
blocked route is the JAX side here.  N = 300 (never N = 700, ROADMAP
queue 3).
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_torch import GP, convert, gp as tgp_mod, terms as tterms
from celerite_torch.testing import bench_kernel, config2_kernel, make_data

KERNELS = {"bench": bench_kernel, "config2": config2_kernel}
N = 300


def _pair(kname, fit_mean=False, perturb=0.05, seed=1):
    jgp = celerite_tpu.GP(KERNELS[kname](jterms), mean=0.3, fit_mean=fit_mean)
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


def _data():
    return make_data(N, seed=4, t_max=30.0)


def _jax_prior(th):
    return -0.5 * jnp.sum((th / 3.0) ** 2)


def _torch_prior(th):
    return -0.5 * torch.sum((th / 3.0) ** 2)


def _jax_ll_grad(jgp, thetas, prior=False):
    t, y, yerr = _data()
    if prior:
        fn = jgp.build_logprob(t, y, yerr=yerr, log_prior=_jax_prior,
                               solver="blocked", fast_grad=False)
    else:
        fl = jgp.build_loglik(t, y, yerr=yerr, solver="blocked")
        fn = lambda th: fl(th)[0]  # noqa: E731
    vag = jax.jit(jax.value_and_grad(fn))
    out = [vag(jnp.asarray(th)) for th in np.atleast_2d(thetas)]
    return (np.array([float(v) for v, _ in out]),
            np.stack([np.asarray(g) for _, g in out]))


def _fused(tgp, **kw):
    t, y, yerr = _data()
    return tgp.build_loglik(t, y, yerr=yerr, solver="fused", block_size=32,
                            **kw)


def _thetas(jgp, rows=3, seed=7):
    rng = np.random.default_rng(seed)
    v = jgp.get_parameter_vector()
    return v[None] + 0.03 * rng.standard_normal((rows, v.size))


def _close(got, want, rtol=1e-8):
    got, want = np.asarray(got), np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("kname", sorted(KERNELS))
@pytest.mark.parametrize("fit_mean", [False, True])
def test_value_ok_grad_matches_jax(kname, fit_mean):
    jgp, tgp = _pair(kname, fit_mean=fit_mean)
    theta = jgp.get_parameter_vector()
    llj, gj = _jax_ll_grad(jgp, theta)
    fn = _fused(tgp)
    ll, ok, grad = fn.value_ok_grad(torch.as_tensor(theta))
    assert bool(ok) and grad.shape == (theta.size,)
    np.testing.assert_allclose(float(ll), llj[0], rtol=1e-10)
    _close(grad.numpy(), gj[0])
    # The value closure's own autograd (the plain primal) agrees too.
    th = torch.tensor(theta, requires_grad=True)
    fn(th)[0].backward()
    _close(th.grad.numpy(), gj[0])


@pytest.mark.parametrize("kname", sorted(KERNELS))
def test_value_and_grad_matches_jax(kname):
    jgp, tgp = _pair(kname, fit_mean=True)
    theta = jgp.get_parameter_vector()
    lpj, gj = _jax_ll_grad(jgp, theta, prior=True)
    t, y, yerr = _data()
    lp = tgp.build_logprob(t, y, yerr=yerr, log_prior=_torch_prior,
                           solver="fused", block_size=32)
    val, grad = lp.value_and_grad(torch.as_tensor(theta))
    np.testing.assert_allclose(float(val), lpj[0], rtol=1e-10)
    np.testing.assert_allclose(float(lp(torch.as_tensor(theta))), lpj[0],
                               rtol=1e-10)
    _close(grad.numpy(), gj[0])


@pytest.mark.parametrize("kname,fit_mean", [("config2", False),
                                            ("bench", True)])
def test_value_ok_grad_batch_matches_per_theta(kname, fit_mean):
    """3 thetas, padded to a folded launch of 4 chains, against JAX per
    theta; with fit_mean the residuals fold through ``fold_lanes``."""
    jgp, tgp = _pair(kname, fit_mean=fit_mean)
    thetas = _thetas(jgp)
    llj, gj = _jax_ll_grad(jgp, thetas)
    fn = _fused(tgp)
    ll, ok, grad = fn.value_ok_grad_batch(torch.as_tensor(thetas))
    assert ll.shape == (3,) and grad.shape == thetas.shape
    assert bool(ok.all())
    np.testing.assert_allclose(ll.numpy(), llj, rtol=1e-10)
    _close(grad.numpy(), gj)


def test_value_ok_grad_batch_chunks_above_the_cap():
    jgp, tgp = _pair("bench", fit_mean=True)
    thetas = torch.as_tensor(_thetas(jgp, rows=5))
    fn = _fused(tgp)
    whole = fn.value_ok_grad_batch(thetas)
    fn.value_ok_grad_batch.fold_cap = 2
    chunked = fn.value_ok_grad_batch(thetas)
    for a, b in zip(whole, chunked):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.double().numpy(), b.double().numpy(),
                                   rtol=1e-12, atol=1e-12)


def test_value_and_grad_batch_matches_jax_and_masks_non_finite():
    """Rows where the log probability is not finite give -inf and a zero
    gradient (celerite_tpu/gp.py:1207-1219); the others match JAX."""
    jgp, tgp = _pair("config2")
    thetas = _thetas(jgp, rows=4)

    def jprior(th):
        return jnp.where(th[0] > 5.0, -jnp.inf, _jax_prior(th))

    def tprior(th):
        return torch.where(th[0] > 5.0, -math.inf, _torch_prior(th))

    thetas[2, 0] = 6.0
    t, y, yerr = _data()
    lp = tgp.build_logprob(t, y, yerr=yerr, log_prior=tprior,
                           solver="fused", block_size=32)
    val, grad = lp.value_and_grad_batch(torch.as_tensor(thetas))
    assert float(val[2]) == -math.inf and bool((grad[2] == 0).all())
    jlp = jgp.build_logprob(t, y, yerr=yerr, log_prior=jprior,
                            solver="blocked", fast_grad=False)
    vag = jax.jit(jax.value_and_grad(jlp))
    for r in (0, 1, 3):
        vj, gj = vag(jnp.asarray(thetas[r]))
        np.testing.assert_allclose(float(val[r]), float(vj), rtol=1e-10)
        _close(grad[r].numpy(), np.asarray(gj))
    single, gsingle = lp.value_and_grad(torch.as_tensor(thetas[2]))
    assert float(single) == -math.inf and bool((gsingle == 0).all())


def test_grad_log_likelihood_matches_jax():
    jgp, tgp = _pair("config2", fit_mean=True)
    t, y, yerr = _data()
    jgp.compute(t, yerr)
    tgp.compute(t, yerr)
    llj, gj = jgp.grad_log_likelihood(y)
    llt, gt = tgp.grad_log_likelihood(y)
    np.testing.assert_allclose(llt, llj, rtol=1e-10)
    _close(gt, gj)


def test_grad_log_likelihood_fused_route_matches_jax(monkeypatch):
    """With the fused solver chosen, ``grad_log_likelihood`` takes the
    closure's ``value_ok_grad`` (the gradient pipeline) and matches JAX."""
    monkeypatch.setattr(tgp_mod, "_SEQ_BELOW", 0)
    jgp, tgp = _pair("config2", fit_mean=True)
    t, y, yerr = _data()
    jgp.compute(t, yerr)
    tgp.compute(t, yerr)
    calls = []
    build = tgp.build_loglik

    def spy(*args, **kwargs):
        fn = build(*args, **kwargs)
        vog = fn.value_ok_grad
        fn.value_ok_grad = lambda th: calls.append(1) or vog(th)
        return fn

    monkeypatch.setattr(tgp, "build_loglik", spy)
    llj, gj = jgp.grad_log_likelihood(y)
    llt, gt = tgp.grad_log_likelihood(y)
    assert calls == [1]
    np.testing.assert_allclose(llt, llj, rtol=1e-10)
    _close(gt, gj)


def test_fast_grad_options():
    _, tgp = _pair("bench")
    t, y, yerr = _data()
    kw = dict(yerr=yerr, solver="fused", block_size=32)
    assert hasattr(tgp.build_logprob(t, y, **kw), "value_and_grad")
    assert hasattr(tgp.build_logprob(t, y, fast_grad=True, **kw),
                   "value_and_grad_batch")
    assert not hasattr(tgp.build_logprob(t, y, fast_grad=False, **kw),
                       "value_and_grad")
    # The sequential route has no fused entry: samplers use autograd.
    assert not hasattr(tgp.build_logprob(t, y, yerr=yerr, solver="seq"),
                       "value_and_grad")


def test_fold_cap_is_a_power_of_two_within_budget():
    dev = torch.device("cpu")
    cap = tgp_mod._fold_cap(100_000, 8, torch.float64, dev)
    assert cap >= 1 and cap & (cap - 1) == 0
    per_chain = 100_000 * (4 * 64 + 8 + 8) * 8
    assert cap * per_chain <= tgp_mod._FOLD_CPU_BYTES
    assert tgp_mod._fold_cap(10**9, 12, torch.float64, dev) == 1


def test_grad_lane_rule():
    """The gradient path's lanes per chain: the value path's count capped
    at 512 on the card (chip_smoke.py's gradient sweeps), the value path's
    count on the CPU."""
    from celerite_torch.ops import lanes4

    for n in (1000, 100_000, 1_000_000):
        value = lanes4.default_num_blocks4(n, "cuda")
        assert lanes4.default_grad_blocks4(n, "cuda") == min(value, 512)
        assert lanes4.default_grad_blocks4(n, "cpu") == \
            lanes4.default_num_blocks4(n, "cpu")
