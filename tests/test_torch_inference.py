"""The port's sampler pieces against the JAX package's, on the same inputs.

Deterministic parts are held exactly or at 1e-12 (adaptation, diagnostics)
and 1e-10 (leapfrog on a GP log probability, against JAX's blocked
gradient).  Random parts cannot match JAX's streams; they are held by their
distributions: momentum draws against the mass matrix within 5% over 20k
draws, and HMC on a correlated 2-D Gaussian within 4 Monte-Carlo standard
errors of the mean and variance.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_tpu.inference import adaptation as jad
from celerite_tpu.inference import diagnostics as jdiag
from celerite_tpu.inference import nuts as jnuts
from celerite_torch import GP, convert, terms as tterms
from celerite_torch.inference import adaptation as tad
from celerite_torch.inference import diagnostics as tdiag
from celerite_torch.inference import hmc, nuts
from celerite_torch.testing import config2_kernel, make_data


def _np(x):
    return np.asarray(x, dtype=float)


# ---------------------------------------------------------------------------
# Adaptation and diagnostics: same numpy arrays, same numbers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mu", [None, math.log(0.3)])
def test_dual_averaging_matches_jax(mu):
    rng = np.random.default_rng(0)
    accept = rng.uniform(0.2, 1.0, 40)
    sj = jad.da_init(jnp.asarray(0.3), target=0.8, mu=mu)
    st = tad.da_init(0.3, target=0.8, mu=mu)
    for a in accept:
        sj = jad.da_update(sj, jnp.asarray(a))
        st = tad.da_update(st, a)
        for k in ("log_step", "log_step_avg", "h_sum"):
            np.testing.assert_allclose(float(getattr(st, k)),
                                       float(getattr(sj, k)), rtol=1e-12)
    np.testing.assert_allclose(float(tad.da_final(st)),
                               float(jad.da_final(sj)), rtol=1e-12)


@pytest.mark.parametrize("dense", [False, True])
def test_welford_matches_jax(dense):
    rng = np.random.default_rng(1)
    batches = rng.standard_normal((12, 4, 3)) * np.array([1.0, 0.1, 5.0])
    if dense:
        sj, st = jad.welford_cov_init(3), tad.welford_cov_init(3)
        upd_j, upd_t = jad.welford_cov_update, tad.welford_cov_update
        est_j, est_t = jad.welford_covariance, tad.welford_covariance
    else:
        sj, st = jad.welford_init(3), tad.welford_init(3)
        upd_j, upd_t = jad.welford_update, tad.welford_update
        est_j, est_t = jad.welford_variance, tad.welford_variance
    for xs in batches:
        sj = upd_j(sj, jnp.asarray(xs))
        st = upd_t(st, torch.as_tensor(xs))
        for k in ("count", "mean", "m2"):
            np.testing.assert_allclose(_np(getattr(st, k)),
                                       _np(getattr(sj, k)), rtol=1e-12,
                                       atol=1e-12)
    for reg in (False, True):
        np.testing.assert_allclose(_np(est_t(st, regularize=reg)),
                                   _np(est_j(sj, regularize=reg)),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("num_warmup", [10, 60, 150, 1000])
def test_window_boundaries_match_jax(num_warmup):
    for a, b in zip(tad.window_boundaries(num_warmup),
                    jad.window_boundaries(num_warmup)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_diagnostics_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 301, 3))
    x[..., 1] = np.cumsum(x[..., 1], axis=1) * 0.1  # autocorrelated
    x[2, :, 2] += 0.5  # one chain off
    energy = rng.gamma(3.0, size=(4, 301))
    for ft, fj in ((tdiag.split_rhat, jdiag.split_rhat),
                   (tdiag.effective_sample_size, jdiag.effective_sample_size),
                   (tdiag.ebfmi, jdiag.ebfmi)):
        arg = energy if ft is tdiag.ebfmi else x
        np.testing.assert_allclose(ft(arg), fj(arg), rtol=1e-12)
    st, sj = tdiag.summary(x), jdiag.summary(x)
    assert sorted(st) == sorted(sj)
    for k in st:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-12)


# ---------------------------------------------------------------------------
# Leapfrog on a GP log probability, against JAX's
# ---------------------------------------------------------------------------


def test_leapfrog_on_gp_logprob_matches_jax():
    jgp = celerite_tpu.GP(config2_kernel(jterms))
    tgp = GP(config2_kernel(tterms), device="cpu")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask)
    t, y, yerr = make_data(300, seed=4, t_max=30.0)

    def jprior(th):
        return -0.5 * jnp.sum((th / 3.0) ** 2)

    def tprior(th):
        return -0.5 * torch.sum((th / 3.0) ** 2)

    jlp = jgp.build_logprob(t, y, yerr=yerr, log_prior=jprior,
                            solver="blocked", fast_grad=False)
    jvag = jax.jit(jax.value_and_grad(jlp))

    def jgrad_fn(q):
        lp, g = jvag(q)
        return -g, lp

    tlp = tgp.build_logprob(t, y, yerr=yerr, log_prior=tprior,
                            solver="fused", block_size=32)

    def tgrad_fn(q):
        lp, g = tlp.value_and_grad_batch(q)
        return -g, lp

    rng = np.random.default_rng(3)
    dim = jgp.vector_size
    a = rng.standard_normal((dim, dim))
    inv_mass = 0.01 * (a @ a.T / dim + np.eye(dim))
    q0 = jgp.get_parameter_vector()
    p0 = rng.standard_normal(dim) * 3.0
    eps = 0.02

    qj, pj = jnp.asarray(q0), jnp.asarray(p0)
    gj, _ = jgrad_fn(qj)
    qt, pt = torch.as_tensor(q0)[None], torch.as_tensor(p0)[None]
    gt, _ = tgrad_fn(qt)
    mj, mt = jnp.asarray(inv_mass), torch.as_tensor(inv_mass)
    for _ in range(5):
        qj, pj, gj, lpj = jnuts._leapfrog(jgrad_fn, qj, pj, gj, eps, mj)
        qt, pt, gt, lpt = nuts._leapfrog(tgrad_fn, qt, pt, gt, eps, mt)
        for a_, b_ in ((qt[0], qj), (pt[0], pj), (gt[0], gj)):
            np.testing.assert_allclose(a_.numpy(), np.asarray(b_),
                                       rtol=1e-10,
                                       atol=1e-10 * float(np.abs(b_).max()))
        np.testing.assert_allclose(float(lpt[0]), float(lpj), rtol=1e-10)


# ---------------------------------------------------------------------------
# Random parts, held by their distributions
# ---------------------------------------------------------------------------

COV = np.array([[1.0, 0.8], [0.8, 2.0]])
MEAN = np.array([0.5, -1.0])


def _gaussian():
    prec = torch.as_tensor(np.linalg.inv(COV))
    mean = torch.as_tensor(MEAN)

    def logprob(q):
        d = q - mean
        return -0.5 * d @ prec @ d

    def value_and_grad_batch(qs):
        d = qs - mean
        return -0.5 * torch.sum(d * (d @ prec), dim=-1), -(d @ prec)

    logprob.value_and_grad_batch = value_and_grad_batch
    return logprob


@pytest.mark.parametrize("dense", [False, True])
def test_sample_momentum_covariance(dense):
    gen = torch.Generator().manual_seed(0)
    inv_mass = torch.as_tensor(np.linalg.inv(COV) if dense
                               else np.array([0.5, 4.0]))
    p = nuts._sample_momentum(gen, 20_000, 2, torch.float64, inv_mass)
    mass = np.linalg.inv(inv_mass.numpy()) if dense \
        else np.diag(1.0 / inv_mass.numpy())
    emp = np.cov(p.numpy().T)
    assert np.all(np.abs(emp - mass) <= 0.05 * np.sqrt(
        np.outer(np.diag(mass), np.diag(mass))))


def test_hmc_on_correlated_gaussian():
    """4 chains x 2000 draws, dense metric, per-chain jittered lengths:
    mean and variance within 4 Monte-Carlo standard errors."""
    logprob = _gaussian()
    gen = torch.Generator().manual_seed(1)
    q = torch.zeros(4, 2, dtype=torch.float64)
    inv_mass = torch.as_tensor(COV)
    draws, accept = [], []
    for i in range(2200):
        q, info = hmc.hmc_kernel(logprob, q, gen, 0.4, inv_mass,
                                 num_leapfrog=8, jitter=True)
        if i >= 200:
            draws.append(q.numpy())
            accept.append(float(info.accept_prob.mean()))
    x = np.stack(draws, axis=1)  # (chains, draws, dim)
    assert np.mean(accept) > 0.6
    flat = x.reshape(-1, 2)
    ess = tdiag.effective_sample_size(x)
    mcse_mean = flat.std(0) / np.sqrt(ess)
    assert np.all(np.abs(flat.mean(0) - MEAN) < 4 * mcse_mean)
    sq = (x - MEAN) ** 2
    mcse_var = sq.reshape(-1, 2).std(0) / np.sqrt(
        tdiag.effective_sample_size(sq))
    assert np.all(np.abs(sq.reshape(-1, 2).mean(0) - np.diag(COV))
                  < 4 * mcse_var)


def test_hmc_jitter_chains_keep_state_past_their_length():
    """Each chain takes its own drawn length; its proposal is exactly the
    composition of that many leapfrogs (JAX's vmapped fori_loop)."""
    logprob = _gaussian()
    vag = logprob.value_and_grad_batch
    q = torch.as_tensor([[0.1, 0.2], [1.0, -1.0], [-0.5, 0.3],
                         [2.0, 0.0]], dtype=torch.float64)
    inv_mass = torch.as_tensor([1.0, 2.0], dtype=torch.float64)
    eps = 0.05
    gen = torch.Generator().manual_seed(4)
    q_new, info = hmc.hmc_kernel(logprob, q, gen, eps, inv_mass,
                                 num_leapfrog=6, jitter=True)
    assert bool(info.accepted.all())
    assert len(set(info.num_steps.tolist())) > 1
    gen.manual_seed(4)
    p0 = nuts._sample_momentum(gen, 4, 2, torch.float64, inv_mass)

    def grad_fn(x):
        lp, g = vag(x)
        return -g, lp

    for c in range(4):
        qq, pp = q[c:c + 1], p0[c:c + 1]
        gg, _ = grad_fn(qq)
        for _ in range(int(info.num_steps[c])):
            qq, pp, gg, _ = nuts._leapfrog(grad_fn, qq, pp, gg, eps,
                                           inv_mass)
        np.testing.assert_allclose(q_new[c].numpy(), qq[0].numpy(),
                                   rtol=1e-12, atol=1e-14)


def test_hmc_autograd_fallback_matches_batched_entry():
    """A log probability without ``value_and_grad_batch`` goes through
    autograd row by row, with the same result."""
    fused = _gaussian()

    def plain(q):
        return fused(q)

    q = torch.as_tensor([[0.1, 0.2], [1.0, -1.0]], dtype=torch.float64)
    inv_mass = torch.as_tensor(COV)
    outs = []
    for fn in (fused, plain):
        gen = torch.Generator().manual_seed(9)
        outs.append(hmc.hmc_kernel(fn, q, gen, 0.3, inv_mass,
                                   num_leapfrog=5, jitter=False))
    np.testing.assert_allclose(outs[0][0].numpy(), outs[1][0].numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(outs[0][1].energy.numpy(),
                               outs[1][1].energy.numpy(), rtol=1e-12)


def test_find_reasonable_step_size_crosses_one_half():
    """At the returned step one leapfrog's acceptance ratio has crossed
    1/2 from the side the initial step was on (Hoffman & Gelman 2014)."""
    logprob = _gaussian()
    vag = logprob.value_and_grad_batch
    q = torch.as_tensor([[0.0, 0.0], [3.0, -2.0], [1.0, 1.0]],
                        dtype=torch.float64)
    inv_mass = torch.ones(2, dtype=torch.float64)
    gen = torch.Generator().manual_seed(5)
    eps = nuts.find_reasonable_step_size(logprob, q, gen, inv_mass=inv_mass,
                                         initial=1.0)
    gen.manual_seed(5)
    p0 = nuts._sample_momentum(gen, 3, 2, torch.float64, inv_mass)

    def grad_fn(x):
        lp, g = vag(x)
        return -g, lp

    g0, lp0 = grad_fn(q)
    h0 = -lp0 + 0.5 * torch.sum(p0 * p0, dim=-1)

    def log_ratio(e):
        _, pn, _, lpn = nuts._leapfrog(grad_fn, q, p0, g0, e, inv_mass)
        return (h0 - (-lpn + 0.5 * torch.sum(pn * pn, dim=-1))).numpy()

    first = log_ratio(torch.ones(3, dtype=torch.float64)) > math.log(0.5)
    final = log_ratio(eps) > math.log(0.5)
    moved = eps.numpy() != 1.0
    assert moved.all()
    np.testing.assert_array_equal(final[moved], ~first[moved])
    back = torch.where(torch.as_tensor(first), eps / 2, eps * 2)
    np.testing.assert_array_equal(log_ratio(back) > math.log(0.5), first)
