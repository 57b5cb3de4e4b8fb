"""The port's ADVI, Laplace, SMC, MAP fitting and checkpoints against the
JAX package's, on the same inputs.

Deterministic parts are held to the tolerances each test states: Adam
against optax to 1e-14, ``minimize`` / ``map_fit`` traces and optima to
1e-8, the Laplace mode and covariance of a Gaussian to 1e-10 (its
gradient is linear, so central differences are exact to rounding), the
ELBO's closed-form gradient on fixed draws to 1e-10, the SMC temperature
search to 1e-12 and the systematic indices exactly.  Random parts cannot
match JAX's streams; they are held by their distributions, with the JAX
package's own bars (tests/test_inference.py).  JAX runs on small
Gaussian targets and arrays, and on its ``solver="blocked"``,
``fast_grad=False`` GP closure at N <= 300 only jitted; never Pallas in
interpret mode.
"""

import functools
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import celerite_tpu
from celerite_tpu import terms as jterms
from celerite_tpu.inference import advi as jadvi
from celerite_tpu.inference import checkpoint as jckpt
from celerite_tpu.inference import optimize as jopt
from celerite_tpu.inference import smc as jsmc
from celerite_torch import GP, convert, terms as tterms
from celerite_torch.inference import advi, checkpoint, optimize, smc
from celerite_torch.testing import config2_kernel, make_data

COV = np.array([[2.0, 1.2], [1.2, 1.5]])
MU = np.array([1.0, -2.0])
PREC = np.linalg.inv(COV)


def jgauss(x):
    d = x - jnp.asarray(MU)
    return -0.5 * d @ jnp.asarray(PREC) @ d


def tgauss(batched=True, box=None):
    """The Gaussian log density (unnormalised); with ``batched`` it carries
    its analytic ``value_and_grad_batch``; with ``box`` it is -inf outside
    |x| < box."""
    prec, mean = torch.as_tensor(PREC), torch.as_tensor(MU)

    def inside(q):
        return torch.ones(q.shape[:-1], dtype=torch.bool) if box is None \
            else torch.all(torch.abs(q) < box, dim=-1)

    def logprob(q):
        d = q - mean
        return torch.where(inside(q), -0.5 * d @ prec @ d, -math.inf)

    def value_and_grad_batch(qs):
        d = qs - mean
        ok = inside(qs)
        val = -0.5 * torch.sum(d * (d @ prec), dim=-1)
        return (torch.where(ok, val, -math.inf),
                torch.where(ok[:, None], -(d @ prec), 0.0))

    if batched:
        logprob.value_and_grad_batch = value_and_grad_batch
    return logprob


def _np(x):
    return np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x,
                      dtype=float)


# ---------------------------------------------------------------------------
# Adam, minimize, map_fit
# ---------------------------------------------------------------------------


def test_adam_matches_optax():
    """50 steps on a fixed gradient sequence: x within 1e-14 of optax's."""
    rng = np.random.default_rng(0)
    grads = rng.standard_normal((50, 5)) * np.logspace(-3, 2, 5)
    x0 = rng.standard_normal(5)
    jo = optax.adam(3e-2)
    xj, sj = jnp.asarray(x0), jo.init(jnp.asarray(x0))
    to = optimize.Adam(3e-2)
    xt = torch.as_tensor(x0)
    st = to.init(xt)
    for g in grads:
        uj, sj = jo.update(jnp.asarray(g), sj)
        xj = optax.apply_updates(xj, uj)
        ut, st = to.update(torch.as_tensor(g), st)
        xt = xt + ut
        np.testing.assert_allclose(xt.numpy(), np.asarray(xj), rtol=1e-14,
                                   atol=1e-14)


@pytest.mark.parametrize("entry", ["autograd", "value_and_grad"])
def test_minimize_matches_jax(entry):
    """The negated Gaussian from (0, 0), 200 steps at 5e-2: the trace and
    the optimum within 1e-8 of JAX's, through autograd and through a
    ``value_and_grad`` attribute."""
    lp = tgauss(batched=False)

    def neg(q):
        return -lp(q)

    if entry == "value_and_grad":
        def vag(q):
            d = q - torch.as_tensor(MU)
            return 0.5 * d @ torch.as_tensor(PREC) @ d, \
                torch.as_tensor(PREC) @ d
        neg.value_and_grad = vag
    xj, trj = jopt.minimize(lambda q: -jgauss(q), jnp.zeros(2),
                            num_steps=200, optimizer=optax.adam(5e-2))
    xt, trt = optimize.minimize(neg, torch.zeros(2, dtype=torch.float64),
                                num_steps=200, optimizer=5e-2)
    np.testing.assert_allclose(_np(trt), np.asarray(trj), rtol=1e-8,
                               atol=1e-12)
    np.testing.assert_allclose(_np(xt), np.asarray(xj), rtol=1e-8)


def _realterm_data():
    """tests/test_inference.py's map_fit set-up: a RealTerm GP draw at
    N = 150."""
    rng = np.random.default_rng(11)
    t = np.sort(rng.uniform(0, 20, 150))
    yerr = np.full(150, 0.3)
    gp_sim = celerite_tpu.GP(jterms.RealTerm(log_a=0.5, log_c=-0.5))
    gp_sim.compute(t, yerr)
    return t, gp_sim.sample(seed=2), yerr


def test_map_fit_matches_jax():
    """RealTerm at N = 150, 30 Adam steps: the log-probability trace and
    the optimum within 1e-8 of JAX's ``map_fit``, and the optimum written
    back into the GP."""
    t, y, yerr = _realterm_data()
    jgp = celerite_tpu.GP(jterms.RealTerm(log_a=-0.5, log_c=0.5))
    tgp = GP(tterms.RealTerm(log_a=-0.5, log_c=0.5), device="cpu")
    pj, trj = jopt.map_fit(
        jgp, t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2), num_steps=30)
    pt, trt = optimize.map_fit(
        tgp, t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * torch.sum((th / 3.0) ** 2),
        num_steps=30)
    np.testing.assert_allclose(trt, trj, rtol=1e-8)
    np.testing.assert_allclose(pt, pj, rtol=1e-8)
    np.testing.assert_array_equal(tgp.get_parameter_vector(), pt)
    assert trt[-1] > trt[0]


# ---------------------------------------------------------------------------
# Laplace
# ---------------------------------------------------------------------------


@functools.cache
def _jax_laplace_gaussian():
    """JAX's Laplace fit of the Gaussian (jax.hessian), shared by the three
    cases below."""
    mj, cj = jadvi.laplace_fit(jgauss, jnp.zeros(2), num_steps=300,
                               learning_rate=5e-2)
    return np.asarray(mj), np.asarray(cj)


@pytest.mark.parametrize("hessian", ["differences", "differences_rows",
                                     "torch.func"])
def test_laplace_gaussian_matches_jax(hessian):
    """Mode and covariance within 1e-10 of JAX's (jax.hessian): through
    central differences of the batched gradient, of a one-row
    ``value_and_grad`` taken row by row, and through torch.func.hessian of
    a closure with neither."""
    mj, cj = _jax_laplace_gaussian()
    lp = tgauss(batched=hessian == "differences")
    if hessian == "differences_rows":
        batch = tgauss().value_and_grad_batch
        lp.value_and_grad = lambda q: tuple(x[0] for x in batch(q[None]))
    mt, ct = advi.laplace_fit(lp, torch.zeros(2, dtype=torch.float64),
                              num_steps=300, learning_rate=5e-2)
    np.testing.assert_allclose(_np(mt), mj, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(_np(ct), cj, rtol=1e-10, atol=1e-12)
    assert ct.dtype == torch.float64


def _config2_pair(n=300):
    """config[2] at N points: JAX's blocked closure (one block of N, the
    fastest to compile) and the port's fused closure (the plain versions
    on the CPU), with the same parameters and Gaussian prior."""
    jgp = celerite_tpu.GP(config2_kernel(jterms))
    tgp = GP(config2_kernel(tterms), device="cpu")
    convert.load_parameters(
        tgp, jgp.get_parameter_names(include_frozen=True),
        jgp.get_parameter_vector(include_frozen=True), jgp.unfrozen_mask)
    t, y, yerr = make_data(n, seed=4, t_max=30.0)
    jlp = jgp.build_logprob(
        t, y, yerr=yerr, log_prior=lambda th: -0.5 * jnp.sum((th / 3.0) ** 2),
        solver="blocked", fast_grad=False, block_size=n)
    tlp = tgp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * torch.sum((th / 3.0) ** 2),
        solver="fused", block_size=32)
    return jgp.get_parameter_vector(), jlp, tlp


def test_laplace_gp_matches_jax():
    """config[2] at N = 300, 10 Adam steps at 2e-2: the port's fused
    closure (central differences of its exact gradient, one batched call)
    against JAX's blocked closure (the exact Hessian; ``laplace_fit``
    jitted whole): mode within 1e-7, covariance within 1e-5 relative to its
    largest entry (measured: 2.2e-14 and 2.0e-6, the differences'
    truncation through an ill-conditioned inverse)."""
    x0, jlp, tlp = _config2_pair()
    calls = []
    batch = tlp.value_and_grad_batch

    def counted(qs):
        calls.append(qs.shape[0])
        return batch(qs)

    tlp.value_and_grad_batch = counted
    mj, cj = jax.jit(lambda x: jadvi.laplace_fit(
        jlp, x, num_steps=10, learning_rate=2e-2))(jnp.asarray(x0))
    mt, ct = advi.laplace_fit(tlp, torch.as_tensor(x0), num_steps=10,
                              learning_rate=2e-2)
    assert calls == [2 * len(x0)]
    cj = np.asarray(cj)
    np.testing.assert_allclose(_np(mt), np.asarray(mj), rtol=1e-7,
                               atol=1e-9)
    assert np.abs(_np(ct) - cj).max() <= 1e-5 * np.abs(cj).max()
    np.testing.assert_allclose(_np(ct), _np(ct).T, rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------
# ADVI
# ---------------------------------------------------------------------------


def test_elbo_gradient_closed_form():
    """The closed-form ELBO gradient on fixed draws (one outside the box,
    where the log probability is -inf) equals torch autograd of the
    clamped ELBO and jax.value_and_grad of the JAX package's ELBO
    expression, within 1e-10."""
    rng = np.random.default_rng(5)
    eps = rng.standard_normal((6, 2))
    eps[2] = [40.0, -3.0]  # far outside |x| < 2.5
    v = np.array([0.4, -0.8, -0.3, 0.2])
    lp = tgauss(box=2.5)
    loss, grad = advi._neg_elbo_and_grad(lp.value_and_grad_batch,
                                         torch.as_tensor(v),
                                         torch.as_tensor(eps))

    vv = torch.as_tensor(v).requires_grad_()
    thetas = vv[:2] + torch.exp(vv[2:]) * torch.as_tensor(eps)
    lps = torch.stack([lp(r) for r in thetas.unbind(0)])
    assert not bool(torch.isfinite(lps).all())
    lps = torch.where(torch.isfinite(lps), lps, -1e10)
    ad_loss = -(torch.mean(lps) + torch.sum(vv[2:]))
    (ad_grad,) = torch.autograd.grad(ad_loss, vv)

    def jlp(x):
        return jnp.where(jnp.all(jnp.abs(x) < 2.5), jgauss(x), -jnp.inf)

    def jneg_elbo(w):
        mu, log_sigma = w[:2], w[2:]
        lp_ = jax.vmap(jlp)(mu + jnp.exp(log_sigma) * jnp.asarray(eps))
        lp_ = jnp.where(jnp.isfinite(lp_), lp_, -1e10)
        return -(jnp.mean(lp_) + jnp.sum(log_sigma))

    j_loss, j_grad = jax.jit(jax.value_and_grad(jneg_elbo))(jnp.asarray(v))
    for want_loss, want_grad in ((float(ad_loss.detach()), _np(ad_grad)),
                                 (float(j_loss), np.asarray(j_grad))):
        np.testing.assert_allclose(float(loss), want_loss, rtol=1e-10)
        np.testing.assert_allclose(_np(grad), want_grad, rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("batched", [True, False])
def test_fit_advi_gaussian(batched):
    """tests/test_inference.py's Gaussian and bars (1500 steps, 8 draws):
    mu within 0.15, sigma within 25% of 1/sqrt(diag(precision)), the ELBO
    improving; through the batched entry (one call of the 8 draws a step)
    and autograd row by row."""
    gen = torch.Generator().manual_seed(2)
    lp = tgauss(batched=batched)
    rows = []
    if batched:
        batch = lp.value_and_grad_batch

        def counted(qs):
            rows.append(qs.shape[0])
            return batch(qs)

        lp.value_and_grad_batch = counted
    res = advi.fit_advi(lp, torch.zeros(2, dtype=torch.float64), gen,
                        num_steps=1500, num_mc=8, learning_rate=5e-2)
    assert rows == ([8] * 1500 if batched else [])
    np.testing.assert_allclose(_np(res.mu), MU, atol=0.15)
    np.testing.assert_allclose(_np(res.sigma), 1.0 / np.sqrt(np.diag(PREC)),
                               rtol=0.25)
    elbo = _np(res.elbo_trace)
    assert elbo.shape == (1500,)
    assert elbo[-100:].mean() > elbo[:100].mean()
    draws = res.sample(torch.Generator().manual_seed(3), 4000)
    assert draws.shape == (4000, 2)
    np.testing.assert_allclose(_np(draws.std(0)), _np(res.sigma), rtol=0.1)


# ---------------------------------------------------------------------------
# SMC
# ---------------------------------------------------------------------------


def _log_likes():
    rng = np.random.default_rng(6)
    a = rng.standard_normal(257) * 40.0 - 300.0
    b = a.copy()
    b[::17] = -1e12  # non-finite likelihoods, made safe
    c = rng.standard_normal(64) * 0.01  # flat: a full step
    return [a, b, c]


@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("beta", [0.0, 0.37])
def test_ess_and_next_beta_match_jax(case, beta):
    """``_ess`` and the 30-bisection temperature search against JAX's on
    the same log-likelihoods, within 1e-12."""
    ll = _log_likes()[case]
    lw = 0.013 * ll
    np.testing.assert_allclose(float(smc._ess(torch.as_tensor(lw))),
                               float(jsmc._ess(jnp.asarray(lw))), rtol=1e-12)
    bt = smc._find_next_beta(torch.as_tensor(ll),
                             torch.tensor(beta, dtype=torch.float64), 0.5)
    bj = jsmc._find_next_beta(jnp.asarray(ll), jnp.asarray(beta), 0.5)
    np.testing.assert_allclose(float(bt), float(bj), rtol=1e-12, atol=1e-15)
    assert float(bt) > beta


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_systematic_indices_match_jax(seed):
    """The indices for JAX's own uniform draw: equal to JAX's
    ``systematic_resample``."""
    key = jax.random.PRNGKey(seed)
    lw = np.random.default_rng(seed).standard_normal(300) * 3.0
    lw[::7] = -1e12
    u = jax.random.uniform(key, (), jnp.float64)
    want = np.asarray(jsmc.systematic_resample(key, jnp.asarray(lw)))
    got = smc._systematic_indices(torch.as_tensor(lw),
                                  torch.tensor(float(u), dtype=torch.float64))
    np.testing.assert_array_equal(got.numpy(), want)
    gen = torch.Generator().manual_seed(seed)
    idx = smc.systematic_resample(gen, torch.as_tensor(lw))
    assert idx.shape == (300,) and int(idx.min()) >= 0
    assert int(idx.max()) < 300


def _wide_prior(scale):
    def log_prior(x):
        return -0.5 * torch.sum(x**2) / scale**2

    log_prior.value_and_grad_batch = lambda qs: (
        -0.5 * torch.sum(qs**2, dim=-1) / scale**2, -qs / scale**2)
    return log_prior


def test_smc_gaussian():
    """tests/test_inference.py's set-up: 512 particles, 4 mutations at 0.5;
    the particle mean within 0.35 of the posterior mean."""
    rng = np.random.default_rng(3)
    init = torch.as_tensor(rng.standard_normal((512, 2)) * 3.0)
    res = smc.sample_smc(_wide_prior(5.0), tgauss(), init,
                         torch.Generator().manual_seed(3), num_mutations=4,
                         hmc_step_size=0.5)
    np.testing.assert_allclose(_np(res.particles.mean(0)), MU, atol=0.35)
    assert res.num_stages >= 1 and res.betas.shape == (res.num_stages,)
    assert bool((torch.diff(res.betas) > 0).all()) and float(
        res.betas[-1]) == 1.0
    assert 0.0 < float(res.final_accept) <= 1.0


def test_smc_bimodal():
    """Both modes of a well-separated mixture survive: the left fraction in
    (0.2, 0.8) (1024 particles, 5 mutations at 0.3)."""
    rng = np.random.default_rng(4)
    init = torch.as_tensor(rng.standard_normal((1024, 1)) * 6.0)
    centers = torch.tensor([-4.0, 4.0], dtype=torch.float64)

    def log_like(x):
        return torch.logsumexp(-0.5 * (x[0] - centers) ** 2 / 0.25, dim=0)

    def like_batch(qs):
        r = -0.5 * (qs - centers) ** 2 / 0.25  # (n, 2)
        w = torch.softmax(r, dim=-1)
        return (torch.logsumexp(r, dim=-1),
                torch.sum(w * -(qs - centers) / 0.25, dim=-1, keepdim=True))

    log_like.value_and_grad_batch = like_batch
    res = smc.sample_smc(_wide_prior(6.0), log_like, init,
                         torch.Generator().manual_seed(4), num_mutations=5,
                         hmc_step_size=0.3)
    frac_left = float(torch.mean((res.particles[:, 0] < 0).double()))
    assert 0.2 < frac_left < 0.8


def test_smc_log_evidence_analytic():
    """Particles drawn from a normalised N(0, 5^2 I) prior, the unnormalised
    Gaussian likelihood: log Z = log[(2 pi)^(d/2) |COV|^(1/2)
    N(MU; 0, 25 I + COV)].  Bar: 4 sqrt(S / n), four times the standard
    error of an adaptive estimate at ESS fraction 1/2 (each of the S
    stages' incremental weights contributes a variance ~(1/rho - 1) / n =
    1 / n)."""
    n, s2 = 1024, 25.0
    rng = np.random.default_rng(8)
    init = torch.as_tensor(rng.standard_normal((n, 2)) * 5.0)
    prior = _wide_prior(5.0)

    def log_prior(x):
        return prior(x) - math.log(2 * math.pi * s2)

    log_prior.value_and_grad_batch = lambda qs: (
        prior.value_and_grad_batch(qs)[0] - math.log(2 * math.pi * s2),
        prior.value_and_grad_batch(qs)[1])
    res = smc.sample_smc(log_prior, tgauss(), init,
                         torch.Generator().manual_seed(8), num_mutations=4,
                         hmc_step_size=0.5)
    tot = s2 * np.eye(2) + COV
    log_n = -0.5 * (MU @ np.linalg.solve(tot, MU)
                    + np.log(np.linalg.det(2 * np.pi * tot)))
    want = np.log(2 * np.pi) + 0.5 * np.log(np.linalg.det(COV)) + log_n
    bar = 4.0 * math.sqrt(res.num_stages / n)
    assert abs(float(res.log_evidence) - want) < bar


def test_smc_batched_entry_matches_autograd():
    """The same prior and likelihood with and without their batched entries
    (autograd row by row), one generator seed (the JAX package's
    test_smc_fused_path_matches_ad): equal stage counts, evidence within
    rtol 1e-6, and each leapfrog one batched call of the cloud."""
    init = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (128, 2))) * 5.0
    like = tgauss()
    rows = []
    batch = like.value_and_grad_batch

    def counted(qs):
        rows.append(qs.shape[0])
        return batch(qs)

    like.value_and_grad_batch = counted
    r1 = smc.sample_smc(_wide_prior(5.0), like, init,
                        torch.Generator().manual_seed(5))
    r2 = smc.sample_smc(lambda x: -0.5 * torch.sum(x**2) / 25.0,
                        tgauss(batched=False), init,
                        torch.Generator().manual_seed(5))
    assert set(rows) == {128}
    assert r1.num_stages == r2.num_stages
    np.testing.assert_allclose(float(r1.log_evidence),
                               float(r2.log_evidence), rtol=1e-6)
    r3 = smc.sample_smc(_wide_prior(5.0), like, init,
                        torch.Generator().manual_seed(5), host_loop=True)
    np.testing.assert_array_equal(r3.particles.numpy(),
                                  r1.particles.numpy())


# ---------------------------------------------------------------------------
# Checkpoints and examples
# ---------------------------------------------------------------------------


def test_checkpoint_round_trip(tmp_path):
    gen = torch.Generator().manual_seed(9)
    torch.rand(3, generator=gen)
    state = checkpoint.SamplerState.create(
        torch.randn(4, 3, dtype=torch.float64), torch.tensor(0.25),
        np.ones(3), gen, iteration=120)
    path = tmp_path / "state.npz"
    state.save(path)
    back = checkpoint.SamplerState.load(path)
    assert sorted(back) == sorted(state)
    for k in state:
        np.testing.assert_array_equal(back[k], state[k])
    assert back["rng_key"].dtype == np.uint8
    resumed = torch.Generator()
    resumed.set_state(torch.from_numpy(back["rng_key"]))
    assert torch.equal(torch.rand(5, generator=resumed),
                       torch.rand(5, generator=gen))
    nested = {"chains": [torch.arange(3.0), np.eye(2)], "step": 0.1}
    checkpoint.save_state(tmp_path / "nested.npz", nested, meta={"r": 1})
    flat, meta = checkpoint.load_state(tmp_path / "nested.npz")
    assert meta == {"r": 1}
    assert sorted(flat) == ["chains[0]", "chains[1]", "step"]
    np.testing.assert_array_equal(flat["chains[1]"], np.eye(2))


def test_checkpoint_reads_jax_file(tmp_path):
    """A file the JAX package's ``save_state`` wrote loads in the port's
    ``load_state`` (and ``SamplerState.load``) with equal arrays."""
    rng = np.random.default_rng(1)
    state = jckpt.SamplerState.create(
        rng.standard_normal((4, 7)), 0.031, rng.random(7),
        jax.random.PRNGKey(3), iteration=500)
    path = tmp_path / "jax_state.npz"
    jckpt.save_state(path, dict(state), meta={"warmup": 500})
    flat, meta = checkpoint.load_state(path)
    want, want_meta = jckpt.load_state(path)
    assert meta == want_meta == {"warmup": 500}
    assert sorted(flat) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(flat[k], want[k])
    back = checkpoint.SamplerState.load(path)
    np.testing.assert_array_equal(back["positions"], state["positions"])


def test_example_config0_on_cpu():
    from celerite_torch.examples import config0_realterm_nuts

    chains, info = config0_realterm_nuts.main(n=16, num_warmup=3,
                                              num_samples=4, device="cpu")
    assert chains.shape == (4, 4, 2)
    assert bool(torch.isfinite(chains).all())


def test_example_config3_on_cpu():
    from celerite_torch.examples import config3_complex_advi

    out = config3_complex_advi.main(n=32, num_steps=10, device="cpu")
    assert out["advi"].elbo_trace.shape == (10,)
    assert np.isfinite(out["drift_sd"])
    cov = _np(out["cov"])
    np.testing.assert_allclose(cov, cov.T, atol=1e-12)
