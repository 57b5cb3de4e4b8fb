"""The port's Kalman/RTS smoother against the JAX package's (CPU, float64).

``celerite_torch.ops.smoother`` / ``ops.pkalman`` and
``celerite_tpu.ops.smoother`` / ``ops.pkalman`` on the same inputs, made
from a seed with numpy: ``realize`` (the same ``None``s, Pinf and H within
1e-14) on config[1]'s SHO, config[2]'s kernel, a Real + Complex stack, an
overdamped SHO and a product of SHOs that is positive definite only as a
whole; the sequential, flat associative-scan and blocked engines against
JAX's sequential engine (jitted) and its blocked one, and against each
other, on ragged grids with missing points, explicit block lengths, and an
all-observed grid with duplicate times (mean and var ``rtol=1e-9,
atol=1e-11``, ll ``rtol=1e-11``, the JAX suite's bars); ``predict_var``
and ``predict_var_parallel`` against JAX's ``predict_var``; the device
merges (searchsorted and stable argsort) bit for bit; ``GP.predict(...,
return_var=True)`` against JAX's GP at N = 300 with and without ``t``, the
unrealizable product on the dense fallback, within 1e-9; ``sample_prior``
with one seed within 1e-10; ``kalman_log_likelihood`` against the GP's ll.
JAX's flat ``parallel_filter_smoother`` is left out: its compile is
minutes long (tests/test_pkalman.py marks it slow); the port's flat engine
is held against JAX's two others.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import celerite_tpu
from celerite_tpu.ops import pkalman as jpk
from celerite_tpu.ops import smoother as jsm
from celerite_tpu.ops.lower import Coefficients as JCoefficients
import celerite_torch
from celerite_torch.ops import pkalman, smoother
from celerite_torch.ops.lower import Coefficients

MOMENTS = dict(rtol=1e-9, atol=1e-11)
LL_RTOL = 1e-11
GP_TOL = 1e-9


def _kernel(T, name):
    t = T.terms
    if name == "config1":
        return t.SHOTerm(log_S0=-0.5, log_Q=1.5, log_omega0=np.log(2.5))
    if name == "config2":
        return (t.SHOTerm(log_S0=0.5, log_Q=np.log(1 / np.sqrt(2)),
                          log_omega0=0.0)
                + t.SHOTerm(log_S0=-1.0, log_Q=2.5, log_omega0=1.8)
                + t.JitterTerm(log_sigma=-1.5))
    if name == "real_complex":
        return (t.RealTerm(log_a=np.log(0.7), log_c=np.log(0.9))
                + t.ComplexTerm(log_a=np.log(0.8), log_b=np.log(0.2),
                                log_c=np.log(0.6), log_d=np.log(1.9)))
    if name == "overdamped":
        return (t.SHOTerm(log_S0=0.1, log_Q=-1.0, log_omega0=0.5)
                + t.RealTerm(log_a=-0.3, log_c=0.0))
    # Positive definite as a whole, but its second complex term has
    # a c < b d: no independent Gauss-Markov realization.
    return (t.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=0.5)
            * t.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=1.5))


KERNELS = ["config1", "config2", "real_complex", "overdamped",
           "unrealizable"]


def _coeffs(name):
    jk, tk = _kernel(celerite_tpu, name), _kernel(celerite_torch, name)
    jc = JCoefficients(*[jnp.asarray(c) for c in jk.coefficients],
                       jitter=jnp.asarray(jk.jitter))
    return jc, Coefficients(*tk.coefficients, jitter=tk.jitter)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


@pytest.mark.parametrize("name", KERNELS)
def test_realize_matches_jax(name):
    jc, tc = _coeffs(name)
    jr, tr = jsm.realize(jc), smoother.realize(tc)
    assert (jr is None) == (tr is None) == (name == "unrealizable")
    if tr is not None:
        assert (tr.p, tr.jr, tr.jc) == (jr.p, jr.jr, jr.jc)
        _close(tr.Pinf, jr.Pinf, rtol=0, atol=1e-14)
        _close(tr.H, jr.H, rtol=0, atol=1e-14)


# ---- the engines on one merged grid ------------------------------------

def _grid(n, seed, missing=0.3):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 20.0, n))
    dt = np.concatenate([[0.0], np.diff(t)])
    yv = np.sin(0.7 * t) + 0.1 * rng.standard_normal(n)
    rv = 0.05 + 0.02 * rng.random(n)
    obs = (rng.random(n) > missing).astype(float)
    return dt, yv * obs, np.where(obs > 0, rv, 1.0), obs


def _duplicates():
    """All observed, with a time three times over."""
    rng = np.random.default_rng(3)
    t = np.sort(np.concatenate([rng.uniform(0, 5.0, 100), [2.0, 2.0, 2.0]]))
    dt = np.concatenate([[0.0], np.diff(t)])
    return dt, np.cos(t), np.full(t.shape, 0.04), np.ones(t.shape)


# (n, L) of tests/test_pkalman.py:99, then the duplicate-time grid; JAX's
# blocked engine (a compile of seconds each) on the marked ones.
CASES = {"257": ((257, None), False), "1024_64": ((1024, 64), True),
         "1000_128": ((1000, 128), False), "64_16": ((64, 16), True),
         "duplicates": ((None, 32), True)}
_REFS = {}


def _case(case):
    """The grid, the block length and JAX's results on it (cached)."""
    if case not in _REFS:
        (n, L), with_blocked = CASES[case]
        grid = _duplicates() if n is None else _grid(n, seed=n)
        jreal = jsm.realize(_coeffs("real_complex")[0])
        args = [jnp.asarray(x) for x in grid]
        refs = {"seq": jax.jit(
            lambda *a: jsm._filter_smoother(jreal, *a))(*args)}
        if with_blocked:
            refs["blocked"] = jpk.blocked_filter_smoother(jreal, *args,
                                                          block_size=L)
        _REFS[case] = grid, L, {k: [np.asarray(x) for x in v]
                                for k, v in refs.items()}
    return _REFS[case]


def _engine(name, real_, grid, L):
    args = [torch.as_tensor(x) for x in grid]
    if name == "seq":
        return smoother._filter_smoother(real_, *args)
    if name == "parallel":
        return pkalman.parallel_filter_smoother(real_, *args)
    return pkalman.blocked_filter_smoother(real_, *args, block_size=L)


def _same_results(got, want):
    _close(got[0], want[0], **MOMENTS)
    _close(got[1], want[1], **MOMENTS)
    _close(got[2], want[2], rtol=LL_RTOL)


@pytest.mark.parametrize("engine", ["seq", "parallel", "blocked"])
@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_jax(case, engine):
    grid, L, refs = _case(case)
    real_ = smoother.realize(_coeffs("real_complex")[1])
    got = [x.numpy() for x in _engine(engine, real_, grid, L)]
    for ref in refs.values():
        _same_results(got, ref)
    if engine != "seq":
        _same_results(got, [x.numpy() for x in
                            _engine("seq", real_, grid, L)])
    assert np.all(got[1] >= 0)


# ---- predictive variance -------------------------------------------------

def _train(n=200, seed=7):
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 10.0, n))
    diag = np.full(n, 0.04)
    resid = np.sin(0.8 * t) + 0.2 * rng.standard_normal(n)
    return t, diag, resid


@pytest.mark.parametrize("name", ["config2", "overdamped"])
def test_predict_var_matches_jax(name):
    """Both entry points against JAX's ``predict_var``, the test grid past
    both ends of the data and unsorted."""
    jc, tc = _coeffs(name)
    t, diag, resid = _train()
    t_test = np.random.default_rng(8).permutation(np.linspace(-0.5, 10.5, 64))
    jmu, jvar = jsm.predict_var(jc, t, diag, resid, t_test)
    for engine in (smoother.predict_var, pkalman.predict_var_parallel):
        mu, var = engine(tc, t, diag, resid, t_test, device="cpu")
        _close(mu, jmu, **MOMENTS)
        _close(var, jvar, **MOMENTS)
        assert np.all(var >= 0)


def test_device_merges_agree_bit_for_bit():
    """The searchsorted merge (sorted test times) and the stable argsort
    give one grid: equal results, ties putting train points first, test
    times on the data, repeated and past both ends; shuffled test times
    give the same results in their order."""
    tc = _coeffs("config2")[1]
    real_ = smoother.realize(tc)
    t, diag, resid = _train(n=150, seed=9)
    t_test = np.sort(np.concatenate([t[::10], t[::25], [-1.0, 11.0],
                                     np.linspace(0.0, 10.0, 40)]))
    args = [torch.as_tensor(x) for x in (t, diag, resid, t_test)]
    engine = functools.partial(pkalman.blocked_filter_smoother,
                               block_size=16)
    a = pkalman._predict_var_device(real_, *args, 0.01, engine,
                                    sorted_test=True)
    b = pkalman._predict_var_device(real_, *args, 0.01, engine,
                                    sorted_test=False)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    # Shuffled, the argsort merge builds the same grid; repeated test
    # times may swap places among themselves, and neighbours at dt = 0
    # differ by the regularized gain's error (~1e-9 of the scale).
    perm = np.random.default_rng(1).permutation(len(t_test))
    c = pkalman._predict_var_device(real_, *args[:3],
                                    torch.as_tensor(t_test[perm]), 0.01,
                                    engine)
    for x, y in zip(a, c):
        _close(x[perm].numpy(), y.numpy(), rtol=0,
               atol=1e-9 * float(y.abs().max()))
    mu, var = smoother.predict_var(tc._replace(jitter=0.01), t, diag, resid,
                                   t_test, device="cpu")
    _close(a[0].numpy(), mu, **MOMENTS)
    _close(a[1].numpy(), var, **MOMENTS)


@pytest.mark.parametrize("name,given", [
    ("config1", True), ("config2", False), ("unrealizable", True),
    ("unrealizable", False)])
def test_gp_predict_var_matches_jax(name, given):
    """``GP.predict(return_var=True)`` at N = 300, a constant mean, on
    the smoother (realizable) or the dense fallback (the product)."""
    rng = np.random.default_rng(1)
    n = 300
    t = np.sort(rng.uniform(0, 30, n))
    yerr = rng.uniform(0.1, 0.3, n)
    y = 0.2 + np.sin(t) + 0.1 * rng.standard_normal(n)
    x = np.linspace(-1.0, 31.0, 77) if given else None
    jgp = celerite_tpu.GP(_kernel(celerite_tpu, name), mean=0.2)
    tgp = celerite_torch.GP(_kernel(celerite_torch, name), mean=0.2,
                            device="cpu")
    jgp.compute(t, yerr)
    tgp.compute(t, yerr)
    jmu, jvar = jgp.predict(y, x, return_var=True)
    mu, var = tgp.predict(y, x, return_var=True)
    assert mu.shape == var.shape == (n if x is None else len(x),)
    for got, want in ((mu, jmu), (var, jvar)):
        _close(got, want, rtol=GP_TOL,
               atol=GP_TOL * float(np.abs(want).max()))
    assert np.all(var >= 0)
    assert np.all(var <= tgp.kernel.get_value(0.0) * (1 + 1e-12))


def test_gp_predict_var_cpu_takes_sequential(monkeypatch):
    """On the CPU the sequential engine, as in the JAX package off the
    TPU."""
    def refuse(*args, **kwargs):
        raise AssertionError("blocked engine called on the CPU")

    monkeypatch.setattr(pkalman, "predict_var_parallel", refuse)
    gp = celerite_torch.GP(_kernel(celerite_torch, "config1"), device="cpu")
    t = np.linspace(0.0, 10.0, 50)
    gp.compute(t, 0.1)
    mu, var = gp.predict(np.sin(t), t[:7] + 0.05, return_var=True)
    assert np.all(np.isfinite(mu)) and np.all(var > 0)


def test_sample_prior_matches_jax():
    jc, tc = _coeffs("config2")
    t = np.sort(np.random.default_rng(4).uniform(0, 100.0, 2000))
    want = jsm.sample_prior(jc, t, seed=11)
    _close(smoother.sample_prior(tc, t, seed=11, device="cpu"), want,
           rtol=0, atol=1e-10 * float(np.abs(want).max()))
    got = smoother.sample_prior(tc, t, rng=np.random.default_rng(11),
                                device="cpu")
    _close(got, want, rtol=0, atol=1e-10 * float(np.abs(want).max()))
    with pytest.raises(ValueError):
        smoother.sample_prior(_coeffs("unrealizable")[1], t, seed=1,
                              device="cpu")


def test_kalman_log_likelihood_matches_gp():
    """The filter's ll against the GP's (the JAX suite's bar, 1e-8) and
    the blocked engine's on the same grid."""
    tc = _coeffs("config2")[1]
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 20, 200))
    yerr = rng.uniform(0.1, 0.3, 200)
    y = np.sin(t)
    ll = float(smoother.kalman_log_likelihood(tc, t, yerr**2, y,
                                              device="cpu"))
    gp = celerite_torch.GP(_kernel(celerite_torch, "config2"), device="cpu")
    gp.compute(t, yerr)
    np.testing.assert_allclose(ll, gp.log_likelihood(y), rtol=1e-8)
    grid = [torch.as_tensor(x) for x in (
        np.concatenate([[0.0], np.diff(t)]), y, yerr**2 + tc.jitter,
        np.ones_like(t))]
    _, _, ll_b = pkalman.blocked_filter_smoother(smoother.realize(tc), *grid)
    np.testing.assert_allclose(float(ll_b), ll, rtol=LL_RTOL)
    with pytest.raises(ValueError):
        smoother.kalman_log_likelihood(_coeffs("unrealizable")[1], t,
                                       yerr**2, y, device="cpu")
