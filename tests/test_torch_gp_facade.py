"""The port's GP solver surface against the JAX package's GP.

``celerite_torch.GP(kernel, device="cpu")`` and ``celerite_tpu.GP(kernel)``
on the same model (config[2], padded width 8, with a constant mean) and
data: ``apply_inverse`` (one and three right-hand sides), ``dot`` (at the
computed coordinates and at others), ``predict`` (the mean with and without
``t``, and ``return_cov``), ``get_matrix`` (square with its diagonal, and
rectangular) and ``sample(seed=...)``, each within 1e-10 of the JAX
package's relative to its largest entry, at N = 300 (the native core where
g++ is there) and N = 5000 (the sequential solver).  Also the shape of
``sample_conditional``, ``dirty`` / ``computed`` after a parameter change,
a pickle round trip, ``predict(return_var=True)`` (the Kalman/RTS
smoother) within 1e-10 of the JAX package's, and, without CUDA, a GP with no device raising on ``compute``,
``apply_inverse``, ``predict`` and ``sample``.
"""

import pickle

import numpy as np
import pytest
import torch

import celerite_tpu
from celerite_tpu import terms as jterms
import celerite_torch
from celerite_torch import terms as tterms
from celerite_torch.testing import config2_kernel, make_data

TOL = 1e-10


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=TOL,
                               atol=TOL * float(np.abs(want).max()))


def _pair(n, seed=1):
    t, y, yerr = make_data(n, seed=seed, t_max=n / 10.0)
    jgp = celerite_tpu.GP(config2_kernel(jterms), mean=0.3)
    tgp = celerite_torch.GP(config2_kernel(tterms), mean=0.3, device="cpu")
    jgp.compute(t, yerr)
    tgp.compute(t, yerr)
    return jgp, tgp, t, y


@pytest.mark.parametrize("n", [300, 5000])
def test_facade_matches_jax(n):
    jgp, tgp, t, y = _pair(n)
    Y = np.random.default_rng(2).standard_normal((n, 3))
    x = np.sort(np.random.default_rng(3).uniform(-1.0, n / 10.0 + 1.0, 40))
    _close(tgp.apply_inverse(y), jgp.apply_inverse(y))
    _close(tgp.apply_inverse(Y), jgp.apply_inverse(Y))
    _close(tgp.dot(y), jgp.dot(y))
    _close(tgp.dot(Y[:40, :2], t=x), jgp.dot(Y[:40, :2], t=x))
    _close(tgp.predict(y, return_cov=False), jgp.predict(y, return_cov=False))
    _close(tgp.predict(y, x, return_cov=False),
           jgp.predict(y, x, return_cov=False))
    mu, cov = tgp.predict(y, x[:12])
    jmu, jcov = jgp.predict(y, x[:12])
    _close(mu, jmu)
    _close(cov, jcov)
    _close(tgp.get_matrix(x, t[:30]), jgp.get_matrix(x, t[:30]))
    _close(tgp.get_matrix(x, include_diagonal=True),
           jgp.get_matrix(x, include_diagonal=True))
    if n == 300:
        _close(tgp.get_matrix(), jgp.get_matrix())
    _close(tgp.sample(seed=5), jgp.sample(seed=5))
    _close(tgp.sample(size=3, seed=5), jgp.sample(size=3, seed=5))


def test_state_pickling_and_conditional():
    """``dirty`` / ``computed`` follow a parameter change and the next
    solve refactors; a computed GP pickles; ``sample_conditional`` draws
    (size, M); ``return_var=True`` (the Kalman/RTS smoother) gives the JAX
    package's mean and variance."""
    jgp, tgp, t, y = _pair(200, seed=4)
    assert tgp.computed and not tgp.dirty
    before = tgp.apply_inverse(y)
    tgp.set_parameter_vector(tgp.get_parameter_vector() + 0.05)
    jgp.set_parameter_vector(jgp.get_parameter_vector() + 0.05)
    assert tgp.dirty and not tgp.computed
    after = tgp.apply_inverse(y)
    assert tgp.computed and not np.allclose(after, before)
    _close(after, jgp.apply_inverse(y))
    tgp2 = pickle.loads(pickle.dumps(tgp))
    assert tgp2.computed
    np.testing.assert_array_equal(tgp2.apply_inverse(y), after)
    x = np.linspace(0.0, 20.0, 7)
    np.random.seed(0)
    assert tgp.sample_conditional(y, x, size=4).shape == (4, 7)
    assert tgp.sample_conditional(y, x).shape == (7,)
    mu, var = tgp.predict(y, x, return_var=True)
    jmu, jvar = jgp.predict(y, x, return_var=True)
    _close(mu, jmu)
    _close(var, jvar)


def test_no_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    t, y, yerr = make_data(50)
    gp = celerite_torch.GP(config2_kernel(tterms))
    for call in (lambda: gp.compute(t, yerr), lambda: gp.apply_inverse(y),
                 lambda: gp.predict(y, t[:5]), lambda: gp.sample(seed=1)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
