"""The JAX package's compatibility options on celerite_torch.GP, port only.

``build_loglik`` / ``build_logprob`` with ``fast_compile=True`` (JAX's
meaning, celerite_tpu/gp.py:341-343, :426: the plain block-parallel
solver, plain autodiff, exact mode off the forward-mode kernels), the
deprecated ``GP(log_white_noise=..., fit_white_noise=...)``
(celerite_tpu/gp.py:82-89) and the package's ``__library_version__``.
Each case is held against the port's own explicit spelling of the same
thing, so no JAX runs here; everything runs with ``device="cpu"`` in
float64.
"""

import numpy as np
import pytest
import torch

import celerite_torch
from celerite_torch import GP, terms
from celerite_torch.testing import make_data


def sho():
    return terms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)


def value_and_grad(fn, theta):
    theta = theta.clone().requires_grad_()
    ll, ok = fn(theta)
    (grad,) = torch.autograd.grad(ll, theta)
    return float(ll.detach()), bool(ok), grad.numpy()


@pytest.mark.parametrize("solver", ["auto", "fused", "seq"])
def test_fast_compile_is_blocked_without_fast_grad(solver):
    t, y, yerr = make_data(300, seed=3)
    gp = GP(sho(), device="cpu")
    fast = gp.build_loglik(t, y, yerr=yerr, solver=solver, fast_grad=True,
                           fast_compile=True)
    plain = gp.build_loglik(t, y, yerr=yerr, solver="blocked",
                            fast_grad=False)
    assert fast.route == plain.route == "blocked"
    theta = torch.as_tensor(gp.get_parameter_vector())
    v1, ok1, g1 = value_and_grad(fast, theta)
    v2, ok2, g2 = value_and_grad(plain, theta)
    assert ok1 and ok2
    assert v1 == v2
    np.testing.assert_array_equal(g1, g2)


def test_fast_compile_keeps_exact_mode_off_the_kernels():
    t, y, yerr = make_data(2048, seed=4)
    gp = GP(sho(), device="cpu")
    assert gp.build_loglik(t, y, yerr=yerr, precision="ds").route == "dsfused"
    fast = gp.build_loglik(t, y, yerr=yerr, precision="ds",
                           fast_compile=True)
    assert fast.route == "blocked"
    assert not hasattr(fast, "value_ok_grad")


def test_build_logprob_passes_fast_compile_on():
    t, y, yerr = make_data(300, seed=5)
    gp = GP(sho(), device="cpu")
    lp = gp.build_logprob(t, y, yerr=yerr, solver="fused", fast_compile=True)
    plain = gp.build_logprob(t, y, yerr=yerr, solver="blocked",
                             fast_grad=False)
    assert lp.loglik.route == "blocked"
    assert not hasattr(lp, "value_and_grad")
    theta = torch.as_tensor(gp.get_parameter_vector())
    assert float(lp(theta)) == float(plain(theta))


@pytest.mark.parametrize("fit_white_noise", [False, True])
def test_log_white_noise_appends_a_jitter_term(fit_white_noise):
    t, y, yerr = make_data(40, seed=6)
    with pytest.warns(UserWarning, match="log_white_noise"):
        gp = GP(sho(), 0.0, False, -1.0, fit_white_noise, device="cpu")
    jt = terms.JitterTerm(log_sigma=-1.0)
    if not fit_white_noise:
        jt.freeze_parameter("log_sigma")
    ref = GP(sho() + jt, device="cpu")
    assert gp.get_parameter_names() == ref.get_parameter_names()
    assert gp.kernel.jitter == pytest.approx(np.exp(-2.0), rel=1e-15)
    names = gp.get_parameter_names()
    assert ("kernel:terms[1]:log_sigma" in names) == fit_white_noise
    gp.compute(t, yerr)
    ref.compute(t, yerr)
    ll = gp.log_likelihood(y)
    assert np.isfinite(ll)
    assert ll == pytest.approx(ref.log_likelihood(y), rel=1e-13)


def test_library_version_is_exported():
    assert celerite_torch.__library_version__ == \
        celerite_torch.solver.__library_version__
    assert "__library_version__" in celerite_torch.__all__
