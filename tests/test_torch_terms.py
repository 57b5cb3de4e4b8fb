"""celerite_torch.terms held against celerite_tpu.terms on the same parameters.

Every term is built in both packages from one builder; padded and eager
coefficients, jitter, k(tau), the PSD, the Sturm check and the coefficient
jacobian must agree.  Tolerance 1e-13: both sides evaluate the same float64
expressions, so only the last bits of exp/sqrt may differ.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celerite_tpu import terms as jterms
from celerite_torch import terms as tterms

RTOL = 1e-13

BUILDERS = {
    "real": lambda T: T.RealTerm(log_a=0.1, log_c=0.5),
    "complex": lambda T: T.ComplexTerm(log_a=0.1, log_c=0.5, log_d=0.1),
    "complex_b": lambda T: T.ComplexTerm(
        log_a=0.1, log_b=-0.2, log_c=0.5, log_d=0.1),
    "sho_over": lambda T: T.SHOTerm(log_S0=0.1, log_Q=-1.0, log_omega0=0.5),
    "sho_under": lambda T: T.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5),
    "sho_half": lambda T: T.SHOTerm(
        log_S0=0.1, log_Q=np.log(0.5), log_omega0=0.5),
    "sho_near_half": lambda T: T.SHOTerm(
        log_S0=0.1, log_Q=np.log(0.5) - 1e-3, log_omega0=0.5),
    "matern": lambda T: T.Matern32Term(log_sigma=0.1, log_rho=0.4),
    "jitter": lambda T: T.JitterTerm(log_sigma=-1.0),
    "sum": lambda T: (
        T.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
        + T.RealTerm(log_a=0.1, log_c=0.4)
        + T.JitterTerm(log_sigma=-1.5)
    ),
    "product": lambda T: (
        T.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
        * T.RealTerm(log_a=0.1, log_c=0.4)
    ),
    "product_cc": lambda T: (
        T.SHOTerm(log_S0=0.1, log_Q=0.8, log_omega0=0.5)
        * T.ComplexTerm(log_a=0.2, log_b=-0.1, log_c=0.3, log_d=0.4)
    ),
    "config2": lambda T: (
        T.SHOTerm(log_S0=0.2, log_Q=-0.3, log_omega0=0.2)
        + T.SHOTerm(log_S0=-0.7, log_Q=2.0, log_omega0=1.6)
        + T.JitterTerm(log_sigma=-1.0)
    ),
}

NAMES = sorted(BUILDERS)


def _pair(name):
    return BUILDERS[name](jterms), BUILDERS[name](tterms)


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a, np.float64),
                               np.asarray(b, np.float64), rtol=rtol, atol=atol)


@pytest.mark.parametrize("name", NAMES)
def test_padded_coefficients_and_jitter(name):
    jt, tt = _pair(name)
    v = jt.get_parameter_vector(include_frozen=True)
    jc = jt.get_padded_coefficients(jnp.asarray(v))
    tc = tt.get_padded_coefficients(torch.as_tensor(v))
    assert len(jc) == len(tc) == 6
    for a, b in zip(jc, tc):
        assert b.shape == tuple(np.shape(a))
        _close(a, b.numpy())
    _close(jt.get_jitter(jnp.asarray(v)), tt.get_jitter(torch.as_tensor(v)))
    assert tt.padded_size == jt.padded_size


@pytest.mark.parametrize("name", NAMES)
def test_eager_coefficients_value_psd(name):
    jt, tt = _pair(name)
    for a, b in zip(jt.coefficients, tt.coefficients):
        _close(a, b)
    assert tt.jitter == pytest.approx(jt.jitter, rel=RTOL)
    tau = np.linspace(0.0, 5.0, 23)
    _close(jt.get_value(tau), tt.get_value(tau), rtol=1e-12)
    omega = np.linspace(0.0, 4.0, 19)
    _close(jt.get_psd(omega), tt.get_psd(omega), rtol=1e-12)
    assert bool(tt.check_parameters()) == bool(jt.check_parameters())


@pytest.mark.parametrize("name", [n for n in NAMES if n not in
                                  ("jitter", "sho_half")])
def test_coeffs_jacobian(name):
    jt, tt = _pair(name)
    ja = jt.get_coeffs_jacobian(include_frozen=True)
    # Entries that are zero analytically may come out as rounding noise.
    _close(ja, tt.get_coeffs_jacobian(include_frozen=True), rtol=1e-12,
           atol=1e-14 * np.abs(ja).max())


def test_padded_autograd_across_sho_branch():
    """Gradients of the padded SHO lowering are finite on both sides of
    Q = 1/2 and at it, and equal JAX's."""
    import jax

    def k_of(T, xp):
        term = T.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.5)
        from celerite_tpu.ops.kernels import kernel_value as jk
        from celerite_torch.ops.kernels import kernel_value as tk
        kv = jk if xp is jnp else tk

        def f(p):
            c = term.get_padded_coefficients(p)
            return kv(*c, xp.asarray(1.3, dtype=xp.float64))

        return f

    fj, ft = k_of(jterms, jnp), k_of(tterms, torch)
    for log_q in [-2.0, np.log(0.5), 0.3]:
        p = np.array([0.1, log_q, 0.5])
        gj = np.asarray(jax.grad(fj)(jnp.asarray(p)))
        pt = torch.tensor(p, requires_grad=True)
        ft(pt).backward()
        gt = pt.grad.numpy()
        assert np.all(np.isfinite(gt))
        _close(gj, gt, rtol=1e-12)


def test_check_parameters_rejects_non_psd():
    bad = dict(log_a=0.0, log_b=1.0, log_c=-1.0, log_d=0.5, quiet=True)
    assert not tterms.ComplexTerm(**bad).check_parameters()
    assert not jterms.ComplexTerm(**bad).check_parameters()


def test_jitter_rejected_in_products():
    with pytest.raises(ValueError):
        tterms.JitterTerm(log_sigma=0.1) * tterms.RealTerm(
            log_a=0.1, log_c=0.5)
