"""The port's one-pass solver against the JAX package's.

``celerite_torch.ops.onepass``'s plain sweep (rows 19-20 of PERF.md's
table) is held against ``celerite_tpu.ops.onepass._sweep_op`` (the Pallas
kernel in interpret mode, as the JAX package's own tests run it on the CPU)
on the same lane streams, every summary at 1e-12 of its largest value, at
padded widths 2, 5 and 8 on 8 lanes of 16 steps; the plain transpose (row
21) against ``jax.vjp`` of ``_sweep_op`` at 1e-11.  ``gp_log_likelihood``
against JAX's at N = 256 and 500 on 8 and 16 lanes (rtol 1e-9, the JAX
tests' own tolerance), the non-PD fixture of tests/test_onepass.py (ok
False and -inf in both), the autograd gradient with respect to the kernel
parameters and to y against ``jax.grad`` of JAX's ``blocked`` (rtol 1e-6,
atol 1e-8), and the plain path at padded width 20 against JAX's
``blocked``.  The CUDA kernels are held against these plain versions by
tests/test_torch_kernels.py (marked ``cuda``) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu import terms as jterms
from celerite_tpu.ops import blocked as jblocked
from celerite_tpu.ops import fused as jfused
from celerite_tpu.ops import onepass as jonepass
from celerite_tpu.ops import seq as jseq
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_tpu.ops.lower import lower as jlower
from celerite_torch import terms as tterms
from celerite_torch.ops import fused, onepass
from celerite_torch.ops.lower import Coefficients, lower
from celerite_torch.testing import make_data, width_kernel

NAMES = ("C", "M0", "m0", "Qm", "qv", "q0", "ld0", "mind0")


def _coeffs(kernel):
    th = jnp.asarray(kernel.get_parameter_vector())
    return [np.asarray(c) for c in (*kernel.get_padded_coefficients(th),
                                    kernel.get_jitter(th))]


def _jssm(cs, t, diag):
    return jlower(JCoefficients(*map(jnp.asarray, cs[:6]),
                                jitter=jnp.asarray(cs[6])),
                  jnp.asarray(t), jnp.asarray(diag))


def _ssm(cs, t, diag):
    return lower(Coefficients(*map(torch.tensor, cs[:6]),
                              jitter=torch.tensor(cs[6])),
                 torch.as_tensor(t), torch.as_tensor(diag))


def _streams(width, n=128, b=8, seed=1):
    """The same lane streams in both packages (``_to_lanes``)."""
    cs = _coeffs(width_kernel(jterms, width))
    t, y, yerr = make_data(n, seed=seed, t_max=20.0)
    js = jfused._to_lanes(_jssm(cs, t, yerr**2), jnp.asarray(y), b)[:5]
    ts = fused._to_lanes(_ssm(cs, t, yerr**2), torch.as_tensor(y), b)[:5]
    return js, ts


def _close(got, want, tol):
    got = got.detach().numpy().reshape(np.shape(want))
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=tol,
                               atol=tol * float(np.abs(want).max()))


@pytest.mark.parametrize("width", [2, 5, 8])
def test_plain_sweep_matches_jax(width):
    """Rows 19 and 20: the summaries of 8 lanes of 16 steps; with saves
    the same summaries."""
    js, ts = _streams(width)
    assert tuple(ts[0].shape) == (16, width, 8)
    want = jax.jit(jonepass._sweep_op)(*js)
    got = onepass.sweep_reference(*ts)
    for name, g, w in zip(NAMES, got, want):
        _close(g, w, 1e-12)
    saved = onepass.sweep_fwd_reference(*ts)
    assert tuple(saved[8].shape) == (16, 8, 2 * width * width + width)
    for g, w in zip(saved[:8], got):
        assert torch.equal(g, w)


def test_plain_sweep_vjp_matches_jax():
    """Row 21: the transpose with seeded cotangents of every summary (C's
    too) against ``jax.vjp`` of the custom-VJP sweep, padded width 5."""
    js, ts = _streams(5)
    outs, vjp = jax.vjp(jonepass._sweep_op, *js)
    rng = np.random.default_rng(3)
    cots = [rng.standard_normal(np.shape(o)) for o in outs]
    want = vjp(tuple(jnp.asarray(c) for c in cots))
    saves = onepass.sweep_fwd_reference(*ts)[8]
    p, b = ts[0].shape[1:]
    tc = [torch.as_tensor(c).reshape(s) for c, s in zip(
        cots[:7], [(p, p, b), (p, p, b), (p, b), (p, p, b), (p, b), (b,),
                   (b,)])]
    got = onepass.sweep_bwd_reference(*ts, saves, *tc)
    for g, w in zip(got, want):
        _close(g, w, 1e-11)


@pytest.mark.parametrize("num_blocks", [8, 16])
@pytest.mark.parametrize("n", [256, 500])
def test_gp_log_likelihood_matches_jax(n, num_blocks):
    """tests/test_onepass.py's problem (SHO + RealTerm, P = 3) through both
    packages' ``gp_log_likelihood`` and the port's sequential solver."""
    kernel = (jterms.SHOTerm(log_S0=0.1, log_Q=1.0, log_omega0=0.3)
              + jterms.RealTerm(log_a=0.2, log_c=-0.4))
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 30.0, n))
    yerr = rng.uniform(0.15, 0.3, n)
    y = np.sin(0.3 * t) + 0.2 * rng.standard_normal(n)
    cs = _coeffs(kernel)
    ll_j, ok_j = jax.jit(jonepass.gp_log_likelihood, static_argnums=2)(
        _jssm(cs, t, yerr**2), jnp.asarray(y), num_blocks)
    ll, ok = onepass.gp_log_likelihood(_ssm(cs, t, yerr**2),
                                       torch.as_tensor(y), num_blocks)
    assert bool(ok) and bool(ok_j)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-9)
    ll_s, _ = jseq.gp_log_likelihood(_jssm(cs, t, yerr**2), jnp.asarray(y))
    np.testing.assert_allclose(float(ll), float(ll_s), rtol=1e-9)


def test_non_pd_flags_not_ok():
    """tests/test_onepass.py::test_onepass_nonpd_flags_not_ok's input."""
    kernel = jterms.ComplexTerm(log_a=0.0, log_b=3.0, log_c=-1.5, log_d=1.5,
                                quiet=True)
    rng = np.random.default_rng(1)
    t = np.sort(rng.uniform(0, 10.0, 256))
    cs = [np.asarray(c) for c in kernel.coefficients] + [
        np.asarray(kernel.jitter)]
    y = rng.standard_normal(256)
    diag = np.full(256, 1e-8)
    ll_j, ok_j = jax.jit(jonepass.gp_log_likelihood, static_argnums=2)(
        _jssm(cs, t, diag), jnp.asarray(y), 16)
    ll, ok = onepass.gp_log_likelihood(_ssm(cs, t, diag), torch.as_tensor(y),
                                       num_blocks=16)
    assert not bool(ok_j) and not bool(ok)
    assert float(ll_j) == -np.inf and float(ll) == -np.inf


def test_gradients_match_jax_blocked():
    """The autograd gradient (row 21 and the float64 assembly) with respect
    to the kernel parameters and to y, against ``jax.grad`` of JAX's
    ``blocked`` solver; N = 400 on 16 lanes, padded width 5."""
    jk, tk = width_kernel(jterms, 5), width_kernel(tterms, 5)
    t, y, yerr = make_data(400, seed=4, t_max=30.0)
    theta = np.asarray(jk.get_parameter_vector())

    def jll(th, yv):
        coeffs = JCoefficients(*jk.get_padded_coefficients(th),
                               jitter=jk.get_jitter(th))
        ssm = jlower(coeffs, jnp.asarray(t), jnp.asarray(yerr**2))
        return jblocked.gp_log_likelihood(ssm, yv)[0]

    v_j, (g_j, gy_j) = jax.jit(jax.value_and_grad(jll, argnums=(0, 1)))(
        jnp.asarray(theta), jnp.asarray(y))
    th = torch.tensor(theta, requires_grad=True)
    yt = torch.tensor(y, requires_grad=True)
    coeffs = Coefficients(*tk.get_padded_coefficients(th),
                          jitter=tk.get_jitter(th))
    ll, ok = onepass.gp_log_likelihood(
        lower(coeffs, torch.as_tensor(t), torch.as_tensor(yerr**2)), yt, 16)
    assert bool(ok)
    g, gy = torch.autograd.grad(ll, (th, yt))
    np.testing.assert_allclose(float(ll.detach()), float(v_j), rtol=1e-9)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=1e-6,
                               atol=1e-8)
    np.testing.assert_allclose(gy.numpy(), np.asarray(gy_j), rtol=1e-6,
                               atol=1e-8)


def test_plain_path_wide_matches_blocked():
    """Padded width 20 (above the kernels' 16) on the CPU: the plain
    sweep, against JAX's ``blocked``."""
    cs = _coeffs(width_kernel(jterms, 20))
    t, y, yerr = make_data(300, seed=5, t_max=30.0)
    ll_j, _ = jax.jit(jblocked.gp_log_likelihood)(_jssm(cs, t, yerr**2),
                                                  jnp.asarray(y))
    ll, ok = onepass.gp_log_likelihood(_ssm(cs, t, yerr**2),
                                       torch.as_tensor(y), num_blocks=8)
    assert bool(ok)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-9)


def test_small_det_matches_linalg():
    """``_small_det`` (elimination without pivoting) against
    ``torch.linalg.det`` on diagonally dominant matrices."""
    rng = np.random.default_rng(7)
    X = torch.as_tensor(rng.standard_normal((5, 6, 6)) * 0.2 + 2 * np.eye(6))
    np.testing.assert_allclose(onepass._small_det(X).numpy(),
                               torch.linalg.det(X).numpy(), rtol=1e-12)
