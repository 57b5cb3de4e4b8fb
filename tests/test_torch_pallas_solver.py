"""The port's three-pass primal against the JAX package's Pallas solver.

``celerite_torch.ops.pallas_solver``'s plain versions of the three kernels
are held against ``celerite_tpu.ops.pallas_solver``'s ``_run_elements`` /
``_run_factor`` / ``_run_subst`` (interpret mode, as the JAX package's own
tests run them on the CPU) on the same streams, every output at rtol 1e-12
(atol 1e-12 of the output's largest value), at padded widths 2, 8, 13 and
16 on N = 1000 points in blocks of L = 96 steps (B = 11 blocks, odd, and a
padded tail of 56 inert rows).  ``run_from_lanes`` and
``gp_log_likelihood(block_size=L)`` against JAX's at rtol 1e-10, and the
latter's autograd gradient with respect to the lowering's coefficients
against ``jax.grad`` of JAX's at rtol 1e-9 (as tests/test_pallas.py:60
holds JAX's).  A kernel that is not positive definite gives (-inf,
False).  The float32 plain subst keeps its Kahan compensation over 800
steps.  The CUDA kernels are held against these plain versions by
tests/test_torch_kernels.py (marked ``cuda``) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu import terms as jterms
from celerite_tpu.ops import pallas_solver as jps
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_tpu.ops.lower import lower as jlower
from celerite_torch.ops import blocked, fused4, pallas_solver
from celerite_torch.ops.lower import Coefficients, lower
from celerite_torch.testing import make_data, width_kernel

N, L = 1000, 96
WIDTHS = (2, 8, 13, 16)


def _problem(width, seed=1):
    """Numpy coefficient arrays of a width-``width`` model and its data."""
    k = width_kernel(jterms, width)
    th = jnp.asarray(k.get_parameter_vector())
    cs = [np.asarray(c) for c in (*k.get_padded_coefficients(th),
                                  k.get_jitter(th))]
    t, y, yerr = make_data(N, seed=seed, t_max=50.0)
    return cs, t, y, yerr**2


def _jssm(cs, t, diag):
    return jlower(JCoefficients(*cs[:6], jitter=cs[6]), jnp.asarray(t),
                  jnp.asarray(diag))


def _streams(width, seed=1):
    """JAX's blocked layout of the lowering: numpy ``(u, v, ph, a, y)``."""
    cs, t, y, diag = _problem(width, seed)
    u, v, ph, a, yy, b, pad = jps._to_blocked_layout(
        _jssm([jnp.asarray(c) for c in cs], t, diag), jnp.asarray(y), L)
    assert (b, pad) == (11, 56)
    return tuple(np.array(x) for x in (u, v, ph, a, yy))


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("width", WIDTHS)
def test_plain_kernels_match_jax(width):
    """Each pass on the same inputs: the factor takes the port's seeds, the
    substitution the port's states, pivots and gains."""
    u, v, ph, a, y = _streams(width)
    uu, vv, pp, aa, yy = map(torch.as_tensor, (u, v, ph, a, y))
    # The port's layout of its own lowering is JAX's.
    cs, t, yd, diag = _problem(width)
    ssm = lower(Coefficients(*map(torch.tensor, cs[:6]),
                             jitter=torch.tensor(cs[6])),
                torch.as_tensor(t), torch.as_tensor(diag))
    ours = blocked._pad_blocks(ssm, torch.as_tensor(yd), L)
    for got, want in zip(ours[:5], (u, v, ph, a, y)):
        _close(got, want, rtol=1e-13)

    elems = pallas_solver.elements_reference(uu, vv, pp, aa)
    want = jax.jit(jps._run_elements, static_argnums=4)(u, v, ph, a, True)
    for got, w in zip(elems, want):
        _close(got, w, rtol=1e-12)
    sh0 = fused4.prefix_sh0(*elems, 11)
    fac = pallas_solver.factor_reference(sh0, uu, vv, pp, aa, yy)
    want = jax.jit(jps._run_factor, static_argnums=6)(
        sh0.numpy(), u, v, ph, a, y, True)
    for got, w in zip(fac, want):
        _close(got, w, rtol=1e-12)
    d, w, M, m = fac
    h0 = fused4.prefix_h0(M, m, 11)
    sub = pallas_solver.subst_reference(h0, uu, pp, w, yy, d)
    want = jax.jit(jps._run_subst, static_argnums=6)(
        h0.numpy(), u, ph, w.numpy(), y, d.numpy(), True)
    for got, x in zip(sub, want):
        _close(got, x, rtol=1e-12)


@pytest.mark.parametrize("width", WIDTHS)
def test_run_from_lanes_matches_jax(width):
    u, v, ph, a, y = _streams(width, seed=2)
    ll_j, ok_j = jax.jit(jps.run_from_lanes, static_argnums=(5, 6))(
        u, v, ph, a, y, N, True)
    ll, ok = pallas_solver.run_from_lanes(*map(torch.as_tensor,
                                               (u, v, ph, a, y)), N)
    assert bool(ok) and bool(ok_j)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-10)


@pytest.mark.parametrize("width", (8, 16))
def test_gp_log_likelihood_and_gradient_match_jax(width):
    """The value through the kernels' plain versions and the gradient
    through the backward, autograd through ``blocked`` (the counterpart of
    the JAX ``custom_vjp``)."""
    cs, t, y, diag = _problem(width, seed=3)
    ll_j, g_j = jax.jit(jax.value_and_grad(
        lambda cs: jps.gp_log_likelihood(_jssm(cs, t, diag), jnp.asarray(y),
                                         L, True)[0]))(
        [jnp.asarray(c) for c in cs])
    xs = [torch.tensor(c, requires_grad=True) for c in cs]
    ssm = lower(Coefficients(*xs[:6], jitter=xs[6]), torch.as_tensor(t),
                torch.as_tensor(diag))
    ll, ok = pallas_solver.gp_log_likelihood(ssm, torch.as_tensor(y),
                                             block_size=L)
    assert bool(ok)
    np.testing.assert_allclose(float(ll.detach()), float(ll_j), rtol=1e-10)
    grads = torch.autograd.grad(ll, [x for x in xs if x.numel()])
    for g, w in zip(grads, [w for w, c in zip(g_j, cs) if c.size]):
        _close(g, w, rtol=1e-9)


def test_non_pd_gives_neg_inf():
    t = np.sort(np.random.default_rng(0).uniform(0, 50, 256))
    ssm = lower(Coefficients(
        torch.tensor([-1.0], dtype=torch.float64),
        torch.tensor([0.1], dtype=torch.float64),
        *[torch.zeros(0, dtype=torch.float64)] * 4,
        jitter=torch.zeros((), dtype=torch.float64)),
        torch.as_tensor(t), torch.full((256,), 1e-8, dtype=torch.float64))
    ll, ok = pallas_solver.gp_log_likelihood(ssm, torch.as_tensor(np.sin(t)),
                                             block_size=64)
    assert not bool(ok)
    assert float(ll) == -np.inf


def test_float32_subst_keeps_compensation():
    """800 steps of 5 lanes whose terms z^2 / d and log d are all positive
    (u = 0, phi = 1, w = 0, so z = y): the float32 Kahan sums stay within
    two float32 ulps of the float64 sums of the same float32 terms."""
    rng = np.random.default_rng(4)
    steps, p, b = 800, 3, 5
    y = rng.standard_normal((steps, 1, b)).astype(np.float32)
    d = rng.uniform(1.5, 9.0, (steps, 1, b)).astype(np.float32)
    zero = torch.zeros(steps, p, b)
    quad, logdet, mind = pallas_solver.subst_reference(
        torch.zeros(p, b), zero, torch.ones_like(zero), zero,
        torch.as_tensor(y), torch.as_tensor(d))
    terms_q = (y * y / d).astype(np.float64).sum(0)[0]
    terms_l = torch.log(torch.as_tensor(d)).double().sum(0)[0].numpy()
    eps = np.finfo(np.float32).eps
    np.testing.assert_allclose(quad.numpy(), terms_q, rtol=2 * eps)
    np.testing.assert_allclose(logdet.numpy(), terms_l, rtol=2 * eps)
    assert quad.dtype == torch.float64 and mind.dtype == torch.float32
    np.testing.assert_array_equal(mind.numpy(), d.min(0)[0])
