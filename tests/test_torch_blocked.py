"""The port's block-parallel solver against the JAX package's.

``celerite_torch.ops.blocked.gp_log_likelihood`` against
``celerite_tpu.ops.blocked.gp_log_likelihood`` and the JAX package's
sequential solver on the same lowering, at padded widths 2, 8, 16 and 20,
N = 512 and 1000 (a padded tail) with L = 64: the value at rtol 1e-12, its
autograd gradient with respect to the lowering's coefficients against
``jax.grad`` of the sequential solver at rtol 1e-9 (atol 1e-9 of the
largest entry).  The two
cross-block prefixes the port uses (``fused4.prefix_sh0`` and
``fused4.prefix_h0``) against the JAX package's exclusive prefixes on 11
blocks (odd B) at 1e-12; a kernel that is not positive definite gives
(-inf, False); ``ops.best_ll`` against the JAX package's on both of its
CPU routes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu import ops as jops, terms as jterms
from celerite_tpu.ops import blocked as jblocked, seq as jseq
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_tpu.ops.lower import lower as jlower
from celerite_torch import ops
from celerite_torch.ops import blocked, fused4
from celerite_torch.ops.lower import Coefficients, lower
from celerite_torch.testing import make_data, width_kernel

WIDTHS = (2, 8, 16, 20)


def _coefficients(width):
    """The padded coefficient arrays of a width-``width`` model, numpy."""
    k = width_kernel(jterms, width)
    th = jnp.asarray(k.get_parameter_vector())
    assert sum(np.multiply(k.padded_size, (1, 2))) == width
    return [np.asarray(c) for c in (*k.get_padded_coefficients(th),
                                    k.get_jitter(th))]


def _problem(width, n, seed=1):
    t, y, yerr = make_data(n, seed=seed, t_max=n / 20.0)
    return _coefficients(width), t, y, yerr**2


def _close(got, want, rtol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want.reshape(got.shape), rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("n", [512, 1000])
def test_value_and_gradient_match_jax(width, n):
    cs, t, y, diag = _problem(width, n)

    def jssm(cs):
        return jlower(JCoefficients(*cs[:6], jitter=cs[6]), jnp.asarray(t),
                      jnp.asarray(diag))

    jcs = [jnp.asarray(c) for c in cs]
    ll_j = jax.jit(lambda cs: jblocked.gp_log_likelihood(
        jssm(cs), jnp.asarray(y), block_size=64)[0])(jcs)
    # The gradient of the sequential solver: the same function, and a far
    # shorter compile than JAX's blocked solver under jax.grad.
    ll_seq, g_j = jax.jit(jax.value_and_grad(lambda cs: jseq.gp_log_likelihood(
        jssm(cs), jnp.asarray(y))[0]))(jcs)
    xs = [torch.tensor(c, requires_grad=True) for c in cs]
    ssm = lower(Coefficients(*xs[:6], jitter=xs[6]), torch.as_tensor(t),
                torch.as_tensor(diag))
    ll, ok = blocked.gp_log_likelihood(ssm, torch.as_tensor(y), 64)
    assert bool(ok)
    np.testing.assert_allclose(float(ll.detach()), float(ll_j), rtol=1e-12)
    np.testing.assert_allclose(float(ll.detach()), float(ll_seq),
                               rtol=1e-12)
    grads = torch.autograd.grad(ll, [x for x in xs if x.numel()])
    for g, w in zip(grads, [w for w, c in zip(g_j, cs) if c.size]):
        _close(g, w, rtol=1e-9)


@pytest.mark.parametrize("width", WIDTHS)
def test_prefixes_match_jax(width):
    """The seeds (C of the exclusive element prefix) and each block's
    incoming state (m of the exclusive affine prefix) on 11 blocks."""
    cs, t, y, diag = _problem(width, 1000, seed=2)
    ssm = lower(Coefficients(*map(torch.tensor, cs[:6]),
                             jitter=torch.tensor(cs[6])),
                torch.as_tensor(t), torch.as_tensor(diag))
    u, v, ph, a, yy, b = blocked._pad_blocks(ssm, torch.as_tensor(y), 96)
    assert b == 11
    elems = blocked._block_elements(u, v, ph, a)
    sh0 = fused4.prefix_sh0(*elems, b)
    want = jax.jit(jblocked._exclusive_prefix_elements)(
        tuple(jnp.asarray(x.permute(2, 0, 1).numpy()) for x in elems))
    _close(sh0, np.asarray(want[2]).transpose(1, 2, 0), rtol=1e-12)
    _, _, M, m = blocked._block_factor(sh0, u, v, ph, a, yy)
    _, mp = jax.jit(jblocked._exclusive_prefix_affine)(
        jnp.asarray(M.permute(2, 0, 1).numpy()), jnp.asarray(m.T.numpy()))
    _close(fused4.prefix_h0(M, m, b), np.asarray(mp).T, rtol=1e-12)


def test_non_pd_gives_neg_inf():
    t = np.sort(np.random.default_rng(0).uniform(0, 50, 256))
    ssm = lower(Coefficients(
        torch.tensor([-1.0], dtype=torch.float64),
        torch.tensor([0.1], dtype=torch.float64),
        *[torch.zeros(0, dtype=torch.float64)] * 4,
        jitter=torch.zeros((), dtype=torch.float64)),
        torch.as_tensor(t), torch.full((256,), 1e-8, dtype=torch.float64))
    ll, ok = blocked.gp_log_likelihood(ssm, torch.as_tensor(np.sin(t)), 64)
    assert not bool(ok)
    assert float(ll) == -np.inf


@pytest.mark.parametrize("n", [1000, 5000])
def test_best_ll_matches_jax(n):
    """Below 4096 points the sequential solver, above it the blocked solver
    on the CPU, in both packages."""
    cs, t, y, diag = _problem(16, n, seed=3)
    jssm = jlower(JCoefficients(*map(jnp.asarray, cs[:6]),
                                jitter=jnp.asarray(cs[6])),
                  jnp.asarray(t), jnp.asarray(diag))
    want = jax.jit(jops.best_ll)(jssm, jnp.asarray(y))
    ssm = lower(Coefficients(*map(torch.tensor, cs[:6]),
                             jitter=torch.tensor(cs[6])),
                torch.as_tensor(t), torch.as_tensor(diag))
    got = ops.best_ll(ssm, torch.as_tensor(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-12)
    assert blocked.default_block_size(n) == jblocked.default_block_size(n)
