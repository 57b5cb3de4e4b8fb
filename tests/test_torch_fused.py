"""The port's single-sweep value against the JAX package's fused kernel.

``celerite_torch.ops.fused``'s plain version of the single-sweep kernel
(``kernel_reference``, through ``run_kernel`` at padded width 8 or less) is
held against ``celerite_tpu.ops.fused.run_kernel`` (the Pallas kernel in
interpret mode, as the JAX package's own tests run it on the CPU) on the
same lane streams at rtol 1e-10, at padded widths 2, 5 and 8 (N 256-1000
on 8-16 lanes, a padded tail at N = 1000 on 16 lanes).  A kernel that is
not positive definite gives (-inf, False), as tests/test_fused.py holds
JAX's.  ``fused.gp_log_likelihood`` and its autograd gradient (through
``blocked``) against JAX's at rtol 1e-10 and 1e-9, and ``ops.best_ll``
against JAX's.  The CUDA kernel is held against this plain version by
tests/test_torch_kernels.py (marked ``cuda``) and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu import ops as jops
from celerite_tpu import terms as jterms
from celerite_tpu.ops import fused as jfused
from celerite_tpu.ops.lower import Coefficients as JCoefficients
from celerite_tpu.ops.lower import lower as jlower
from celerite_torch import ops
from celerite_torch.ops import fused
from celerite_torch.ops.lower import Coefficients, lower
from celerite_torch.testing import make_data, width_kernel


def _problem(width, n, seed=1):
    """Numpy coefficient arrays of a width-``width`` model and its data."""
    k = width_kernel(jterms, width)
    th = jnp.asarray(k.get_parameter_vector())
    cs = [np.asarray(c) for c in (*k.get_padded_coefficients(th),
                                  k.get_jitter(th))]
    t, y, yerr = make_data(n, seed=seed, t_max=50.0)
    return cs, t, y, yerr**2


def _jssm(cs, t, diag):
    return jlower(JCoefficients(*cs[:6], jitter=cs[6]), jnp.asarray(t),
                  jnp.asarray(diag))


def _ssm(cs, t, diag):
    return lower(Coefficients(*map(torch.tensor, cs[:6]),
                              jitter=torch.tensor(cs[6])),
                 torch.as_tensor(t), torch.as_tensor(diag))


@pytest.mark.parametrize("width,n,b", [(2, 256, 8), (5, 512, 16),
                                       (8, 1000, 16)])
def test_run_kernel_matches_jax(width, n, b):
    """The same streams (JAX's lane layout, which is the port's) through
    both packages' ``run_kernel``; two copies of the streams side by side,
    as two segments, give the one segment's sums twice."""
    cs, t, y, diag = _problem(width, n)
    jstreams = jfused._to_lanes(_jssm(cs, t, diag), jnp.asarray(y), b)[:5]
    ll_j, ok_j = jfused.run_kernel(*jstreams, n, interpret=True)
    streams = fused._to_lanes(_ssm(cs, t, diag), torch.as_tensor(y), b)[:5]
    for got, want in zip(streams, jstreams):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                                   atol=1e-13)
    ll, ok = fused.run_kernel(*streams, n)
    assert bool(ok) and bool(ok_j)
    np.testing.assert_allclose(float(ll), float(ll_j), rtol=1e-10)
    one = fused.kernel_reference(*streams)
    two = fused.kernel_reference(*(torch.cat([x, x], -1) for x in streams),
                                 seg=b)
    assert two[0].shape == (2,) and two[0].dtype == torch.float64
    for x1, x2 in zip(one, two):
        np.testing.assert_allclose(x2.numpy(), x1.expand(2).numpy(),
                                   rtol=1e-13)


def test_non_pd_gives_neg_inf():
    """tests/test_fused.py::test_fused_non_pd's input in both packages."""
    t = np.sort(np.random.default_rng(0).uniform(0, 50, 256))
    cs = [np.asarray([-1.0]), np.asarray([0.1])] + [np.zeros(0)] * 4 \
        + [np.zeros(())]
    diag = np.full(256, 1e-8)
    ll_j, ok_j = jfused.gp_log_likelihood(
        _jssm([jnp.asarray(c) for c in cs], t, diag),
        jnp.asarray(np.sin(t)), num_blocks=8, interpret=True)
    ll, ok = fused.gp_log_likelihood(_ssm(cs, t, diag),
                                     torch.as_tensor(np.sin(t)), num_blocks=8)
    assert not bool(ok) and not bool(ok_j)
    assert float(ll) == -np.inf and float(ll_j) == -np.inf


def test_gp_log_likelihood_and_gradient_match_jax():
    """Padded width 8 on 16 lanes: the value through the plain single-sweep
    kernel, the gradient through the backward (autograd through
    ``blocked``), against JAX's ``fused.gp_log_likelihood`` and its
    ``custom_vjp`` (backward through JAX's ``blocked``)."""
    cs, t, y, diag = _problem(8, 1000, seed=3)
    ll_j, g_j = jax.jit(jax.value_and_grad(
        lambda cs: jfused.gp_log_likelihood(_jssm(cs, t, diag),
                                            jnp.asarray(y), 16, True)[0]))(
        [jnp.asarray(c) for c in cs])
    xs = [torch.tensor(c, requires_grad=True) for c in cs]
    ssm = lower(Coefficients(*xs[:6], jitter=xs[6]), torch.as_tensor(t),
                torch.as_tensor(diag))
    ll, ok = fused.gp_log_likelihood(ssm, torch.as_tensor(y), num_blocks=16)
    assert bool(ok)
    np.testing.assert_allclose(float(ll.detach()), float(ll_j), rtol=1e-10)
    grads = torch.autograd.grad(ll, [x for x in xs if x.numel()])
    for g, w in zip(grads, [w for w, c in zip(g_j, cs) if c.size]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-9,
                                   atol=1e-9 * float(np.abs(w).max()))


@pytest.mark.parametrize("n", [1000, 4096])
def test_best_ll_matches_jax(n):
    """Below 4096 points the sequential solver, from 4096 on the CPU the
    block-parallel solver, in both packages; padded width 5."""
    cs, t, y, diag = _problem(5, n, seed=4)
    want = jax.jit(lambda cs: jops.best_ll(_jssm(cs, t, diag),
                                           jnp.asarray(y)))(
        [jnp.asarray(c) for c in cs])
    got = ops.best_ll(_ssm(cs, t, diag), torch.as_tensor(y))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-10)


def test_kernel_wrappers_refuse_cpu_tensors():
    """The CUDA wrapper takes CUDA tensors only; the dispatcher takes the
    plain version for CPU streams."""
    streams = [torch.ones(4, 2, 3)] * 3 + [torch.ones(4, 1, 3)] * 2
    with pytest.raises(ValueError, match="CUDA tensor"):
        fused.kernel_cuda(*streams)
    with pytest.raises(ValueError, match="does not divide"):
        fused.kernel(*streams, seg=2)
