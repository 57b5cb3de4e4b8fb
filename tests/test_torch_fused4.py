"""The fused primal of the port against the JAX package and the oracles.

The plain version (``primal_reference``, what the CPU runs) is held against
``celerite_tpu.ops.fused4.run_primal`` in interpret mode on the same plan
and packed coefficients, at JAX's own bar (1e-12, tests/test_fused4.py),
and against the port's sequential and dense oracles.  The CUDA kernel is
held against the plain version by tests/test_torch_kernels.py (marked
``cuda``, skipped without a card) and by ``chip_smoke.py``.
"""

import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from celerite_tpu.ops import fused4 as jf4, lanes4 as jl4
from celerite_torch.ops import dense, fused4, lanes4, lower, seq
from celerite_torch.testing import CASES, make_data, pack_values

N, B = 257, 32


def _plans(jr, jc, n_chain=1, seed=0):
    t, y, yerr = make_data(N, seed=seed)
    pj = jl4.make_plan4(t, y, yerr**2, B, dtype=np.float64, n_chain=n_chain)
    pt = lanes4.make_plan4(t, y, yerr**2, B, dtype=torch.float64,
                           n_chain=n_chain)
    return (t, y, yerr), pj, pt


def _coeffs(jr, jc, cf):
    k = [cf[:jr], cf[jr:2 * jr]] + [
        cf[2 * jr + i * jc: 2 * jr + (i + 1) * jc] for i in range(4)
    ]
    jitter = cf[-1] - k[0].sum() - k[2].sum()
    return lower.Coefficients(*[torch.as_tensor(x) for x in k],
                              torch.as_tensor(jitter))


@pytest.mark.parametrize("jr,jc,vals", CASES)
def test_primal_matches_jax(jr, jc, vals):
    _, pj, pt = _plans(jr, jc)
    cf = pack_values(jr, jc, vals)
    llj, okj = jf4.run_primal(jnp.asarray(cf), pj, jr, jc, interpret=True)
    llt, okt = fused4.run_primal(torch.as_tensor(cf), pt, jr, jc)
    assert bool(okj) and bool(okt)
    np.testing.assert_allclose(float(llt), float(llj), rtol=1e-12)


def test_primal_chain_folded_matches_jax():
    jr, jc, vals = CASES[2]
    _, pj, pt = _plans(jr, jc, n_chain=2)
    cf = pack_values(jr, jc, vals)
    cf2 = np.stack([cf, cf * np.r_[np.full(len(cf) - 1, 0.9), 1.0]])
    llj, okj = jf4.run_primal(jnp.asarray(cf2), pj, jr, jc, interpret=True)
    llt, okt = fused4.run_primal(torch.as_tensor(cf2), pt, jr, jc)
    assert llt.shape == (2,) and bool(okt.all()) and bool(np.all(okj))
    np.testing.assert_allclose(llt.numpy(), np.asarray(llj), rtol=1e-12)
    # Each chain's segment equals the single-model value: no state crosses.
    _, _, p1 = _plans(jr, jc)
    for k in range(2):
        ll1, _ = fused4.run_primal(torch.as_tensor(cf2[k]), p1, jr, jc)
        np.testing.assert_allclose(float(llt[k]), float(ll1), rtol=1e-12)


@pytest.mark.parametrize("jr,jc,vals", CASES)
def test_primal_matches_oracles(jr, jc, vals):
    (t, y, yerr), _, pt = _plans(jr, jc, seed=5)
    cf = pack_values(jr, jc, vals)
    llt, okt = fused4.run_primal(torch.as_tensor(cf), pt, jr, jc)
    coeffs = _coeffs(jr, jc, cf)
    tt, dg, yy = (torch.as_tensor(x) for x in (t, yerr**2, y))
    ssm = lower.lower(coeffs, tt, dg)
    lls, oks = seq.gp_log_likelihood(ssm, yy)
    K = dense.build_matrix(coeffs, tt, dg)
    lld = dense.log_likelihood(K, yy)
    assert bool(okt) and bool(oks)
    np.testing.assert_allclose(float(llt), float(lls), rtol=1e-10)
    np.testing.assert_allclose(float(llt), float(lld), rtol=1e-10)
    # The sequential factorization's pivots give the dense log-determinant.
    fac = seq.factor(ssm)
    assert bool(fac.ok)
    np.testing.assert_allclose(float(torch.log(fac.D).sum()),
                               float(torch.linalg.slogdet(K)[1]), rtol=1e-10)


def test_gp_log_likelihood_from_coefficients():
    jr, jc, vals = CASES[1]
    _, _, pt = _plans(jr, jc)
    cf = pack_values(jr, jc, vals)
    ll, ok = fused4.gp_log_likelihood(_coeffs(jr, jc, cf), pt)
    ll2, _ = fused4.run_primal(torch.as_tensor(cf), pt, jr, jc)
    assert bool(ok)
    np.testing.assert_allclose(float(ll), float(ll2), rtol=1e-14)


def test_non_pd_gives_minus_inf_on_both_sides():
    jr, jc = 0, 1
    _, pj, pt = _plans(jr, jc)
    # a*c << b*d: the complex term's PSD goes negative; K is not PD.
    cf = pack_values(jr, jc, [0.1, 3.0, 0.05, 2.0], jitter=0.0)
    llj, okj = jf4.run_primal(jnp.asarray(cf), pj, jr, jc, interpret=True)
    llt, okt = fused4.run_primal(torch.as_tensor(cf), pt, jr, jc)
    assert not bool(okj) and not bool(okt)
    assert float(llt) == -math.inf and float(llj) == -math.inf


def test_cpu_plan_takes_plain_version():
    """On CPU tensors the wrapper runs the plain version; the kernel's
    launch counter does not move."""
    jr, jc, vals = CASES[0]
    _, _, pt = _plans(jr, jc)
    before = fused4.primal_cuda.launches
    fused4.run_primal(torch.as_tensor(pack_values(jr, jc, vals)), pt, jr, jc)
    assert fused4.primal_cuda.launches == before


def test_plain_version_autograd_finite():
    jr, jc, vals = CASES[2]
    _, _, pt = _plans(jr, jc)
    cf = torch.tensor(pack_values(jr, jc, vals), requires_grad=True)
    ll, _ = fused4.run_primal(cf, pt, jr, jc)
    ll.backward()
    assert torch.all(torch.isfinite(cf.grad))
    # Finite-difference check of one coefficient's derivative.
    eps = 1e-6
    k = 2 * jr
    up = cf.detach().clone()
    up[k] += eps
    dn = cf.detach().clone()
    dn[k] -= eps
    fd = (float(fused4.run_primal(up, pt, jr, jc)[0])
          - float(fused4.run_primal(dn, pt, jr, jc)[0])) / (2 * eps)
    np.testing.assert_allclose(float(cf.grad[k]), fd, rtol=1e-6)
