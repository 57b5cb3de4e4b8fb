"""The fleet plan and the fused4 kernels' fleet segmentation against JAX.

``lanes4.make_plan4_curves`` against ``celerite_tpu.ops.lanes4``'s, stream
for stream and exactly, with JAX's ``(L, 8, W)`` flattened to ``(L, B)``;
``fused4.run_primal`` and ``build_ll_and_grad`` at ``n_seg`` = lanes,
``state_seg = 1`` (the plain versions, what the CPU runs) against JAX's
jitted ``data.batched_gp_log_likelihood`` per curve (1e-10; padded lanes
read 0) and ``jax.grad`` of its sum (1e-8 of the gradient's norm); and the
two-chain particle batch against each parameter set's per-curve sums.
JAX's interpret-mode fused4 is too slow for the fleet (its own fleet tests
are ``slow``), so its jitted sequential route is the reference.  The CUDA
kernels on a fleet plan are held against these plain versions by
tests/test_torch_kernels.py and chip_smoke.py (phase L).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from celerite_tpu import data as jdata, terms as jterms
from celerite_tpu.ops import lanes4 as jl4
from celerite_torch import terms
from celerite_torch.data import LightCurveBatch, _coefficients
from celerite_torch.ops import fused4, lanes4

THETA = np.array([0.1, 1.0, 0.5])  # SHOTerm: log_S0, log_Q, log_omega0
THETA2 = np.array([-0.2, 0.6, 0.8])


def make_fleet(n_curves=5, seed=0, nmin=20, nmax=60):
    rng = np.random.default_rng(seed)
    ts, ys, es = [], [], []
    for _ in range(n_curves):
        n = int(rng.integers(nmin, nmax))
        t = np.sort(rng.uniform(0, 10, n))
        e = rng.uniform(0.1, 0.2, n)
        ts.append(t)
        ys.append(np.sin(t) + e * rng.standard_normal(n))
        es.append(e)
    return ts, ys, es


def _kernels():
    return (terms.SHOTerm(*THETA),
            jterms.SHOTerm(log_S0=THETA[0], log_Q=THETA[1],
                           log_omega0=THETA[2]))


@pytest.fixture(scope="module")
def fleet():
    ts, ys, es = make_fleet()
    return LightCurveBatch.from_ragged(ts, ys, es)


@pytest.fixture(scope="module")
def jax_ll():
    """JAX's jitted per-curve lls and the gradient of their sum."""
    ts, ys, es = make_fleet()
    batch = jdata.LightCurveBatch.from_ragged(ts, ys, es)
    kernel = _kernels()[1]

    @jax.jit
    def lls(p):
        return jdata.batched_gp_log_likelihood(kernel, p, batch)

    grad = jax.jit(jax.grad(lambda p: jnp.sum(lls(p)[0])))
    return lambda th: (np.asarray(lls(jnp.asarray(th))[0]),
                       np.asarray(grad(jnp.asarray(th))))


@pytest.mark.parametrize("n_chain", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_plan4_curves_matches_jax(fleet, n_chain, dtype):
    b = fleet
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    pj = jl4.make_plan4_curves(b.t, b.y, b.yerr**2, b.lengths,
                               n_chain=n_chain, dtype=np_dtype)
    pt = lanes4.make_plan4_curves(b.t, b.y, b.yerr**2, b.lengths,
                                  n_chain=n_chain, dtype=dtype, device="cpu")
    assert pt.num_blocks == pj.num_blocks == 8 * n_chain
    assert pt.t.shape == (b.t.shape[1], pj.num_blocks)
    for k in ("t", "t_lo", "dt", "diag", "y", "mask"):
        got = getattr(pt, k).numpy()
        want = np.asarray(getattr(pj, k)).reshape(got.shape)
        np.testing.assert_array_equal(got, want, err_msg=k)
    assert pt.n.dtype == torch.int64
    np.testing.assert_array_equal(pt.n.numpy(), np.asarray(pj.n))


def test_plan4_curves_lane_padding():
    """Lanes pad so lanes x chains is a multiple of 8: 5 curves take 8
    lanes alone, 6 a chain at 4 chains, 5 at 8 chains; each chain's count
    is the fleet's total."""
    ts, ys, es = make_fleet(5)
    b = LightCurveBatch.from_ragged(ts, ys, es)
    for nc, lanes in ((1, 8), (4, 6), (8, 5)):
        p = lanes4.make_plan4_curves(b.t, b.y, b.yerr**2, b.lengths,
                                     n_chain=nc, dtype=torch.float64,
                                     device="cpu")
        assert p.num_blocks == lanes * nc
        want = b.lengths if nc == 1 else np.full(nc, b.lengths.sum())
        np.testing.assert_array_equal(p.n.numpy()[:len(want)], want)
        assert float(p.mask[:, lanes - 1].sum()) == (
            b.lengths[-1] if lanes == 5 else 0.0)


def _theta_cf(kernel, theta):
    th = torch.tensor(theta, dtype=torch.float64, requires_grad=True)
    return th, lanes4.pack_cf(_coefficients(kernel, th, torch.float64),
                              dtype=torch.float64)


def test_fleet_primal_and_grad_match_jax(fleet, jax_ll):
    kernel = _kernels()[0]
    jr, jc = kernel.padded_size
    b = fleet
    plan = lanes4.make_plan4_curves(b.t, b.y, b.yerr**2, b.lengths,
                                    dtype=torch.float64, device="cpu")
    ncur, lanes = len(b), plan.num_blocks
    want, gwant = jax_ll(THETA)

    th, cf = _theta_cf(kernel, THETA)
    llp, okp = fused4.run_primal(cf.detach(), plan, jr, jc, n_seg=lanes,
                                 state_seg=1)
    assert llp.shape == okp.shape == (lanes,) and bool(okp.all())
    np.testing.assert_allclose(llp[:ncur].numpy(), want, rtol=1e-10)
    assert np.all(llp[ncur:].numpy() == 0.0)

    fn = fused4.build_ll_and_grad(plan, jr, jc, n_seg=lanes, state_seg=1)
    ll, ok = fn(cf)
    assert bool(ok.all())
    np.testing.assert_allclose(ll.detach()[:ncur].numpy(), want, rtol=1e-10)
    assert np.all(ll.detach()[ncur:].numpy() == 0.0)
    (grad,) = torch.autograd.grad(ll.sum(), th)
    err = np.linalg.norm(grad.numpy() - gwant) / np.linalg.norm(gwant)
    assert err < 1e-8


def test_fleet_two_chains_match_per_chain_sums(fleet, jax_ll):
    """A (2, C) batch on the 2-chain fleet plan: each chain's fleet sum
    and gradient row equal its parameters' per-curve sums, by the value
    kernel's plain version and by the gradient pipeline's."""
    kernel = _kernels()[0]
    jr, jc = kernel.padded_size
    b = fleet
    plan = lanes4.make_plan4_curves(b.t, b.y, b.yerr**2, b.lengths,
                                    n_chain=2, dtype=torch.float64,
                                    device="cpu")
    th = torch.tensor(np.stack([THETA, THETA2]), requires_grad=True)
    cf = torch.stack([lanes4.pack_cf(_coefficients(kernel, r, torch.float64),
                                     dtype=torch.float64) for r in th])
    llp, okp = fused4.run_primal(cf.detach(), plan, jr, jc, n_seg=2,
                                 state_seg=1)
    ll, ok = fused4.build_ll_and_grad(plan, jr, jc, n_chain=2, n_seg=2,
                                      state_seg=1)(cf)
    (grad,) = torch.autograd.grad(ll.sum(), th)
    ll = ll.detach()
    assert ll.shape == (2,) and bool(ok.all()) and bool(okp.all())
    for k, theta in enumerate((THETA, THETA2)):
        want, gwant = jax_ll(theta)
        np.testing.assert_allclose(float(llp[k]), want.sum(), rtol=1e-10)
        np.testing.assert_allclose(float(ll[k]), want.sum(), rtol=1e-10)
        err = np.linalg.norm(grad[k].numpy() - gwant) / np.linalg.norm(gwant)
        assert err < 1e-8


def test_fleet_segmentation_rules(fleet):
    kernel = _kernels()[0]
    jr, jc = kernel.padded_size
    b = fleet
    plan = lanes4.make_plan4_curves(b.t, b.y, b.yerr**2, b.lengths,
                                    n_chain=2, dtype=torch.float64,
                                    device="cpu")
    _, cf = _theta_cf(kernel, THETA)
    cf2 = torch.stack([cf, cf]).detach()
    with pytest.raises(ValueError, match="n_seg == n_chain"):
        fused4.run_primal(cf2, plan, jr, jc, n_seg=4)
    with pytest.raises(ValueError, match="n_seg == n_chain"):
        fused4.build_ll_and_grad(plan, jr, jc, n_chain=2, n_seg=4)
    with pytest.raises(ValueError, match="state segments"):
        fused4.run_primal(cf2, plan, jr, jc, state_seg=3)
    # A shared row over both chains' copies: one output a copy.
    ll, ok = fused4.run_primal(cf.detach(), plan, jr, jc, n_seg=2,
                               state_seg=1)
    assert ll.shape == (2,) and float(ll[0]) == float(ll[1])
