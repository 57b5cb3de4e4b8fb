"""``celerite_torch.data`` against the JAX package's ``data`` module.

The batch from ragged curves (native packer, and the numpy packer it falls
back on, equal), ``.lcb`` files byte for byte the JAX package's and read
back from a JAX-written file, ``batched_gp_log_likelihood`` against JAX's
jitted one (1e-10) and the port's per-curve ``GP``, and
``make_fleet_loglik`` on the CPU at one and two chains.
"""

import os

import jax
import numpy as np
import pytest
import torch

from celerite_tpu import data as jdata, terms as jterms
from celerite_torch import GP, data, terms

THETA = np.array([0.1, 1.0, 0.5])


def make_ragged(n_curves=5, seed=0):
    rng = np.random.default_rng(seed)
    ts, ys, es = [], [], []
    for _ in range(n_curves):
        n = int(rng.integers(20, 60))
        t = np.sort(rng.uniform(0, 10, n))
        e = rng.uniform(0.1, 0.2, n)
        ts.append(t)
        ys.append(np.sin(t) + e * rng.standard_normal(n))
        es.append(e)
    return ts, ys, es


def _same_batch(got, want):
    for k in ("t", "y", "yerr", "mask", "lengths"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("nmax", [None, 70])
def test_from_ragged_matches_jax(nmax):
    ts, ys, es = make_ragged()
    _same_batch(data.LightCurveBatch.from_ragged(ts, ys, es, nmax=nmax),
                jdata.LightCurveBatch.from_ragged(ts, ys, es, nmax=nmax))
    assert len(data.LightCurveBatch.from_ragged(ts, ys, es)) == 5
    with pytest.raises(ValueError, match="dimension mismatch"):
        data.LightCurveBatch.from_ragged(ts, ys[:4], es)


@pytest.mark.parametrize("repeat_edge", [False, True])
def test_native_and_numpy_packers_equal(repeat_edge, monkeypatch):
    assert data._get_lib() is not None, "native packer did not build"
    ts, _, _ = make_ragged(7, seed=3)
    ts.append(np.zeros(0))
    native, ln = data._pack(ts, 64, fill=-1.5, repeat_edge=repeat_edge)
    monkeypatch.setattr(data, "_get_lib", lambda: None)
    plain, lp = data._pack(ts, 64, fill=-1.5, repeat_edge=repeat_edge)
    np.testing.assert_array_equal(native, plain)
    np.testing.assert_array_equal(ln, lp)


def test_lcb_bytes_and_reads_match_jax(tmp_path):
    ts, ys, es = make_ragged()
    ours, theirs = (os.path.join(tmp_path, n) for n in ("t.lcb", "j.lcb"))
    data.save_lcb(ours, ts, ys, es)
    jdata.save_lcb(theirs, ts, ys, es)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        assert f.read() == g.read()
    _same_batch(data.load_lcb(theirs), jdata.load_lcb(theirs))
    _same_batch(data.load_lcb(theirs, nmax=80),
                jdata.LightCurveBatch.from_ragged(ts, ys, es, nmax=80))
    rts, rys, res = data.load_lcb(theirs, batch=False)
    for got, want in zip((rts, rys, res), (ts, ys, es)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_lcb_rejects_bad_files(tmp_path):
    path = os.path.join(tmp_path, "bad.lcb")
    with open(path, "wb") as f:
        f.write(b"XXXX" + bytes(12))
    with pytest.raises(ValueError, match="not an lcb file"):
        data.load_lcb(path)
    with open(path, "wb") as f:
        f.write(b"CTLC" + (2).to_bytes(4, "little") + bytes(8))
    with pytest.raises(ValueError, match="unsupported lcb version"):
        data.load_lcb(path)


def test_batched_loglik_matches_jax_and_gp():
    ts, ys, es = make_ragged()
    batch = data.LightCurveBatch.from_ragged(ts, ys, es)
    jbatch = jdata.LightCurveBatch.from_ragged(ts, ys, es)
    jk = jterms.SHOTerm(log_S0=THETA[0], log_Q=THETA[1],
                        log_omega0=THETA[2])
    want, okj = jax.jit(lambda p: jdata.batched_gp_log_likelihood(
        jk, p, jbatch))(THETA)
    kernel = terms.SHOTerm(*THETA)
    lls, oks = data.batched_gp_log_likelihood(
        kernel, torch.as_tensor(THETA), batch, device="cpu")
    assert lls.shape == oks.shape == (5,)
    assert bool(oks.all()) and bool(np.all(okj))
    np.testing.assert_allclose(lls.numpy(), np.asarray(want), rtol=1e-10)
    for b in range(5):
        gp = GP(terms.SHOTerm(*THETA), device="cpu")
        gp.compute(ts[b], es[b])
        np.testing.assert_allclose(float(lls[b]), gp.log_likelihood(ys[b]),
                                   rtol=1e-10)


def test_batched_loglik_not_positive_definite():
    """A kernel that is not positive definite: -inf and ok False on every
    curve, as the per-curve oracle says."""
    ts, ys, es = make_ragged(3)
    batch = data.LightCurveBatch.from_ragged(ts, ys, es)
    kernel = terms.ComplexTerm(log_a=0.0, log_b=-1.0, log_c=0.0, log_d=0.0)
    theta = torch.tensor([0.0, 2.0, -3.0, 0.0], dtype=torch.float64)
    lls, oks = data.batched_gp_log_likelihood(kernel, theta, batch,
                                              device="cpu")
    assert not bool(oks.any())
    assert bool((lls == -np.inf).all())


def test_fleet_loglik_on_cpu():
    """One chain: the per-curve values and their gradient (the batched
    route); two chains: each chain's fleet sum and gradient row from the
    kernels' plain versions on the fleet plan, against the one-chain
    closure's sums."""
    ts, ys, es = make_ragged()
    batch = data.LightCurveBatch.from_ragged(ts, ys, es)
    kernel = terms.SHOTerm(*THETA)
    one = data.make_fleet_loglik(kernel, batch, device="cpu")
    two = data.make_fleet_loglik(kernel, batch, n_chain=2, device="cpu")
    assert one.plan is None and two.plan.num_blocks == 16
    rows = torch.tensor(np.stack([THETA, THETA + 0.2]), requires_grad=True)
    ll2, ok2 = two(rows)
    (g2,) = torch.autograd.grad(ll2.sum(), rows)
    assert ll2.shape == ok2.shape == (2,) and bool(ok2.all())
    for k in range(2):
        th = rows[k].detach().clone().requires_grad_()
        lls, oks = one(th)
        assert lls.shape == (5,) and bool(oks.all())
        (g1,) = torch.autograd.grad(lls.sum(), th)
        np.testing.assert_allclose(float(ll2[k].detach()),
                                   float(lls.detach().sum()), rtol=1e-10)
        np.testing.assert_allclose(g2[k].numpy(), g1.numpy(), rtol=1e-8,
                                   atol=1e-8 * float(g1.norm()))
    with torch.no_grad():
        np.testing.assert_allclose(two(rows)[0].numpy(),
                                   ll2.detach().numpy(), rtol=1e-12)


def test_fleet_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ts, ys, es = make_ragged(2)
    batch = data.LightCurveBatch.from_ragged(ts, ys, es)
    kernel = terms.SHOTerm(*THETA)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.make_fleet_loglik(kernel, batch)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        data.batched_gp_log_likelihood(kernel, torch.as_tensor(THETA), batch)


def test_curve_logprob_batched_entry_matches_vmap():
    """``make_curve_logprob``: one call of the gradient pipeline's plain
    versions over 10 rows (5 curves x 2 parameter sets; a fleet plan of
    16 lanes, one coefficient row a lane) against ``torch.func.vmap`` of
    the per-curve masked sequential log probability, and against JAX's
    ``seq.gp_log_likelihood_masked`` per curve."""
    from celerite_tpu.ops import lower as jlower, seq as jseq

    ts, ys, es = make_ragged()
    batch = data.LightCurveBatch.from_ragged(ts, ys, es)
    kernel = terms.SHOTerm(*THETA)
    lp = data.make_curve_logprob(
        kernel, lambda th: -0.5 * torch.sum((th / 3.0) ** 2))
    rows = data.curve_rows(batch, device="cpu")
    rows = {k: v.repeat_interleave(2, 0) for k, v in rows.items()}
    gen = torch.Generator().manual_seed(1)
    th = torch.as_tensor(THETA) + 0.1 * torch.randn(
        10, 3, generator=gen, dtype=torch.float64)
    val, grad = lp.value_and_grad_batch(rows, th)
    gref, vref = torch.func.vmap(torch.func.grad_and_value(lp, argnums=1))(
        rows, th)
    np.testing.assert_allclose(val.numpy(), vref.numpy(), rtol=1e-12)
    np.testing.assert_allclose(grad.numpy(), gref.numpy(), rtol=1e-9,
                               atol=1e-10 * float(gref.abs().max()))
    jk = jterms.SHOTerm(log_S0=THETA[0], log_Q=THETA[1], log_omega0=THETA[2])

    @jax.jit
    @jax.vmap
    def jax_rows(p, t, y, yerr, mask, n):
        coeffs = jlower.Coefficients(*jk.get_padded_coefficients(p),
                                     jitter=jk.get_jitter(p))
        ll, _ = jseq.gp_log_likelihood_masked(
            jlower.lower(coeffs, t, yerr**2), y * mask, mask, n)
        return ll - 0.5 * jax.numpy.sum((p / 3.0) ** 2)

    pick = np.repeat(np.arange(5), 2)
    want = jax_rows(th.numpy(), batch.t[pick], batch.y[pick],
                    batch.yerr[pick], batch.mask[pick].astype(float),
                    batch.lengths[pick])
    np.testing.assert_allclose(val.numpy(), np.asarray(want), rtol=1e-10)
