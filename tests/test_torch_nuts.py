"""The port's NUTS against the JAX package's, on the same targets.

Deterministic parts are held exactly: the bit helpers and the checkpoint
levels each leaf opens and closes.  Random parts cannot match JAX's
streams and are held by their distributions: dense-mass NUTS over 8 chains
on a correlated 4-D Gaussian gives its mean and covariance within 4
Monte-Carlo standard errors, and JAX's ``sample_nuts`` on the same target
agrees with the port within 4 combined standard errors.  A chain whose
tree stops early keeps its state while the others finish, and a chunked
run repeats an unchunked one exactly.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from celerite_tpu.inference import nuts as jnuts
from celerite_torch.inference import diagnostics, nuts

RNG = np.random.default_rng(0)
_A = RNG.standard_normal((4, 4))
COV = _A @ _A.T / 4 + 0.3 * np.eye(4)
MEAN = np.array([0.5, -1.0, 2.0, 0.0])
PREC = np.linalg.inv(COV)
INIT = RNG.standard_normal((8, 4))
WARMUP, SAMPLES = 300, 500


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread for these small tensors: the tests run in
    several worker processes at once, and per-op thread hand-offs then
    cost more than the arithmetic."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gaussian(wall=None):
    """The target as a log probability with ``value_and_grad_batch``;
    ``wall``: a steep penalty beyond q[0] = wall."""
    prec, mean = torch.as_tensor(PREC), torch.as_tensor(MEAN)

    def value_and_grad_batch(qs):
        d = qs - mean
        lp, g = -0.5 * torch.sum(d * (d @ prec), -1), -(d @ prec)
        if wall is not None:
            over = torch.clamp(qs[:, 0] - wall, min=0.0)
            lp = lp - 1e12 * over**2
            g = g.clone()
            g[:, 0] -= 2e12 * over
        return lp, g

    def logprob(q):
        return value_and_grad_batch(q[None])[0][0]

    logprob.value_and_grad_batch = value_and_grad_batch
    return logprob


def _moments(x):
    """Means and covariance entries of draws (chains, draws, dim), each
    with its Monte-Carlo standard error."""
    dim = x.shape[-1]
    cols = [x[..., i] for i in range(dim)]
    c = x - MEAN
    cols += [c[..., i] * c[..., j] for i in range(dim) for j in range(i, dim)]
    z = np.stack(cols, -1)
    ess = diagnostics.effective_sample_size(z)
    flat = z.reshape(-1, z.shape[-1])
    return flat.mean(0), flat.std(0) / np.sqrt(ess)


def _truth():
    iu = np.triu_indices(4)
    return np.concatenate([MEAN, COV[iu]])


@functools.lru_cache(maxsize=None)
def _port_draws():
    gen = torch.Generator().manual_seed(1)
    chain, info = nuts.sample_nuts(_gaussian(), torch.as_tensor(INIT), gen,
                                   num_warmup=WARMUP, num_samples=SAMPLES,
                                   dense_mass=True)
    return chain.numpy(), info


def test_bit_helpers_and_checkpoints_match_jax():
    xs = np.array([0, 1, 2, 3, 4, 7, 8, 12, 255, 256, 1023, 2**20 + 6, -1,
                   -8, 2**31 - 1], np.int32)
    np.testing.assert_array_equal(
        nuts._popcount(torch.as_tensor(xs)).numpy(),
        np.asarray(jnuts._popcount(jnp.asarray(xs))))
    np.testing.assert_array_equal(
        nuts._trailing_zeros(torch.as_tensor(xs)).numpy(),
        np.asarray(jnuts._trailing_zeros(jnp.asarray(xs))))
    md = 6
    lvl = jnp.arange(1, md + 1)
    for depth in range(md):
        for leaf in range(1 << depth):
            opened, closed = nuts._checkpoint_masks(leaf, depth, md)
            n = jnp.int32(leaf)
            np.testing.assert_array_equal(
                opened.numpy(), np.asarray(lvl <= jnuts._trailing_zeros(n)))
            np.testing.assert_array_equal(
                closed.numpy(),
                np.asarray((lvl <= jnuts._trailing_zeros(n + 1))
                           & (lvl <= depth)))


def test_nuts_correlated_gaussian_moments():
    x, info = _port_draws()
    assert x.shape == (8, SAMPLES, 4)
    got, se = _moments(x)
    assert np.all(np.abs(got - _truth()) < 4 * se), (got - _truth()) / se
    assert 0.6 < float(info["accept_prob"]) < 0.99
    assert int(info["divergences"]) == 0


def test_nuts_agrees_with_jax_sample_nuts():
    x, _ = _port_draws()
    prec, mean = jnp.asarray(PREC), jnp.asarray(MEAN)

    def logprob(q):
        d = q - mean
        return -0.5 * d @ prec @ d

    xj, _ = jnuts.sample_nuts(logprob, jnp.asarray(INIT),
                              jax.random.PRNGKey(1), num_warmup=WARMUP,
                              num_samples=SAMPLES, dense_mass=True)
    got, se = _moments(x)
    want, sej = _moments(np.asarray(xj))
    assert np.all(np.abs(got - want) < 4 * np.hypot(se, sej))


def test_stopped_chain_keeps_its_state_while_the_others_finish():
    """Chain 0 starts past the wall: its first leapfrog diverges and its
    tree stops at depth 1 with its start as the proposal.  The other
    chains go on, and their transitions are exactly what they are when
    chain 0 starts in the bulk instead."""
    logprob = _gaussian(wall=3.0)
    q = torch.as_tensor(INIT[:4]).clone()
    q[0, 0] = 4.0
    outs = []
    for q0 in (q, torch.cat([torch.zeros(1, 4, dtype=q.dtype), q[1:]])):
        gen = torch.Generator().manual_seed(5)
        outs.append(nuts.nuts_kernel(logprob, q0, gen, 0.1,
                                     torch.as_tensor(COV),
                                     max_tree_depth=8))
    (qa, ia), (qb, ib) = outs
    assert bool(ia.diverging[0]) and int(ia.tree_depth[0]) == 1
    assert int(ia.num_steps[0]) == 1
    np.testing.assert_array_equal(qa[0].numpy(), q[0].numpy())
    assert bool((ia.tree_depth[1:] > 1).all())
    assert bool((qa[1:] != q[1:]).any(1).all())
    for a, b in ((qa, qb), (ia.tree_depth, ib.tree_depth),
                 (ia.accept_prob, ib.accept_prob), (ia.energy, ib.energy)):
        np.testing.assert_array_equal(a[1:].numpy(), b[1:].numpy())


@pytest.mark.parametrize("dense", [False, True])
def test_sample_nuts_chunked_repeats_unchunked(dense):
    logprob = _gaussian()
    runs, seen = [], []
    for chunk in (None, 7):
        gen = torch.Generator().manual_seed(3)
        runs.append(nuts.sample_nuts(
            logprob, torch.as_tensor(INIT[:2]), gen, num_warmup=30,
            num_samples=20, chunk_size=chunk, dense_mass=dense,
            initial_step_size="auto", warmup_max_tree_depth=4,
            progress=seen.append if chunk else None))
    (c1, i1), (c2, i2) = runs
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())
    for k in ("accept_prob", "divergences", "num_steps", "inv_mass",
              "warmup_accept_prob"):
        np.testing.assert_array_equal(np.asarray(i1[k]), np.asarray(i2[k]))
    assert [r["phase"] for r in seen] == ["warmup"] * 5 + ["sample"] * 3
