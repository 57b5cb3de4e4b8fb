"""``inference.sample_nuts_batch`` of the port on the CPU (no JAX).

The port of tests/test_inference.py:241-258 (three Gaussian problems of
four chains each, their means recovered; through the function's batched
entry, since ``torch.func`` over the rows costs twice the time), the
chunked run bit for bit
equal to one segment with its per-problem step sizes, both value-and-
gradient entries (the function's own batched one and ``torch.func`` over
the rows) giving the same draws, and ``sample_nuts`` unchanged for a fixed
generator: its draws against values recorded from the tree before the
per-row metric came in.
"""

import numpy as np
import pytest
import torch

from celerite_torch.inference import sample_nuts, sample_nuts_batch

MUS = torch.tensor([[0.0, 0.0], [3.0, -1.0], [-2.0, 2.0]],
                   dtype=torch.float64)


def logprob(mu, th):
    return -0.5 * torch.sum((th - mu) ** 2)


def _init():
    rng = np.random.default_rng(0)
    return torch.as_tensor(rng.standard_normal((3, 4, 2)))


def _batched(fn):
    """``fn`` carrying its rows' value and gradient in one call."""
    def rows(mus, ths):
        return -0.5 * torch.sum((ths - mus) ** 2, -1), -(ths - mus)

    fn.value_and_grad_batch = rows
    return fn


def test_sample_nuts_batch_recovers_means():
    chains, info = sample_nuts_batch(
        _batched(lambda mu, th: logprob(mu, th)), MUS, _init(),
        torch.Generator().manual_seed(0), num_warmup=150, num_samples=150)
    assert chains.shape == (3, 4, 150, 2)
    means = chains.reshape(3, -1, 2).mean(1)
    np.testing.assert_allclose(means.numpy(), MUS.numpy(), atol=0.25)
    assert info["step_size"].shape == (3,)
    assert info["inv_mass"].shape == (3, 2)
    assert info["accept_prob"].shape == (3,)
    assert info["energy"].shape == (3, 4, 150)
    assert bool((info["accept_prob"] > 0.5).all())


def _short(chunk_size=None, fn=logprob, thin=1, **kwargs):
    return sample_nuts_batch(
        fn, MUS, _init(), torch.Generator().manual_seed(5), num_warmup=60,
        num_samples=40, max_tree_depth=5, warmup_max_tree_depth=4,
        chunk_size=chunk_size, thin=thin, **kwargs)


def test_sample_nuts_batch_chunks_bit_for_bit():
    one, info1 = _short()
    many, info40 = _short(chunk_size=40)
    assert torch.equal(one, many)
    assert info40["step_size"].shape == (3,)
    for key in info1:
        assert torch.equal(info1[key], info40[key]), key
    thinned, _ = _short(chunk_size=40, thin=3)
    assert thinned.shape == (3, 4, 14, 2)
    assert torch.equal(thinned, one[:, :, ::3])


def test_sample_nuts_batch_value_and_grad_batch_entry():
    """A function with ``value_and_grad_batch(data_rows, thetas)`` is
    called once for all rows and gives the draws of the vmapped entry."""
    calls = []
    fn = _batched(lambda mu, th: logprob(mu, th))
    rows = fn.value_and_grad_batch

    def counted(mus, ths):
        calls.append(ths.shape[0])
        return rows(mus, ths)

    fn.value_and_grad_batch = counted
    got, _ = _short(fn=fn)
    want, _ = _short()
    assert set(calls) == {12}
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("init_step", [0.1, "auto"])
def test_sample_nuts_batch_dict_data(init_step):
    """A dict of tensors as the data, and the step-size search per
    problem."""
    def fn(data, th):
        return -0.5 * torch.sum(((th - data["mu"]) / data["sd"]) ** 2)

    data = {"mu": MUS, "sd": torch.tensor([[1.0, 0.5], [2.0, 1.0],
                                           [0.5, 0.5]], dtype=torch.float64)}
    chains, info = sample_nuts_batch(
        fn, data, _init(), torch.Generator().manual_seed(2), num_warmup=60,
        num_samples=20, max_tree_depth=5, initial_step_size=init_step)
    assert chains.shape == (3, 4, 20, 2)
    assert bool(torch.isfinite(chains).all())
    assert info["warmup_accept_prob"].shape == (60, 3)
    assert info["warmup_divergences"].shape == (3,)


def _gauss():
    scale = torch.tensor([1.0, 4.0, 0.25], dtype=torch.float64)

    def lp(q):
        return -0.5 * torch.sum((q - 1.0) ** 2 / scale)

    lp.value_and_grad_batch = lambda qs: (
        -0.5 * torch.sum((qs - 1.0) ** 2 / scale, -1), -(qs - 1.0) / scale)
    return lp


# sample_nuts's draws on _gauss() from zeros(4, 3), generator seed 3, 60
# warmup and 20 sampling transitions at depth 5, chunks of 25: the sum of
# the draws and the first chain's last draw, recorded before the per-row
# metric came in (the same values before and after, bit for bit).
SAMPLE_NUTS_RECORD = {
    False: (275.6832002024403,
            [-0.18417288552561406, 0.05438451629667229, 0.39683126161147964]),
    True: (278.7927028566726,
           [1.5688270587981528, 0.49560833627480294, 2.0222727708912505]),
}


@pytest.mark.parametrize("dense", [False, True])
def test_sample_nuts_draws_unchanged(dense):
    chain, _ = sample_nuts(
        _gauss(), torch.zeros(4, 3, dtype=torch.float64),
        torch.Generator().manual_seed(3), num_warmup=60, num_samples=20,
        max_tree_depth=5, dense_mass=dense, chunk_size=25)
    total, last = SAMPLE_NUTS_RECORD[dense]
    assert float(chain.sum()) == total
    assert chain[0, -1].tolist() == last
