"""Warmup adaptation: dual-averaged step size + Welford mass matrix.

Port of ``celerite_tpu/inference/adaptation.py`` on torch tensors.  Nesterov
dual averaging (Hoffman & Gelman 2014, section 3.2) drives the log step size
toward a target acceptance statistic; Welford accumulators over warmup
draws estimate a diagonal or dense inverse mass matrix, refreshed at
Stan-style doubling window boundaries.

The JAX package's ``axis_name`` pooling across sharded chains is dropped:
here the chains are one ``(n_chains, dim)`` batch on one device, and a batch
update pools all of them.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = [
    "DualAveragingState",
    "da_init",
    "da_update",
    "da_final",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_variance",
    "welford_cov_init",
    "welford_cov_update",
    "welford_covariance",
    "window_boundaries",
]


class DualAveragingState(NamedTuple):
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_sum: torch.Tensor
    mu: torch.Tensor
    count: int
    target: float


def da_init(step_size, target=0.8, mu=None):
    """Initial dual-averaging state.

    ``mu`` anchors the shrinkage point; the default log(10 * step) is
    Stan's upward bias, for a blind guess.  After
    :func:`~celerite_torch.inference.nuts.find_reasonable_step_size` pass
    ``mu=log(step_size)``.
    """
    step_size = torch.as_tensor(step_size, dtype=torch.float64)
    log_step = torch.log(step_size)
    if mu is None:
        mu = torch.log(10.0 * step_size)
    return DualAveragingState(
        log_step=log_step,
        log_step_avg=log_step,
        h_sum=torch.zeros_like(step_size),
        mu=torch.as_tensor(mu, dtype=step_size.dtype),
        count=0,
        target=float(target),
    )


def da_update(s: DualAveragingState, accept_prob, t0=10.0, gamma=0.05,
              kappa=0.75):
    """One dual-averaging step from an acceptance statistic."""
    count = s.count + 1
    h_sum = s.h_sum + (s.target - torch.as_tensor(accept_prob).to(s.h_sum))
    log_step = s.mu - math.sqrt(count) / gamma * h_sum / (count + t0)
    eta = count ** (-kappa)
    log_step_avg = eta * log_step + (1.0 - eta) * s.log_step_avg
    return s._replace(log_step=log_step, log_step_avg=log_step_avg,
                      h_sum=h_sum, count=count)


def da_final(s: DualAveragingState):
    return torch.exp(s.log_step_avg)


class WelfordState(NamedTuple):
    count: torch.Tensor
    mean: torch.Tensor
    m2: torch.Tensor


def welford_init(dim, dtype=torch.float64, device=None, batch=()):
    """Diagonal Welford accumulator; ``batch`` adds leading axes, one
    independent accumulator each (``nuts.sample_nuts_batch``'s problems)."""
    return WelfordState(
        count=torch.zeros(batch, dtype=dtype, device=device),
        mean=torch.zeros(*batch, dim, dtype=dtype, device=device),
        m2=torch.zeros(*batch, dim, dtype=dtype, device=device),
    )


def _batch_moments(s, xs):
    xs = torch.atleast_2d(torch.as_tensor(xs)).to(s.mean)
    n = torch.tensor(float(xs.shape[-2]), dtype=s.count.dtype,
                     device=s.count.device)
    batch_mean = xs.sum(-2) / n
    count = s.count + n
    delta = batch_mean - s.mean
    mean = s.mean + delta * (n / count)[..., None]
    return xs - batch_mean[..., None, :], n, count, delta, mean


def welford_update(s: WelfordState, xs):
    """Batch update with ``xs`` of shape (n_chains, dim): pools all chains.
    With a batched state, ``xs`` is ``(*batch, n_chains, dim)``."""
    dev, n, count, delta, mean = _batch_moments(s, xs)
    m2 = s.m2 + torch.sum(dev**2, dim=-2) \
        + delta**2 * (n * s.count / count)[..., None]
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_variance(s: WelfordState, regularize=True):
    count = s.count[..., None]
    var = s.m2 / torch.clamp(count - 1.0, min=1.0)
    if regularize:
        # Stan's shrinkage toward unit scale for small sample counts.
        w = count / (count + 5.0)
        var = w * var + (1.0 - w) * 1e-3
    return var


def welford_cov_init(dim, dtype=torch.float64, device=None):
    """Dense-covariance Welford accumulator: ``m2`` is (dim, dim)."""
    return WelfordState(
        count=torch.zeros((), dtype=dtype, device=device),
        mean=torch.zeros(dim, dtype=dtype, device=device),
        m2=torch.zeros(dim, dim, dtype=dtype, device=device),
    )


def welford_cov_update(s: WelfordState, xs):
    """Batch update accumulating full cross moments (dense mass matrix)."""
    dev, n, count, delta, mean = _batch_moments(s, xs)
    m2 = s.m2 + dev.T @ dev + torch.outer(delta, delta) * (n * s.count / count)
    return WelfordState(count=count, mean=mean, m2=m2)


def welford_covariance(s: WelfordState, regularize=True):
    """Sample covariance with Stan's shrinkage toward a scaled identity."""
    cov = s.m2 / torch.clamp(s.count - 1.0, min=1.0)
    if regularize:
        w = s.count / (s.count + 5.0)
        eye = torch.eye(s.mean.shape[0], dtype=cov.dtype, device=cov.device)
        cov = w * cov + (1.0 - w) * 1e-3 * eye
    return cov


def window_boundaries(num_warmup, init_buffer=75, term_buffer=50,
                      base_window=25):
    """Boolean host-side schedules (mass-window membership, window ends).

    Stan's three-phase warmup: a fast initial buffer (step size only),
    doubling slow windows (mass accumulation) and a fast terminal buffer.
    Returns two bool tensors of length ``num_warmup``.
    """
    if num_warmup < init_buffer + term_buffer + base_window:
        init_buffer = max(1, int(0.15 * num_warmup))
        term_buffer = max(1, int(0.1 * num_warmup))
        base_window = max(1, num_warmup - init_buffer - term_buffer)

    in_window = torch.zeros(num_warmup, dtype=torch.bool)
    window_end = torch.zeros(num_warmup, dtype=torch.bool)
    start = init_buffer
    end_slow = num_warmup - term_buffer
    in_window[start:end_slow] = True
    size = base_window
    pos = start
    while pos < end_slow:
        nxt = pos + size
        if nxt + 2 * size > end_slow:
            nxt = end_slow
        window_end[min(nxt, num_warmup) - 1] = True
        pos = nxt
        size *= 2
    return in_window, window_end
