"""Adaptive-tempering Sequential Monte Carlo with HMC mutations.

Port of ``celerite_tpu/inference/smc.py``.  Targets multimodal posteriors
(BASELINE.json configs[4]: QPO posteriors).  Anneals from the prior-ish
initial distribution to the posterior through temperatures chosen
adaptively so the effective sample size stays at a fixed fraction;
particles are resampled systematically and mutated with a few
jittered-HMC steps at each temperature.

Where the JAX package maps one particle's function over the cloud with
``vmap``, the cloud is here the leading axis of an ``(n, dim)`` batch: its
likelihood, and the tempered target's value and gradient at every
leapfrog, are one batched call each (``value_and_grad_batch``,
chain-folded onto the gradient kernels' lanes for the GP log
probability).  Random draws come from an explicit ``torch.Generator`` on
the particles' device.  The stage loop runs on the host.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from .hmc import hmc_kernel
from .nuts import value_and_grad_batch

__all__ = ["SMCResult", "sample_smc", "systematic_resample"]


class SMCResult(NamedTuple):
    particles: torch.Tensor  # (n_particles, dim)
    log_evidence: torch.Tensor  # log marginal-likelihood estimate
    num_stages: int
    final_accept: torch.Tensor
    betas: torch.Tensor  # the temperature after each stage


def _systematic_indices(log_weights, u):
    """Systematic resampling's indices for the uniform draw ``u``: the
    positions (u + i) / n located in the weights' cumulative sum."""
    n = log_weights.shape[0]
    e = torch.exp(log_weights - log_weights.max())
    w = e / e.sum()
    positions = (u + torch.arange(n, dtype=w.dtype, device=w.device)) / n
    cum = torch.cumsum(w, dim=0)
    return torch.searchsorted(cum, positions, right=True).clamp(0, n - 1)


def systematic_resample(generator, log_weights):
    """Systematic (low-variance) resampling; returns particle indices."""
    u = torch.rand((), generator=generator, dtype=log_weights.dtype,
                   device=log_weights.device)
    return _systematic_indices(log_weights, u)


def _ess(log_weights):
    lw = log_weights - torch.logsumexp(log_weights, dim=0)
    return torch.exp(-torch.logsumexp(2.0 * lw, dim=0))


def _find_next_beta(log_like, beta, target_frac):
    """Largest next temperature keeping ESS >= target_frac * N (30
    bisections); 1 where the ESS at 1 suffices."""
    target = target_frac * log_like.shape[0]
    one = torch.ones((), dtype=beta.dtype, device=beta.device)

    def ess_at(b):
        return _ess((b - beta) * log_like)

    lo, hi = beta, one
    for _ in range(30):
        mid = 0.5 * (lo + hi)
        ok = ess_at(mid) >= target
        lo, hi = torch.where(ok, mid, lo), torch.where(ok, hi, mid)
    return torch.where(ess_at(one) >= target, one, lo)


def _safe(x):
    return torch.where(torch.isfinite(x), x, -1e12)


def _tempered(vag_prior, vag_like, beta):
    """The tempered log probability prior + beta * likelihood, carrying its
    batched value and gradient (-1e12 and a zero gradient where it is not
    finite, smc.py:114-137)."""

    def vag(qs):
        lpri, gpri = vag_prior(qs)
        ll, gll = vag_like(qs)
        val = lpri + beta * ll
        bad = ~torch.isfinite(val)
        return (torch.where(bad, -1e12, val),
                torch.where(bad[:, None], 0.0, gpri + beta * gll))

    def logprob(q):
        return vag(q[None])[0][0]

    logprob.value_and_grad_batch = vag
    return logprob


def sample_smc(
    log_prior_fn: Callable,
    log_like_fn: Callable,
    init_particles,
    generator,
    num_mutations=5,
    hmc_step_size=0.1,
    num_leapfrog=8,
    target_ess_frac=0.5,
    max_stages=50,
    host_loop=False,
):
    """Adaptive-tempering SMC.  Returns an :class:`SMCResult`.

    ``init_particles`` (n, dim) should be draws from the prior (or any
    overdispersed initialization; the first tempering stage corrects);
    ``generator`` is a ``torch.Generator`` on their device.  Each stage
    takes the cloud's likelihood (non-finite values read -1e12), chooses
    the next temperature, updates the evidence, resamples, and mutates
    with ``num_mutations`` batched HMC transitions (a jittered trajectory
    length a particle, diagonal inverse mass the cloud's variance) on the
    tempered target; the step size then moves by exp(0.5 (acceptance -
    0.6)).  The prior's and the likelihood's ``value_and_grad_batch``
    serve the likelihood and every leapfrog (autograd row by row without
    them).  The result also holds ``betas``, the temperature after each
    stage (the JAX package's result has no schedule).  ``host_loop`` is
    accepted for the JAX package's signature: the stages run on the host
    either way, with the same result.
    """
    del host_loop
    particles = torch.as_tensor(init_particles).detach()
    n, dim = particles.shape
    dtype, dev = particles.dtype, particles.device
    vag_prior = value_and_grad_batch(log_prior_fn)
    vag_like = value_and_grad_batch(log_like_fn)

    beta = torch.zeros((), dtype=dtype, device=dev)
    log_z = torch.zeros((), dtype=dtype, device=dev)
    accept = torch.ones((), dtype=dtype, device=dev)
    step_size = torch.tensor(hmc_step_size, dtype=dtype, device=dev)
    betas = []
    while len(betas) < max_stages and bool(beta < 1.0):
        ll = _safe(vag_like(particles)[0])
        beta_new = _find_next_beta(ll, beta, target_ess_frac)
        lw = (beta_new - beta) * ll
        log_z = log_z + torch.logsumexp(lw, dim=0) - math.log(n)
        particles = particles[systematic_resample(generator, lw)]

        # The HMC metric follows the cloud: as the tempered posterior
        # narrows (often anisotropically), unit-mass proposals lose all
        # acceptance.
        inv_mass = torch.clamp(torch.var(particles, dim=0, correction=0),
                               min=1e-10)
        target = _tempered(vag_prior, vag_like, beta_new)
        acc = torch.zeros(n, dtype=dtype, device=dev)
        for _ in range(num_mutations):
            particles, info = hmc_kernel(target, particles, generator,
                                         step_size, inv_mass,
                                         num_leapfrog=num_leapfrog)
            acc = acc + info.accept_prob
        accept = torch.mean(acc / num_mutations)
        # Crude step-size controller toward ~0.6 acceptance.
        step_size = step_size * torch.exp(0.5 * (accept - 0.6))
        beta = beta_new
        betas.append(beta)
    return SMCResult(particles=particles, log_evidence=log_z,
                     num_stages=len(betas), final_accept=accept,
                     betas=torch.stack(betas) if betas else beta.new_zeros(0))
