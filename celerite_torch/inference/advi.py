"""Automatic Differentiation Variational Inference (mean-field), and the
Laplace approximation at the mode.

Port of ``celerite_tpu/inference/advi.py``: a reparameterized ELBO with a
diagonal-Gaussian posterior q(theta) = N(mu, diag(exp(2 log_sigma))),
optimized with Adam (:class:`.optimize.Adam`, optax's).  Matches
BASELINE.json configs[3]: ADVI over celerite kernel hyperparameters with a
Hessian check at the mode available via :func:`laplace_fit`.

Random draws come from an explicit ``torch.Generator`` on the parameters'
device.  The ``num_mc`` draws of a step are one batched value-and-gradient
call (``value_and_grad_batch``, chain-folded onto the gradient kernels'
lanes for the GP log probability), and so are the Laplace Hessian's
``2 dim`` gradient points.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .nuts import value_and_grad_batch
from .optimize import Adam, value_and_grad

__all__ = ["ADVIResult", "fit_advi", "laplace_fit"]


class ADVIResult(NamedTuple):
    mu: torch.Tensor
    sigma: torch.Tensor
    elbo_trace: torch.Tensor

    def sample(self, generator, num_samples):
        eps = torch.randn(num_samples, self.mu.shape[0], generator=generator,
                          dtype=self.mu.dtype, device=self.mu.device)
        return self.mu + self.sigma * eps


def _neg_elbo_and_grad(vag_batch, v, eps):
    """``(-ELBO, d(-ELBO)/dv)`` at ``v = [mu, log_sigma]`` over the draws
    ``eps`` ``(num_mc, dim)``, from one batched call of ``vag_batch``.

    The reparameterization gradient in closed form (advi.py:79-97):
    d/dmu = mean_i g_i, d/dlog_sigma = mean_i (g_i * eps_i) * sigma + 1.
    A draw whose log probability is not finite counts -1e10 with a zero
    gradient, as autograd through the clamped ELBO gives.
    """
    dim = eps.shape[1]
    mu, log_sigma = v[:dim], v[dim:]
    sigma = torch.exp(log_sigma)
    lps, gs = vag_batch(mu + sigma * eps)
    finite = torch.isfinite(lps)
    lps = torch.where(finite, lps, -1e10)
    gs = torch.where(finite[:, None], gs, 0.0)
    elbo = torch.mean(lps) + torch.sum(log_sigma)
    g_mu = torch.mean(gs, dim=0)
    g_ls = torch.mean(gs * eps, dim=0) * sigma + 1.0
    return -elbo, -torch.cat([g_mu, g_ls])


def fit_advi(logprob_fn, init_params, generator, num_steps=2000, num_mc=8,
             learning_rate=5e-2):
    """Maximize the ELBO; returns an :class:`ADVIResult`.

    ELBO = E_q[logprob(theta)] + entropy(q); the entropy of a diagonal
    Gaussian is sum(log sigma) + const, so the estimator is the mean over
    eps of logprob(mu + sigma*eps) + sum(log_sigma).  log_sigma starts at
    -2.  ``init_params`` sets the device; ``generator`` is a
    ``torch.Generator`` there.  Each step draws ``num_mc`` rows and takes
    their log probabilities and gradients in one call of the closure's
    ``value_and_grad_batch`` (autograd through ``logprob_fn`` row by row
    without it), assembled in closed form (:func:`_neg_elbo_and_grad`).
    ``elbo_trace`` holds the ELBO estimate before each step.
    """
    init_params = torch.as_tensor(init_params).detach()
    dim = init_params.shape[0]
    dtype, dev = init_params.dtype, init_params.device
    v = torch.cat([init_params, torch.full((dim,), -2.0, dtype=dtype,
                                           device=dev)])
    opt = Adam(learning_rate)
    state = opt.init(v)
    vag = value_and_grad_batch(logprob_fn)
    trace = []
    for _ in range(num_steps):
        eps = torch.randn(num_mc, dim, generator=generator, dtype=dtype,
                          device=dev)
        loss, g = _neg_elbo_and_grad(vag, v, eps)
        updates, state = opt.update(g, state)
        v = v + updates
        trace.append(-loss)
    elbo = torch.stack(trace) if trace else v.new_zeros(0)
    return ADVIResult(mu=v[:dim], sigma=torch.exp(v[dim:]), elbo_trace=elbo)


def _fd_hessian(vag_batch, mode):
    """Negative Hessian of the log probability at ``mode`` by central
    differences of its exact gradient, h = 1e-4 (1 + |mode|), symmetrised:
    the ``2 dim`` points in one batched call."""
    dim = mode.shape[0]
    h = 1e-4 * (1.0 + torch.abs(mode))
    step = torch.diag(h)
    _, g = vag_batch(torch.cat([mode + step, mode - step]))
    cols = -(g[:dim] - g[dim:]) / (2.0 * h[:, None])
    return 0.5 * (cols + cols.T)


def laplace_fit(logprob_fn, init_params, num_steps=500, learning_rate=1e-2):
    """MAP + Laplace approximation (Hessian check at the mode).

    Returns ``(mode, cov)`` where ``cov`` is the inverse negative Hessian at
    the mode (float64): the 'Hessian-checked posterior at mode' of
    BASELINE.json configs[3].  The ascent is Adam on the negated log
    probability (1e10 and a zero gradient where it is not finite),
    through the closure's ``value_and_grad`` where it has one.

    The Hessian: a closure carrying ``value_and_grad_batch`` (the fused GP
    log probability, whose kernels are first-order only) takes central
    differences of its exact gradient, all ``2 dim`` points in one
    ``value_and_grad_batch`` call; one carrying only ``value_and_grad``
    takes the same differences a point at a time; any other closure takes
    ``torch.func.hessian`` of the negated, clamped ``logprob_fn``.
    """
    opt = Adam(learning_rate)
    vag = value_and_grad(logprob_fn)

    v = torch.as_tensor(init_params).detach().clone()
    state = opt.init(v)
    for _ in range(num_steps):
        lp, g_lp = vag(v)
        bad = ~torch.isfinite(lp)
        g = torch.where(bad, 0.0, -g_lp)
        updates, state = opt.update(g, state)
        v = v + updates
    mode = v
    if hasattr(logprob_fn, "value_and_grad_batch"):
        hess = _fd_hessian(logprob_fn.value_and_grad_batch, mode)
    elif hasattr(logprob_fn, "value_and_grad"):
        def rows(qs):
            lp, grad = zip(*(vag(r) for r in qs.unbind(0)))
            return torch.stack(lp), torch.stack(grad)

        hess = _fd_hessian(rows, mode)
    else:
        def neg_lp(x):
            lp = logprob_fn(x)
            return torch.where(torch.isfinite(lp), -lp, 1e10)

        hess = torch.func.hessian(neg_lp)(mode)
    cov = torch.linalg.inv(hess.to(torch.float64))
    return mode, cov
