"""Hamiltonian building blocks shared by the samplers, batched over chains.

Port of ``celerite_tpu/inference/nuts.py:75-157``: the metric (a diagonal
or dense inverse mass matrix), momentum draws, the leapfrog step and the
Hoffman & Gelman step-size search.  Where the JAX package maps one chain's
function over chains with ``vmap``, these take the chains as the leading
axis of a ``(n_chains, dim)`` batch, so one batched value-and-gradient call
(``GP.build_logprob(...).value_and_grad_batch``, chain-folded onto the
kernels' lanes) serves every chain.  Random draws come from an explicit
``torch.Generator`` on the chains' device.

The tree builder (``nuts_kernel``, ``_build_segments``, ``sample_nuts``)
is not ported yet (ROADMAP queue 1, item 9).
"""

from __future__ import annotations

import math

import torch

__all__ = ["find_reasonable_step_size", "value_and_grad_batch"]


def value_and_grad_batch(logprob_fn):
    """``(n, dim) -> (logp (n,), grad (n, dim))`` for a log probability.

    Takes the closure's ``value_and_grad_batch`` where it has one (the fused
    GP log probability), else autograd through ``logprob_fn`` row by row.
    """
    vag = getattr(logprob_fn, "value_and_grad_batch", None)
    if vag is not None:
        return vag

    def autograd_batch(qs):
        th = qs.detach().requires_grad_()
        with torch.enable_grad():
            lp = torch.stack([logprob_fn(r) for r in th.unbind(0)])
            (grad,) = torch.autograd.grad(lp.sum(), th)
        return lp.detach(), grad

    return autograd_batch


def _velocity(inv_mass, p):
    """dq/dt = M^-1 p for a diagonal (vector) or dense (matrix) metric;
    ``p`` is one momentum or a batch of rows (the JAX package's
    ``_velocity`` and ``_velocity_rows`` in one)."""
    if inv_mass.ndim == 2:
        return p @ inv_mass  # symmetric, so right-multiply works
    return inv_mass * p


def _sample_momentum(generator, n, dim, dtype, inv_mass):
    """``n`` draws p ~ N(0, M) with M = inv_mass^-1, as rows.

    Dense path: inv_mass = L L^T, so p = L^-T xi has covariance
    (L L^T)^-1 = M.
    """
    xi = torch.randn(n, dim, generator=generator, dtype=dtype,
                     device=inv_mass.device)
    if inv_mass.ndim == 2:
        L = torch.linalg.cholesky(inv_mass)
        return torch.linalg.solve_triangular(L.T, xi.T, upper=True).T
    return xi / torch.sqrt(inv_mass)


def _leapfrog(grad_fn, q, p, grad, eps, inv_mass):
    """One leapfrog step; ``grad_fn(q) -> (grad U, logp)`` with U = -logp.

    ``q``, ``p`` and ``grad`` are rows (one per chain); ``eps`` is a scalar
    or one step size per chain.
    """
    eps = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
    if eps.ndim == 1:
        eps = eps[:, None]
    p = p - 0.5 * eps * grad
    q = q + eps * _velocity(inv_mass, p)
    new_grad, logp = grad_fn(q)
    p = p - 0.5 * eps * new_grad
    return q, p, new_grad, logp


def _metric(inv_mass, dim, dtype, device):
    if inv_mass is None:
        return torch.ones(dim, dtype=dtype, device=device)
    inv_mass = torch.as_tensor(inv_mass, dtype=dtype).to(device)
    if inv_mass.ndim < 2:
        inv_mass = inv_mass.expand(dim)
    return inv_mass


def find_reasonable_step_size(logprob_fn, q, generator, inv_mass=None,
                              initial=1.0, max_iters=30):
    """Per chain, double or halve eps until one leapfrog's accept ratio
    crosses 1/2 (Hoffman & Gelman 2014, algorithm 4).

    ``q`` is ``(n_chains, dim)``; returns the ``(n_chains,)`` step sizes.
    Each round is one batched value-and-gradient call for every chain; a
    chain whose ratio has crossed keeps its step size, as a chain of the
    JAX package's vmapped ``while_loop`` does.
    """
    n, dim = q.shape
    inv_mass = _metric(inv_mass, dim, q.dtype, q.device)
    vag = value_and_grad_batch(logprob_fn)

    def grad_fn(x):
        logp, g = vag(x)
        return -g, logp

    grad0, logp0 = grad_fn(q)
    p0 = _sample_momentum(generator, n, dim, q.dtype, inv_mass)
    h0 = -logp0 + 0.5 * torch.sum(p0 * _velocity(inv_mass, p0), dim=-1)

    def log_ratio(eps):
        _, pn, _, logpn = _leapfrog(grad_fn, q, p0, grad0, eps, inv_mass)
        h1 = -logpn + 0.5 * torch.sum(pn * _velocity(inv_mass, pn),
                                      dim=-1)
        r = h0 - h1
        return torch.where(torch.isnan(r), -math.inf, r)

    eps = torch.full((n,), float(initial), dtype=q.dtype, device=q.device)
    lr = log_ratio(eps)
    direction = torch.where(lr > math.log(0.5), 1.0, -1.0).to(q.dtype)
    moving = torch.ones(n, dtype=torch.bool, device=q.device)
    for _ in range(max_iters):
        moving = moving & (direction * lr > direction * math.log(0.5))
        if not bool(moving.any()):
            break
        eps = torch.where(moving, eps * torch.exp2(direction), eps)
        lr = log_ratio(eps)
    return eps
