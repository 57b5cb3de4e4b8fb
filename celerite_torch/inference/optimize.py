"""Maximum-a-posteriori fitting conveniences.

Port of ``celerite_tpu/inference/optimize.py``.  The reference tutorials
fit by passing the negative log-likelihood and its gradient to
scipy.optimize (docs/tutorials/first.rst); here the same workflow is one
call: Adam on the pure log-probability, on the host loop, with the result
written back into the GP.  Where the JAX package takes an optax transform,
these take a learning rate or any object with optax's ``init`` /
``update`` shape (:class:`Adam` is ``optax.adam``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops import lanes4

__all__ = ["Adam", "map_fit", "minimize", "value_and_grad"]


class AdamState(NamedTuple):
    count: int
    mu: torch.Tensor  # first moment
    nu: torch.Tensor  # second moment


# optax.adam's fixed moments and denominator floor.
B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    """``optax.adam(learning_rate)``: b1 0.9, b2 0.999, eps 1e-8 added
    outside the square root, both moments bias-corrected.

    ``init(x) -> state``; ``update(g, state) -> (updates, state)``, the
    step to add to ``x``.
    """

    def __init__(self, learning_rate):
        self.learning_rate = learning_rate

    def init(self, x):
        return AdamState(0, torch.zeros_like(x), torch.zeros_like(x))

    def update(self, g, state):
        mu = (1 - B1) * g + B1 * state.mu
        nu = (1 - B2) * (g * g) + B2 * state.nu
        count = state.count + 1
        mu_hat = mu / (1 - B1 ** count)
        nu_hat = nu / (1 - B2 ** count)
        step = mu_hat / (torch.sqrt(nu_hat) + EPS)
        return -self.learning_rate * step, AdamState(count, mu, nu)


def _optimizer(optimizer, default_lr):
    """``None`` -> Adam(default_lr); a number -> Adam(number); else the
    object itself (``init`` / ``update``)."""
    if optimizer is None:
        return Adam(default_lr)
    if isinstance(optimizer, (int, float)):
        return Adam(float(optimizer))
    return optimizer


def value_and_grad(fn):
    """``theta -> (fn(theta), grad)``: the closure's ``value_and_grad``
    where it has one (the fused GP log probability), else autograd.

    On the autograd path a non-finite value has a zero gradient, as the
    JAX package's ``jnp.where`` around ``jax.value_and_grad`` gives.
    """
    vag = getattr(fn, "value_and_grad", None)
    if vag is not None:
        return vag

    def autograd(theta):
        th = theta.detach().requires_grad_()
        with torch.enable_grad():
            v = fn(th)
            if v.requires_grad:
                (g,) = torch.autograd.grad(v, th)
            else:
                g = torch.zeros_like(th)
        v = v.detach()
        return v, torch.where(torch.isfinite(v), g, 0.0)

    return autograd


def minimize(neg_logprob_fn, x0, num_steps=1000, optimizer=None):
    """Minimize a scalar function with Adam; returns ``(x, trace)``.

    Honors a fused ``value_and_grad`` attribute on ``neg_logprob_fn``
    (convention: it returns the value and gradient of the *objective*),
    else autograd.  A non-finite loss reads 1e12 and non-finite gradient
    entries 0.  ``optimizer``: a learning rate, or an object with
    ``init(x)`` and ``update(g, state) -> (updates, state)``; ``None`` is
    Adam at 1e-2.  ``trace`` holds the loss before each step.
    """
    opt = _optimizer(optimizer, 1e-2)
    vag = value_and_grad(neg_logprob_fn)
    x = torch.as_tensor(x0).detach().clone()
    state = opt.init(x)
    trace = []
    for _ in range(num_steps):
        loss, g = vag(x)
        loss = torch.where(torch.isfinite(loss), loss, 1e12)
        g = torch.where(torch.isfinite(g), g, 0.0)
        updates, state = opt.update(g, state)
        x = x + updates
        trace.append(loss)
    trace = torch.stack(trace) if trace else x.new_zeros(0)
    return x, trace


def map_fit(gp, t, y, yerr=1.123e-12, log_prior=None, num_steps=1000,
            optimizer=None, solver="auto", set_parameters=True):
    """MAP-fit a GP's active parameters to data.

    Builds the pure log-posterior via :meth:`GP.build_logprob`, minimizes
    its negation (the closure's ``value_and_grad`` where it has one) on
    the GP's device, and by default writes the optimum back into ``gp``.
    ``optimizer`` as in :func:`minimize`.  Returns ``(params,
    logprob_trace)`` as numpy.
    """
    logprob = gp.build_logprob(t, y, yerr=yerr, log_prior=log_prior,
                               solver=solver)
    device = lanes4.resolve_device(gp.device)
    x0 = torch.as_tensor(np.asarray(gp.get_parameter_vector(), np.float64),
                         device=device)

    def neg(q):
        return -logprob(q)

    vag = getattr(logprob, "value_and_grad", None)
    if vag is not None:
        def neg_vag(q):
            v, g = vag(q)
            return -v, -g
        neg.value_and_grad = neg_vag
    x, trace = minimize(neg, x0, num_steps=num_steps, optimizer=optimizer)
    params = x.cpu().numpy()
    if set_parameters:
        gp.set_parameter_vector(params)
    return params, -trace.cpu().numpy()

