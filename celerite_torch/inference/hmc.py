"""Plain HMC with jittered trajectory length, batched over chains.

Port of ``celerite_tpu/inference/hmc.py:27-87``.  One transition moves a
``(n_chains, dim)`` batch; every leapfrog is one batched value-and-gradient
call for all chains (chain-folded onto the kernels' lanes for the GP log
probability).  With ``jitter=True`` each chain draws its own trajectory
length in [1, num_leapfrog] and a chain past its length keeps its state
while the others move, the semantics of the JAX package's vmapped
``fori_loop``; with ``jitter=False`` every chain takes ``num_leapfrog``
steps (a caller that wants one jittered length shared by all chains draws
it and passes it, as benchmarks/nuts_config2.py:153-180 does).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .nuts import _metric, _sample_momentum, _velocity, value_and_grad_batch

__all__ = ["HMCInfo", "hmc_kernel"]

# Energy error above which a trajectory counts as divergent (Stan's
# threshold, as the JAX package's NUTS uses).
DIVERGENCE = 1000.0


class HMCInfo(NamedTuple):
    accept_prob: torch.Tensor
    accepted: torch.Tensor
    energy: torch.Tensor  # Hamiltonian H = -logp + kinetic at the new state
    logp: torch.Tensor  # log probability at the new state
    num_steps: torch.Tensor  # leapfrogs each chain took
    diverging: torch.Tensor  # energy error above 1000 or not finite (Stan)


def hmc_kernel(logprob_fn, q, generator, step_size, inv_mass,
               num_leapfrog=16, jitter=True):
    """One HMC transition of every chain; returns ``(q_new, HMCInfo)``.

    ``q`` is ``(n_chains, dim)``; ``inv_mass`` a (dim,) diagonal or a dense
    (dim, dim) inverse mass matrix shared by the chains; ``generator`` a
    ``torch.Generator`` on ``q``'s device.
    """
    n, dim = q.shape
    dtype, dev = q.dtype, q.device
    inv_mass = _metric(inv_mass, dim, dtype, dev)
    vag = value_and_grad_batch(logprob_fn)

    def kinetic(p):
        return 0.5 * torch.sum(p * _velocity(inv_mass, p), dim=-1)

    p0 = _sample_momentum(generator, n, dim, dtype, inv_mass)
    logp0, grad0 = vag(q)
    h0 = -logp0 + kinetic(p0)

    if jitter:
        # Uniform jitter in [1, num_leapfrog] decorrelates trajectory
        # lengths (avoids resonances; Neal 2011).
        steps = torch.randint(1, num_leapfrog + 1, (n,), generator=generator,
                              device=dev)
    else:
        steps = torch.full((n,), int(num_leapfrog), device=dev)
    eps = torch.as_tensor(step_size, dtype=dtype).to(dev)

    qq, pp, gg, lp = q, p0, grad0, logp0
    for i in range(int(steps.max())):
        live = (i < steps)[:, None]
        ph = pp + 0.5 * eps * gg  # gg = grad logp
        qn = qq + eps * _velocity(inv_mass, ph)
        lpn, gn = vag(qn)
        pn = ph + 0.5 * eps * gn
        qq = torch.where(live, qn, qq)
        pp = torch.where(live, pn, pp)
        gg = torch.where(live, gn, gg)
        lp = torch.where(live[:, 0], lpn, lp)
    h1 = -lp + kinetic(pp)
    diverging = ~(h1 - h0 <= DIVERGENCE)
    log_accept = torch.clamp(h0 - h1, max=0.0)
    log_accept = torch.where(torch.isnan(log_accept), -math.inf, log_accept)
    u = torch.rand(n, generator=generator, dtype=dtype, device=dev)
    accept = torch.log(u) < log_accept
    q_new = torch.where(accept[:, None], qq, q)
    return q_new, HMCInfo(
        accept_prob=torch.exp(log_accept),
        accepted=accept,
        energy=torch.where(accept, h1, h0),
        logp=torch.where(accept, lp, logp0),
        num_steps=steps,
        diverging=diverging,
    )
