"""BASELINE config[4]: a fleet of light curves, adaptive-tempering SMC.

Port of ``examples/config4_pod_smc.py``: a batch of SHO light curves (100
to 160 points each, drawn from the prior with ``GP.sample``), and SMC over
one set of SHO parameters shared by the fleet, on a posterior whose
oscillator frequency is ambiguous.  The fleet's log-likelihood comes from
``data.make_fleet_loglik``: every curve is one lane of the fused4 kernels,
and each chunk of particles is one folded call (``n_chain`` = the chunk),
its gradient through the four gradient kernels.

It runs on one card through ``inference.sample_smc``.  The JAX example
shards the particles over a device mesh with ``sample_smc_sharded``
(ROADMAP queue 1 item 15); on one device that algorithm is
``sample_smc``'s.  Run with ``python -m
celerite_torch.examples.config4_pod_smc [--curves N] [--particles N]
[--seed N] [--device cuda|cpu]``; scale up with ``--curves 10240``.
"""

import argparse

import numpy as np
import torch

from celerite_torch import GP, terms
from celerite_torch.data import LightCurveBatch, make_fleet_loglik
from celerite_torch.gp import _fold_cap
from celerite_torch.inference import sample_smc
from celerite_torch.ops import lanes4


def make_batch(n_curves=32, seed=4, device=None):
    """``n_curves`` SHO curves of 100-160 points on [0, 20], each drawn
    with ``GP.sample`` (seed ``seed + i``)."""
    rng = np.random.default_rng(seed)
    ts, ys, es = [], [], []
    gp_sim = GP(terms.SHOTerm(log_S0=0.0, log_Q=2.0, log_omega0=np.log(3.0)),
                device=device)
    for i in range(n_curves):
        n = int(rng.integers(100, 160))
        t = np.sort(rng.uniform(0, 20, n))
        e = rng.uniform(0.1, 0.2, n)
        gp_sim.compute(t, e)
        ts.append(t)
        ys.append(gp_sim.sample(seed=seed + i))
        es.append(e)
    return LightCurveBatch.from_ragged(ts, ys, es)


def fleet_log_like(kernel, batch, rows, dtype=torch.float64, device=None):
    """``theta -> fleet log-likelihood`` carrying ``value_and_grad_batch``.

    A batch of ``rows`` parameter vectors runs in chunks of ``chunk`` rows
    (a power of two), each one folded call of ``make_fleet_loglik(...,
    n_chain=chunk)``; ``chunk`` is the fold cap the GP closures take for
    the fleet's saves (``gp._fold_cap`` over curves x Nmax points), at
    most ``rows`` rounded up.  A short last chunk repeats its first row.
    Non-finite values read -1e12 with a zero gradient
    (examples/config4_pod_smc.py's ``log_like``).
    """
    dev = lanes4.resolve_device(device)
    jr, jc = kernel.padded_size
    cap = _fold_cap(batch.t.size, jr + 2 * jc, dtype, dev)
    chunk = min(cap, 1 << max(0, int(rows) - 1).bit_length())
    fleet = make_fleet_loglik(kernel, batch, dtype=dtype, n_chain=chunk,
                              device=dev)

    def value_and_grad_batch(qs):
        qs = torch.as_tensor(qs).to(device=dev, dtype=dtype)
        n = qs.shape[0]
        pad = -n % chunk
        qs = torch.cat([qs, qs[:1].expand(pad, -1)])
        vals, grads = [], []
        for part in qs.split(chunk):
            th = part.detach().requires_grad_()
            with torch.enable_grad():
                ll, ok = fleet(th)
                ok = ok & torch.isfinite(ll)
                (grad,) = torch.autograd.grad(
                    torch.where(ok, ll, 0.0).sum(), th)
            vals.append(torch.where(ok, ll.detach(), -1e12))
            grads.append(torch.where(ok[:, None], grad, 0.0))
        return torch.cat(vals)[:n], torch.cat(grads)[:n]

    def log_like(theta):
        return value_and_grad_batch(torch.as_tensor(theta)[None])[0][0]

    log_like.value_and_grad_batch = value_and_grad_batch
    log_like.chunk = chunk
    log_like.plan = fleet.plan
    return log_like


def log_prior(theta):
    return -0.5 * torch.sum((theta / 2.0) ** 2)


log_prior.value_and_grad_batch = lambda qs: (
    -0.5 * torch.sum((qs / 2.0) ** 2, dim=-1), -qs / 4.0)


def main(n_particles=512, seed=4, n_curves=32, device=None, num_mutations=3,
         max_stages=50):
    """Run the example; returns ``(SMCResult, log_like)``."""
    dev = lanes4.resolve_device(device)
    batch = make_batch(n_curves, device=dev)
    kernel = terms.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=1.0)
    log_like = fleet_log_like(kernel, batch, n_particles, device=dev)

    rng = np.random.default_rng(seed)
    init = torch.as_tensor(rng.standard_normal((n_particles, 3)), device=dev)
    print("device: {0}, particles: {1}, curves: {2}, particles a call: "
          "{3}".format(dev, n_particles, len(batch), log_like.chunk))
    res = sample_smc(log_prior, log_like, init,
                     torch.Generator(device=dev).manual_seed(seed),
                     num_mutations=num_mutations, hmc_step_size=0.05,
                     max_stages=max_stages)
    parts = res.particles.cpu().numpy()
    print("stages: {0}  log-evidence: {1:.1f}  accept: {2:.2f}".format(
        res.num_stages, float(res.log_evidence), float(res.final_accept)))
    print("posterior: log_S0 {0:+.2f}+-{1:.2f}  log_Q {2:+.2f}+-{3:.2f}  "
          "log_w0 {4:+.2f}+-{5:.2f} (truth 0.00, 2.00, {6:.2f})".format(
              parts[:, 0].mean(), parts[:, 0].std(), parts[:, 1].mean(),
              parts[:, 1].std(), parts[:, 2].mean(), parts[:, 2].std(),
              np.log(3.0)))
    return res, log_like


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--particles", type=int, default=512)
    ap.add_argument("--curves", type=int, default=32)
    ap.add_argument("--seed", type=int, default=4)
    ap.add_argument("--device", default=None)
    a = ap.parse_args()
    main(n_particles=a.particles, seed=a.seed, n_curves=a.curves,
         device=a.device)
