"""BASELINE config[1]: SHOTerm fit to a Kepler-like light curve.

Port of ``examples/config1_sho_lightcurve.py``: the reference's 'first'
tutorial (docs/tutorials/first.rst) fits a stochastically-driven damped
harmonic oscillator to an irregularly sampled light curve and draws the
conditional prediction; here with NUTS and ``GP.predict(return_var=True)``
(the Kalman/RTS smoother).  Run with ``python -m
celerite_torch.examples.config1_sho_lightcurve`` (on the card).
"""

import numpy as np
import torch

from celerite_torch import GP, terms
from celerite_torch.inference import sample_nuts, summary
from celerite_torch.ops import lanes4


def simulate_lightcurve(n=700, seed=1, device=None):
    """Quasi-periodic stellar variability + gaps, Kepler-ish cadence."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 30, n))
    # observing gaps
    keep = (t % 7.0) < 5.5
    t = t[keep]
    yerr = rng.uniform(0.05, 0.1, len(t))
    gp_sim = GP(
        terms.SHOTerm(log_S0=-0.5, log_Q=1.5, log_omega0=np.log(2.5)),
        device=device,
    )
    gp_sim.compute(t, yerr)
    return t, gp_sim.sample(seed=seed), yerr


def main(n=700, seed=1, warmup=500, samples=500, device=None):
    """Fit, print the posterior summary and the prediction band; returns
    ``(stats, mu, var)``, the band's mean and variance at 500 points."""
    dev = lanes4.resolve_device(device)
    t, y, yerr = simulate_lightcurve(n=n, seed=seed, device=dev)
    rng = np.random.default_rng(seed)

    kernel = terms.SHOTerm(log_S0=0.0, log_Q=0.5, log_omega0=0.5)
    gp = GP(kernel, device=dev)
    gp.compute(t, yerr)
    print("N =", len(t), " initial ll:", gp.log_likelihood(y))

    logprob = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * torch.sum((th / 3.0) ** 2),
    )
    init = torch.as_tensor(
        gp.get_parameter_vector()[None, :]
        + 0.05 * rng.standard_normal((4, 3)), device=dev)
    chain, info = sample_nuts(
        logprob, init, torch.Generator(device=dev).manual_seed(seed),
        num_warmup=warmup, num_samples=samples,
    )
    names = ["log_S0", "log_Q", "log_omega0"]
    stats = summary(chain.cpu().numpy(), names=names)
    for i, name in enumerate(names):
        print(
            "{0:10s} mean={1:+.3f} sd={2:.3f} ess={3:6.0f}".format(
                name, stats["mean"][i], stats["sd"][i], stats["ess"][i]
            )
        )

    # Conditional prediction at the posterior mean.
    gp.set_parameter_vector(stats["mean"])
    gp.compute(t, yerr)
    x = np.linspace(t.min(), t.max(), 500)
    mu, var = gp.predict(y, x, return_var=True)
    print(
        "prediction band: mean in [{0:.2f}, {1:.2f}], "
        "median sd {2:.3f}".format(
            mu.min(), mu.max(), float(np.median(np.sqrt(var)))
        )
    )
    return stats, mu, var


if __name__ == "__main__":
    main()
