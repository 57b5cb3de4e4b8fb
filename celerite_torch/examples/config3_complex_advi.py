"""BASELINE config[3]: general ComplexTerm kernel with ADVI + Hessian check.

Port of ``examples/config3_complex_advi.py``: fits the 4-parameter
ComplexTerm with mean-field ADVI and validates the variational posterior
against the Laplace approximation at the mode (inverse Hessian), reporting
the per-parameter scale ratios.  Run with ``python -m
celerite_torch.examples.config3_complex_advi`` (on the card).
"""

import numpy as np
import torch

from celerite_torch import GP, terms
from celerite_torch.inference import fit_advi, laplace_fit
from celerite_torch.ops import lanes4


def main(n=512, seed=3, num_steps=3000, device=None):
    """Fit by ADVI (``num_steps`` steps, 8 draws a step) and by Laplace
    (``num_steps`` Adam steps at 2e-2) and print both; returns a dict of
    the ADVI result, the mode, the Laplace covariance and the largest
    ADVI-to-mode drift in Laplace standard deviations."""
    dev = lanes4.resolve_device(device)
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 40, n))
    yerr = np.full(n, 0.2)

    # (log_a + log_c >= log_b + log_d keeps the term positive-definite.)
    gp_sim = GP(
        terms.ComplexTerm(log_a=0.3, log_b=-1.0, log_c=-0.3, log_d=0.5),
        device=dev,
    )
    gp_sim.compute(t, yerr)
    y = gp_sim.sample(seed=seed)

    gp = GP(
        terms.ComplexTerm(log_a=0.0, log_b=-0.7, log_c=0.0, log_d=0.5),
        device=dev,
    )
    gp.compute(t, yerr)
    logprob = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * torch.sum((th / 3.0) ** 2),
    )
    x0 = torch.as_tensor(gp.get_parameter_vector(), device=dev)

    res = fit_advi(
        logprob, x0, torch.Generator(device=dev).manual_seed(seed),
        num_steps=num_steps, num_mc=8,
    )
    mode, cov = laplace_fit(logprob, x0, num_steps=num_steps,
                            learning_rate=2e-2)
    mu, sigma = res.mu.cpu().numpy(), res.sigma.cpu().numpy()
    mode_np = mode.cpu().numpy()
    sd_laplace = np.sqrt(np.diag(cov.cpu().numpy()))

    names = gp.get_parameter_names()
    print("param          ADVI mu   Laplace mode   ADVI sd  Laplace sd")
    for i, name in enumerate(names):
        print(
            "{0:14s} {1:+.3f}    {2:+.3f}         {3:.3f}    {4:.3f}".format(
                name, mu[i], mode_np[i], sigma[i], sd_laplace[i],
            )
        )
    drift = np.abs(mu - mode_np)
    drift_sd = float((drift / sd_laplace).max())
    print(
        "mode agreement: max |ADVI mu - Laplace mode| = {0:.3f} "
        "({1:.1f} Laplace sd)".format(drift.max(), drift_sd)
    )
    return {"advi": res, "mode": mode, "cov": cov, "drift_sd": drift_sd}


if __name__ == "__main__":
    main()
