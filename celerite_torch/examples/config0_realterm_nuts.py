"""BASELINE config[0]: RealTerm GP likelihood + NUTS fit, N=1024.

Port of ``examples/config0_realterm_nuts.py``: simulates a series from a
RealTerm GP, then runs a 4-chain NUTS fit and prints a posterior summary
with diagnostics.  Run with ``python -m
celerite_torch.examples.config0_realterm_nuts`` (on the card).
"""

import numpy as np
import torch

from celerite_torch import GP, terms
from celerite_torch.inference import sample_nuts, summary
from celerite_torch.ops import lanes4


def main(n=1024, seed=42, num_warmup=500, num_samples=500, device=None):
    """Fit and print the summary; returns ``(chains, info)``."""
    dev = lanes4.resolve_device(device)
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 40, n))
    yerr = np.full(n, 0.25)

    truth = dict(log_a=0.5, log_c=-0.5)
    gp_sim = GP(terms.RealTerm(**truth), device=dev)
    gp_sim.compute(t, yerr)
    y = gp_sim.sample(seed=seed)

    gp = GP(terms.RealTerm(log_a=0.0, log_c=0.0), device=dev)
    gp.compute(t, yerr)
    print("initial log-likelihood:", gp.log_likelihood(y))

    logprob = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * torch.sum((th / 3.0) ** 2),
    )
    init = torch.as_tensor(
        gp.get_parameter_vector()[None, :]
        + 0.1 * rng.standard_normal((4, 2)), device=dev)
    chain, info = sample_nuts(
        logprob, init, torch.Generator(device=dev).manual_seed(seed),
        num_warmup=num_warmup, num_samples=num_samples,
    )
    stats = summary(chain.cpu().numpy(), names=["log_a", "log_c"])
    for i, name in enumerate(stats["names"]):
        print(
            "{0:8s} mean={1:+.3f} sd={2:.3f} ess={3:6.0f} rhat={4:.3f}"
            " (truth {5:+.3f})".format(
                name, stats["mean"][i], stats["sd"][i],
                stats["ess"][i], stats["rhat"][i], truth[name],
            )
        )
    print("divergences:", int(info["divergences"]))
    return chain, info


if __name__ == "__main__":
    main()
