"""BASELINE config[2]: asteroseismic granulation model at N ~ 100k.

Port of ``examples/config2_asteroseismic.py``: a sum of SHOTerms
(granulation background + oscillation envelope) plus a JitterTerm, fit with
gradient-based NUTS, the data drawn from the true model's Gauss-Markov
realization (``ops.smoother.sample_prior``, host float64).  Mirrors the
reference's asteroseismology example (paper/ms.tex Ex.4) at two orders of
magnitude more data.  Run with ``python -m
celerite_torch.examples.config2_asteroseismic [n]`` (on the card).
"""

import time

import numpy as np
import torch

from celerite_torch import GP, terms
from celerite_torch.inference import sample_nuts, summary
from celerite_torch.ops import lanes4
from celerite_torch.ops.lower import Coefficients
from celerite_torch.ops.smoother import sample_prior


def main(n=100_000, seed=2, chains=4, warmup=200, samples=200,
         chunk_size=None, solver="auto", fast_grad=True, modes=1,
         warmup_depth=6, progress=False, device=None):
    """Simulate, fit and print the summary; returns ``(chain, info)``."""
    dev = lanes4.resolve_device(device)
    rng = np.random.default_rng(seed)
    t = np.sort(rng.uniform(0, 100.0, n))
    yerr = np.full(n, 0.3)

    # ``modes`` oscillation SHOTerms on top of the granulation
    # background (the reference Ex.4 uses several modes at J=8,
    # paper/ms.tex:1626).
    kernel_true = (
        terms.SHOTerm(log_S0=0.5, log_Q=np.log(1 / np.sqrt(2)),
                      log_omega0=0.0)       # granulation
        + terms.SHOTerm(log_S0=-1.0, log_Q=2.5, log_omega0=1.8)  # osc.
        + terms.JitterTerm(log_sigma=-1.5)
    )
    for k in range(1, modes):
        kernel_true = kernel_true + terms.SHOTerm(
            log_S0=-1.0 - 0.3 * k, log_Q=2.5, log_omega0=1.8 + 0.25 * k
        )
    # Simulate host-side in f64 through the Gauss-Markov realization —
    # exact at any N.
    kc = Coefficients(*kernel_true.coefficients, jitter=kernel_true.jitter)
    y = (
        sample_prior(kc, t, seed=seed, device=dev)
        + np.sqrt(yerr**2 + kernel_true.jitter)
        * rng.standard_normal(n)
    )

    kernel = (
        terms.SHOTerm(log_S0=0.2, log_Q=-0.3, log_omega0=0.2)
        + terms.SHOTerm(log_S0=-0.7, log_Q=2.0, log_omega0=1.6)
        + terms.JitterTerm(log_sigma=-1.0)
    )
    for k in range(1, modes):
        kernel = kernel + terms.SHOTerm(
            log_S0=-0.8 - 0.3 * k, log_Q=2.0, log_omega0=1.7 + 0.25 * k
        )
    gp = GP(kernel, device=dev)

    logprob = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * torch.sum((th / 3.0) ** 2),
        solver=solver, fast_grad=fast_grad,
    )

    dim = gp.vector_size
    init = torch.as_tensor(
        gp.get_parameter_vector()[None, :]
        + 0.02 * rng.standard_normal((chains, dim)), device=dev)

    t0 = time.perf_counter()
    chain, info = sample_nuts(
        logprob, init, torch.Generator(device=dev).manual_seed(seed),
        num_warmup=warmup, num_samples=samples, max_tree_depth=8,
        chunk_size=chunk_size, warmup_max_tree_depth=warmup_depth,
        progress=progress,
    )
    dt = time.perf_counter() - t0
    total = chains * samples
    print(
        "N={0}: {1} samples in {2:.1f}s ({3:.2f} samples/s, "
        "{4} leapfrogs)".format(
            n, total, dt, total / dt, int(info["num_steps"])
        )
    )
    stats = summary(chain.cpu().numpy(), names=gp.get_parameter_names())
    for i, name in enumerate(stats["names"]):
        print(
            "{0:28s} mean={1:+.3f} sd={2:.3f} ess={3:6.0f}".format(
                name, stats["mean"][i], stats["sd"][i], stats["ess"][i]
            )
        )
    return chain, info


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("n", type=int, nargs="?", default=100_000)
    ap.add_argument("--chains", type=int, default=4)
    ap.add_argument("--warmup", type=int, default=200)
    ap.add_argument("--samples", type=int, default=200)
    ap.add_argument("--chunk", type=int, default=None,
                    help="run the sampler in segments of this many "
                         "transitions")
    ap.add_argument("--solver", default="auto")
    ap.add_argument("--fast-grad", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--modes", type=int, default=1,
                    help="oscillation SHOTerms (2 -> padded width 12)")
    ap.add_argument("--warmup-depth", type=int, default=6,
                    help="warmup-only tree-depth cap (sampling uses 8)")
    ap.add_argument("--progress", action="store_true",
                    help="live per-chunk metrics (needs --chunk)")
    args = ap.parse_args()
    main(n=args.n, chains=args.chains, warmup=args.warmup,
         samples=args.samples, chunk_size=args.chunk,
         solver=args.solver, fast_grad=args.fast_grad,
         modes=args.modes, warmup_depth=args.warmup_depth,
         progress=args.progress)
