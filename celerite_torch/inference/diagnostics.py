"""Convergence diagnostics: R-hat, effective sample size, summaries.

A copy of ``celerite_tpu/inference/diagnostics.py`` (numpy only; the port
imports nothing of the JAX package): split-chain R-hat and autocorrelation
ESS (Vehtari et al. 2021 style, simplified), computed post hoc on
(n_chains, n_samples, dim) arrays.  Pass tensors through ``.cpu().numpy()``
or any array numpy accepts.
"""

from __future__ import annotations

import numpy as np

__all__ = ["split_rhat", "effective_sample_size", "summary", "ebfmi"]


def _split(chains):
    """(C, S, D) -> (2C, S//2, D) split chains."""
    c, s, d = chains.shape
    half = s // 2
    return np.concatenate(
        [chains[:, :half], chains[:, half : 2 * half]], axis=0
    )


def split_rhat(chains):
    """Split-chain potential scale reduction factor per dimension."""
    x = _split(np.asarray(chains, dtype=float))
    m, n, d = x.shape
    chain_means = x.mean(axis=1)  # (m, d)
    chain_vars = x.var(axis=1, ddof=1)  # (m, d)
    between = n * chain_means.var(axis=0, ddof=1)
    within = chain_vars.mean(axis=0)
    var_est = (n - 1) / n * within + between / n
    return np.sqrt(var_est / within)


def _autocov(x):
    """FFT autocovariance of a 1-D series."""
    n = len(x)
    x = x - x.mean()
    nfft = int(2 ** np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(x, nfft)
    acov = np.fft.irfft(f * np.conj(f), nfft)[:n].real
    return acov / n


def effective_sample_size(chains):
    """Autocorrelation-based ESS per dimension (Geyer initial-positive).

    chains: (C, S, D).  Combines within-chain autocovariances with the
    multi-chain variance like Vehtari et al.
    """
    x = np.asarray(chains, dtype=float)
    c, s, d = x.shape
    ess = np.empty(d)
    for j in range(d):
        acovs = np.stack([_autocov(x[i, :, j]) for i in range(c)])
        mean_var = acovs[:, 0].mean() * s / (s - 1.0)
        var_plus = mean_var * (s - 1.0) / s
        if c > 1:
            var_plus += x[:, :, j].mean(axis=1).var(ddof=1)
        rho = 1.0 - (mean_var - acovs.mean(axis=0)) / var_plus
        # Geyer: sum consecutive pairs while positive.
        total = 0.0
        t = 1
        while t + 1 < s:
            pair = rho[t] + rho[t + 1]
            if pair < 0:
                break
            total += pair
            t += 2
        tau = 1.0 + 2.0 * total
        ess[j] = c * s / max(tau, 1e-12)
    return ess


def ebfmi(energy):
    """Energy Bayesian fraction of missing information, per chain.

    ``energy``: (n_chains, n_samples) Hamiltonian series from
    ``sample_nuts``'s ``info["energy"]``.  E-BFMI_c = mean squared
    successive difference / variance of the energy series (Betancourt
    2016).  Values below ~0.3 indicate the momentum resampling cannot
    explore the energy marginal — typically heavy tails.
    """
    e = np.atleast_2d(np.asarray(energy, dtype=float))
    num = np.mean(np.diff(e, axis=1) ** 2, axis=1)
    den = np.var(e, axis=1)
    return num / np.maximum(den, 1e-300)


def summary(chains, names=None):
    """Per-parameter table: mean, sd, 5/95%, ESS, R-hat (dict of arrays)."""
    x = np.asarray(chains, dtype=float)
    flat = x.reshape(-1, x.shape[-1])
    out = {
        "mean": flat.mean(axis=0),
        "sd": flat.std(axis=0),
        "q5": np.percentile(flat, 5, axis=0),
        "q95": np.percentile(flat, 95, axis=0),
        "ess": effective_sample_size(x),
        "rhat": split_rhat(x),
    }
    if names is not None:
        out["names"] = list(names)
    return out
