#!/usr/bin/env python
"""Time the Kalman/RTS engines behind ``GP.predict(..., return_var=True)``
on the card, to set their constants (PERF.md section 6).

Usage (on a machine with an NVIDIA H100), from the root of a checkout:

    python3 tools/kalman_tune.py

Prints one JSON line a measurement, each with the card's name and power
limit (nvidia-smi), float64 throughout:

- ``engines``: the blocked engine (``ops.pkalman``, at its default L) and
  the flat one (one associative scan over all the points), each behind
  the same device merge (the stable argsort and the searchsorted one), at
  main path B's size (config[2], N = 1e5 with 1e4 sorted test points) and
  main path A's (bench.py's model, N = 1e6 with 1e5): the median ms of 5
  host-clock calls from numpy in to numpy out, the peak device memory
  above what was allocated before, the launches, device-busy ms and idle
  share of one call (torch.profiler), and the largest distance between
  the engines' results;
- ``block_sweep``: the blocked engine at L = 4-512 at B's size;
- ``gate``: the sequential engine (``ops.smoother``) against the blocked
  and the flat ones at 512, 2048 and 8192 merged points of B's data.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 5
BLOCKS = (4, 8, 16, 32, 64, 128, 256, 512)
GATE_SIZES = (512, 2048, 8192)


def main():
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch

    import celerite_torch
    import chip_smoke as cs
    from celerite_torch import terms
    from celerite_torch.ops import pkalman, smoother
    from celerite_torch.testing import bench_kernel, config2_kernel

    if not torch.cuda.is_available():
        print("kalman_tune: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_name_power()

    def emit(what, **fields):
        print(json.dumps({"measurement": what, "card": smi, **fields}),
              flush=True)

    def timed(fn, reps=REPS, warm=True):
        """(median ms, last result) of synchronised calls after one warm
        call, host clock."""
        if warm:
            fn()
        per, out = [], None
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            per.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(per)), out

    def blocked(L):
        return lambda *grid: pkalman._blocked_fs_impl(*grid, L)

    engines = {"blocked": blocked(pkalman._BLOCK),
               "flat": pkalman.parallel_filter_smoother}

    def predict(coeffs, t, yerr, y, x, engine, sorted_test=False):
        """numpy in, numpy out: the merged-grid predict on the card."""
        real_, jitter = smoother._realized(coeffs)

        def put(v):
            return torch.as_tensor(v, dtype=torch.float64, device=dev)

        mean, var = pkalman._predict_var_device(
            real_, put(t), put(yerr**2), put(y), put(x), jitter, engine,
            sorted_test=sorted_test)
        return mean.cpu().numpy(), var.cpu().numpy()

    def coefficients(kernel):
        return cs.kalman_coefficients(celerite_torch.GP(kernel))

    cases = (("B", coefficients(config2_kernel(terms)), cs.b_data(),
              10_000),
             ("A", coefficients(bench_kernel(terms)), cs.bench_data(),
              100_000))
    for size, coeffs, (t, y, yerr), m in cases:
        x = np.sort(np.random.default_rng(19).uniform(0.0, t[-1], m))
        rows, results = {}, {}
        for name, engine in engines.items():
            for sorted_test in (False, True):
                merge = "searchsorted" if sorted_test else "argsort"

                def call():
                    return predict(coeffs, t, yerr, y, x, engine,
                                   sorted_test)

                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                ms, results[name] = timed(call)
                peak = torch.cuda.max_memory_allocated() - base
                prof = cs.profile_evals(lambda _: call(), None, evals=1)
                rows["{0}_{1}".format(name, merge)] = {
                    "ms": ms, "peak_mib": peak / 2**20,
                    "launches": prof["kernel_launches_per_eval"],
                    "device_busy_ms": prof["device_busy_ms_per_eval"],
                    "device_idle_share": prof["device_idle_share"]}
        dist = max(float(np.abs(a - b).max() / np.abs(b).max())
                   for a, b in zip(results["flat"], results["blocked"]))
        emit("engines", size=size, n=len(t), m=m, block=pkalman._BLOCK,
             rows=rows, rel_dist_flat_vs_blocked=dist)

    coeffs, (t, y, yerr), m = cases[0][1], cases[0][2], cases[0][3]
    x = np.sort(np.random.default_rng(19).uniform(0.0, t[-1], m))
    sweep = {L: timed(lambda: predict(coeffs, t, yerr, y, x, blocked(L)),
                      reps=3)[0] for L in BLOCKS}
    emit("block_sweep", size="B", n=len(t), m=m, ms=sweep)

    for nm in GATE_SIZES:
        nt = nm * 10 // 11
        xg = np.sort(np.random.default_rng(nm).uniform(t[0], t[nt - 1],
                                                       nm - nt))
        ms_seq, want = timed(lambda: smoother.predict_var(
            coeffs, t[:nt], yerr[:nt]**2, y[:nt], xg, device=dev), reps=1,
            warm=False)
        row = {"seq_ms": ms_seq}
        for name, engine in engines.items():
            row[name + "_ms"], got = timed(lambda: predict(
                coeffs, t[:nt], yerr[:nt], y[:nt], xg, engine), reps=3)
            row[name + "_rel_dist_vs_seq"] = max(
                float(np.abs(a - b).max() / np.abs(b).max())
                for a, b in zip(got, want))
        emit("gate", merged=nm, n=nt, m=nm - nt, **row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
