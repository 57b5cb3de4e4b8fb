"""Adaptive wall-clock benchmarking (reference celerite/timer.py analog).

Port of ``celerite_tpu/utils/timer.py``: ``benchmark`` repeats a callable
until enough wall-clock has elapsed for a stable estimate.  CUDA work runs
asynchronously, so every call is followed by ``torch.cuda.synchronize``
once CUDA is in use (the JAX package blocks on the result instead).
"""

from __future__ import annotations

import time

import torch

__all__ = ["benchmark"]


def _block():
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def benchmark(fn, *args, minimum_time=0.2, max_time=10.0, warmup=1):
    """Return the best-estimate seconds-per-call of ``fn(*args)``."""
    for _ in range(warmup):
        fn(*args)
        _block()
    count = 0
    t0 = time.perf_counter()
    while True:
        fn(*args)
        _block()
        count += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= minimum_time and count >= 3:
            break
        if elapsed > max_time:
            break
    return elapsed / count
