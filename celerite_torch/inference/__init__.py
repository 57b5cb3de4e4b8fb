"""Inference of the port: NUTS, HMC, window adaptation and diagnostics.

Ported (ROADMAP queue 1, item 9): the chain-batched NUTS sampler
(``nuts``: metric, momentum, leapfrog, step-size search, ``nuts_kernel``,
``sample_nuts``), plain HMC (``hmc``), dual averaging and Welford mass
adaptation (``adaptation``) and the numpy diagnostics (``diagnostics``).
``sample_nuts_batch``, the fleet primitive, waits for the fleet slice
(queue 1, item 13).
"""

from . import adaptation, diagnostics, hmc, nuts  # noqa: F401
from .diagnostics import (  # noqa: F401
    ebfmi,
    effective_sample_size,
    split_rhat,
    summary,
)
from .hmc import HMCInfo, hmc_kernel  # noqa: F401
from .nuts import (  # noqa: F401
    NUTSInfo,
    find_reasonable_step_size,
    nuts_kernel,
    sample_nuts,
)
