"""Inference of the port: HMC, window adaptation and diagnostics.

Ported so far (ROADMAP queue 1, item 9): the chain-batched Hamiltonian
pieces (``nuts``: metric, momentum, leapfrog, step-size search), plain HMC
(``hmc``), dual averaging and Welford mass adaptation (``adaptation``) and
the numpy diagnostics (``diagnostics``).  The NUTS tree builder and
``sample_nuts`` are the next slice.
"""

from . import adaptation, diagnostics, hmc, nuts  # noqa: F401
from .diagnostics import (  # noqa: F401
    ebfmi,
    effective_sample_size,
    split_rhat,
    summary,
)
from .hmc import HMCInfo, hmc_kernel  # noqa: F401
from .nuts import find_reasonable_step_size  # noqa: F401
