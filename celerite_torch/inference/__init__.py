"""Inference of the port: NUTS, HMC, window adaptation, diagnostics, ADVI
with the Laplace check, adaptive-tempering SMC, MAP fitting and sampler
checkpoints.

Ported (ROADMAP queue 1, items 9, 12 and 13): the chain-batched NUTS
sampler (``nuts``: metric, momentum, leapfrog, step-size search,
``nuts_kernel``, ``sample_nuts``, and ``sample_nuts_batch``, the fleet
primitive: many problems' chains as the rows of one batched run, adapted
per problem), plain HMC (``hmc``), dual averaging and Welford mass
adaptation (``adaptation``), the numpy diagnostics (``diagnostics``),
mean-field ADVI and ``laplace_fit`` (``advi``), SMC (``smc``), ``minimize``
and ``map_fit`` (``optimize``) and ``checkpoint``.  Every algorithm takes
the log probability's batched value and gradient
(``GP.build_logprob(...).value_and_grad_batch``, chain-folded onto the
gradient kernels' lanes) for all its rows at once.  The particle-sharded
SMC waits for ``parallel`` (item 15).
"""

from . import (  # noqa: F401
    adaptation,
    advi,
    checkpoint,
    diagnostics,
    hmc,
    nuts,
    optimize,
    smc,
)
from .advi import fit_advi, laplace_fit  # noqa: F401
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
    sample_nuts_batch,
)
from .smc import sample_smc  # noqa: F401
