"""Numeric core of the port: lowering, oracles, lane plan, fused primal.

- ``kernels``: closed-form kernel / PSD evaluation
- ``poly``: polynomial algebra + Sturm PSD positivity check (numpy)
- ``ds``: double-single phase reduction for the float32 lowering
- ``lower``: coefficient arrays -> semiseparable (U, V, phi, A) lowering
- ``dense``: O(N^3) dense oracle (tests only)
- ``seq``: sequential solver (oracle; CPU route below N = 4096)
- ``blocked``: the block-parallel solver in plain torch (autograd), the
  CPU route of wide models and the backward of the pre-lowered primals
- ``lanes4``: the per-dataset lane plan and the packed coefficient vector
- ``fused4``: the fused primal and the gradient pipeline: the CUDA kernels
  and their plain versions
- ``dsfused``: exact mode (``precision="ds"``): the forward-mode kernels
  and their plain versions
- ``lanes`` and ``fused``: the lane plan and lowering of pre-lowered
  ``(L, P, B)`` streams, and the value on them: the single-sweep kernel
  (padded widths up to 8) and its plain version
- ``tangent``: the value and its forward-mode gradient on those streams
  (padded widths up to 16): the CUDA kernels and their plain versions
- ``pallas_solver``: the three-pass primal on those streams (padded
  widths up to 16): the CUDA kernels and their plain versions
- ``adjoint``: the adjoint pipeline on those streams (padded widths up to
  16): the CUDA kernels and their plain versions
- ``smoother``: the Gauss-Markov realization (numpy), the sequential
  Kalman/RTS smoother and the prior sampler
- ``pkalman``: the associative-scan and blocked Kalman/RTS engines and the
  merged-grid predictive variance
- ``carma``: CARMA(p, q) Kalman likelihood and its celerite conversion
"""

from . import blocked, carma, fused, pkalman, seq, smoother


def best_ll(ssm, resid):
    """GP log-likelihood of an SSM through the port's fastest backend for
    the tensors' device (celerite_tpu/ops/__init__.py:18-37).

    Below 4096 points the sequential solver; on the card
    ``fused.gp_log_likelihood`` up to padded width 16 (the single-sweep
    kernel at width 8 or less, the three-pass kernels above) and
    ``blocked.gp_log_likelihood`` above, where the kernels stop (ROADMAP
    queue 2, item 10); on the CPU ``blocked.gp_log_likelihood``.  Returns
    the ll value only (-inf when the factorization fails).
    """
    n, p = ssm.U.shape
    if n < 4096:
        ll, _ = seq.gp_log_likelihood(ssm, resid)
    elif ssm.U.device.type == "cuda" and p <= 16:
        ll, _ = fused.gp_log_likelihood(ssm, resid)
    else:
        ll, _ = blocked.gp_log_likelihood(ssm, resid)
    return ll
