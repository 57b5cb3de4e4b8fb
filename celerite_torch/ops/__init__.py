"""Numeric core of the port: lowering, oracles, lane plan, fused primal.

- ``kernels``: closed-form kernel / PSD evaluation
- ``poly``: polynomial algebra + Sturm PSD positivity check (numpy)
- ``ds``: double-single phase reduction for the float32 lowering
- ``lower``: coefficient arrays -> semiseparable (U, V, phi, A) lowering
- ``dense``: O(N^3) dense oracle (tests only)
- ``seq``: sequential solver (oracle; CPU route below N = 4096)
- ``lanes4``: the per-dataset lane plan and the packed coefficient vector
- ``fused4``: the fused primal and the gradient pipeline: the CUDA kernels
  and their plain versions
- ``dsfused``: exact mode (``precision="ds"``): the forward-mode kernels
  and their plain versions
- ``lanes`` and ``fused``: the lane plan and lowering of pre-lowered
  ``(L, P, B)`` streams
- ``adjoint``: the adjoint pipeline on those streams (padded widths up to
  16): the CUDA kernels and their plain versions
"""
