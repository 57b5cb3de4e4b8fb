"""Dense O(N^3) oracle solver (tests only).

Port of ``celerite_tpu/ops/dense.py`` (the reference's ``DirectSolver``
analog): validates the O(N) solvers, and builds ``GP.get_matrix`` and
``GP.predict``'s covariance, never on a hot path.
"""

from __future__ import annotations

import math

import torch

from .kernels import kernel_value

__all__ = ["build_matrix", "log_likelihood"]


def build_matrix(coeffs, t, diag=None, include_jitter=True, t2=None,
                 A_gen=None, U_gen=None, V_gen=None):
    """Dense covariance matrix K(t, t) with diag, jitter and the general
    (A, U, V) blocks: ``tril(U^T V, -1) + triu(V^T U, 1) + diag(A)``,
    ``A`` (N,), ``U`` and ``V`` (J_general, N) (dense.py:21-52).

    With ``t2`` the rectangular cross-covariance ``K(t, t2)``: kernel
    values only, the diagonal, jitter and general blocks belong to the
    square case.
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = coeffs
    if t2 is not None:
        return kernel_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp,
                            t[:, None] - t2[None, :])
    tau = t[:, None] - t[None, :]
    k = kernel_value(a_real, c_real, a_comp, b_comp, c_comp, d_comp, tau)
    n = t.shape[0]
    eye = torch.eye(n, dtype=k.dtype, device=k.device)
    if include_jitter:
        k = k + jitter * eye
    if diag is not None:
        k = k + torch.diag(torch.as_tensor(diag, dtype=k.dtype, device=k.device))
    if U_gen is not None and U_gen.shape[0] > 0:
        def gen(x):
            return torch.as_tensor(x, dtype=k.dtype, device=k.device)

        low = gen(U_gen).T @ gen(V_gen)
        k = k + torch.tril(low, -1) + torch.triu(low.T, 1) + torch.diag(
            gen(A_gen))
    return k


def log_likelihood(K, resid):
    """Dense multivariate-normal log-likelihood of ``resid`` under cov K."""
    n = K.shape[0]
    _, logdet = torch.linalg.slogdet(K)
    alpha = torch.linalg.solve(K, resid)
    return -0.5 * (resid @ alpha + logdet + n * math.log(2.0 * math.pi))
