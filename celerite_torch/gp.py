"""GP orchestration API of the port.

Port of ``celerite_tpu/gp.py:34-277, 279-810, 1160-1412``: a ModelSet of
``kernel`` and ``mean`` submodels with ``compute`` / ``log_likelihood`` /
``grad_log_likelihood``, the pure closures the fits and samplers call,
``build_loglik`` (``theta_active -> (ll, ok)``) and ``build_logprob``
(``theta_active -> ll + log prior``), and the solver surface: ``compute``
factors through :class:`solver.CholeskySolver` (the ``solver`` property;
``dirty`` / ``computed`` refactor after a parameter change), and
``apply_inverse``, ``dot``, ``predict`` (the mean and ``return_cov``; with
``return_var`` the Kalman/RTS smoother of ``ops/smoother`` and
``ops/pkalman``), ``get_matrix``, ``sample`` and ``sample_conditional`` run
on it.

Routing of ``solver="auto"``: on the CPU the sequential solver below
N = 4096 points (the JAX package's CPU route) and the plain fused primal
above; on the card the CUDA fused primal kernel at every N, over a lane plan
built once per dataset.  Entry points run on ``cuda`` unless the GP was made
with ``device="cpu"``, and raise when CUDA is missing; they never fall back
to the CPU.

The fused closure also carries the value-and-gradient entries the samplers
call, through the gradient pipeline (``fused4.build_ll_and_grad``):
``value_ok_grad_batch(thetas)`` for ``(n, dim)`` parameter rows folds the
rows onto the kernels' lane axis (one launch of each kernel for every
chunk of rows; the torch counterpart of ``celerite_tpu/ops/vog_prim.py``'s
batching rule, gp.py:744-809), and ``value_ok_grad(theta) -> (ll, ok,
grad)`` is that entry on one row.

A model of padded width 13-16 at ``solver="auto"`` or ``"fused"`` takes the
adjoint route (celerite_tpu/gp.py:812-923): ``lanes.lower_lanes`` and the
four kernels of ``ops/adjoint`` (on the card at every N, their plain
versions on the CPU from N = 4096, or at any N with ``solver="fused"``)
for the same two value-and-gradient entries, and the three kernels of
``ops/pallas_solver`` for the value closure (``fused.run_kernel`` over a
value plan whose lane count is its own).  Under autograd the value's
backward is the adjoint pipeline with ``fast_grad``, else autograd through
``ops/blocked`` (celerite_tpu/gp.py:869-899).

``fast_grad="tangent"`` at ``solver="auto"`` or ``"fused"`` and padded
width 1-16 takes the tangent route (celerite_tpu/gp.py:812-923, fused4
skipped as gp.py:571 skips it): ``lanes.lower_lanes`` over one lane plan,
the value closure through ``fused.run_kernel`` (the single-sweep kernel
at width 8 or less, the three-pass kernels above), and the gradient in
forward mode along the parameters' basis directions through
``ops/tangent`` (the single-sweep kernel with tangents at width 8 or
less, the split pair above), for the value closure's backward and the two
value-and-gradient entries.  On the CPU every route runs the kernels'
plain versions (the JAX package's CPU backward goes through ``blocked``).

``solver="pallas"`` and ``"blocked"`` are closures over ``lower(...)``:
the three-pass kernels (``pallas_solver.gp_log_likelihood``, whose
autograd backward runs through ``blocked``) and the plain block-parallel
solver; with ``fast_grad`` their backward is the adjoint pipeline
(celerite_tpu/gp.py:926-999), with ``fast_grad="tangent"`` (and so for
``"seq"``) ``tangent.gp_log_likelihood_jac`` on ``block_size`` lanes, as
the JAX package passes it (gp.py:940-973).  ``solver="auto"`` takes
``blocked`` above padded width 16 (gp.py:515-524), where the kernels stop
(ROADMAP queue 2, item 10): there ``"fused"``, ``"pallas"``, a truthy
``fast_grad`` with ``"blocked"`` and ``fast_grad="tangent"`` raise.

General (A, U, V) blocks (``compute(..., A=, U=, V=)``) are phi = 1
columns after the kernel's (``ops.lower``); P counts the general rank.
They never take a lane route (fused4, the adjoint or tangent plans),
which lower from coefficients and would drop them: as in the JAX package
(celerite_tpu/gp.py:503-561), ``solver="auto"`` takes ``"seq"`` on the
CPU below 4096 points, else ``"blocked"``, and ``"fused"`` is the
SSM-level ``fused.gp_log_likelihood`` (the single-sweep kernel at P <= 8,
the three-pass kernels above), with ``fast_grad`` as for ``"pallas"`` and
``"blocked"``.  These closures carry no value-and-gradient entries, so
samplers take autograd row by row; the dense oracle and the variance of
``predict`` add the blocks at the computed coordinates.

Exact mode, ``precision="ds"``, is routed as the JAX package routes it
(celerite_tpu/gp.py:410-433): a kernel of padded width 1-8 with a frozen
mean, N >= 2048 points and no ``block_size`` takes the forward-mode
pipeline of ``ops/dsfused`` in float64 (the CUDA kernels on the card, their
plain versions on the CPU), with the same entries; any other exact-mode
call takes the float64 route above, the port's stand-in for the JAX
package's lax double-single solver (``dsblocked``, not ported).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from . import terms
from .modeling import ConstantModel, ModelSet
from .ops import (adjoint, blocked, dense, dsfused, fused, fused4, lanes,
                  lanes4, pallas_solver, pkalman, seq, smoother, tangent)
from .ops.lower import Coefficients, lower
from .solver import CholeskySolver, LinAlgError, _not_in_slice

__all__ = ["GP", "LinAlgError"]

# Below this many points the CPU takes the sequential solver (the JAX
# package's CPU route, celerite_tpu/gp.py:507-508).
_SEQ_BELOW = 4096
# Share of the card's memory (on the CPU: bytes) that one folded launch's
# per-step saves may take; it sets the chains per launch (_fold_cap).
_FOLD_MEMORY_SHARE = 0.25
_FOLD_CPU_BYTES = 1 << 30
# Lanes a chain of the exact-mode route: on the card at most 128, the
# fastest count for one chain and for 16 folded at N = 1e5, P = 8 in
# chip_smoke.py's lane_sweep_D (PERF.md); on the CPU (its plain versions)
# lanes of about _DS_CPU_STEPS steps.
_DS_CUDA_LANES = 128
_DS_CPU_STEPS = 8


def _fold_cap(n, p, dtype, device):
    """Chains per folded launch of the adjoint route: a power of two whose
    per-step saves fit.

    The gradient pipelines save ``(4 P^2 + P)`` words a point and chain
    (fused4_grad.cu and adjoint.cu alike); a folded launch of ``nc`` chains
    holds ``nc`` times that.
    """
    item = torch.finfo(dtype).bits // 8
    return _chains_within(max(n, 1) * (4 * p * p + p + 8) * item, device)


def _fold_cap_ds(lanes, p, c, device):
    """Chains per folded call of the exact-mode route.

    No saves: a chain holds its ``(1 + C)``-word dual outputs of both
    kernels, ``6 P^2 + 2 P + 3`` float64 words a lane and word, and the
    glue's temporaries, taken as eight times that.
    """
    return _chains_within(8 * lanes * (1 + c) * (6 * p * p + 2 * p + 3) * 8,
                          device)


def _fold_cap_tangent(n, p, dim, dtype, device):
    """Chains per folded call of the tangent route.

    No saves: a chain holds its ``(3 P + 2)``-word streams a point and
    their ``dim`` tangents, and the lowering's vmapped temporaries, taken
    as four times that.
    """
    item = torch.finfo(dtype).bits // 8
    return _chains_within(4 * max(n, 1) * (3 * p + 2) * (dim + 1) * item,
                          device)


def _chains_within(per_chain, device):
    """The largest power of two of chains whose ``per_chain`` bytes fit:
    on the card ``_FOLD_MEMORY_SHARE`` of its memory, on the CPU
    ``_FOLD_CPU_BYTES``."""
    if device.type == "cuda":
        budget = _FOLD_MEMORY_SHARE * torch.cuda.get_device_properties(
            device).total_memory
    else:
        budget = _FOLD_CPU_BYTES
    cap = 1
    while 2 * cap * per_chain <= budget:
        cap *= 2
    return cap


def _fold_entries(make, vog_rows, fold_cap, device):
    """The batched and one-row value-and-gradient entries of a route.

    ``make(nc)`` builds what a folded call of ``nc`` rows runs on, its
    first item the plan; it is cached per chain count.  ``vog_rows(entry,
    th)`` gives ``(ll, ok, grad)`` for a power-of-two batch ``th`` on
    ``entry = make(len(th))``.  Returns ``(value_ok_grad_batch,
    value_ok_grad, entry)``, ``entry(nc)`` the cached builder.
    """
    cache = {}

    def entry(nc):
        if nc not in cache:
            cache[nc] = make(nc)
        return cache[nc]

    def value_ok_grad_batch(thetas):
        """``(n, dim)`` rows -> ``(ll (n,), ok (n,), grad (n, dim))``.

        Pads n to a power of two with copies of the first row; above
        ``value_ok_grad_batch.fold_cap`` chains (set from the memory a
        folded call takes) it folds in chunks of that many.
        ``value_ok_grad_batch.folded_plan(nc)`` is the cached plan a chunk
        of ``nc`` rows runs on.
        """
        thetas = torch.as_tensor(thetas).to(device)
        rows = thetas.shape[0]
        cap = value_ok_grad_batch.fold_cap
        nc = 1 << max(0, rows - 1).bit_length()
        chunk = min(nc, cap)
        pad = -rows % chunk
        th = torch.cat([thetas, thetas[:1].expand(pad, -1)])
        outs = [vog_rows(entry(chunk), part) for part in th.split(chunk)]
        ll, ok, grad = (torch.cat(x) for x in zip(*outs))
        return ll[:rows], ok[:rows], grad[:rows]

    def value_ok_grad(theta):
        """``(ll, ok, grad)`` for one parameter vector: the batched entry
        on one row (a plan with the gradient path's lane count)."""
        ll, ok, grad = value_ok_grad_batch(torch.as_tensor(theta)[None])
        return ll[0], ok[0], grad[0]

    value_ok_grad_batch.fold_cap = fold_cap
    value_ok_grad_batch.folded_plan = lambda nc: entry(nc)[0]
    return value_ok_grad_batch, value_ok_grad, entry


class _ForwardModeLL(torch.autograd.Function):
    """``(cf, fn) -> (ll, ok)`` for the exact-mode route under autograd.

    The forward runs ``fn``, the forward-mode pipeline, once for the value
    and ``d ll / d cf``; the backward multiplies the cotangent by that
    gradient (celerite_tpu/gp.py:1144-1156).
    """

    @staticmethod
    def forward(ctx, cf, fn):
        ll, ok, grad = fn(cf.detach())
        ctx.save_for_backward(grad)
        ctx.mark_non_differentiable(ok)
        return ll, ok

    @staticmethod
    def backward(ctx, gll, _gok):
        (grad,) = ctx.saved_tensors
        return gll * grad, None


class _KernelValue(torch.autograd.Function):
    """``(theta, value, grad) -> (ll, ok)``: the forward ``value(theta)``
    (kernels, no autograd rule), the backward the cotangent times
    ``grad(theta)``, computed then: the counterpart of the JAX package's
    ``custom_vjp`` closures (celerite_tpu/gp.py:869-899, 974-999)."""

    @staticmethod
    def forward(ctx, theta, value, grad):
        ll, ok = value(theta.detach())
        ctx.save_for_backward(theta.detach())
        ctx.grad = grad
        ctx.mark_non_differentiable(ok)
        return ll, ok

    @staticmethod
    def backward(ctx, gll, _gok):
        (theta,) = ctx.saved_tensors
        g = ctx.grad(theta).to(theta.dtype)
        return gll.to(theta.dtype) * g, None, None


def _autograd_grad(ll_fn):
    """``theta -> d ll_fn(theta)[0] / d theta`` by one reverse pass."""

    def grad(theta):
        th = theta.detach().requires_grad_()
        with torch.enable_grad():
            (g,) = torch.autograd.grad(ll_fn(th)[0], th)
        return g

    return grad


def _lane_inputs(split_theta, mean_fn, mean_active, t64, dtype):
    """``(th, plan) -> (u, v, ph, a, y)`` of a lane plan for the ``(n_chain,
    dim)`` rows ``th``, one a chain: ``lanes.lower_lanes`` of the vmapped
    coefficients and, with an active mean, each chain's residual (with a
    frozen mean the plan's data is the residual)."""

    def coeffs_of(theta):
        return tuple(split_theta(theta)[0])

    def mean_of(theta):
        return mean_fn(split_theta(theta)[1], t64)

    def lane_inputs(th, plan):
        coeffs = torch.func.vmap(coeffs_of)(th)
        u, v, ph, a = lanes.lower_lanes(coeffs, plan)
        y = plan.y
        if mean_active:
            mvals = torch.func.vmap(mean_of)(th).to(dtype)
            y = y - plan.mask * lanes4.fold_lanes(
                mvals, plan.t.shape[-1] // plan.n_chain,
                plan.t.shape[0])[:, None]
        return u, v, ph, a, y

    return lane_inputs


def _mean_value_fn(mean_model):
    """A torch (params, x) -> value function for a mean model.

    ConstantModel and zero-parameter models are handled automatically;
    other mean models may provide a torch ``value_fn(params, x)`` method.
    """
    if isinstance(mean_model, ConstantModel):
        return lambda params, x: params[0] * torch.ones_like(x)
    if hasattr(mean_model, "value_fn"):
        return mean_model.value_fn
    if mean_model.full_size == 0:
        value = float(np.asarray(mean_model.get_value(np.zeros(1)))[0])
        return lambda params, x: value * torch.ones_like(x)

    def fallback(params, x):
        raise ValueError(
            "custom mean models used in the pure closures must define "
            "value_fn(params, x)"
        )

    return fallback


class GP(ModelSet):
    """The main user-facing Gaussian-Process interface.

    Args:
        kernel: a :class:`celerite_torch.terms.Term`.
        mean: a float or a :class:`celerite_torch.modeling.Model`.
        fit_mean: if False, the mean's parameters are frozen.
        log_white_noise: deprecated; appends a
            ``terms.JitterTerm(log_sigma=log_white_noise)`` to ``kernel``
            with a ``UserWarning`` (celerite_tpu/gp.py:82-89).
        fit_white_noise: if False, that term's ``log_sigma`` is frozen.
        device: where the entry points compute; ``None`` means ``"cuda"``.
    """

    def __init__(self, kernel, mean=0.0, fit_mean=False,
                 log_white_noise=None, fit_white_noise=False, *,
                 device=None):
        self.device = device
        self._solver = None
        self._computed = False
        self._t = None
        self._yerr = None
        self._diag = None
        self._A = np.empty(0)
        self._U = np.empty((0, 0))
        self._V = np.empty((0, 0))
        if log_white_noise is not None:
            warnings.warn(
                "The 'log_white_noise' parameter is deprecated. "
                "Use a 'JitterTerm' instead."
            )
            jt = terms.JitterTerm(log_sigma=float(log_white_noise))
            if not fit_white_noise:
                jt.freeze_parameter("log_sigma")
            kernel = kernel + jt
        try:
            mean = ConstantModel(float(mean))
        except TypeError:
            pass
        if not fit_mean:
            for name in mean.get_parameter_names():
                mean.freeze_parameter(name)
        super().__init__([("kernel", kernel), ("mean", mean)])

    @property
    def kernel(self):
        return self.models["kernel"]

    @property
    def mean(self):
        return self.models["mean"]

    @property
    def solver(self):
        """The GP's :class:`solver.CholeskySolver` on its device."""
        if self._solver is None:
            self._solver = CholeskySolver(device=self.device)
        return self._solver

    @property
    def dirty(self):
        return ModelSet.dirty.fget(self) or not self._computed

    @dirty.setter
    def dirty(self, value):
        self._computed = not value
        ModelSet.dirty.fset(self, value)

    @property
    def computed(self):
        return (self._solver is not None and self._solver.computed()
                and not self.dirty)

    # -- compute / log_likelihood ------------------------------------------
    def compute(self, t, yerr=1.123e-12, check_sorted=True, A=None, U=None,
                V=None):
        """Store the coordinates, per-point variances and general blocks,
        lower the kernel at the current parameters and factor it through
        :attr:`solver` (celerite_tpu/gp.py:134-171).

        ``A`` (N,), ``U`` and ``V`` (J_general, N) are general semiseparable
        blocks added to the covariance (:func:`ops.dense.build_matrix`); the
        closures of :meth:`build_loglik` and the facade's ops take them
        too.  Raises ValueError for unsorted input or blocks of the wrong
        shape, and LinAlgError when the covariance matrix does not factor
        (not positive definite).
        """
        t = np.atleast_1d(np.asarray(t, dtype=float))
        if check_sorted and np.any(np.diff(t) < 0.0):
            raise ValueError("the input coordinates must be sorted")
        if check_sorted and t.ndim > 1:
            raise ValueError("dimension mismatch")
        self._t = t
        self._yerr = np.empty_like(t)
        self._yerr[:] = yerr
        self._A = np.empty(0) if A is None else np.asarray(A)
        self._U = np.empty((0, 0)) if U is None else np.asarray(U)
        self._V = np.empty((0, 0)) if V is None else np.asarray(V)
        self._diag = self._yerr ** 2
        self._refactor()

    def _refactor(self):
        """Lower and factor with the stored inputs at the current
        parameters (the padded lowering, float64)."""
        kp = torch.as_tensor(self.parameter_vector)[:self.kernel.full_size]
        coeffs = [c.detach().cpu().numpy()
                  for c in self.kernel.get_padded_coefficients(kp)]
        self.solver.compute(float(self.kernel.get_jitter(kp)), *coeffs,
                            A=self._A, U=self._U, V=self._V, t=self._t,
                            diag=self._diag)
        self.dirty = False

    def _recompute(self):
        if not self.computed:
            if self._t is None:
                raise RuntimeError("you must call 'compute' first")
            self._refactor()

    def _process_input(self, y):
        if self._t is None:
            raise RuntimeError("you must call 'compute' first")
        if len(self._t) != len(y):
            raise ValueError("dimension mismatch")
        return np.ascontiguousarray(y, dtype=float)

    def log_likelihood(self, y, quiet=False):
        """Marginal GP log-likelihood of ``y`` (requires compute first).

        A kernel that does not factor raises LinAlgError, or gives -inf with
        ``quiet=True``.
        """
        if self._t is None:
            raise RuntimeError("you must call 'compute' first")
        y = np.asarray(y, dtype=float)
        if y.ndim > 1 or len(y) != len(self._t):
            raise ValueError("dimension mismatch")
        fn = self.build_loglik(self._t, y, diag=self._diag)
        ll, ok = fn(torch.as_tensor(self.get_parameter_vector()))
        if not bool(ok):
            if quiet:
                return -np.inf
            raise LinAlgError("failed to factorize or solve matrix")
        return float(ll)

    def grad_log_likelihood(self, y, quiet=False):
        """``(ll, grad)`` with respect to the active parameter vector.

        The fused solver takes its closure's ``value_ok_grad`` (on the card
        the gradient kernels over the gradient path's lane plan); the
        sequential solver one reverse pass of autograd.  A kernel that does
        not factor raises LinAlgError, or gives ``(-inf, zeros)`` with
        ``quiet=True``.
        """
        if self._t is None:
            raise RuntimeError("you must call 'compute' first")
        y = np.asarray(y, dtype=float)
        if y.ndim > 1 or len(y) != len(self._t):
            raise ValueError("dimension mismatch")
        fn = self.build_loglik(self._t, y, diag=self._diag)
        theta = torch.tensor(self.get_parameter_vector())
        if hasattr(fn, "value_ok_grad"):
            ll, ok, grad = fn.value_ok_grad(theta)
        else:
            theta.requires_grad_()
            ll, ok = fn(theta)
            grad = None
        if not bool(ok):
            if quiet:
                return -np.inf, np.zeros(self.vector_size)
            raise LinAlgError("failed to factorize or solve matrix")
        if grad is None:
            (grad,) = torch.autograd.grad(ll, theta)
        return float(ll.detach()), grad.detach().cpu().numpy()

    # -- linear algebra (celerite_tpu/gp.py:1222-1412) ------------------------
    def apply_inverse(self, y):
        """K^-1 y (with yerr and jitter on the diagonal); y is (N,) or (N,
        K)."""
        self._recompute()
        return self.solver.solve(self._process_input(y))

    def dot(self, y, t=None, A=None, U=None, V=None, kernel=None,
            check_sorted=True):
        """K y without the yerr diagonal (reference celerite.py:330-397): at
        the computed coordinates with the stored general blocks, or at ``t``
        with the general blocks ``A, U, V`` given here."""
        if kernel is None:
            kernel = self.kernel
        if t is not None:
            t = np.atleast_1d(np.asarray(t, dtype=float))
            if check_sorted and np.any(np.diff(t) < 0.0):
                raise ValueError("the input coordinates must be sorted")
            if check_sorted and t.ndim > 1:
                raise ValueError("dimension mismatch")
        else:
            if not self.computed:
                raise RuntimeError("you must call 'compute' first")
            t, A, U, V = self._t, self._A, self._U, self._V
        return self.solver.dot(kernel.jitter, *kernel.coefficients, A, U, V,
                               t, np.ascontiguousarray(y, dtype=float))

    def predict(self, y, t=None, return_cov=True, return_var=False):
        """Conditional predictive distribution at coordinates ``t``: ``mu``,
        ``(mu, cov)`` or ``(mu, var)`` (celerite_tpu/gp.py:1260-1355).

        ``return_var=True`` on a kernel with a Gauss-Markov realization
        (``ops.smoother.realize``) takes the O((N+M) p^2) Kalman/RTS
        smoother over the merged train and test grid, which gives the mean
        too: on the card the blocked engine (``ops.pkalman``) at every size
        (faster than the sequential one at every size measured,
        tools/kalman_tune.py: the JAX package's gate of 16384 points is not
        kept), on the CPU the sequential one (``ops.smoother``).  Any
        other kernel, and any model with general blocks, takes
        the dense O(N M) variance k(0) - sum(Kxs^T * K^-1 Kxs^T).  The mean
        is otherwise O(N) (the lag-state recursions, in parallel on the
        blocked route; with general blocks the dense ``K(xs, t) K^-1 r``,
        celerite_tpu/gp.py:1318-1323), the covariance dense O(N M)
        (reference celerite.py:399-474)."""
        y = self._process_input(y)
        if y.ndim > 1:
            raise ValueError("dimension mismatch")
        if t is None:
            xs = self._t
        else:
            xs = np.ascontiguousarray(t, dtype=float)
            if xs.ndim > 1:
                raise ValueError("dimension mismatch")
        self._recompute()
        resid = y - self.mean.get_value(self._t)
        has_general = len(self._A) > 0
        if return_var and not has_general:
            coeffs = Coefficients(*self.kernel.coefficients,
                                  jitter=self.kernel.jitter)
            if smoother.realize(coeffs) is not None:
                device = lanes4.resolve_device(self.device)
                engine = (pkalman.predict_var_parallel
                          if device.type == "cuda" else smoother.predict_var)
                mu, var = engine(coeffs, self._t, self._yerr ** 2, resid, xs,
                                 device=device)
                return self.mean.get_value(xs) + mu, var
        if t is None:
            alpha = self.solver.solve(resid).reshape(-1)
            alpha = resid - (self._yerr ** 2 + self.kernel.jitter) * alpha
        elif not has_general:
            alpha = self.solver.predict(resid, xs)
        else:
            alpha = self.get_matrix(xs, self._t) @ self.solver.solve(
                resid).reshape(-1)
        mu = self.mean.get_value(xs) + alpha
        if return_var:
            return mu, self._dense_var(xs)
        if not return_cov:
            return mu
        Kxs = self.get_matrix(xs, self._t)
        cov = self.get_matrix(xs, xs)
        cov -= Kxs @ self.apply_inverse(np.ascontiguousarray(Kxs.T))
        return mu, cov

    def _dense_var(self, xs):
        """The dense O(N M) predictive variance at ``xs``: k(0) -
        sum(Kxs^T * K^-1 Kxs^T) (celerite_tpu/gp.py:1332-1336)."""
        KxsT = np.ascontiguousarray(self.get_matrix(xs, self._t).T)
        var = -np.sum(KxsT * self.apply_inverse(KxsT), axis=0)
        return var + self.kernel.get_value(0.0)

    def get_matrix(self, x1=None, x2=None, include_diagonal=None,
                   include_general=None):
        """Dense covariance matrix (reference celerite.py:476-516) on the
        GP's device, as numpy: ``K(t, t)`` with the diagonal and jitter
        (unless ``include_diagonal`` is False) and the general blocks
        (unless ``include_general`` is False) at the computed coordinates,
        or the kernel's ``K(x1, x2)`` (jitter on the diagonal of ``K(x1,
        x1)`` with ``include_diagonal``)."""
        device = lanes4.resolve_device(self.device)
        coeffs = Coefficients(*(torch.as_tensor(c, device=device)
                                for c in self.kernel.coefficients),
                              jitter=torch.tensor(self.kernel.jitter,
                                                  dtype=torch.float64,
                                                  device=device))

        def dev(x):
            return torch.as_tensor(np.ascontiguousarray(x, dtype=float),
                                   device=device)

        if x1 is None and x2 is None:
            if self._t is None or not self.computed:
                raise RuntimeError("you must call 'compute' first")
            use_diag = include_diagonal is None or include_diagonal
            use_gen = ((include_general is None or include_general)
                       and len(self._A) > 0)
            gen = dict(A_gen=dev(self._A), U_gen=dev(self._U),
                       V_gen=dev(self._V)) if use_gen else {}
            K = dense.build_matrix(
                coeffs, dev(self._t),
                diag=dev(self._yerr ** 2) if use_diag else None,
                include_jitter=use_diag, **gen)
            return K.cpu().numpy()
        incl = False
        if x2 is None:
            x2 = x1
            incl = include_diagonal is not None and include_diagonal
        K = dense.build_matrix(coeffs, dev(x1), t2=dev(x2)).cpu().numpy()
        if incl:
            K[np.diag_indices_from(K)] += self.kernel.jitter
        return K

    def sample(self, size=None, seed=None):
        """Sample from the GP prior at the computed coordinates.  With a
        ``seed`` the normal draws are ``np.random.default_rng(seed)``'s, as
        the JAX package's (gp.py:1388-1405), so a seeded sample agrees with
        it to float64 rounding."""
        self._recompute()
        n = len(self._t)
        if seed is not None:
            rng = np.random.default_rng(seed)
            z = rng.standard_normal(n if size is None else (n, size))
        else:
            z = (np.random.randn(n) if size is None
                 else np.random.randn(n, size))
        z = self.solver.dot_L(z)
        if size is None:
            return self.mean.get_value(self._t) + z[:, 0]
        return self.mean.get_value(self._t)[None, :] + z.T

    def sample_conditional(self, y, t=None, size=None, regularize=None):
        """Sample from the predictive distribution (O(M^3) in len(t))."""
        mu, cov = self.predict(y, t, return_cov=True)
        if regularize is not None:
            cov[np.diag_indices_from(cov)] += regularize
        return np.random.multivariate_normal(mu, cov, size=size)

    # -- pure closures --------------------------------------------------------
    def build_loglik(self, t, y, yerr=1.123e-12, diag=None, solver="auto",
                     block_size=None, fast_grad=False, precision=None,
                     dtype=torch.float64, fast_compile=False):
        """Return a pure closure ``theta_active -> (ll, ok)``.

        ``theta_active`` follows ``get_parameter_vector()`` ordering (kernel
        params then mean params, frozen entries excluded); a 1-D tensor on
        any device.  ``solver``: "seq" (sequential), "fused" (the fused
        primal over a lane plan: the CUDA kernel on the card, its plain
        version on the CPU), "pallas" (the three-pass kernels over blocks
        of L steps), "blocked" (the plain block-parallel solver) or
        "auto".  ``block_size`` sets the plan's lane count B, or L for
        "pallas" and "blocked".  ``dtype`` is the working precision
        (float32 or float64).  ``precision="ds"`` is exact mode, always
        float64: under the JAX package's gates (module docstring) the
        forward-mode kernels of
        ``ops/dsfused`` (``route == "dsfused"``), whose value and gradient
        come from one sweep; otherwise the float64 route, standing in for
        the unported ``dsblocked``.  ``ll`` is differentiable with autograd;
        on the card the fused route's backward reruns the gradient kernels
        over the value plan's lanes, whose cross-lane glue costs more
        launches than the gradient path's plan (PERF.md), and the
        exact-mode route's backward multiplies by its forward-mode gradient.
        The fused and exact-mode closures carry ``value_ok_grad`` and
        ``value_ok_grad_batch`` (module docstring), the tuned route,
        whatever ``fast_grad`` says, as JAX's does, except that
        ``fast_grad="tangent"`` at "fused" (or "auto") takes the
        forward-mode route of ``ops/tangent`` at padded widths 1-16, and
        makes the backward of "seq", "pallas" and "blocked" forward mode
        (module docstring).  A model of padded width 13-16 takes the
        adjoint route (module docstring); wider models take "blocked" at
        ``solver="auto"`` and raise with "fused", "pallas", "blocked" with a
        truthy ``fast_grad``, or ``fast_grad="tangent"``.  ``loglik.route``
        names the route taken: "seq", "fused", "adjoint", "tangent",
        "dsfused", "pallas" or "blocked".  ``fast_compile=True`` forces
        ``solver="blocked"`` with ``fast_grad=False`` and keeps exact mode
        off the forward-mode kernels, as the JAX package's flag does
        (celerite_tpu/gp.py:341-343, :426): no kernel runs.
        """
        if fast_compile:
            solver = "blocked"
            fast_grad = False
        if precision not in (None, "ds"):
            raise ValueError(
                "precision must be None or 'ds', got {0!r}".format(precision)
            )
        if precision == "ds":
            dtype = torch.float64
        device = lanes4.resolve_device(self.device)

        t_np = np.atleast_1d(np.asarray(t, dtype=np.float64))
        y_np = np.asarray(y, dtype=np.float64)
        if diag is None:
            diag = np.broadcast_to(np.asarray(yerr, np.float64), t_np.shape) ** 2
        diag_np = np.broadcast_to(np.asarray(diag, np.float64), t_np.shape)
        n = t_np.shape[0]

        kernel = self.kernel
        pr, pc = kernel.padded_size
        has_general = len(self._A) > 0
        if has_general and len(self._A) != n:
            raise ValueError("dimension mismatch")
        # General rank counts in the padded width P.
        width = pr + 2 * pc + (self._U.shape[0] if has_general else 0)
        mask = np.asarray(self.unfrozen_mask)
        idx = torch.as_tensor(np.flatnonzero(mask), device=device)
        fixed = torch.as_tensor(self.parameter_vector, device=device)
        nk = kernel.full_size
        mean_fn = _mean_value_fn(self.mean)
        mean_active = len(idx) > 0 and int(idx.max()) >= nk

        def split_theta(theta):
            full = fixed.to(device=theta.device, dtype=theta.dtype)
            if len(idx):
                full = full.index_put((idx.to(theta.device),), theta)
            kp, mp = full[:nk], full[nk:]
            coeffs = Coefficients(
                *kernel.get_padded_coefficients(kp),
                jitter=kernel.get_jitter(kp),
            )
            return coeffs, mp

        # Exact mode under the JAX package's gates (celerite_tpu/gp.py:
        # 419-428): the forward-mode kernels on the card, their plain
        # versions on the CPU.  Other exact-mode calls, general blocks
        # among them, take the float64 route below.
        if (precision == "ds" and not mean_active and not has_general
                and 0 < width <= 8 and n >= 2048 and block_size is None
                and not fast_compile):
            return self._build_loglik_dsfused(t_np, y_np, diag_np,
                                              split_theta, fixed, nk,
                                              mean_fn, pr, pc, device)

        if solver == "auto":
            if width == 0 or (device.type == "cpu" and n < _SEQ_BELOW):
                solver = "seq"
            elif has_general or width > adjoint.MAX_WIDTH:
                # JAX's "auto" keeps general blocks off the lane routes
                # (celerite_tpu/gp.py:503-515).
                solver = "blocked"
            else:
                solver = "fused"
        if solver not in ("seq", "fused", "blocked", "pallas"):
            raise ValueError("unknown solver '{0}'".format(solver))
        if width > adjoint.MAX_WIDTH and (
                solver in ("fused", "pallas") or fast_grad == "tangent"
                or (solver == "blocked" and fast_grad)):
            raise _not_in_slice(
                "the kernels above padded width 16 (solver={0!r}, "
                "fast_grad={1!r} at P = {2})".format(solver, fast_grad,
                                                     width),
                "queue 2, item 10")

        # The SSM closures (seq, blocked, pallas, and the blocked backward
        # of the wide route's value) lower on the device in the working
        # dtype.
        t_dev = torch.as_tensor(t_np, dtype=dtype, device=device)
        y_dev = torch.as_tensor(y_np, dtype=dtype, device=device)
        diag_dev = torch.as_tensor(np.array(diag_np), dtype=dtype,
                                   device=device)
        lower_kw = {}
        if has_general:
            lower_kw = {k: torch.as_tensor(np.asarray(x, np.float64),
                                           dtype=dtype, device=device)
                        for k, x in (("A_gen", self._A), ("U_gen", self._U),
                                     ("V_gen", self._V))}
        if dtype == torch.float32:
            # Static double-single grid: exact spacings and the lo half of
            # t (ops/ds.py).
            lower_kw.update(
                dt=torch.as_tensor(np.concatenate([[0.0], np.diff(t_np)]),
                                   dtype=dtype, device=device),
                t_lo=torch.as_tensor(
                    t_np - t_np.astype(np.float32).astype(np.float64),
                    dtype=dtype, device=device),
            )

        def ssm_resid(theta):
            coeffs, mp = split_theta(theta)
            return (lower(coeffs, t_dev, diag_dev, **lower_kw),
                    y_dev - mean_fn(mp, t_dev))

        if solver == "fused" and has_general:
            # The lane routes lower from coefficients and would drop the
            # general columns: the SSM-level single sweep instead
            # (celerite_tpu/gp.py:539-561).
            return self._build_loglik_ssm(solver, ssm_resid, block_size,
                                          fast_grad)
        if solver == "fused" and fast_grad == "tangent":
            return self._build_loglik_tangent(
                t_np, y_np, diag_np, split_theta, fixed, nk, mean_fn,
                mean_active, width, block_size, dtype, device)
        if solver == "fused" and width > fused4.MAX_WIDTH:
            return self._build_loglik_adjoint(
                t_np, y_np, diag_np, split_theta, ssm_resid, fixed, nk,
                mean_fn, mean_active, width, block_size, fast_grad, dtype,
                device)

        if solver in ("seq", "blocked", "pallas"):
            return self._build_loglik_ssm(solver, ssm_resid, block_size,
                                          fast_grad)

        nb = block_size or lanes4.default_num_blocks4(n, device)
        plan = lanes4.make_plan4(t_np, y_np, diag_np, nb, dtype=dtype,
                                 device=device)
        ll_plan = fused4.build_ll(plan, pr, pc)
        t64 = torch.as_tensor(t_np, dtype=torch.float64, device=device)
        if not mean_active:
            # Frozen mean: the residual stream is data, built once.
            y_fixed = plan.y - mean_fn(fixed[nk:], plan.t) * plan.mask
            y_fold = y_np - np.asarray(mean_fn(fixed[nk:].cpu(),
                                               t64.cpu()), np.float64)

        def cf_of(theta):
            coeffs, _ = split_theta(theta)
            return lanes4.pack_cf(coeffs, dtype=dtype).to(device)

        def y4_of(theta):
            if not mean_active:
                return y_fixed
            _, mp = split_theta(theta)
            return plan.y - mean_fn(mp.to(dtype), plan.t) * plan.mask

        def loglik(theta):
            return ll_plan(cf_of(theta), y4_of(theta))

        def folded_fn(nc):
            bc = block_size or lanes4.default_grad_blocks4(n, device)
            planb = lanes4.make_plan4(
                t_np, y_np if mean_active else y_fold, diag_np, bc,
                dtype=dtype, n_chain=nc, device=device)
            return planb, bc, fused4.build_ll_and_grad(planb, pr, pc,
                                                       n_chain=nc)

        def mean_of(theta):
            return mean_fn(split_theta(theta)[1], t64)

        def folded_vog(entry, th):
            """(ll, ok, grad) for a power-of-two batch of rows, one
            folded launch of each kernel."""
            planb, bc, fnb = entry
            th = th.detach().requires_grad_()
            with torch.enable_grad():
                cfs = torch.func.vmap(cf_of)(th)
                y4 = planb.y
                if mean_active:
                    mvals = torch.func.vmap(mean_of)(th).to(dtype)
                    y4 = y4 - planb.mask * lanes4.fold_lanes(
                        mvals, bc, planb.t.shape[0])
                ll, ok = fnb(cfs, y4)
                (grad,) = torch.autograd.grad(ll.sum(), th)
            return ll.detach(), ok, grad

        loglik.value_ok_grad_batch, loglik.value_ok_grad, _ = _fold_entries(
            folded_fn, folded_vog, _fold_cap(n, width, dtype, device), device)
        loglik.plan = plan
        loglik.route = "fused"
        return loglik

    @staticmethod
    def _build_loglik_ssm(solver, ssm_resid, block_size, fast_grad):
        """The closures over ``ssm_resid(theta) -> (lower(...), resid)``:
        the sequential solver, the plain block-parallel solver, the
        three-pass kernels or, for general blocks at ``solver="fused"``,
        the SSM-level single sweep (``fused.gp_log_likelihood`` on
        ``block_size`` lanes: the single-sweep kernel at padded width 8 or
        less, the three-pass kernels above).  Their backward: autograd;
        with ``fast_grad="tangent"`` the forward-mode pipeline on
        ``block_size`` lanes (celerite_tpu/gp.py:940-973); with another
        truthy ``fast_grad`` (not "seq") the adjoint pipeline (gp.py:
        974-999).  JAX passes ``block_size`` to both as the lane count."""
        if solver == "seq":
            def value(theta):
                return seq.gp_log_likelihood(*ssm_resid(theta))
        elif solver == "fused":
            def value(theta):
                return fused.gp_log_likelihood(*ssm_resid(theta),
                                               num_blocks=block_size)
        else:
            module = blocked if solver == "blocked" else pallas_solver

            def value(theta):
                return module.gp_log_likelihood(*ssm_resid(theta),
                                                block_size=block_size)

        if fast_grad == "tangent":
            def grad(theta):
                (ssm, resid), (dssm, dresid) = lanes.basis_jvp(ssm_resid,
                                                               theta)
                return tangent.gp_log_likelihood_jac(
                    ssm, resid, dssm, dresid, num_blocks=block_size)[2]
        elif fast_grad and solver != "seq":
            grad = _autograd_grad(lambda th: adjoint.gp_log_likelihood(
                *ssm_resid(th), num_blocks=block_size))
        else:
            grad = None

        if grad is None:
            loglik = value
        else:
            def loglik(theta):
                return _KernelValue.apply(theta, value, grad)
        loglik.route = solver
        return loglik

    def _build_loglik_adjoint(self, t_np, y_np, diag_np, split_theta,
                              ssm_resid, fixed, nk, mean_fn, mean_active,
                              width, block_size, fast_grad, dtype, device):
        """Padded width 13-16 (celerite_tpu/gp.py:812-923): the adjoint
        kernels of ``ops/adjoint`` for the value-and-gradient entries, the
        three-pass kernels of ``ops/pallas_solver`` for the value, each
        over a lane plan of pre-lowered streams.

        ``value_ok_grad_batch`` folds the rows onto the lanes: the
        coefficients of a chunk of rows are vmapped, ``lanes.lower_lanes``
        lays them out per chain, and one launch of each kernel serves the
        chunk, the glue segmented per chain.  The value closure runs
        ``fused.run_kernel`` over the value plan (``loglik.value_plan``;
        ``pallas_solver.default_lanes`` lanes, the adjoint plan itself when
        the counts agree); under autograd its backward is
        ``adjoint.value_and_grad_fn`` on the value plan with
        ``fast_grad``, else autograd through ``blocked.gp_log_likelihood``
        on ``ssm_resid(theta)`` (celerite_tpu/gp.py:869-899).
        """
        n = t_np.shape[0]
        nb = block_size or adjoint.default_adjoint_blocks(n, device)
        nv = block_size or pallas_solver.default_lanes(n, device)
        t_dev = torch.as_tensor(t_np, dtype=torch.float64, device=device)
        if not mean_active:
            # Frozen mean: the residual is data, folded into the plan.
            y_np = y_np - np.asarray(mean_fn(fixed[nk:].cpu(), t_dev.cpu()),
                                     np.float64)
        lane_inputs = _lane_inputs(split_theta, mean_fn, mean_active, t_dev,
                                   dtype)

        def folded_fn(nc):
            return (lanes.make_plan(t_np, y_np, diag_np, nb, dtype=dtype,
                                    n_chain=nc, device=device),)

        def folded_vog(entry, th):
            """(ll, ok, grad) for a power-of-two batch of rows, one
            folded launch of each kernel."""
            (plan,) = entry
            nc = th.shape[0]
            ll, ok, grad = adjoint.value_and_grad_fn(
                lambda x: lane_inputs(x, plan), n, n_chain=nc)(th)
            return ll.reshape(nc), ok.reshape(nc), grad

        batch, single, entry = _fold_entries(
            folded_fn, folded_vog, _fold_cap(n, width, dtype, device),
            device)
        plan = entry(1)[0]
        vplan = plan if nv == nb else lanes.make_plan(
            t_np, y_np, diag_np, nv, dtype=dtype, device=device)

        def value(theta):
            return fused.run_kernel(*lane_inputs(theta[None], vplan), n)

        if fast_grad:
            def grad(theta):
                return adjoint.value_and_grad_fn(
                    lambda th: lane_inputs(th[None], vplan), n)(theta)[2]
        else:
            grad = _autograd_grad(
                lambda th: blocked.gp_log_likelihood(*ssm_resid(th)))

        def loglik(theta):
            return _KernelValue.apply(theta, value, grad)

        loglik.value_ok_grad_batch, loglik.value_ok_grad = batch, single
        loglik.plan, loglik.value_plan = plan, vplan
        loglik.route = "adjoint"
        return loglik

    def _build_loglik_tangent(self, t_np, y_np, diag_np, split_theta, fixed,
                              nk, mean_fn, mean_active, width, block_size,
                              dtype, device):
        """``fast_grad="tangent"`` at ``solver="fused"`` (or "auto"), padded
        width 1-16 (celerite_tpu/gp.py:812-923, skipping fused4 as
        gp.py:571 does): one lane plan per dataset and chain count
        (``tangent.default_jac_blocks`` lanes a chain).

        The value closure runs ``fused.run_kernel`` on the plan (the
        single-sweep kernel at width 8 or less, the three-pass kernels
        above); under autograd its backward is the cotangent times
        ``lanes.gp_log_likelihood_jac``'s gradient (gp.py:869-877).
        ``value_ok_grad`` is ``lanes.gp_log_likelihood_jac``;
        ``value_ok_grad_batch`` folds the rows onto the lanes (one segment
        a chain; JAX's ``vmap`` adds a grid axis instead) with one launch
        of each kernel a chunk of rows.  On the CPU the kernels' plain
        versions run (JAX's CPU backward goes through ``blocked``).
        """
        n = t_np.shape[0]
        nb = block_size or tangent.default_jac_blocks(n, device)
        t_dev = torch.as_tensor(t_np, dtype=torch.float64, device=device)
        if not mean_active:
            # Frozen mean: the residual is data, folded into the plan.
            y_np = y_np - np.asarray(mean_fn(fixed[nk:].cpu(), t_dev.cpu()),
                                     np.float64)
        lane_inputs = _lane_inputs(split_theta, mean_fn, mean_active, t_dev,
                                   dtype)
        dim = int(np.count_nonzero(self.unfrozen_mask))

        def folded_fn(nc):
            return (lanes.make_plan(t_np, y_np, diag_np, nb, dtype=dtype,
                                    n_chain=nc, device=device),)

        def folded_vog(entry, th):
            """(ll, ok, grad) for a power-of-two batch of rows, one
            folded launch of each kernel."""
            (plan,) = entry
            nc = th.shape[0]
            ll, ok, grad = lanes.gp_log_likelihood_jac(
                lambda x: lane_inputs(x, plan), th, n, n_chain=nc)
            return (ll.reshape(nc), ok.reshape(nc),
                    grad.reshape(nc, -1).to(th.dtype))

        batch, single, entry = _fold_entries(
            folded_fn, folded_vog,
            _fold_cap_tangent(n, width, dim, dtype, device), device)
        plan = entry(1)[0]

        def value(theta):
            return fused.run_kernel(*lane_inputs(theta[None], plan), n)

        def grad(theta):
            return lanes.gp_log_likelihood_jac(
                lambda th: lane_inputs(th[None], plan), theta, n)[2]

        def loglik(theta):
            return _KernelValue.apply(theta, value, grad)

        loglik.value_ok_grad_batch, loglik.value_ok_grad = batch, single
        loglik.plan = plan
        loglik.route = "tangent"
        return loglik

    def _build_loglik_dsfused(self, t_np, y_np, diag_np, split_theta,
                              fixed, nk, mean_fn, pr, pc, device):
        """Exact mode: the two forward-mode kernels of ``ops/dsfused``.

        The counterpart of celerite_tpu/gp.py:1019-1158.  The closure
        ``theta -> (ll, ok)`` runs the value kernels alone; under autograd
        it runs the forward-mode pipeline once and its backward multiplies
        by that gradient (``_ForwardModeLL``).  ``value_ok_grad_batch``
        folds rows onto lanes as the adjoint route does; the theta
        gradient is the VJP of ``pack_cf_ds`` applied to the packed
        coefficients' gradient.  The mean is frozen on this route, so the
        residual stream is data.
        """
        n = t_np.shape[0]
        width = pr + 2 * pc
        c = dsfused.cf_len(pr, pc)
        y_res = y_np - np.asarray(
            mean_fn(fixed[nk:].cpu(), torch.as_tensor(t_np)), np.float64)
        lanes = min(lanes4.default_grad_blocks4(n, device), _DS_CUDA_LANES)
        if device.type == "cpu":
            # The plain versions' forward mode costs per torch op of a
            # Python loop over the steps: take ~_DS_CPU_STEPS-step lanes.
            lanes = max(8, min(1024, 1 << (-(-n // _DS_CPU_STEPS) - 1)
                               .bit_length()))

        def cf_of(theta):
            coeffs, _ = split_theta(theta)
            return dsfused.pack_cf_ds(coeffs).to(device)

        def folded_fn(nc):
            planb = dsfused.make_plan_ds(t_np, y_res, diag_np, lanes,
                                         n_chain=nc, device=device)
            return planb, dsfused.build_ll_and_grad_ds(planb, pr, pc,
                                                       n_chain=nc)

        def folded_vog(entry, th):
            """(ll, ok, grad) for a power-of-two batch of rows: one launch
            of each kernel a direction chunk."""
            _, fnb = entry
            th = th.detach().requires_grad_()
            with torch.enable_grad():
                cfs = torch.func.vmap(cf_of)(th)
            ll, ok, gcf = fnb(cfs.detach())
            (grad,) = torch.autograd.grad(cfs, th, gcf)
            return ll, ok, grad

        batch, single, entry = _fold_entries(
            folded_fn, folded_vog, _fold_cap_ds(lanes, width, c, device),
            device)
        plan, fn_grad = entry(1)
        fn_value = dsfused.build_ll_ds(plan, pr, pc)

        def loglik(theta):
            cf = cf_of(theta)
            if torch.is_grad_enabled() and cf.requires_grad:
                return _ForwardModeLL.apply(cf, fn_grad)
            return fn_value(cf)

        loglik.value_ok_grad_batch, loglik.value_ok_grad = batch, single
        loglik.plan = plan
        loglik.route = "dsfused"
        return loglik

    def build_logprob(self, t, y, yerr=1.123e-12, log_prior=None,
                      solver="auto", block_size=None, fast_grad=None,
                      precision=None, dtype=torch.float64,
                      fast_compile=False):
        """Pure ``theta -> log posterior`` (ll + prior), -inf-safe.

        ``log_prior`` defaults to the box prior of the parameter bounds.
        With ``fast_grad=None`` (or True) and the fused solver, the closure
        carries ``value_and_grad(theta) -> (logp, grad)`` and
        ``value_and_grad_batch(thetas) -> (logp (n,), grad (n, dim))``
        through the log-likelihood's ``value_ok_grad`` entries; where the
        log probability is not finite it is -inf and its gradient 0
        (celerite_tpu/gp.py:1207-1219).  ``fast_grad=False`` attaches
        neither (samplers then use autograd); ``"tangent"`` takes the
        forward-mode route (:meth:`build_loglik`).  ``precision="ds"``
        takes exact mode (:meth:`build_loglik`); on config[2]-sized data
        that is the forward-mode kernels.  These two wrap either route's
        entries unchanged.  ``fast_compile`` is passed on to
        :meth:`build_loglik`.
        """
        ll_fn = self.build_loglik(
            t, y, yerr=yerr, solver=solver, block_size=block_size,
            fast_grad=fast_grad, precision=precision, dtype=dtype,
            fast_compile=fast_compile,
        )
        if log_prior is None:
            bounds = self.get_parameter_bounds()
            lo = torch.tensor([-math.inf if b[0] is None else b[0]
                               for b in bounds], dtype=torch.float64)
            hi = torch.tensor([math.inf if b[1] is None else b[1]
                               for b in bounds], dtype=torch.float64)

            def log_prior(theta):
                in_box = torch.all((theta >= lo.to(theta.device))
                                   & (theta <= hi.to(theta.device)))
                return torch.where(in_box, 0.0, -math.inf).to(theta)

        def logprob(theta):
            lp = log_prior(theta)
            ll, ok = ll_fn(theta)
            total = lp + torch.where(ok, ll, -math.inf)
            return torch.where(torch.isfinite(total), total, -math.inf)

        logprob.loglik = ll_fn
        vog = getattr(ll_fn, "value_ok_grad", None)
        if fast_grad is False or vog is None:
            return logprob

        def prior_and_grad(th):
            """Log prior of each row of ``th`` and its gradient."""
            th = th.detach().requires_grad_()
            with torch.enable_grad():
                lp = torch.stack([log_prior(r) for r in th.unbind(0)])
            if lp.requires_grad:
                (dlp,) = torch.autograd.grad(lp.sum(), th)
            else:  # e.g. the box prior: piecewise constant
                dlp = torch.zeros_like(th)
            return lp.detach(), dlp

        def combine(lp, dlp, ll, ok, dll):
            total = lp + torch.where(ok, ll.to(lp.dtype), -math.inf)
            bad = ~torch.isfinite(total)
            total = torch.where(bad, -math.inf, total)
            grad = torch.where(bad[..., None], 0.0, dlp + dll.to(dlp.dtype))
            return total, grad

        device = ll_fn.plan.t.device

        def value_and_grad(theta):
            theta = torch.as_tensor(theta).to(device)
            lp, dlp = prior_and_grad(theta[None])
            ll, ok, dll = vog(theta)
            total, grad = combine(lp[0], dlp[0], ll, ok, dll)
            return total, grad

        def value_and_grad_batch(thetas):
            thetas = torch.as_tensor(thetas).to(device)
            lp, dlp = prior_and_grad(thetas)
            ll, ok, dll = ll_fn.value_ok_grad_batch(thetas)
            return combine(lp, dlp, ll, ok, dll)

        logprob.value_and_grad = value_and_grad
        logprob.value_and_grad_batch = value_and_grad_batch
        return logprob
