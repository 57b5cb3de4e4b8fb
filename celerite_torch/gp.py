"""GP orchestration API of the port.

Port of ``celerite_tpu/gp.py:34-277, 279-810, 1160-1219``: a ModelSet of
``kernel`` and ``mean`` submodels with ``compute`` / ``log_likelihood`` /
``grad_log_likelihood``, and the pure closures the fits and samplers call,
``build_loglik`` (``theta_active -> (ll, ok)``) and ``build_logprob``
(``theta_active -> ll + log prior``).

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
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .modeling import ConstantModel, ModelSet
from .ops import fused4, lanes4, seq
from .ops.lower import Coefficients, lower

__all__ = ["GP", "LinAlgError"]

# Below this many points the CPU takes the sequential solver (the JAX
# package's CPU route, celerite_tpu/gp.py:507-508).
_SEQ_BELOW = 4096
# Share of the card's memory (on the CPU: bytes) that one folded launch's
# per-step saves may take; it sets the chains per launch (_fold_cap).
_FOLD_MEMORY_SHARE = 0.25
_FOLD_CPU_BYTES = 1 << 30


class LinAlgError(Exception):
    """The covariance matrix failed to factor (not positive definite)."""


def _not_in_slice(what, item):
    return NotImplementedError(
        "{0}: not ported yet (ROADMAP {1})".format(what, item)
    )


def _fold_cap(n, p, dtype, device):
    """Chains per folded launch: a power of two whose per-step saves fit.

    The gradient pipeline writes ``(4 P^2 + P)`` words a point and chain
    (fused4_grad.cu); a folded launch of ``nc`` chains holds ``nc`` times
    that.  On the card the saves may take ``_FOLD_MEMORY_SHARE`` of its
    memory, on the CPU ``_FOLD_CPU_BYTES``.
    """
    item = torch.finfo(dtype).bits // 8
    per_chain = max(n, 1) * (4 * p * p + p + 8) * item
    if device.type == "cuda":
        budget = _FOLD_MEMORY_SHARE * torch.cuda.get_device_properties(
            device).total_memory
    else:
        budget = _FOLD_CPU_BYTES
    cap = 1
    while 2 * cap * per_chain <= budget:
        cap *= 2
    return cap


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
        device: where the entry points compute; ``None`` means ``"cuda"``.
    """

    def __init__(self, kernel, mean=0.0, fit_mean=False, device=None):
        self.device = device
        self._t = None
        self._diag = None
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

    # -- compute / log_likelihood ------------------------------------------
    def compute(self, t, yerr=1.123e-12, check_sorted=True, A=None, U=None,
                V=None):
        """Store the coordinates and per-point variances.

        Raises ValueError for unsorted input.  The factorization runs in
        :meth:`log_likelihood`.
        """
        if any(x is not None and np.size(x) > 0 for x in (A, U, V)):
            raise _not_in_slice("general (A, U, V) blocks",
                                "queue 1, item 10")
        t = np.atleast_1d(np.asarray(t, dtype=float))
        if check_sorted and np.any(np.diff(t) < 0.0):
            raise ValueError("the input coordinates must be sorted")
        if check_sorted and t.ndim > 1:
            raise ValueError("dimension mismatch")
        self._t = t
        self._diag = np.broadcast_to(np.asarray(yerr, float) ** 2, t.shape)

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

    # -- pure closures --------------------------------------------------------
    def build_loglik(self, t, y, yerr=1.123e-12, diag=None, solver="auto",
                     block_size=None, fast_grad=False, precision=None,
                     dtype=torch.float64):
        """Return a pure closure ``theta_active -> (ll, ok)``.

        ``theta_active`` follows ``get_parameter_vector()`` ordering (kernel
        params then mean params, frozen entries excluded); a 1-D tensor on
        any device.  ``solver``: "seq" (sequential), "fused" (the fused
        primal over a lane plan: the CUDA kernel on the card, its plain
        version on the CPU) or "auto".  ``block_size`` sets the plan's lane
        count B.  ``dtype`` is the working precision (float32 or float64);
        ``precision="ds"`` means float64, which the card computes natively.
        ``ll`` is differentiable with autograd; on the card its backward
        reruns the gradient kernels over the value plan's lanes, whose
        cross-lane glue costs more launches than the gradient path's plan
        (PERF.md).  The fused closure carries ``value_ok_grad`` and
        ``value_ok_grad_batch`` (module docstring), the tuned route,
        whatever ``fast_grad`` says, as JAX's does; ``fast_grad="tangent"``
        (the forward-mode kernels) is not ported yet.
        """
        if fast_grad == "tangent":
            raise _not_in_slice("fast_grad='tangent' (the forward-mode "
                                "kernels)", "queue 2, item 8")
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
        width = pr + 2 * pc
        if solver == "auto":
            use_seq = width == 0 or (device.type == "cpu" and n < _SEQ_BELOW)
            solver = "seq" if use_seq else "fused"
        if solver in ("blocked", "pallas"):
            raise _not_in_slice("solver={0!r}".format(solver),
                                "queue 1, item 6")
        if solver not in ("seq", "fused"):
            raise ValueError("unknown solver '{0}'".format(solver))
        if solver == "fused" and width > fused4.MAX_WIDTH:
            raise _not_in_slice("padded width P > 12", "queue 2, items 5-7")

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

        if solver == "seq":
            t_dev = torch.as_tensor(t_np, dtype=dtype, device=device)
            y_dev = torch.as_tensor(y_np, dtype=dtype, device=device)
            diag_dev = torch.as_tensor(diag_np, dtype=dtype, device=device)
            lower_kw = {}
            if dtype == torch.float32:
                # Static double-single grid: exact spacings and the lo half
                # of t (ops/ds.py).
                lower_kw = dict(
                    dt=torch.as_tensor(np.concatenate([[0.0], np.diff(t_np)]),
                                       dtype=dtype, device=device),
                    t_lo=torch.as_tensor(
                        t_np - t_np.astype(np.float32).astype(np.float64),
                        dtype=dtype, device=device),
                )

            def loglik(theta):
                coeffs, mp = split_theta(theta)
                resid = y_dev - mean_fn(mp, t_dev)
                ssm = lower(coeffs, t_dev, diag_dev, **lower_kw)
                return seq.gp_log_likelihood(ssm, resid)

            return loglik

        nb = block_size or lanes4.default_num_blocks4(n, device)
        plan = lanes4.make_plan4(t_np, y_np, diag_np, nb, dtype=dtype,
                                 device=device)
        ll_plan = fused4.build_ll(plan, pr, pc)
        t_dev = torch.as_tensor(t_np, dtype=torch.float64, device=device)
        if not mean_active:
            # Frozen mean: the residual stream is data, built once.
            y_fixed = plan.y - mean_fn(fixed[nk:], plan.t) * plan.mask
            y_fold = y_np - np.asarray(mean_fn(fixed[nk:].cpu(),
                                               t_dev.cpu()), np.float64)

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

        folded = {}

        def folded_fn(nc):
            if nc not in folded:
                bc = block_size or lanes4.default_grad_blocks4(n, device)
                planb = lanes4.make_plan4(
                    t_np, y_np if mean_active else y_fold, diag_np, bc,
                    dtype=dtype, n_chain=nc, device=device)
                folded[nc] = (planb, bc, fused4.build_ll_and_grad(
                    planb, pr, pc, n_chain=nc))
            return folded[nc]

        def mean_of(theta):
            return mean_fn(split_theta(theta)[1], t_dev)

        def folded_vog(th):
            """(ll, ok, grad) for a power-of-two batch of rows, one
            folded launch of each kernel."""
            planb, bc, fnb = folded_fn(th.shape[0])
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

        def value_ok_grad_batch(thetas):
            """``(n, dim)`` rows -> ``(ll (n,), ok (n,), grad (n, dim))``.

            Pads n to a power of two with copies of the first row; above
            ``value_ok_grad_batch.fold_cap`` chains (set from the memory
            the per-step saves take) it folds in chunks of that many.
            ``value_ok_grad_batch.folded_plan(nc)`` is the cached plan a
            chunk of ``nc`` rows runs on.
            """
            thetas = torch.as_tensor(thetas).to(device)
            rows = thetas.shape[0]
            cap = value_ok_grad_batch.fold_cap
            nc = 1 << max(0, rows - 1).bit_length()
            chunk = min(nc, cap)
            pad = -rows % chunk
            th = torch.cat([thetas, thetas[:1].expand(pad, -1)])
            outs = [folded_vog(part) for part in th.split(chunk)]
            ll, ok, grad = (torch.cat(x) for x in zip(*outs))
            return ll[:rows], ok[:rows], grad[:rows]

        def value_ok_grad(theta):
            """``(ll, ok, grad)`` for one parameter vector: the batched
            entry on one row (a plan with the gradient path's lane count)."""
            ll, ok, grad = value_ok_grad_batch(torch.as_tensor(theta)[None])
            return ll[0], ok[0], grad[0]

        value_ok_grad_batch.fold_cap = _fold_cap(n, width, dtype, device)
        value_ok_grad_batch.folded_plan = lambda nc: folded_fn(nc)[0]
        loglik.plan = plan
        loglik.value_ok_grad = value_ok_grad
        loglik.value_ok_grad_batch = value_ok_grad_batch
        return loglik

    def build_logprob(self, t, y, yerr=1.123e-12, log_prior=None,
                      solver="auto", block_size=None, fast_grad=None,
                      precision=None, dtype=torch.float64):
        """Pure ``theta -> log posterior`` (ll + prior), -inf-safe.

        ``log_prior`` defaults to the box prior of the parameter bounds.
        With ``fast_grad=None`` (or True) and the fused solver, the closure
        carries ``value_and_grad(theta) -> (logp, grad)`` and
        ``value_and_grad_batch(thetas) -> (logp (n,), grad (n, dim))``
        through the log-likelihood's ``value_ok_grad`` entries; where the
        log probability is not finite it is -inf and its gradient 0
        (celerite_tpu/gp.py:1207-1219).  ``fast_grad=False`` attaches
        neither (samplers then use autograd); ``"tangent"`` is not ported.
        """
        ll_fn = self.build_loglik(
            t, y, yerr=yerr, solver=solver, block_size=block_size,
            fast_grad=fast_grad, precision=precision, dtype=dtype,
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
