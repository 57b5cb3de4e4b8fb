"""GP orchestration API of the port.

Port of ``celerite_tpu/gp.py:34-256, 279-610, 1160-1219``: a ModelSet of
``kernel`` and ``mean`` submodels with ``compute`` / ``log_likelihood``, and
the pure closures the fits and samplers call,
``build_loglik`` (``theta_active -> (ll, ok)``) and ``build_logprob``
(``theta_active -> ll + log prior``).

Routing of ``solver="auto"``: on the CPU the sequential solver below
N = 4096 points (the JAX package's CPU route) and the plain fused primal
above; on the card the CUDA fused primal kernel at every N, over a lane plan
built once per dataset.  Entry points run on ``cuda`` unless the GP was made
with ``device="cpu"``, and raise when CUDA is missing; they never fall back
to the CPU.
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


class LinAlgError(Exception):
    """The covariance matrix failed to factor (not positive definite)."""


def _resolve_device(device):
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "celerite_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def _not_in_slice(what, item):
    return NotImplementedError(
        "{0}: not ported yet (ROADMAP {1})".format(what, item)
    )


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
        On the CPU ``ll`` is differentiable with autograd.
        """
        if fast_grad:
            raise _not_in_slice("fast_grad (the gradient kernels)",
                                "queue 2, items 2-3")
        if precision not in (None, "ds"):
            raise ValueError(
                "precision must be None or 'ds', got {0!r}".format(precision)
            )
        if precision == "ds":
            dtype = torch.float64
        device = _resolve_device(self.device)

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
        if not mean_active:
            # Frozen mean: the residual stream is data, built once.
            y_fixed = plan.y - mean_fn(fixed[nk:], plan.t) * plan.mask

        def loglik(theta):
            coeffs, mp = split_theta(theta)
            cf = lanes4.pack_cf(coeffs, dtype=dtype).to(device)
            if mean_active:
                y4 = plan.y - mean_fn(mp.to(dtype), plan.t) * plan.mask
            else:
                y4 = y_fixed
            return ll_plan(cf, y4)

        loglik.plan = plan
        return loglik

    def build_logprob(self, t, y, yerr=1.123e-12, log_prior=None,
                      solver="auto", block_size=None, fast_grad=None,
                      precision=None, dtype=torch.float64):
        """Pure ``theta -> log posterior`` (ll + prior), -inf-safe.

        ``log_prior`` defaults to the box prior of the parameter bounds.
        The fused value-and-gradient entry point (``value_and_grad``) is the
        next slice: ``fast_grad=True`` raises.
        """
        if fast_grad:
            raise _not_in_slice("value_and_grad / chain folding",
                                "queue 1, item 8")
        ll_fn = self.build_loglik(
            t, y, yerr=yerr, solver=solver, block_size=block_size,
            precision=precision, dtype=dtype,
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
        return logprob
