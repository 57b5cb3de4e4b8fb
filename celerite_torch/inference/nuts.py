"""The No-U-Turn Sampler and its Hamiltonian building blocks, batched over
chains.

Port of ``celerite_tpu/inference/nuts.py``: the metric (a diagonal or
dense inverse mass matrix, or a diagonal one a row), momentum draws, the
leapfrog step, the Hoffman & Gelman step-size search, the iterative
multinomial NUTS transition (``nuts_kernel``: doublings of a trajectory
with checkpoint slots for the sub-tree U-turn checks, divergence threshold
1000), the warmup and sample segments (``_build_segments``: dual-averaged
step size and windowed diagonal or dense mass), ``sample_nuts``, chunked,
and ``sample_nuts_batch``, the fleet primitive: B problems' chains folded
into the rows of one batched run, each problem adapting its own step size
and metric.

Where the JAX package maps one chain's function over chains with ``vmap``,
these take the chains as the leading axis of a ``(n_chains, dim)`` batch,
so one batched value-and-gradient call
(``GP.build_logprob(...).value_and_grad_batch``, chain-folded onto the
kernels' lanes) serves every chain at every leapfrog.  A chain whose tree
has stopped (U-turn, divergence or depth) keeps its state under a mask
while the others go on, as vmap's padding did.  Random draws come from an
explicit ``torch.Generator`` on the chains' device.  The ``axis_name``
pooling across sharded chains is dropped: the batch pools all chains.
"""

from __future__ import annotations

import math
import time
from typing import NamedTuple

import torch

from . import adaptation

__all__ = ["NUTSInfo", "RowDiagonal", "nuts_kernel", "sample_nuts",
           "sample_nuts_batch", "find_reasonable_step_size",
           "value_and_grad_batch"]


class NUTSInfo(NamedTuple):
    accept_prob: torch.Tensor  # mean Metropolis accept stat over the tree
    num_steps: torch.Tensor  # leapfrog slots of the tree's doublings
    tree_depth: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor  # Hamiltonian H = -logp + kinetic at the proposal
    logp: torch.Tensor  # log probability at the proposal


def _popcount(x):
    """Set bits of each value's 32-bit pattern (``lax.population_count``
    on int32)."""
    x = torch.as_tensor(x).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (((x * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def _trailing_zeros(n):
    """Trailing zero bits; 32 for n == 0 (the JAX package's int32 rule)."""
    n = torch.as_tensor(n).to(torch.int64)
    return _popcount((n & -n) - 1)


def _checkpoint_masks(leaf, depth, max_depth):
    """Which of the ``max_depth`` checkpoint levels leaf ``leaf`` of a
    subtree of depth ``depth`` opens and closes.

    Leaf n opens the level-j spans j <= tz(n) (storing its momentum and the
    momentum sum before it) and closes those j <= tz(n + 1), j <= depth,
    whose U-turn test then runs: every binary sub-tree is checked once.
    """
    lvl = torch.arange(1, max_depth + 1)
    opened = lvl <= _trailing_zeros(leaf)
    closed = (lvl <= _trailing_zeros(leaf + 1)) & (lvl <= depth)
    return opened, closed


def value_and_grad_batch(logprob_fn):
    """``(n, dim) -> (logp (n,), grad (n, dim))`` for a log probability.

    Takes the closure's ``value_and_grad_batch`` where it has one (the fused
    GP log probability), else autograd through ``logprob_fn`` row by row.
    """
    vag = getattr(logprob_fn, "value_and_grad_batch", None)
    if vag is not None:
        return vag

    def autograd_batch(qs):
        th = qs.detach().requires_grad_()
        with torch.enable_grad():
            lp = torch.stack([logprob_fn(r) for r in th.unbind(0)])
            (grad,) = torch.autograd.grad(lp.sum(), th)
        return lp.detach(), grad

    return autograd_batch


class RowDiagonal(NamedTuple):
    """A diagonal inverse mass for each row of the batch, ``(n, dim)``:
    :func:`sample_nuts_batch`'s per-problem metrics, one row a chain."""

    diag: torch.Tensor


def _velocity(inv_mass, p):
    """dq/dt = M^-1 p for a diagonal (vector), dense (matrix) or per-row
    diagonal (:class:`RowDiagonal`) metric; ``p`` is one momentum or a
    batch of rows, with any axes between the rows and ``dim`` (the JAX
    package's ``_velocity`` and ``_velocity_rows`` in one)."""
    if isinstance(inv_mass, RowDiagonal):
        d = inv_mass.diag
        return d.reshape(d.shape[0], *([1] * (p.ndim - 2)), d.shape[1]) * p
    if inv_mass.ndim == 2:
        return p @ inv_mass  # symmetric, so right-multiply works
    return inv_mass * p


def _sample_momentum(generator, n, dim, dtype, inv_mass):
    """``n`` draws p ~ N(0, M) with M = inv_mass^-1, as rows.

    Dense path: inv_mass = L L^T, so p = L^-T xi has covariance
    (L L^T)^-1 = M.
    """
    if isinstance(inv_mass, RowDiagonal):
        xi = torch.randn(n, dim, generator=generator, dtype=dtype,
                         device=inv_mass.diag.device)
        return xi / torch.sqrt(inv_mass.diag)
    xi = torch.randn(n, dim, generator=generator, dtype=dtype,
                     device=inv_mass.device)
    if inv_mass.ndim == 2:
        L = torch.linalg.cholesky(inv_mass)
        return torch.linalg.solve_triangular(L.T, xi.T, upper=True).T
    return xi / torch.sqrt(inv_mass)


def _leapfrog(grad_fn, q, p, grad, eps, inv_mass):
    """One leapfrog step; ``grad_fn(q) -> (grad U, logp)`` with U = -logp.

    ``q``, ``p`` and ``grad`` are rows (one per chain); ``eps`` is a scalar
    or one step size per chain.
    """
    eps = torch.as_tensor(eps, dtype=q.dtype, device=q.device)
    if eps.ndim == 1:
        eps = eps[:, None]
    p = p - 0.5 * eps * grad
    q = q + eps * _velocity(inv_mass, p)
    new_grad, logp = grad_fn(q)
    p = p - 0.5 * eps * new_grad
    return q, p, new_grad, logp


def _metric(inv_mass, dim, dtype, device):
    if inv_mass is None:
        return torch.ones(dim, dtype=dtype, device=device)
    if isinstance(inv_mass, RowDiagonal):
        return RowDiagonal(inv_mass.diag.to(device=device, dtype=dtype))
    inv_mass = torch.as_tensor(inv_mass, dtype=dtype).to(device)
    if inv_mass.ndim < 2:
        inv_mass = inv_mass.expand(dim)
    return inv_mass


def find_reasonable_step_size(logprob_fn, q, generator, inv_mass=None,
                              initial=1.0, max_iters=30):
    """Per chain, double or halve eps until one leapfrog's accept ratio
    crosses 1/2 (Hoffman & Gelman 2014, algorithm 4).

    ``q`` is ``(n_chains, dim)``; returns the ``(n_chains,)`` step sizes.
    Each round is one batched value-and-gradient call for every chain; a
    chain whose ratio has crossed keeps its step size, as a chain of the
    JAX package's vmapped ``while_loop`` does.
    """
    n, dim = q.shape
    inv_mass = _metric(inv_mass, dim, q.dtype, q.device)
    vag = value_and_grad_batch(logprob_fn)

    def grad_fn(x):
        logp, g = vag(x)
        return -g, logp

    grad0, logp0 = grad_fn(q)
    p0 = _sample_momentum(generator, n, dim, q.dtype, inv_mass)
    h0 = -logp0 + 0.5 * torch.sum(p0 * _velocity(inv_mass, p0), dim=-1)

    def log_ratio(eps):
        _, pn, _, logpn = _leapfrog(grad_fn, q, p0, grad0, eps, inv_mass)
        h1 = -logpn + 0.5 * torch.sum(pn * _velocity(inv_mass, pn),
                                      dim=-1)
        r = h0 - h1
        return torch.where(torch.isnan(r), -math.inf, r)

    eps = torch.full((n,), float(initial), dtype=q.dtype, device=q.device)
    lr = log_ratio(eps)
    direction = torch.where(lr > math.log(0.5), 1.0, -1.0).to(q.dtype)
    moving = torch.ones(n, dtype=torch.bool, device=q.device)
    for _ in range(max_iters):
        moving = moving & (direction * lr > direction * math.log(0.5))
        if not bool(moving.any()):
            break
        eps = torch.where(moving, eps * torch.exp2(direction), eps)
        lr = log_ratio(eps)
    return eps


def _where(mask, new, old):
    """Rows of ``new`` where ``mask`` (one bool a chain), else ``old``."""
    return torch.where(mask.reshape(-1, *([1] * (new.ndim - 1))), new, old)


def nuts_kernel(logprob_fn, q, generator, step_size, inv_mass,
                max_tree_depth=10, divergence_threshold=1000.0):
    """One NUTS transition of every chain; returns ``(q_new, NUTSInfo)``.

    ``q`` is ``(n_chains, dim)``; ``inv_mass`` a (dim,) diagonal or dense
    (dim, dim) inverse mass matrix shared by the chains, or a
    :class:`RowDiagonal` of one diagonal a chain; ``step_size`` a scalar or
    one a chain; ``generator`` a ``torch.Generator`` on ``q``'s device.
    The chains double their trees
    together: a doubling of depth d streams its 2^d leaves, each one
    batched value-and-gradient call for every chain, and a chain whose
    subtree turned or diverged, or whose tree has stopped, keeps its state.
    """
    n, dim = q.shape
    dtype, dev = q.dtype, q.device
    md = int(max_tree_depth)
    inv_mass = _metric(inv_mass, dim, dtype, dev)
    eps = torch.as_tensor(step_size, dtype=dtype).to(dev)
    vag = value_and_grad_batch(logprob_fn)

    def grad_fn(x):
        logp, g = vag(x)
        return -g, logp  # gradient of the potential U = -logp

    def kinetic(p):
        return 0.5 * torch.sum(p * _velocity(inv_mass, p), dim=-1)

    def rand():
        return torch.rand(n, generator=generator, dtype=dtype, device=dev)

    p0 = _sample_momentum(generator, n, dim, dtype, inv_mass)
    grad0, logp0 = grad_fn(q)
    h0 = -logp0 + kinetic(p0)
    zeros = torch.zeros(n, dtype=dtype, device=dev)
    no = torch.zeros(n, dtype=torch.bool, device=dev)

    def subtree(q, p, g, eps_signed, depth, live):
        """Stream the 2^depth leaves of the new subtree (the JAX package's
        ``build_subtree``); a chain stops at its first U-turn or
        divergence."""
        s = dict(q=q, p=p, g=g, psum=torch.zeros_like(p),
                 ckpt_p=torch.zeros(n, md, dim, dtype=dtype, device=dev),
                 ckpt_psum=torch.zeros(n, md, dim, dtype=dtype, device=dev),
                 q_prop=q, logp_prop=torch.full_like(zeros, -math.inf),
                 h_prop=h0, log_w=torch.full_like(zeros, -math.inf),
                 sum_accept=zeros, turning=no, diverging=no)
        for leaf in range(1 << depth):
            go = live & ~s["turning"] & ~s["diverging"]
            if not bool(go.any()):
                break
            qn, pn, gn, logpn = _leapfrog(grad_fn, s["q"], s["p"], s["g"],
                                          eps_signed, inv_mass)
            h = -logpn + kinetic(pn)
            delta = h - h0
            # A NaN energy counts as a divergence and must not poison the
            # running statistics.
            bad = torch.isnan(delta)
            div = bad | (delta > divergence_threshold)
            logw = torch.where(bad, -math.inf, -delta)
            accept = torch.where(bad, 0.0, torch.clamp(torch.exp(-delta),
                                                       max=1.0))
            opened, closed = _checkpoint_masks(leaf, depth, md)
            opened, closed = opened.to(dev), closed.to(dev)
            ckpt_p = torch.where(opened[None, :, None], pn[:, None],
                                 s["ckpt_p"])
            ckpt_psum = torch.where(opened[None, :, None], s["psum"][:, None],
                                    s["ckpt_psum"])
            psum = s["psum"] + pn
            v = _velocity(inv_mass, psum[:, None] - ckpt_psum)  # (n, md, dim)
            turn_j = (torch.sum(v * ckpt_p, -1) <= 0) \
                | (torch.sum(v * pn[:, None], -1) <= 0)
            turning = s["turning"] | torch.any(turn_j & closed, -1)
            log_w = torch.logaddexp(s["log_w"], logw)
            take = (torch.log(rand()) < logw - log_w) & ~div
            new = dict(q=qn, p=pn, g=gn, psum=psum, ckpt_p=ckpt_p,
                       ckpt_psum=ckpt_psum,
                       q_prop=_where(take, qn, s["q_prop"]),
                       logp_prop=torch.where(take, logpn, s["logp_prop"]),
                       h_prop=torch.where(take, h, s["h_prop"]),
                       log_w=log_w, sum_accept=s["sum_accept"] + accept,
                       turning=turning, diverging=s["diverging"] | div)
            s = {k: _where(go, new[k], s[k]) for k in s}
        return s

    t = dict(q_left=q, p_left=p0, g_left=grad0, q_right=q, p_right=p0,
             g_right=grad0, psum=p0, q_prop=q, logp_prop=logp0, h_prop=h0,
             log_w=zeros, sum_accept=zeros,
             num_steps=torch.zeros(n, dtype=torch.int64, device=dev),
             depth=torch.zeros(n, dtype=torch.int64, device=dev),
             turning=no, diverging=no)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    for depth in range(md):
        if not bool(active.any()):
            break
        right = rand() < 0.5
        eps_signed = torch.where(right, eps, -eps)
        s = subtree(_where(right, t["q_right"], t["q_left"]),
                    _where(right, t["p_right"], t["p_left"]),
                    _where(right, t["g_right"], t["g_left"]),
                    eps_signed, depth, active)
        ok = ~(s["turning"] | s["diverging"])
        new = dict(t)
        for side, cond in (("right", right & ok), ("left", ~right & ok)):
            for k, sk in (("q", "q"), ("p", "p"), ("g", "g")):
                new[k + "_" + side] = _where(cond, s[sk], t[k + "_" + side])
        new["psum"] = t["psum"] + s["psum"]
        # Biased progressive sampling between the old tree and the new
        # subtree.
        take = (torch.log(rand()) < s["log_w"] - t["log_w"]) & ok
        for k in ("q_prop", "logp_prop", "h_prop"):
            new[k] = _where(take, s[k], t[k])
        new["log_w"] = torch.logaddexp(t["log_w"], s["log_w"])
        # The top-level U-turn across the merged trajectory.
        v = _velocity(inv_mass, new["psum"])
        turning_top = (torch.sum(v * new["p_left"], -1) <= 0) \
            | (torch.sum(v * new["p_right"], -1) <= 0)
        new["turning"] = s["turning"] | (ok & turning_top)
        new["sum_accept"] = t["sum_accept"] + s["sum_accept"]
        new["num_steps"] = t["num_steps"] + (1 << depth)
        new["depth"] = t["depth"] + 1
        new["diverging"] = t["diverging"] | s["diverging"]
        t = {k: _where(active, new[k], t[k]) for k in t}
        active = active & ~t["turning"] & ~t["diverging"]

    accept_prob = t["sum_accept"] / torch.clamp(t["num_steps"].to(dtype),
                                                min=1.0)
    return t["q_prop"], NUTSInfo(accept_prob=accept_prob,
                                 num_steps=t["num_steps"],
                                 tree_depth=t["depth"],
                                 diverging=t["diverging"],
                                 energy=t["h_prop"], logp=t["logp_prop"])


def _build_segments(logprob_fn, n_chains, dim, dtype, max_tree_depth,
                    target_accept, warmup_max_tree_depth=None,
                    dense_mass=False, device=None, problems=None):
    """Warmup and sample segments of ``sample_nuts``.

    Returns ``(init_carry, warmup_segment, sample_segment)``.
    ``warmup_segment(carry, generator, mass_flags, end_flags)`` runs one
    transition a flag pair: the chains' pooled acceptance drives one
    dual-averaged step size; in a mass window the draws feed a Welford
    accumulator (dense covariance with ``dense_mass``, else the diagonal
    variance); at a window's end the estimate becomes the metric if it is
    sane and dual averaging restarts.  It returns the carry and each
    transition's pooled acceptance and divergence count.
    ``sample_segment(qs, generator, num, step_size, inv_mass)`` runs
    ``num`` transitions and returns the draws, acceptances, divergences,
    leapfrog slots and energies, each stacked on a transition axis.
    ``warmup_max_tree_depth`` caps the tree depth in warmup only.

    ``problems`` (``sample_nuts_batch``): the rows are that many problems
    of ``n_chains`` chains each, problem-major; the step size and the
    diagonal metric are one a problem (``(problems,)``, ``(problems,
    dim)``), pooled over that problem's chains, and the pooled acceptance
    and divergence count come back per problem.
    """
    if problems is not None and dense_mass:
        raise NotImplementedError("batched problems take a diagonal metric")
    batch = () if problems is None else (problems,)
    if dense_mass:
        def wf_init():
            return adaptation.welford_cov_init(dim, dtype, device)

        wf_update = adaptation.welford_cov_update
        wf_estimate = adaptation.welford_covariance

        def im_init():
            return torch.eye(dim, dtype=dtype, device=device)

        def im_sane(new, old):
            # A window covariance can be rank-deficient early on: take it
            # only if finite, with a positive diagonal and a Cholesky
            # factor, or every later momentum draw would be NaN.
            chol, info = torch.linalg.cholesky_ex(new)
            good = (bool(torch.isfinite(new).all())
                    and bool((torch.diagonal(new) > 0).all())
                    and int(info) == 0 and bool(torch.isfinite(chol).all()))
            return new if good else old
    else:
        def wf_init():
            return adaptation.welford_init(dim, dtype, device, batch=batch)

        wf_update = adaptation.welford_update
        wf_estimate = adaptation.welford_variance

        def im_init():
            return torch.ones(*batch, dim, dtype=dtype, device=device)

        def im_sane(new, old):
            return torch.where(torch.isfinite(new) & (new > 0), new, old)

    if problems is None:
        def metric(step_size, inv_mass):
            return step_size, inv_mass

        def pooled_mean(x):
            return x.mean()

        def pooled_sum(x):
            return x.sum()

        def by_problem(qs):
            return qs
    else:
        def metric(step_size, inv_mass):
            return (torch.as_tensor(step_size).repeat_interleave(n_chains),
                    RowDiagonal(inv_mass.repeat_interleave(n_chains, 0)))

        def pooled_mean(x):
            return x.reshape(problems, n_chains).mean(1)

        def pooled_sum(x):
            return x.reshape(problems, n_chains).sum(1)

        def by_problem(qs):
            return qs.reshape(problems, n_chains, dim)

    if warmup_max_tree_depth is None:
        warmup_max_tree_depth = max_tree_depth
    warmup_max_tree_depth = min(warmup_max_tree_depth, max_tree_depth)

    def init_carry(init_params, initial_step_size, mu=None):
        da = adaptation.da_init(initial_step_size, target_accept, mu=mu)
        return init_params, da, wf_init(), im_init()

    def warmup_segment(carry, generator, mass_flags, end_flags):
        qs, da, wf, inv_mass = carry
        accepts, divs = [], []
        for in_window, at_end in zip(mass_flags, end_flags):
            qs, info = nuts_kernel(logprob_fn, qs, generator,
                                   *metric(torch.exp(da.log_step), inv_mass),
                                   max_tree_depth=warmup_max_tree_depth)
            accept = pooled_mean(info.accept_prob)
            da = adaptation.da_update(da, accept)
            if bool(in_window):
                wf = wf_update(wf, by_problem(qs))
            if bool(at_end):
                inv_mass = im_sane(wf_estimate(wf), inv_mass)
                da = adaptation.da_init(torch.exp(da.log_step),
                                        target_accept)
                wf = wf_init()
            accepts.append(accept)
            divs.append(pooled_sum(info.diverging))
        return (qs, da, wf, inv_mass), (torch.stack(accepts),
                                         torch.stack(divs))

    def sample_segment(qs, generator, num, step_size, inv_mass):
        out = []
        for _ in range(num):
            qs, info = nuts_kernel(logprob_fn, qs, generator,
                                   *metric(step_size, inv_mass),
                                   max_tree_depth=max_tree_depth)
            out.append((qs, info.accept_prob, info.diverging,
                        info.num_steps, info.energy))
        return qs, tuple(torch.stack(x) for x in zip(*out))

    return init_carry, warmup_segment, sample_segment


def _emitter(progress):
    def emit(rec):
        if callable(progress):
            progress(rec)
        elif progress:
            print("[nuts] " + "  ".join(
                "{0}={1}".format(k, v) for k, v in rec.items()), flush=True)

    return emit


def _drive(segments, carry, generator, num_warmup, num_samples, chunk_size,
           rows, progress):
    """Warmup, then sampling, in host segments of at most ``chunk_size``
    transitions, ``progress`` called after each (the same results as one
    segment).  Returns ``(step_size, inv_mass, draws, accept, div, steps,
    energy, warmup accept, warmup div)``, the sampling records stacked on
    a leading transition axis, each ``(num_samples, rows, ...)``."""
    _, warmup_segment, sample_segment = segments
    emit = _emitter(progress)
    in_window, window_end = adaptation.window_boundaries(num_warmup)
    chunk = chunk_size or max(num_warmup, num_samples, 1)

    warm_acc, warm_div = [], []
    for lo in range(0, num_warmup, chunk):
        hi = min(lo + chunk, num_warmup)
        t0 = time.perf_counter()
        carry, (acc, div) = warmup_segment(carry, generator,
                                           in_window[lo:hi],
                                           window_end[lo:hi])
        warm_acc.append(acc)
        warm_div.append(div)
        if progress:
            emit({"phase": "warmup", "done": hi, "total": num_warmup,
                  "trans/s": (hi - lo) / (time.perf_counter() - t0),
                  "accept": float(acc.mean()),
                  "step_size": float(torch.exp(carry[1].log_step).mean())})
    qs, da, _, inv_mass = carry
    step_size = adaptation.da_final(da)

    parts = []
    for lo in range(0, num_samples, chunk):
        hi = min(lo + chunk, num_samples)
        t0 = time.perf_counter()
        qs, part = sample_segment(qs, generator, hi - lo, step_size,
                                  inv_mass)
        parts.append(part)
        if progress:
            _, acc, div, steps, _ = part
            dt = time.perf_counter() - t0
            emit({"phase": "sample", "done": hi, "total": num_samples,
                  "samples/s": rows * (hi - lo) / dt,
                  "leapfrogs/s": float(steps.sum()) / dt,
                  "accept": float(acc.mean()),
                  "divergences": int(div.sum())})
    dtype, dev = qs.dtype, qs.device
    empty = torch.zeros(0, rows, dtype=dtype, device=dev)
    records = tuple(torch.cat(x) for x in zip(*parts)) if parts else (
        torch.zeros(0, *qs.shape, dtype=dtype, device=dev), empty, empty,
        empty, empty)
    warm = [torch.cat(x) if x else torch.zeros(0, dtype=dtype, device=dev)
            for x in (warm_acc, warm_div)]
    return (step_size, inv_mass, *records, *warm)


def _initial_step(logprob_fn, init_params, generator, initial_step_size,
                  num_warmup, problems=None):
    """The dual averaging's start and anchor ``(step, mu)``: with
    ``initial_step_size="auto"`` the Hoffman & Gelman search on every row
    and their geometric mean (per problem), anchored there."""
    if initial_step_size != "auto" or num_warmup == 0:
        return initial_step_size, None
    eps = find_reasonable_step_size(logprob_fn, init_params, generator)
    log_eps = torch.log(eps)
    if problems is None:
        step = torch.exp(torch.mean(log_eps)).cpu()
    else:
        step = torch.exp(torch.mean(log_eps.reshape(problems, -1), 1)).cpu()
    return step, torch.log(step)


def sample_nuts(logprob_fn, init_params, generator, num_warmup=500,
                num_samples=500, max_tree_depth=10, target_accept=0.8,
                initial_step_size=0.1, thin=1, chunk_size=None,
                warmup_max_tree_depth=None, progress=None, dense_mass=False):
    """Multi-chain NUTS with cross-chain window adaptation.

    ``init_params``: ``(n_chains, dim)``; ``generator`` a
    ``torch.Generator`` on their device.  Returns ``(samples, info)``,
    samples shaped ``(n_chains, num_samples // thin, dim)``.

    Adaptation (Stan-style): a dual-averaged step size toward
    ``target_accept`` from the acceptance pooled over all chains, and a
    diagonal (or with ``dense_mass`` a dense) inverse mass matrix from
    Welford statistics pooled over all chains in doubling windows
    (``adaptation.window_boundaries``).  ``initial_step_size="auto"``
    first runs the Hoffman & Gelman search on every chain and starts dual
    averaging at their geometric mean, anchored there (``mu``).
    ``warmup_max_tree_depth`` caps the tree depth in warmup only: a chain
    opening deep trees while the step size is still off costs every
    chain, since the chains advance together.

    ``chunk_size`` runs warmup and sampling in host segments of at most
    that many transitions, with ``progress`` (``True`` to print, or a
    callable taking a dict) called after each; the results are the same
    as in one segment.  ``info`` holds ``step_size``, ``inv_mass``,
    ``accept_prob`` (mean over sampling), ``divergences`` and
    ``num_steps`` (sums over sampling), ``energy`` ``(n_chains,
    num_samples)`` and the warmup's per-transition pooled
    ``warmup_accept_prob`` and total ``warmup_divergences``.
    """
    init_params = torch.atleast_2d(torch.as_tensor(init_params))
    n_chains, dim = init_params.shape
    dtype, dev = init_params.dtype, init_params.device
    segments = _build_segments(
        logprob_fn, n_chains, dim, dtype, max_tree_depth, target_accept,
        warmup_max_tree_depth=warmup_max_tree_depth, dense_mass=dense_mass,
        device=dev)
    step0, mu = _initial_step(logprob_fn, init_params, generator,
                              initial_step_size, num_warmup)
    carry = segments[0](init_params, step0, mu=mu)
    (step_size, inv_mass, chain, accept, div, steps, energy, warm_acc,
     warm_div) = _drive(segments, carry, generator, num_warmup, num_samples,
                        chunk_size, n_chains, progress)
    info = {
        "step_size": step_size,
        "inv_mass": inv_mass,
        "accept_prob": accept.mean() if accept.numel() else accept.sum(),
        "divergences": div.sum(),
        "num_steps": steps.sum(),
        # (n_chains, num_samples): input to diagnostics.ebfmi.
        "energy": energy.T,
        "warmup_accept_prob": warm_acc,
        "warmup_divergences": warm_div.sum(),
    }
    return chain.transpose(0, 1)[:, ::thin], info


def _rows_logprob(logprob_fn, data_batch, n_chains):
    """The log probability over the problem-major rows of a batch, as a
    closure carrying its ``value_and_grad_batch``.

    Each leaf of ``data_batch`` (a tensor, or a tuple, list or dict of
    them, leading axis the problems) is repeated ``n_chains`` times, so
    row ``b n_chains + c`` is problem ``b``'s chain ``c``.  The rows' value
    and gradient are one call: ``logprob_fn.value_and_grad_batch(data_rows,
    thetas)`` where the function has one, else ``torch.func.vmap`` of
    ``torch.func.grad_and_value`` of ``logprob_fn(data, theta)``.
    """
    from torch.utils import _pytree

    data_rows = _pytree.tree_map(
        lambda x: torch.as_tensor(x).repeat_interleave(n_chains, 0),
        data_batch)
    batch_fn = getattr(logprob_fn, "value_and_grad_batch", None)
    if batch_fn is not None:
        def vag(qs):
            return batch_fn(data_rows, qs)
    else:
        rows_fn = torch.func.vmap(
            torch.func.grad_and_value(logprob_fn, argnums=1))

        def vag(qs):
            grad, val = rows_fn(data_rows, qs)
            return val, grad

    def logprob(q):
        return vag(q[None])[0][0]

    logprob.value_and_grad_batch = vag
    return logprob


def sample_nuts_batch(logprob_fn, data_batch, init_params, generator,
                      num_warmup=500, num_samples=500, max_tree_depth=10,
                      target_accept=0.8, initial_step_size=0.1, thin=1,
                      chunk_size=None, warmup_max_tree_depth=None):
    """Independent NUTS fits for a batch of problems in one batched run.

    The port of nuts.py:820-938, the fleet-fitting primitive (BASELINE
    configs[4]: thousands of light curves, each with its own
    hyperparameters).  Where the JAX package vmaps one ``sample_nuts`` per
    problem, the B problems' ``n_chains`` chains are the ``B n_chains``
    rows of one batched transition, so one value-and-gradient call serves
    every row at every leapfrog (see :func:`_rows_logprob`).  Adaptation is
    per problem: dual averaging on each problem's pooled acceptance, and
    Welford windows over each problem's chains for its diagonal metric.

    ``logprob_fn(data, theta)`` is one problem's log probability;
    ``data_batch`` a tensor or a tuple, list or dict of tensors with
    leading axis B; ``init_params`` ``(B, n_chains, dim)``; ``generator`` a
    ``torch.Generator`` on their device.  ``chunk_size`` runs host
    segments of at most that many transitions, with the same draws as one
    segment.
    Returns ``(chains, info)``: chains ``(B, n_chains, num_samples // thin,
    dim)``; info's ``step_size`` ``(B,)``, ``inv_mass`` ``(B, dim)``,
    ``accept_prob`` ``(B,)`` (mean over sampling and chains),
    ``divergences`` and ``num_steps`` ``(B,)`` (sums), ``energy`` ``(B,
    n_chains, num_samples)``, ``warmup_accept_prob`` ``(num_warmup, B)``
    and ``warmup_divergences`` ``(B,)``.
    """
    init_params = torch.as_tensor(init_params)
    b, n_chains, dim = init_params.shape
    dtype, dev = init_params.dtype, init_params.device
    rows = b * n_chains
    target = _rows_logprob(logprob_fn, data_batch, n_chains)
    segments = _build_segments(
        target, n_chains, dim, dtype, max_tree_depth, target_accept,
        warmup_max_tree_depth=warmup_max_tree_depth, device=dev, problems=b)
    qs0 = init_params.reshape(rows, dim)
    step0, mu = _initial_step(target, qs0, generator, initial_step_size,
                              num_warmup, problems=b)
    step0 = torch.as_tensor(step0, dtype=torch.float64).expand(b)
    mu = None if mu is None else torch.as_tensor(mu).expand(b)
    carry = segments[0](qs0, step0, mu=mu)
    (step_size, inv_mass, chain, accept, div, steps, energy, warm_acc,
     warm_div) = _drive(segments, carry, generator, num_warmup, num_samples,
                        chunk_size, rows, None)

    def per_problem(x):
        """(num_samples, rows) -> (B, n_chains, num_samples)."""
        return x.reshape(x.shape[0], b, n_chains).permute(1, 2, 0)

    chain = chain.reshape(-1, b, n_chains, dim).permute(1, 2, 0, 3)
    info = {
        "step_size": step_size,
        "inv_mass": inv_mass,
        "accept_prob": per_problem(accept).mean(dim=(1, 2)),
        "divergences": per_problem(div).sum(dim=(1, 2)),
        "num_steps": per_problem(steps).sum(dim=(1, 2)),
        "energy": per_problem(energy),
        "warmup_accept_prob": warm_acc,
        "warmup_divergences": warm_div.sum(0),
    }
    return chain[:, :, ::thin], info
