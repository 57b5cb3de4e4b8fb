"""Batched light-curve containers, loaders and the fleet likelihood.

Port of ``celerite_tpu/data.py``.  Pod-scale workloads (BASELINE.json
configs[4]: 10k light curves) pack ragged per-target time series into
padded rectangular batches:

- :class:`LightCurveBatch`: padded ``(B, Nmax)`` arrays and a mask, built
  from ragged lists by the native multithreaded packer
  (``native/lightcurve_io.cpp``, built with g++ into ``build/native/`` at
  first use) or, where that build fails, by numpy with the same output;
- a binary container (``.lcb``) for bulk storage, read through a memory
  map, byte for byte the JAX package's;
- :func:`batched_gp_log_likelihood`: the masked GP log-likelihood of every
  curve of a batch, one sequential loop over the steps for all curves
  (padded samples are inert: A = 1, U = V = 0, resid = 0);
- :func:`make_fleet_loglik`: the same per-curve values, or each chain's
  fleet sum, from one launch of each fused4 kernel on the card, one lane a
  curve (``ops.lanes4.make_plan4_curves``);
- :func:`make_curve_logprob` and :func:`curve_rows`: one curve's log
  probability with its own parameters, whose batched value and gradient
  (``inference.sample_nuts_batch``'s call for all rows) runs the same
  kernels with one coefficient row a lane.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
from pathlib import Path
from typing import NamedTuple, Sequence

import numpy as np
import torch

__all__ = [
    "LightCurveBatch",
    "save_lcb",
    "load_lcb",
    "batched_gp_log_likelihood",
    "make_fleet_loglik",
    "curve_rows",
    "make_curve_logprob",
]

_MAGIC = b"CTLC"
_ROOT = Path(__file__).resolve().parent.parent
_SRC = _ROOT / "native" / "lightcurve_io.cpp"
_BUILD_DIR = _ROOT / "build" / "native"

_lib = None
_tried = False


def _compile_and_load():
    digest = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    so_path = _BUILD_DIR / "lightcurve_io_{0}.so".format(digest)
    if not so_path.exists():
        tmp = so_path.with_suffix(".{0}.tmp".format(os.getpid()))
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
               "-o", str(tmp), str(_SRC)]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(str(so_path))
    i64 = ctypes.c_int64
    dptr = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    iptr = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.lc_pack.restype = None
    lib.lc_pack.argtypes = [i64, i64, dptr, iptr, ctypes.c_double, dptr,
                            ctypes.c_int]
    lib.lc_pack_repeat.restype = None
    lib.lc_pack_repeat.argtypes = [i64, i64, dptr, iptr, dptr, ctypes.c_int]
    lib.lc_abi_version.restype = ctypes.c_int
    if lib.lc_abi_version() != 1:
        raise RuntimeError("lightcurve_io ABI version mismatch")
    return lib


def _get_lib():
    """The native packer, or None where it does not build or load."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        try:
            _lib = _compile_and_load()
        except (OSError, RuntimeError, subprocess.CalledProcessError):
            _lib = None
    return _lib


def _pack(ragged: Sequence[np.ndarray], nmax, fill=0.0, repeat_edge=False):
    """Ragged float64 arrays -> ``((n, nmax) padded, lengths)``.

    The pad is ``fill``, or with ``repeat_edge`` each array's last value
    (0 for an empty array, as the native packer writes).  Where the native
    packer did not build, numpy packs with the same output.
    """
    arrays = [np.ascontiguousarray(a, dtype=np.float64) for a in ragged]
    lengths = np.array([len(a) for a in arrays], dtype=np.int64)
    offsets = np.zeros(len(arrays) + 1, dtype=np.int64)
    np.cumsum(lengths, out=offsets[1:])
    flat = (np.concatenate(arrays) if arrays
            else np.zeros(0, dtype=np.float64))
    out = np.empty((len(arrays), nmax), dtype=np.float64)
    lib = _get_lib()
    if lib is not None:
        if repeat_edge:
            lib.lc_pack_repeat(len(arrays), nmax, flat, offsets, out, 0)
        else:
            lib.lc_pack(len(arrays), nmax, flat, offsets, fill, out, 0)
    else:
        for b, a in enumerate(arrays):
            out[b, :len(a)] = a
            if repeat_edge:
                out[b, len(a):] = a[-1] if len(a) else 0.0
            else:
                out[b, len(a):] = fill
    return out, lengths


class LightCurveBatch(NamedTuple):
    """Padded batch of light curves (host numpy arrays).

    t: (B, Nmax) sorted times, padded by repeating the last stamp;
    y, yerr: (B, Nmax) padded with zeros / ones; mask: (B, Nmax) bool;
    lengths: (B,).
    """

    t: np.ndarray
    y: np.ndarray
    yerr: np.ndarray
    mask: np.ndarray
    lengths: np.ndarray

    @classmethod
    def from_ragged(cls, ts, ys, yerrs, nmax=None):
        if not (len(ts) == len(ys) == len(yerrs)):
            raise ValueError("dimension mismatch")
        lengths = np.array([len(a) for a in ts], dtype=np.int64)
        if nmax is None:
            nmax = int(lengths.max()) if len(lengths) else 0
        t, _ = _pack(ts, nmax, repeat_edge=True)
        y, _ = _pack(ys, nmax, fill=0.0)
        yerr, _ = _pack(yerrs, nmax, fill=1.0)
        mask = np.arange(nmax)[None, :] < lengths[:, None]
        return cls(t=t, y=y, yerr=yerr, mask=mask, lengths=lengths)

    def __len__(self):
        return self.t.shape[0]


def save_lcb(path, ts, ys, yerrs):
    """Write ragged light curves to the .lcb binary container: the magic
    ``CTLC``, version 1 and the curve count, then each curve's length and
    its t, y and yerr as little-endian float64."""
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Iq", 1, len(ts)))
        for t, y, e in zip(ts, ys, yerrs):
            t, y, e = (np.ascontiguousarray(a, dtype="<f8") for a in (t, y, e))
            if not (len(t) == len(y) == len(e)):
                raise ValueError("dimension mismatch")
            f.write(struct.pack("<q", len(t)))
            f.write(t.tobytes())
            f.write(y.tobytes())
            f.write(e.tobytes())


def load_lcb(path, batch=True, nmax=None):
    """Read a .lcb container; returns a LightCurveBatch (or, with
    ``batch=False``, ragged lists of t, y and yerr viewing the memory
    map)."""
    buf = np.memmap(path, dtype=np.uint8, mode="r")
    if bytes(buf[:4]) != _MAGIC:
        raise ValueError("not an lcb file")
    version, n = struct.unpack("<Iq", bytes(buf[4:16]))
    if version != 1:
        raise ValueError("unsupported lcb version")
    out = ([], [], [])
    off = 16
    for _ in range(n):
        (length,) = struct.unpack("<q", bytes(buf[off:off + 8]))
        off += 8
        for col in out:
            col.append(np.frombuffer(buf, dtype="<f8", count=length,
                                     offset=off))
            off += 8 * length
    if not batch:
        return out
    return LightCurveBatch.from_ragged(*out, nmax=nmax)


def _coefficients(kernel, params, dtype):
    from .ops.lower import Coefficients

    return Coefficients(
        *[c.to(dtype) for c in kernel.get_padded_coefficients(params)],
        jitter=kernel.get_jitter(params).to(dtype))


def batched_gp_log_likelihood(kernel, params, batch, dtype=None,
                              device=None):
    """Masked GP log-likelihood of every curve of a LightCurveBatch.

    ``params``: (dim,) shared kernel parameters.  Returns ``(lls, oks)``
    of shape (B,).  Padded samples are made exactly inert (U = V = 0, A =
    1, resid = 0; ``ops.seq.gp_log_likelihood_masked``); one loop over the
    Nmax steps serves every curve.  Differentiable with autograd.
    ``device`` defaults to ``cuda`` (raising without CUDA), ``dtype`` to
    float64.
    """
    from .ops import seq
    from .ops.lanes4 import resolve_device
    from .ops.lower import lower

    dev = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    params = torch.as_tensor(params).to(device=dev, dtype=dtype)
    tb, yb, eb = (torch.as_tensor(np.asarray(x, np.float64), device=dev)
                  .to(dtype) for x in (batch.t, batch.y, batch.yerr))
    mb = torch.as_tensor(np.asarray(batch.mask), device=dev)
    ncur, nmax = tb.shape
    dt = torch.cat([tb.new_zeros(ncur, 1), torch.diff(tb, dim=1)], dim=1)
    ssm = lower(_coefficients(kernel, params, dtype), tb.reshape(-1),
                (eb**2).reshape(-1), dt=dt.reshape(-1))
    ssm = type(ssm)(*(x.reshape(ncur, nmax, *x.shape[1:]) for x in ssm))
    return seq.gp_log_likelihood_masked(
        ssm, yb, mb, torch.as_tensor(np.asarray(batch.lengths), device=dev))


def make_fleet_loglik(kernel, batch: LightCurveBatch, dtype=None, n_chain=1,
                      device=None):
    """Build ``params -> (lls, oks)`` over a fleet.

    On the card (the default ``device``; raising without CUDA) every curve
    occupies one lane of the fused4 kernels (``make_plan4_curves``, one
    state segment a lane), so the whole fleet's likelihoods come from one
    launch of each kernel: the fused primal for a value, the four gradient
    kernels when autograd needs the gradient (the JAX package's TPU
    branch, celerite_tpu/data.py:262-294).  ``n_chain = 1`` returns the
    per-curve ``(lls, oks)`` of shared ``(dim,)`` parameters.

    ``n_chain > 1`` (a power of two) tiles the fleet per parameter set:
    the closure takes ``(n_chain, dim)`` parameters and returns each
    chain's fleet-summed ``(ll, ok)``, the population-fit / SMC-particle
    path (BASELINE configs[4]).

    On the CPU (``device="cpu"``) ``n_chain = 1`` takes
    :func:`batched_gp_log_likelihood` and ``n_chain > 1`` the kernels'
    plain versions on the fleet plan (the JAX package's off-TPU branches).
    The closure is differentiable with autograd; ``dtype`` defaults to
    float64.
    """
    from .ops import fused4, lanes4

    dev = lanes4.resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    if dev.type == "cpu" and n_chain == 1:
        def fallback(params):
            return batched_gp_log_likelihood(kernel, params, batch,
                                             dtype=dtype, device=dev)

        fallback.plan = None
        return fallback

    jr, jc = kernel.padded_size
    plan = lanes4.make_plan4_curves(
        batch.t, batch.y, np.asarray(batch.yerr, np.float64) ** 2,
        batch.lengths, n_chain=n_chain, dtype=dtype, device=dev)
    n_seg = n_chain if n_chain > 1 else plan.num_blocks
    grad_fn = fused4.build_ll_and_grad(plan, jr, jc, n_chain=n_chain,
                                       n_seg=n_seg, state_seg=1)
    ncur = len(batch)

    def cf_of(params):
        return lanes4.pack_cf(_coefficients(kernel, params, dtype),
                              dtype=dtype)

    def loglik(params):
        params = torch.as_tensor(params).to(device=dev, dtype=dtype)
        cf = torch.func.vmap(cf_of)(params) if n_chain > 1 else cf_of(params)
        if torch.is_grad_enabled() and cf.requires_grad:
            lls, oks = grad_fn(cf, plan.y)
        else:
            lls, oks = fused4.run_primal(cf, plan, jr, jc, n_seg=n_seg,
                                         state_seg=1)
        if n_chain > 1:
            return lls, oks
        return lls[:ncur], oks[:ncur]

    loglik.plan = plan
    return loglik


def curve_rows(batch, dtype=None, device=None):
    """One curve a row, as :func:`make_curve_logprob` takes them: a dict of
    ``t``, ``y``, ``diag`` (yerr^2), ``mask`` ``(B, Nmax)`` and ``n``
    ``(B,)`` tensors (benchmarks/fleet.py:113-119).  ``device`` defaults to
    ``cuda`` (raising without CUDA), ``dtype`` to float64."""
    from .ops.lanes4 import resolve_device

    dev = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype

    def tensor(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev).to(dtype)

    return {"t": tensor(batch.t), "y": tensor(batch.y),
            "diag": tensor(np.asarray(batch.yerr, np.float64) ** 2),
            "mask": tensor(batch.mask), "n": tensor(batch.lengths)}


def make_curve_logprob(kernel, log_prior=None):
    """``(data, theta) -> log prob`` of one light curve with its own
    parameters, for ``inference.sample_nuts_batch`` over a fleet.

    ``data`` is one row of :func:`curve_rows`; the value is the masked
    sequential likelihood plus ``log_prior(theta)`` (0 without one), -inf
    where not finite (benchmarks/fleet.py:122-141).  Its
    ``value_and_grad_batch(data_rows, thetas)`` computes every row in one
    call of the fused4 gradient pipeline on a fleet plan of the rows, one
    lane and one coefficient row a curve (``state_seg = 1``): the kernels
    on the card, their plain versions on the CPU.  The plan is built once
    for a ``data_rows`` object and reused while the sampler passes it.
    """
    from .ops import fused4, lanes4, seq
    from .ops.lower import lower

    jr, jc = kernel.padded_size

    def prior(theta):
        if log_prior is None:
            return theta.new_zeros(())
        return log_prior(theta)

    def logprob(data, theta):
        ssm = lower(_coefficients(kernel, theta, theta.dtype), data["t"],
                    data["diag"])
        ll, ok = seq.gp_log_likelihood_masked(
            ssm, data["y"] * data["mask"], data["mask"], data["n"])
        total = prior(theta) + torch.where(ok, ll, -torch.inf)
        return torch.where(torch.isfinite(total), total, -torch.inf)

    cache = {}

    def value_and_grad_batch(data_rows, thetas):
        if cache.get("rows") is not data_rows:
            host = {k: v.detach().cpu().numpy() for k, v in data_rows.items()}
            plan = lanes4.make_plan4_curves(
                host["t"], host["y"], host["diag"],
                host["n"].astype(np.int64), dtype=data_rows["t"].dtype,
                device=data_rows["t"].device)
            lanes = plan.num_blocks
            cache.update(rows=data_rows, lanes=lanes, fn=fused4.
                         build_ll_and_grad(plan, jr, jc, n_chain=lanes,
                                           n_seg=lanes, state_seg=1))
        rows, lanes = thetas.shape[0], cache["lanes"]
        th = torch.cat([thetas, thetas[:1].expand(lanes - rows, -1)])
        th = th.detach().requires_grad_()
        with torch.enable_grad():
            cf = torch.func.vmap(lambda p: lanes4.pack_cf(
                _coefficients(kernel, p, th.dtype), dtype=th.dtype))(th)
            ll, ok = cache["fn"](cf)
            lp = torch.func.vmap(prior)(th) + torch.where(ok, ll, -torch.inf)
            good = torch.isfinite(lp)
            (grad,) = torch.autograd.grad(torch.where(good, lp, 0.0).sum(),
                                          th)
        lp = torch.where(good, lp.detach(), -torch.inf)
        return lp[:rows], torch.where(good[:, None], grad, 0.0)[:rows]

    logprob.value_and_grad_batch = value_and_grad_batch
    return logprob
