"""Lane plan: the static per-dataset streams of the fused primal kernel.

Port of ``celerite_tpu/ops/lanes4.py:46-274``.  The N points are
cut into B contiguous chunks, one per virtual lane; lane ``l`` owns
points ``[l*L, (l+1)*L)`` and every stream is stored ``(L, B)``, so step
``i`` of lane ``l`` lies at ``i*B + l``: neighbouring CUDA threads read
neighbouring addresses.  This is the JAX package's ``(L, 8, W)`` layout
(lane ``l = r*W + c``) with the TPU's sublane split flattened; the memory
order is the same.

The streams (time grid with its double-single lo part, exact spacings,
per-point variance, data, mask) are built on the host in float64 once per
dataset; the kernel lowers the coefficients per step from them.  A fleet
plan (:func:`make_plan4_curves`) gives each light curve a lane of its own.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .lower import Coefficients

__all__ = ["Plan4", "make_plan4", "make_plan4_curves", "fold_lanes",
           "pack_cf", "cf_len",
           "default_num_blocks4", "default_grad_blocks4", "resolve_device"]

# Lane counts on an H100 from the sweeps of chip_smoke.py (PERF.md): the
# kernel is fastest at 32768 lanes for N = 1e6 (P = 2) and at 16-50 steps a
# lane for N = 1e5 (P = 8); the float32 result is at its floor at every
# lane count down to 16 steps a lane.
_CUDA_LANES = 32768
_MIN_STEPS = 16
# Lanes per chain of the gradient path: the float64 torch glue between
# the gradient kernels runs log2(lanes per chain) rounds of ~10 launches
# each, so the gradient wants fewer, longer lanes than the value path.
# In chip_smoke.py's gradient sweeps 512 was fastest for one chain and for
# 16 folded chains at N = 1e5 (P = 8); at N = 1e6 (P = 2) the fastest
# count moved between 512 and 8192 from run to run (PERF.md).
_GRAD_LANES = 512


class Plan4(NamedTuple):
    """Static per-dataset streams, each shaped ``(L, B)``."""

    t: torch.Tensor      # time grid (hi part in float32)
    t_lo: torch.Tensor   # double-single lo part of the f64 grid
    dt: torch.Tensor     # exact spacings; 0 at the global start and on pad
    diag: torch.Tensor   # per-point variance (yerr^2), 0 on pad
    y: torch.Tensor      # data, 0 on pad
    mask: torch.Tensor   # 1.0 on real rows, 0.0 on pad
    n: int               # unpadded point count (per segment: a tensor)
    num_blocks: int      # B virtual lanes (all chains together)


def resolve_device(device):
    """``torch.device`` for a public entry point: ``None`` means ``cuda``.

    Raises when CUDA is asked for (or defaulted to) and no device is
    present: the port never falls back to the CPU silently.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "celerite_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run on the CPU"
        )
    return dev


def default_num_blocks4(n, device):
    """Virtual-lane count B (a power of two) for ``n`` points.

    On the card: up to the measured ``_CUDA_LANES``, keeping at least
    ``_MIN_STEPS`` steps a lane.  On the CPU (the plain version): about
    sqrt(n) lanes, which balances the Python loop over the L steps against
    the log2(B) prefix rounds.
    """
    if torch.device(device).type == "cuda":
        b = 8
        while b * 2 * _MIN_STEPS <= n and b < _CUDA_LANES:
            b *= 2
        return b
    b = 8
    while b * b < n and b < 1024:
        b *= 2
    return b


def default_grad_blocks4(n, device):
    """Lanes per chain of the gradient path's (chain-folded) plan.

    On the card the value path's count capped at ``_GRAD_LANES``; on the
    CPU the value path's count.
    """
    b = default_num_blocks4(n, device)
    if torch.device(device).type == "cuda":
        b = min(b, _GRAD_LANES)
    return b


def _lanes(x64, b, L):
    """(B*L,) host array -> (L, B) with lane l owning [l*L, (l+1)*L)."""
    return np.ascontiguousarray(np.asarray(x64).reshape(b, L).T)


def make_plan4(t, y, diag, num_blocks, dtype=torch.float32, n_chain=1,
               device=None) -> Plan4:
    """Host-side plan construction from float64 inputs.

    Every lane's first row keeps its true spacing (lanes are seeded by the
    cross-lane prefix, not by resetting the recursion); only the global
    first point and pad rows get dt = 0.

    ``n_chain > 1`` builds a chain-folded plan: the dataset's
    ``num_blocks``-lane layout is tiled ``n_chain`` times along the lane
    axis, so one launch evaluates ``n_chain`` models of the same data; the
    cross-lane prefixes are segmented at chain boundaries.

    ``device`` defaults to ``cuda`` (raising without CUDA); the tests pass
    ``device="cpu"``.
    """
    b = int(num_blocks)
    nc = int(n_chain)
    if b & (b - 1) or b < 8:
        raise ValueError("num_blocks must be a power of two >= 8")
    if nc & (nc - 1) or nc < 1:
        raise ValueError("n_chain must be a power of two")
    device = resolve_device(device)
    t = np.asarray(t, np.float64)
    y = np.asarray(y, np.float64)
    diag = np.broadcast_to(np.asarray(diag, np.float64), t.shape)
    n = t.shape[0]
    L = -(-n // b)
    pad = b * L - n

    def padded(x, fill):
        base = np.concatenate([x, np.full(pad, fill, np.float64)])
        return np.tile(base, nc) if nc > 1 else base

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    t_pad = padded(t, t[-1] if n else 0.0)
    t_hi = np.asarray(t_pad, np_dtype)
    t_lo = np.asarray(t_pad - np.asarray(t_hi, np.float64), np_dtype)
    streams = dict(
        t=t_hi,
        t_lo=t_lo,
        dt=padded(np.concatenate([[0.0], np.diff(t)]), 0.0),
        diag=padded(diag, 0.0),
        y=padded(y, 0.0),
        mask=padded(np.ones(n), 0.0),
    )
    bt = b * nc
    return Plan4(
        **{
            k: torch.as_tensor(
                _lanes(np.asarray(v, np_dtype), bt, L), device=device
            )
            for k, v in streams.items()
        },
        n=n,
        num_blocks=bt,
    )


def make_plan4_curves(t, y, diag, lengths, n_chain=1, dtype=torch.float32,
                      device=None) -> Plan4:
    """Fleet folding: one virtual lane per light curve.

    Port of ``celerite_tpu/ops/lanes4.py:167-250`` in this package's
    ``(L, B)`` layout.  ``t, y, diag``: ``(n_curves, Lmax)`` padded
    per-curve arrays (pad tail arbitrary); ``lengths``: ``(n_curves,)``
    valid counts.  Lane ``l`` is curve row ``l`` with ``Lmax`` steps, and
    every lane is its own state segment (``state_seg = 1`` in
    ``fused4.run_primal`` / ``build_ll_and_grad``): a whole fleet's
    likelihoods come from one launch of each kernel, ragged tails under
    the mask.

    The lane count is padded so that ``lanes * n_chain`` is a multiple of
    8, as the JAX package pads to full sublane tiles; padded lanes are all
    mask (``ll = 0``).  ``n_chain > 1`` (a power of two) tiles the fleet
    per chain: lanes ``[c lanes, (c + 1) lanes)`` are chain ``c``'s copy,
    and with an ``(n_chain, C)`` coefficient batch and ``n_seg = n_chain``
    the kernels return each chain's fleet sum.

    ``Plan4.n`` is an int64 tensor of the per-segment point counts: per
    lane for ``n_chain == 1``, each chain's total otherwise.  ``device``
    defaults to ``cuda`` (raising without CUDA).
    """
    t = np.asarray(t, np.float64)
    y = np.asarray(y, np.float64)
    diag = np.broadcast_to(np.asarray(diag, np.float64), t.shape)
    lengths = np.asarray(lengths, np.int64)
    ncur, lmax = t.shape
    nc = int(n_chain)
    if nc & (nc - 1) or nc < 1:
        raise ValueError("n_chain must be a power of two")
    device = resolve_device(device)

    lanes = ncur
    while (lanes * nc) % 8:
        lanes += 1
    pad_l = lanes - ncur

    mask = (np.arange(lmax)[None, :] < lengths[:, None]).astype(np.float64)
    dt = np.zeros_like(t)
    dt[:, 1:] = np.diff(t, axis=1)
    dt *= mask * np.concatenate([np.zeros((ncur, 1)), mask[:, :-1]], axis=1)

    def padlanes(x):
        return np.concatenate([x, np.zeros((pad_l, lmax))]) if pad_l else x

    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    t2 = padlanes(t * mask)
    t_hi = np.asarray(t2, np_dtype)
    streams = dict(
        t=t_hi,
        t_lo=np.asarray(t2 - np.asarray(t_hi, np.float64), np_dtype),
        dt=padlanes(dt),
        diag=padlanes(diag * mask),
        y=padlanes(y * mask),
        mask=padlanes(mask),
    )
    n_lane = np.concatenate([lengths, np.zeros(pad_l, np.int64)])
    n_seg = np.full(nc, int(lengths.sum()), np.int64) if nc > 1 else n_lane
    # One chain's (Lmax, lanes) streams go to the device, tiled there.
    return Plan4(
        **{k: torch.as_tensor(np.ascontiguousarray(
            np.asarray(v, np_dtype).T), device=device).repeat(1, nc)
           for k, v in streams.items()},
        n=torch.as_tensor(n_seg, device=device),
        num_blocks=lanes * nc,
    )


def fold_lanes(x, num_blocks, L):
    """``(n_chain, n)`` per-chain values -> the folded ``(L, n_chain * B)``.

    The torch counterpart of ``make_plan4(..., n_chain=nc)``'s host tiling
    (``celerite_tpu/ops/lanes4.py:147 fold_lanes``, in this package's
    layout): chain ``c`` occupies lanes ``[c B, (c + 1) B)``, lane ``l``
    owns points ``[l L, (l + 1) L)`` of its chain, and the pad tail is 0.
    Carries per-chain residuals (active mean parameters) into a folded
    launch; differentiable with autograd.
    """
    nc, n = x.shape
    b = int(num_blocks)
    x = torch.nn.functional.pad(x, (0, b * L - n))
    return x.reshape(nc * b, L).T


def cf_len(jr, jc):
    """Length of the packed coefficient vector for (jr, jc) term counts."""
    return 2 * jr + 4 * jc + 1


def pack_cf(coeffs: Coefficients, dtype=torch.float32):
    """Pack lowering coefficients into the kernel's flat vector.

    Layout: [a_real(jr), c_real(jr), a_c(jc), b_c(jc), c_c(jc), d_c(jc),
    total] with total = sum(a_real) + sum(a_comp) + jitter (the diagonal
    shift).  Differentiable with autograd.
    """
    a_real, c_real, a_comp, b_comp, c_comp, d_comp, jitter = coeffs
    total = (torch.sum(a_real) + torch.sum(a_comp) + jitter).reshape(1)
    parts = [a_real, c_real, a_comp, b_comp, c_comp, d_comp, total]
    return torch.cat([torch.as_tensor(p).reshape(-1) for p in parts]).to(dtype)
