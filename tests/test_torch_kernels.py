"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips without a CUDA device, since a CUDA
kernel has no CPU mode.  This file imports no JAX, so on a machine with a
card (and without JAX) it runs on its own:

    python -m pytest --noconftest tests/test_torch_kernels.py -q
"""

import math

import numpy as np
import pytest
import torch

from celerite_torch.ops import fused4, lanes4
from celerite_torch.testing import (CASES, blocked_streams,
                                    compare_adjoint_kernels,
                                    compare_fused_kernel,
                                    compare_grad_kernels,
                                    compare_solver_kernels,
                                    compare_tangent_kernels,
                                    lane_tangent_streams, make_data,
                                    pack_values, width_kernel)

# The float32 primal against its float32 plain version on the same plan
# (chip_smoke.F32_PLAIN_RTOL).
F32_PLAIN_RTOL = 2e-5
# The float32 gradient kernels against their float32 plain versions on the
# same plan: ten times the largest error chip_smoke.py measured (PERF.md).
GRAD_F32_RTOL = 4e-5
# The same for the adjoint kernels on chip_smoke.py's small plans.
ADJ_F32_RTOL = 7e-4
# The same for the three-pass kernels on chip_smoke.py's small plans.
SOLVER_F32_RTOL = 1.05e-3
# The same for the single-sweep kernel and the tangent kernels, per kernel
# (factor_jvp's dq0 at P = 13 read 1.26e-2, float32 plain itself 1.17e-2
# from float64 there).
FUSED_F32_RTOL = 9.4e-5
TANGENT_F32_RTOL = {"elements_jvp": 5.1e-4, "factor_jvp": 0.13,
                    "jac": 1.3e-3}


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _wide_case(jr, jc):
    """PSD coefficients for jr real and jc complex terms (a*c > b*d)."""
    a_r = [0.3 / (j + 1) for j in range(jr)]
    c_r = [0.5 + 0.3 * j for j in range(jr)]
    a_c = [0.5] * jc
    b_c = [0.1] * jc
    c_c = [0.6 + 0.2 * k for k in range(jc)]
    d_c = [1.0 + 0.5 * k for k in range(jc)]
    return (jr, jc, a_r + c_r + a_c + b_c + c_c + d_c)


# Every other padded width up to 12 (CASES covers P = 1, 2, 4, 8).
WIDE_CASES = [_wide_case(jr, jc) for jr, jc in
              [(3, 0), (1, 1), (1, 2), (0, 3), (3, 2), (1, 4), (5, 2), (2, 4),
               (3, 4), (0, 6)]]


def _plain_ll(cf, plan, jr, jc, n):
    quad, ld, _ = fused4.primal_reference(cf, plan, jr, jc)
    return -0.5 * (float(quad.sum() + ld.sum()) + n * math.log(2 * math.pi))


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,vals", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_primal_kernel_matches_plain(jr, jc, vals, dtype, cuda_device):
    """f64 kernel equals the f64 plain version to 1e-10.  The f32 kernel is
    within 2e-5 relative of the f32 plain version on the same plan, and
    within 1e-4 of the f64 one (the f32 input-quantization floor)."""
    t, y, yerr = make_data(4099, seed=7, t_max=400.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 256, dtype=dtype,
                             device=cuda_device)
    plan64 = lanes4.make_plan4(t, y, yerr**2, 256, dtype=torch.float64,
                               device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    before = fused4.primal_cuda.launches
    llk, okk = fused4.run_primal(cf, plan, jr, jc)
    assert fused4.primal_cuda.launches == before + 1
    assert bool(okk)
    ref64 = _plain_ll(cf, plan64, jr, jc, len(t))
    if dtype == torch.float64:
        np.testing.assert_allclose(float(llk), ref64, rtol=1e-10)
    else:
        np.testing.assert_allclose(
            float(llk), _plain_ll(cf.float(), plan, jr, jc, len(t)), rtol=2e-5)
        np.testing.assert_allclose(float(llk), ref64, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,vals", WIDE_CASES)
def test_primal_kernel_every_width(jr, jc, vals, cuda_device):
    """Each padded width builds and matches the plain version in f64."""
    t, y, yerr = make_data(2053, seed=5, t_max=200.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=torch.float64,
                             device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    llk, okk = fused4.run_primal(cf, plan, jr, jc)
    assert bool(okk)
    np.testing.assert_allclose(float(llk), _plain_ll(cf, plan, jr, jc, len(t)),
                               rtol=1e-10)


@pytest.mark.cuda
def test_primal_kernel_chain_folded(cuda_device):
    jr, jc, vals = CASES[3]
    t, y, yerr = make_data(4099, seed=8, t_max=400.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=torch.float64,
                             n_chain=4, device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    # Scaling every entry (amplitudes, rates and the diagonal total) keeps
    # each chain's kernel positive definite.
    cfs = torch.stack([cf * s for s in (1.0, 0.9, 1.1, 1.2)])
    llk, okk = fused4.run_primal(cfs, plan, jr, jc)
    llp, okp = fused4.run_primal(cfs.cpu(), lanes4.Plan4(
        *[x.cpu() for x in plan[:6]], plan.n, plan.num_blocks), jr, jc)
    assert bool(okk.all()) and bool(okp.all())
    np.testing.assert_allclose(llk.cpu().numpy(), llp.numpy(), rtol=1e-10)


# The primal's width cases: P = 1, 2, 4, 8 and 12.
PRIMAL_WIDTH_CASES = {1: CASES[0], 2: CASES[1], 4: CASES[2], 8: CASES[3],
                      12: _wide_case(0, 6)}


def _primal_plan(lanes, steps, dtype, device, keep=None, seed=4, n=None,
                 t_max=None):
    """A plan of ``lanes`` lanes of ``steps`` points each, or of ``n``
    points with a padded tail (a power of two of lanes; ``keep`` of them
    kept, the rest cut off the end)."""
    n = n or lanes * steps
    t, y, yerr = make_data(n, seed=seed, t_max=t_max or n / 10.0)
    plan = lanes4.make_plan4(t, y, yerr**2, lanes, dtype=dtype, device=device)
    if keep is None:
        return plan
    return lanes4.Plan4(*[x[:, :keep].contiguous() for x in plan[:6]],
                        plan.n, keep)


def _assert_lanes_close(got, want, rtol):
    """Per-lane outputs against the plain version's, each within ``rtol``
    of its largest value; NaN and infinity where it has them."""
    for g, w in zip(got, want):
        g, w = g.double().cpu().numpy(), w.double().cpu().numpy()
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin & ~np.isnan(w)],
                                      w[~fin & ~np.isnan(w)])
        if fin.any():
            top = float(np.abs(w[fin]).max())
            np.testing.assert_allclose(g[fin], w[fin], rtol=0,
                                       atol=rtol * top)


@pytest.mark.cuda
@pytest.mark.parametrize("width,lanes,keep,seg,steps", [
    (4, 64, None, 16, None),
    # segments inside a scan block, straddling its blocks (24 lanes), and
    # over many blocks (every lane one segment), on lanes of 2 and 1 steps
    *[(p, 4096, None, 8, 2) for p in (1, 2, 8, 12)],
    *[(p, 4096, 4080, 24, 2) for p in (1, 2, 8, 12)],
    *[(p, 4096, None, 4096, 1) for p in (1, 2, 8, 12)]])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_primal_kernel_segments_one_cf_row(width, lanes, keep, seg, steps,
                                           dtype, cuda_device):
    """One coefficient row over segments of ``seg`` lanes: no state crosses
    them, and each lane's quad, ld and mind equal the plain version's, to
    1e-10 in float64 and within F32_PLAIN_RTOL of each output's largest
    value in float32, where the segments lie inside one of the prefix
    scan's blocks, straddle them, and span many."""
    jr, jc, vals = PRIMAL_WIDTH_CASES[width]
    # steps None: N = 2053 on 64 lanes, a padded tail.
    plan = _primal_plan(lanes, steps, dtype, cuda_device, keep,
                        n=None if steps else 2053,
                        t_max=None if steps else 200.0)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device,
                         dtype=dtype)
    before = fused4.primal_cuda.launches
    got = fused4.primal_cuda(cf, plan, jr, jc, seg=seg)
    assert fused4.primal_cuda.launches == before + 1
    want = fused4.primal_reference(cf, plan, jr, jc, seg=seg)
    if dtype == torch.float32:
        _assert_lanes_close(got, want, F32_PLAIN_RTOL)
        return
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8])
@pytest.mark.parametrize("shape", ["one_step", "two_steps", "dead_lane",
                                   "four_warps"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_primal_kernel_shapes(width, shape, dtype, cuda_device):
    """The primal's sweeps on the shapes their ring and their blocks meet:
    lanes of one and two steps (fewer than the three the ring copies
    ahead); ``dead_lane``: a last one-warp block of 32 / G lanes but one;
    ``four_warps``: enough lanes (three past 128 / G a block on every SM)
    for four-warp blocks, whose last holds dead lanes.  Each lane's quad,
    ld and mind against the plain version's, one segment."""
    jr, jc, vals = PRIMAL_WIDTH_CASES[width]
    g = 1 << (width - 1).bit_length()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    keep = {"one_step": None, "two_steps": None,
            "dead_lane": 4 * 32 // g - 1,
            "four_warps": sms * 128 // g + 3}[shape]
    lanes = 512 if keep is None else 1 << (keep - 1).bit_length()
    steps = {"one_step": 1, "two_steps": 2}.get(shape, 4)
    plan = _primal_plan(lanes, steps, dtype, cuda_device, keep)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device,
                         dtype=dtype)
    got = fused4.primal_cuda(cf, plan, jr, jc)
    want = fused4.primal_reference(cf, plan, jr, jc)
    _assert_lanes_close(got, want, 1e-10 if dtype == torch.float64
                        else F32_PLAIN_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_primal_kernel_bad_pivots(width, dtype, cuda_device):
    """A zero pivot (lane 64's first step, which heads segment 1: a = 0)
    and a NaN pivot (lane 140, step 3: a NaN variance) in two of four
    segments of 64 lanes: quad, ld and mind equal the plain version's, NaN
    where it has NaN, the clean segments within 1e-10 of its largest value
    in float64 and F32_PLAIN_RTOL in float32."""
    jr, jc, vals = PRIMAL_WIDTH_CASES[width]
    plan = _primal_plan(256, 8, dtype, cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device,
                         dtype=dtype)
    diag = plan.diag.clone()
    diag[0, 64] = -cf[-1]          # a = m (diag + total) + (1 - m) = 0
    diag[3, 140] = math.nan
    plan = plan._replace(diag=diag)
    got = fused4.primal_cuda(cf, plan, jr, jc, seg=64)
    want = fused4.primal_reference(cf, plan, jr, jc, seg=64)
    assert bool(torch.isnan(want[0][64:128]).all())
    assert bool(torch.isnan(want[0][140:192]).all())
    _assert_lanes_close(got, want, 1e-10 if dtype == torch.float64
                        else F32_PLAIN_RTOL)


@pytest.mark.cuda
def test_primal_kernel_non_pd(cuda_device):
    t, y, yerr = make_data(4099, seed=9, t_max=400.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 128, dtype=torch.float64,
                             device=cuda_device)
    cf = torch.as_tensor(pack_values(0, 1, [0.1, 3.0, 0.05, 2.0], jitter=0.0),
                         device=cuda_device)
    ll, ok = fused4.run_primal(cf, plan, 0, 1)
    assert not bool(ok) and float(ll) == -math.inf


@pytest.mark.cuda
def test_primal_kernel_backward_matches_grad_pipeline(cuda_device):
    """Autograd through the primal kernel goes through the gradient kernels
    and equals ``build_ll_and_grad``'s gradient in cf and y."""
    jr, jc, vals = CASES[2]
    t, y, yerr = make_data(2053, seed=1, t_max=200.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=torch.float64,
                             device=cuda_device)
    grads = []
    for fn in (fused4.build_ll(plan, jr, jc),
               fused4.build_ll_and_grad(plan, jr, jc)):
        cf = torch.tensor(pack_values(jr, jc, vals), device=cuda_device,
                          requires_grad=True)
        y4 = plan.y.clone().requires_grad_()
        before = fused4.factor_bwd_cuda.launches
        ll, ok = fn(cf, y4)
        ll.backward()
        assert bool(ok) and fused4.factor_bwd_cuda.launches == before + 1
        grads.append((cf.grad, y4.grad))
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(),
                                   rtol=1e-12, atol=1e-12 * float(b.abs().max()))


def _check_grad_kernels(cf, plan, jr, jc, rtol, seg=None):
    errs = compare_grad_kernels(cf, plan, jr, jc, seg=seg)
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"] > rtol}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,vals", CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernels_match_plain(jr, jc, vals, dtype, cuda_device):
    """Each of the four gradient kernels equals its plain version on the
    same inputs: 1e-10 in float64, GRAD_F32_RTOL in float32."""
    t, y, yerr = make_data(4099, seed=7, t_max=400.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 256, dtype=dtype,
                             device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    _check_grad_kernels(cf, plan, jr, jc,
                        1e-10 if dtype == torch.float64 else GRAD_F32_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,vals", WIDE_CASES)
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernels_every_width(jr, jc, vals, dtype, cuda_device):
    t, y, yerr = make_data(2053, seed=5, t_max=200.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=dtype,
                             device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    _check_grad_kernels(cf, plan, jr, jc,
                        1e-10 if dtype == torch.float64 else GRAD_F32_RTOL)


def _first_lanes(plan, b):
    """The first ``b`` lanes of ``plan`` as a plan of their own."""
    return plan._replace(num_blocks=b, **{
        k: getattr(plan, k)[:, :b].contiguous()
        for k in ("t", "t_lo", "dt", "diag", "y", "mask")})


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,vals", CASES + WIDE_CASES)
@pytest.mark.parametrize("shape", ["dead_lanes", "one_step", "two_steps"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernels_odd_shapes(jr, jc, vals, shape, dtype, cuda_device):
    """The gradient kernels at every padded width 1-12 on 12 lanes, which
    no block of factor_bwd's or elem_bwd's divides (128 / G lanes, G
    threads a lane: the last block runs dead lanes; the forward pair's
    one-warp blocks of 32 / G lanes leave dead lanes at P <= 4), and on 16
    lanes of one step and of two steps each, fewer steps than the forward
    pair's ring holds."""
    if shape == "dead_lanes":
        t, y, yerr = make_data(1499, seed=9, t_max=150.0)
        plan = _first_lanes(lanes4.make_plan4(
            t, y, yerr**2, 16, dtype=dtype, device=cuda_device), 12)
    else:
        steps = 1 if shape == "one_step" else 2
        t, y, yerr = make_data(16 * steps, seed=9, t_max=2.0 * steps)
        plan = lanes4.make_plan4(t, y, yerr**2, 16, dtype=dtype,
                                 device=cuda_device)
        assert plan.t.shape[0] == steps
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    _check_grad_kernels(cf, plan, jr, jc,
                        1e-10 if dtype == torch.float64 else GRAD_F32_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernels_chain_folded_and_segments(dtype, cuda_device):
    """A (4, C) batch on a folded plan, and one cf row over 16-lane
    segments: no state crosses a segment."""
    jr, jc, vals = CASES[3]
    rtol = 1e-10 if dtype == torch.float64 else GRAD_F32_RTOL
    t, y, yerr = make_data(4099, seed=8, t_max=400.0)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    folded = lanes4.make_plan4(t, y, yerr**2, 64, dtype=dtype, n_chain=4,
                               device=cuda_device)
    _check_grad_kernels(torch.stack([cf * s for s in (1.0, 0.9, 1.1, 1.2)]),
                        folded, jr, jc, rtol)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=dtype,
                             device=cuda_device)
    _check_grad_kernels(cf, plan, jr, jc, rtol, seg=16)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [512, 8192])
@pytest.mark.parametrize("cut", [0, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernels_block_widths(lanes, cut, dtype, cuda_device):
    """The forward pair's (elem_fwd's and factor_fwd's) two block widths
    at P = 8: 512 lanes (main path C's one-theta plan) take blocks of one
    warp, since blocks of four would leave most of an H100's 132 SMs
    without one, and 8192 lanes (its 16-chain plan) blocks of four; with
    ``cut`` lanes fewer the last block runs dead lanes.  Six steps a
    lane."""
    jr, jc, vals = CASES[3]
    n = 6 * lanes - 5
    t, y, yerr = make_data(n, seed=12, t_max=n / 10.0)
    plan = _first_lanes(lanes4.make_plan4(t, y, yerr**2, lanes, dtype=dtype,
                                          device=cuda_device), lanes - cut)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    _check_grad_kernels(cf, plan, jr, jc,
                        1e-10 if dtype == torch.float64 else GRAD_F32_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,seg", [(8160, 24), (510, 6)])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_grad_kernels_segments_inside_blocks(lanes, seg, dtype, cuda_device):
    """A coefficient row a segment, with segment boundaries inside the
    forward pair's blocks at P = 8: 24-lane segments over four-warp blocks
    of 16 lanes (8160 lanes), 6-lane segments over one-warp blocks of 4
    (510 lanes).  Each row scales config[2]'s coefficients by its own
    factor, so a lane that read its neighbour segment's row would show."""
    jr, jc, vals = CASES[3]
    full = 2 ** math.ceil(math.log2(lanes))
    n = 6 * full - 5
    t, y, yerr = make_data(n, seed=13, t_max=n / 10.0)
    plan = _first_lanes(lanes4.make_plan4(t, y, yerr**2, full, dtype=dtype,
                                          device=cuda_device), lanes)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    nseg = lanes // seg
    cfs = torch.stack([cf * (0.9 + 0.3 * i / nseg) for i in range(nseg)])
    _check_grad_kernels(cfs, plan, jr, jc,
                        1e-10 if dtype == torch.float64 else GRAD_F32_RTOL,
                        seg=seg)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [512, 8192])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_elem_bwd_on_elem_fwd_kernel_saves(lanes, dtype, cuda_device):
    """elem_bwd (the transpose) on the saves elem_fwd's kernel wrote, in
    both of elem_fwd's block widths, equals the plain pipeline: the plain
    transpose on the plain forward's saves, the coefficient cotangent
    summed over the lanes as the pipeline returns it."""
    from celerite_torch.testing import _errors

    jr, jc, vals = CASES[3]
    p = jr + 2 * jc
    n = 6 * lanes - 5
    t, y, yerr = make_data(n, seed=14, t_max=n / 10.0)
    plan = lanes4.make_plan4(t, y, yerr**2, lanes, dtype=dtype,
                             device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    cots = [torch.randn(p, p, lanes, generator=gen, dtype=torch.float64,
                        device=cuda_device) for _ in range(3)]
    saves = fused4.elem_fwd_cuda(cf, plan, jr, jc)[3]
    got = fused4.elem_bwd_cuda(cf, plan, jr, jc, saves, *cots)
    want = fused4.elem_bwd_reference(
        cf, plan, jr, jc, fused4.elem_fwd_reference(cf, plan, jr, jc)[3],
        *cots)
    _, rel = _errors(got, want, summed=True, seg=lanes)
    assert rel <= (1e-10 if dtype == torch.float64 else GRAD_F32_RTOL), rel


@pytest.mark.cuda
@pytest.mark.parametrize("jr,jc,vals", CASES)
@pytest.mark.parametrize("case", ["T1", "T4", "all", "value", "last",
                                  "folded", "narrow"])
def test_ds_kernels_match_plain(jr, jc, vals, case, cuda_device):
    """Both exact-mode kernels equal their plain versions on the same
    inputs, every output word (value and each tangent) to 1e-10.

    T1 / T4: one or four directions from coefficient 1 (clipped to the C
    coefficients); all: every direction in one launch (one block holds them
    all, T = 17 at P = 8); value: T = 0, the value warp alone; last: the
    last coefficient alone (toff = C - 1, the jitter).  The plan's lanes
    take 17 steps, two tiles of K = 8 steps and one step more.  folded:
    four chains with a coefficient row each (seg = 64 lanes), 65 steps a
    lane, every direction.  narrow: 8 lanes of 513 steps, every direction;
    at widths 1 and 2 a block holds 32 or 16 lanes, so most of its lanes
    lie past the plan's and are never written."""
    from celerite_torch.ops import dsfused
    from celerite_torch.testing import compare_ds_kernels, pack_values_ds

    t, y, yerr = make_data(4099, seed=7, t_max=400.0)
    cf = torch.as_tensor(pack_values_ds(vals), device=cuda_device)
    c = dsfused.cf_len(jr, jc)
    if case == "folded":
        plan = dsfused.make_plan_ds(t, y, yerr**2, 64, n_chain=4,
                                    device=cuda_device)
        cf = torch.stack([cf * s for s in (1.0, 0.9, 1.1, 1.2)])
    else:
        lanes = 8 if case == "narrow" else 256
        plan = dsfused.make_plan_ds(t, y, yerr**2, lanes, device=cuda_device)
    toff, T = {"T1": (1, 1), "T4": (1, min(4, c - 1)), "all": (0, None),
               "value": (0, 0), "last": (c - 1, 1),
               "folded": (0, None), "narrow": (0, None)}[case]
    errs = compare_ds_kernels(cf, plan, jr, jc, toff=toff, T=T)
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"] > 1e-10}
    assert not bad, bad


@pytest.mark.cuda
def test_grad_wrappers_reject_cpu_tensors(cuda_device):
    jr, jc, vals = CASES[0]
    t, y, yerr = make_data(256, seed=2)
    plan = lanes4.make_plan4(t, y, yerr**2, 16, dtype=torch.float64,
                             device="cpu")
    cf = torch.as_tensor(pack_values(jr, jc, vals))
    with pytest.raises(ValueError, match="CUDA"):
        fused4.elem_fwd_cuda(cf, plan, jr, jc)


@pytest.mark.cuda
def test_gp_gradient_entries_on_the_card(cuda_device):
    """The GP's gradient entries on the card (the gradient kernels) equal
    the same entries on the CPU (the plain versions), with an active mean:
    ``grad_log_likelihood`` and ``value_and_grad_batch`` over 3 rows."""
    from celerite_torch import GP, terms
    from celerite_torch.testing import config2_kernel

    t, y, yerr = make_data(3000, seed=9, t_max=300.0)
    out = {}
    for dev in ("cpu", "cuda"):
        gp = GP(config2_kernel(terms), mean=0.1, fit_mean=True, device=dev)
        gp.compute(t, yerr)
        ll, grad = gp.grad_log_likelihood(y)
        lp = gp.build_logprob(t, y, yerr=yerr, solver="fused", block_size=64)
        theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)
        rows = theta[None] + 0.01 * torch.arange(3, device=dev,
                                                 dtype=theta.dtype)[:, None]
        vals, grads = lp.value_and_grad_batch(rows)
        out[dev] = (ll, grad, vals.cpu().numpy(), grads.cpu().numpy())
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-8,
                                   atol=1e-8 * float(np.abs(b).max()))


def _wide_streams(width, dtype, device, n_chain=1, n=4099, lanes=64,
                  first=None):
    """Lane streams of a model of padded width 2, 5, 8, 13, 14 or 16
    (``width_kernel``) over ``lanes`` lanes a chain (``n`` points; by
    default N = 4099, 64 lanes), chain k's row 1.0, 0.98, 1.02, 1.04 (k mod
    4) times (1 + 0.005 (k // 4)) the parameters; with ``first`` only the
    first lanes."""
    from celerite_torch import terms
    from celerite_torch.ops import lanes as lanes_
    from celerite_torch.ops.lower import Coefficients

    t, y, yerr = make_data(n, seed=7, t_max=400.0 * n / 4099)
    plan = lanes_.make_plan(t, y, yerr**2, lanes, dtype=dtype,
                            n_chain=n_chain, device=device)
    kern = width_kernel(terms, width)
    th = torch.as_tensor(kern.get_parameter_vector(), device=device)
    scale = [[1.0, 0.98, 1.02, 1.04][k % 4] * (1 + 0.005 * (k // 4))
             for k in range(n_chain)]
    rows = th * torch.tensor(scale, dtype=th.dtype, device=device)[:, None]
    coeffs = torch.func.vmap(lambda x: tuple(Coefficients(
        *kern.get_padded_coefficients(x), jitter=kern.get_jitter(x))))(rows)
    if n_chain == 1:
        coeffs = [c[0] for c in coeffs]
    streams = (*lanes_.lower_lanes(coeffs, plan), plan.y)
    if first is not None:
        streams = tuple(x[..., :first].contiguous() for x in streams)
    return streams


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 5, 8, 13, 14, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_chain", [1, 4, 16, 32])
def test_adjoint_kernels_match_plain(width, dtype, n_chain, cuda_device):
    """Each of the four adjoint kernels equals its plain version on the
    same streams, every output: 1e-10 in float64, ADJ_F32_RTOL in
    float32; one chain, and 4, 16 and 32 chains folded onto the lanes
    (64 lanes a chain: at P = 13-16 elements_fwd and factor_fwd take
    blocks of one warp up to 1024 lanes and of four at 2048 on an H100's
    132 SMs); groups of G = 2, 8 and 16 threads a lane."""
    streams = _wide_streams(width, dtype, cuda_device, n_chain)
    errs = compare_adjoint_kernels(*streams, seg=64)
    rtol = 1e-10 if dtype == torch.float64 else ADJ_F32_RTOL
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"] > rtol}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("width", [13, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", ["dead_lanes", "one_step", "short",
                                   "one_lane"])
def test_adjoint_kernels_odd_shapes(width, dtype, shape, cuda_device):
    """The adjoint kernels on lane counts that no backward or forward
    block divides (32 / G lanes a block: its last block runs dead lanes)
    and on lanes shorter than the kernels' rings of steps: 63 lanes of 65
    steps, 7 lanes of one step, 5 lanes of three steps, one lane of 17
    steps."""
    n, lanes, first = {"dead_lanes": (4099, 64, 63), "one_step": (8, 8, 7),
                       "short": (24, 8, 5), "one_lane": (17, 1, 1)}[shape]
    streams = _wide_streams(width, dtype, cuda_device, n=n, lanes=lanes,
                            first=first)
    errs = compare_adjoint_kernels(*streams, seg=first)
    rtol = 1e-10 if dtype == torch.float64 else ADJ_F32_RTOL
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"] > rtol}
    assert not bad, bad


@pytest.mark.cuda
def test_adjoint_route_on_the_card(cuda_device):
    """config[2] with three modes (P = 16) through the adjoint route on the
    card (the kernels) equals the same entries on the CPU (the plain
    versions), with an active mean: ``value_and_grad_batch`` over 3 rows
    and ``grad_log_likelihood``."""
    from celerite_torch import GP, terms
    from celerite_torch.ops import adjoint
    from celerite_torch.testing import config2_kernel

    t, y, yerr = make_data(3000, seed=9, t_max=300.0)
    out = {}
    for dev in ("cpu", "cuda"):
        gp = GP(config2_kernel(terms, modes=3), mean=0.1, fit_mean=True,
                device=dev)
        lp = gp.build_logprob(t, y, yerr=yerr, solver="fused", block_size=64)
        assert lp.loglik.route == "adjoint"
        theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)
        rows = theta[None] + 0.01 * torch.arange(3, device=dev,
                                                 dtype=theta.dtype)[:, None]
        before = adjoint.factor_bwd_cuda.launches
        vals, grads = lp.value_and_grad_batch(rows)
        launched = adjoint.factor_bwd_cuda.launches - before
        assert launched == (1 if dev == "cuda" else 0)
        gp.compute(t, yerr)
        ll, grad = gp.grad_log_likelihood(y)
        out[dev] = (ll, grad, vals.cpu().numpy(), grads.cpu().numpy())
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, rtol=1e-8,
                                   atol=1e-8 * float(np.abs(b).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8, 13, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solver_kernels_match_plain(width, dtype, cuda_device):
    """Each of the three pallas_solver kernels equals its plain version on
    the same streams, every output: 1e-10 in float64, SOLVER_F32_RTOL in
    float32.
    N = 1000 in blocks of 96 steps: 11 lanes (odd) and a padded tail."""
    from celerite_torch import terms

    t, y, yerr = make_data(1000, seed=1, t_max=50.0)
    streams = blocked_streams(width_kernel(terms, width), t, y, yerr, 96,
                              dtype=dtype, device=cuda_device)
    assert streams[0].shape[-1] == 11
    errs = compare_solver_kernels(*streams)
    rtol = 1e-10 if dtype == torch.float64 else SOLVER_F32_RTOL
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"] > rtol}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8, 13, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", ["one_step", "two_steps", "dead_lane",
                                   "four_warps"])
def test_solver_three_kernels_shapes(width, dtype, shape, cuda_device):
    """The three pallas_solver kernels, each a streamed sweep, on the shapes
    their ring and their blocks meet: lanes of one and two steps (fewer
    than the three the ring copies ahead), 37 lanes; ``dead_lane``: four
    one-warp blocks of 32 / G lanes but one, 96 steps; ``four_warps``:
    enough lanes (three past 128 / G a block on every SM) for the
    four-warp blocks, whose last block holds dead lanes, 4 steps.  Each
    kernel launches once; every output against its plain version: 1e-10
    in float64, SOLVER_F32_RTOL in float32."""
    from celerite_torch import terms
    from celerite_torch.ops import pallas_solver

    g = 1 << (width - 1).bit_length()   # threads a lane
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    steps, lanes = {"one_step": (1, 37), "two_steps": (2, 37),
                    "dead_lane": (96, 4 * 32 // g - 1),
                    "four_warps": (4, sms * 128 // g + 3)}[shape]
    n = steps * lanes
    t, y, yerr = make_data(n, seed=5, t_max=n / 20.0)
    streams = blocked_streams(width_kernel(terms, width), t, y, yerr, steps,
                              dtype=dtype, device=cuda_device)
    assert streams[0].shape == (steps, width, lanes)
    wrappers = [getattr(pallas_solver, k + "_cuda")
                for k in pallas_solver.SOLVER_KERNELS]
    before = [f.launches for f in wrappers]
    errs = compare_solver_kernels(*streams)
    assert [f.launches - n for f, n in zip(wrappers, before)] == [1, 1, 1]
    rtol = 1e-10 if dtype == torch.float64 else SOLVER_F32_RTOL
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"] > rtol}
    assert not bad, bad


@pytest.mark.cuda
def test_solver_subst_kernel_keeps_compensation(cuda_device):
    """800 float32 steps of positive terms (u = 0, phi = 1, w = 0): the
    kernel's Kahan sums stay within two float32 ulps of the float64 sums
    of the same float32 terms, and equal the plain version's."""
    from celerite_torch.ops import pallas_solver

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    steps, p, b = 800, 16, 37
    y = torch.randn(steps, 1, b, generator=gen, device=cuda_device)
    d = 1.5 + 7.5 * torch.rand(steps, 1, b, generator=gen,
                               device=cuda_device)
    zero = torch.zeros(steps, p, b, device=cuda_device)
    args = (torch.zeros(p, b, device=cuda_device), zero,
            torch.ones_like(zero), zero, y, d)
    quad, logdet, mind = pallas_solver.subst_cuda(*args)
    want = pallas_solver.subst_reference(*args)
    eps = torch.finfo(torch.float32).eps
    sums = ((y * y / d).double().sum(0)[0], torch.log(d).double().sum(0)[0])
    for got, ref in zip((quad, logdet), sums):
        assert float(((got - ref) / ref).abs().max()) <= 2 * eps
    for got, ref in zip((quad, logdet, mind), want):
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=2 * eps)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_solver_subst_kernel_bad_pivots(width, dtype, cuda_device):
    """subst on pivots that are not positive, as a non-PD model gives: lane
    3 has a zero pivot at step 5 and a NaN at step 9, lane 6 a zero pivot
    at its last step.  quad, logdet and mind equal the plain version's,
    NaN and infinity where it has them, the other lanes within 1e-10 in
    float64 and SOLVER_F32_RTOL in float32 of its largest finite value."""
    from celerite_torch import terms
    from celerite_torch.ops import pallas_solver as ps

    t, y, yerr = make_data(1000, seed=3, t_max=50.0)
    u, v, ph, a, yy = blocked_streams(width_kernel(terms, width), t, y, yerr,
                                      96, dtype=dtype, device=cuda_device)
    b = u.shape[-1]
    sh0 = fused4.prefix_sh0(*ps.elements_reference(u, v, ph, a), b)
    d, w, M, m = ps.factor_reference(sh0, u, v, ph, a, yy)
    h0 = fused4.prefix_h0(M, m, b)
    d = d.clone()
    d[5, 0, 3] = 0.0
    d[9, 0, 3] = math.nan
    d[-1, 0, 6] = 0.0
    got = ps.subst_cuda(h0, u, ph, w, yy, d)
    want = ps.subst_reference(h0, u, ph, w, yy, d)
    rtol = 1e-10 if dtype == torch.float64 else SOLVER_F32_RTOL
    assert bool(torch.isnan(got[2][3])) and float(got[2][6]) == 0.0
    for g, x in zip(got, want):
        g, x = g.cpu().numpy(), x.cpu().numpy()
        top = float(np.abs(x[np.isfinite(x)]).max())
        np.testing.assert_allclose(g, x, rtol=0, atol=rtol * top)


@pytest.mark.cuda
def test_solver_routes_on_the_card(cuda_device):
    """The wide route's value closure (P = 16), ``solver="pallas"`` and
    ``"blocked"`` on the card equal the same closures on the CPU (the plain
    versions), value and autograd gradient, at N = 3000 with 64-point
    blocks; the value closure launches each kernel once a call."""
    from celerite_torch import GP, terms
    from celerite_torch.ops import pallas_solver

    t, y, yerr = make_data(3000, seed=9, t_max=300.0)
    out = {}
    for dev in ("cpu", "cuda"):
        gp = GP(width_kernel(terms, 16), mean=0.1, fit_mean=True, device=dev)
        theta = torch.tensor(gp.get_parameter_vector(), device=dev,
                             requires_grad=True)
        for solver in ("fused", "pallas", "blocked"):
            fn = gp.build_loglik(t, y, yerr=yerr, solver=solver,
                                 block_size=64)
            before = [getattr(pallas_solver, k + "_cuda").launches
                      for k in pallas_solver.SOLVER_KERNELS]
            ll, ok = fn(theta)
            after = [getattr(pallas_solver, k + "_cuda").launches
                     for k in pallas_solver.SOLVER_KERNELS]
            (grad,) = torch.autograd.grad(ll, theta)
            assert bool(ok)
            if solver == "fused" and dev == "cuda":
                assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
            out[dev, solver] = np.concatenate(
                [[float(ll.detach())], grad.cpu().numpy()])
    for solver in ("fused", "pallas", "blocked"):
        want = out["cpu", solver]
        np.testing.assert_allclose(out["cuda", solver], want, rtol=1e-8,
                                   atol=1e-8 * float(np.abs(want).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_matches_plain(width, dtype, cuda_device):
    """The single-sweep kernel equals its plain version on the same
    streams, quad, ld and mind: 1e-10 in float64, FUSED_F32_RTOL in
    float32.  N = 4099 in blocks of 96 steps (43 lanes, a padded tail),
    one segment; and 4 segments of 16 lanes of N = 2048 points."""
    from celerite_torch import terms
    from celerite_torch.ops import fused

    rtol = 1e-10 if dtype == torch.float64 else FUSED_F32_RTOL
    t, y, yerr = make_data(4099, seed=7, t_max=400.0)
    streams = blocked_streams(width_kernel(terms, width), t, y, yerr, 96,
                              dtype=dtype, device=cuda_device)
    before = fused.kernel_cuda.launches
    errs = compare_fused_kernel(*streams)["fused"]
    assert fused.kernel_cuda.launches == before + 1
    assert errs["max_rel_err"] <= rtol, errs
    t, y, yerr = make_data(2048, seed=8, t_max=200.0)
    streams = blocked_streams(width_kernel(terms, width), t, y, yerr, 32,
                              dtype=dtype, device=cuda_device)
    assert streams[0].shape[-1] == 64
    errs = compare_fused_kernel(*streams, seg=16)["fused"]
    assert errs["max_rel_err"] <= rtol, errs


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("lanes,seg", [(48, 1), (96, 6), (96, 24), (100, 25),
                                      (512, 32)])
def test_fused_kernel_segments(width, dtype, lanes, seg, cuda_device):
    """The single-sweep kernel's chunked scans (chunks of ceil(sqrt(seg /
    3)) lanes) on segments of 1 lane (a chunk each), 6 (three chunks of 2),
    24 (eight of 3), 25 (chunks of 3, the last of 1) and 32 lanes, 16
    chains: quad, ld and mind of each segment against the plain version's,
    1e-10 in float64 and FUSED_F32_RTOL in float32, on lanes of 16
    steps."""
    from celerite_torch import terms
    from celerite_torch.ops import fused

    t, y, yerr = make_data(lanes * 16, seed=3, t_max=lanes * 1.6)
    streams = blocked_streams(width_kernel(terms, width), t, y, yerr, 16,
                              dtype=dtype, device=cuda_device)
    assert streams[0].shape[-1] == lanes
    errs = compare_fused_kernel(*streams, seg=seg)["fused"]
    rtol = 1e-10 if dtype == torch.float64 else FUSED_F32_RTOL
    assert errs["max_rel_err"] <= rtol, errs


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("shape", ["one_step", "two_steps", "dead_lane",
                                   "four_warps"])
def test_fused_kernel_shapes(width, dtype, shape, cuda_device):
    """The single-sweep kernel's two streamed sweeps on the shapes their
    ring and their blocks meet, as the three-pass kernels' test: lanes of
    one and two steps, 37 lanes; ``dead_lane``: one-warp blocks of 32 / G
    lanes but one, 96 steps; ``four_warps``: three lanes past 128 / G a
    block on every SM, 4 steps.  One launch; quad, ld and mind against the
    plain version's, 1e-10 in float64 and FUSED_F32_RTOL in float32."""
    from celerite_torch import terms
    from celerite_torch.ops import fused

    g = 1 << (width - 1).bit_length()
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    steps, lanes = {"one_step": (1, 37), "two_steps": (2, 37),
                    "dead_lane": (96, 4 * 32 // g - 1),
                    "four_warps": (4, sms * 128 // g + 3)}[shape]
    n = steps * lanes
    t, y, yerr = make_data(n, seed=5, t_max=n / 20.0)
    streams = blocked_streams(width_kernel(terms, width), t, y, yerr, steps,
                              dtype=dtype, device=cuda_device)
    assert streams[0].shape == (steps, width, lanes)
    before = fused.kernel_cuda.launches
    errs = compare_fused_kernel(*streams)["fused"]
    assert fused.kernel_cuda.launches == before + 1
    rtol = 1e-10 if dtype == torch.float64 else FUSED_F32_RTOL
    assert errs["max_rel_err"] <= rtol, errs


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fused_kernel_bad_pivots(width, dtype, cuda_device):
    """A zero pivot (lane 24's first step, which heads segment 2: a = 0)
    and a NaN pivot (lane 41, step 5: a NaN) in two of four segments of 12
    lanes: quad, ld and mind equal the plain version's, NaN where it has
    NaN, the clean segments within 1e-10 of its largest value in float64
    and FUSED_F32_RTOL in float32."""
    from celerite_torch import terms
    from celerite_torch.ops import fused

    t, y, yerr = make_data(48 * 16, seed=2, t_max=80.0)
    u, v, ph, a, yy = blocked_streams(width_kernel(terms, width), t, y, yerr,
                                      16, dtype=dtype, device=cuda_device)
    a = a.clone()
    a[0, 0, 24] = 0.0
    a[5, 0, 41] = math.nan
    got = fused.kernel_cuda(u, v, ph, a, yy, 12)
    want = fused.kernel_reference(u, v, ph, a, yy, 12)
    assert bool(torch.isnan(want[0][2:]).all())
    assert bool(torch.isfinite(want[0][:2]).all())
    _assert_lanes_close(got, want, 1e-10 if dtype == torch.float64
                        else FUSED_F32_RTOL)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8, 13, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tangent_split_kernels_match_plain(width, dtype, cuda_device):
    """The split pair with tangents (elements and factor) equals its plain
    versions on the same streams and basis tangents, every output: 1e-10
    in float64, TANGENT_F32_RTOL in float32.  Two chains of N = 2000
    folded onto 2 x 16 lanes."""
    from celerite_torch import terms

    t, y, yerr = make_data(2000, seed=7, t_max=200.0)
    s, d = lane_tangent_streams(width_kernel(terms, width), t, y, yerr, 16,
                                n_chain=2, dtype=dtype, device=cuda_device)
    errs = compare_tangent_kernels(s, d, seg=16,
                                   kernels=("elements_jvp", "factor_jvp"))
    f64 = dtype == torch.float64
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"]
           > (1e-10 if f64 else TANGENT_F32_RTOL[k])}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 5, 8])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_tangent_jac_kernel_matches_plain(width, dtype, cuda_device):
    """The single-sweep kernel with tangents equals its plain version
    (the jvp of the single-sweep value) per segment: quad, ld, mind and
    the tangents of quad and ld, 1e-10 in float64, TANGENT_F32_RTOL in
    float32.  Two chains of N = 2000 folded onto 2 x 16 lanes."""
    from celerite_torch import terms
    from celerite_torch.ops import tangent

    t, y, yerr = make_data(2000, seed=7, t_max=200.0)
    s, d = lane_tangent_streams(width_kernel(terms, width), t, y, yerr, 16,
                                n_chain=2, dtype=dtype, device=cuda_device)
    before = tangent.jac_cuda.launches
    errs = compare_tangent_kernels(s, d, seg=16, kernels=("jac",))
    assert tangent.jac_cuda.launches == before + 1
    rtol = 1e-10 if dtype == torch.float64 else TANGENT_F32_RTOL["jac"]
    assert errs["jac"]["max_rel_err"] <= rtol, errs


def _jac_model(terms, width):
    """A model of padded width 1, 2, 4 or 8."""
    from celerite_torch.testing import bench_kernel, config2_kernel

    if width == 1:
        return terms.RealTerm(log_a=-0.5, log_c=-1.0)
    if width == 4:
        return bench_kernel(terms) + terms.ComplexTerm(
            log_a=-0.7, log_b=-2.0, log_c=-0.5, log_d=0.8)
    return bench_kernel(terms) if width == 2 else config2_kernel(terms)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2, 4, 8])
@pytest.mark.parametrize("ndir", [1, 7, 9, 13])
def test_tangent_jac_kernel_directions(width, ndir, cuda_device):
    """The jac kernel along ndir directions (random combinations of the
    parameters' basis tangents, numpy seed): one chunk of the block's
    directions (1, 7), two (9: five and four, 13: seven and six); 30 lanes
    in three segments of 10 (no block of 32 / G lanes divides them) of 125
    steps (no multiple of the 8-step tile), float64, against the plain
    version at 1e-10."""
    from celerite_torch import terms
    from celerite_torch.ops import tangent

    t, y, yerr = make_data(2000, seed=3, t_max=200.0)
    s, d = lane_tangent_streams(_jac_model(terms, width), t, y, yerr, 16,
                                n_chain=2, device=cuda_device)
    assert s[0].shape[0] % 8 != 0
    mix = torch.as_tensor(np.random.default_rng(ndir).standard_normal(
        (ndir, d[0].shape[1])), device=cuda_device)
    s = tuple(x[..., :30].contiguous() for x in s)
    d = tuple(torch.einsum("kt,ltpb->lkpb", mix, x[..., :30]).contiguous()
              for x in d)
    before = tangent.jac_cuda.launches
    errs = compare_tangent_kernels(s, d, seg=10, kernels=("jac",))
    assert tangent.jac_cuda.launches == before + 1
    assert errs["jac"]["max_rel_err"] <= 1e-10, errs


def _wide_jvp_model(terms, width):
    """A model of padded width 9 (a RealTerm and config[2]'s model), 13
    or 16."""
    from celerite_torch.testing import config2_kernel

    if width == 9:
        return terms.RealTerm(log_a=-0.5, log_c=-1.0) + config2_kernel(terms)
    return width_kernel(terms, width)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [9, 13, 16])
@pytest.mark.parametrize("ndir", [1, 7, 8, 13, 16])
@pytest.mark.parametrize("shape", ["dead_lanes", "one_step"])
@pytest.mark.parametrize("kernel", ["elements_jvp", "factor_jvp"])
def test_tangent_factor_kernel_directions(width, ndir, shape, kernel,
                                          cuda_device):
    """The split pair (elements_jvp, then factor_jvp on the plain
    elements' seeds), each on the jac sweeps' layout, along ndir
    directions (random combinations of the parameters' basis tangents,
    numpy seed) at padded widths 9-16, where a block holds 2 lanes and at
    most seven directions: one chunk (1, 7), a full one and one of one
    (8), two uneven ones (13: seven and six) and three (16: six, five and
    five).  ``dead_lanes``: 31 lanes of 63 steps (the last block holds a
    dead lane; no multiple of the 2-step tile); ``one_step``: 16 lanes of
    one step.  Every output and tangent (factor_jvp's dq0 and dld
    included), float64, against the plain version at 1e-10."""
    from celerite_torch import terms
    from celerite_torch.ops import tangent

    model = _wide_jvp_model(terms, width)
    n, lanes = (2000, 32) if shape == "dead_lanes" else (16, 16)
    t, y, yerr = make_data(n, seed=3, t_max=n / 10.0)
    s, d = lane_tangent_streams(model, t, y, yerr, lanes,
                                device=cuda_device)
    if shape == "dead_lanes":
        s = tuple(x[..., :31].contiguous() for x in s)
        d = tuple(x[..., :31].contiguous() for x in d)
    assert s[0].shape[0] == (63 if shape == "dead_lanes" else 1)
    assert s[0].shape[1] == width
    mix = torch.as_tensor(np.random.default_rng(ndir).standard_normal(
        (ndir, d[0].shape[1])), device=cuda_device)
    d = tuple(torch.einsum("kt,ltpb->lkpb", mix, x).contiguous() for x in d)
    wrapper = getattr(tangent, kernel + "_cuda")
    before = wrapper.launches
    errs = compare_tangent_kernels(s, d, seg=s[0].shape[-1],
                                   kernels=(kernel,))
    assert wrapper.launches == before + 1
    assert errs[kernel]["max_rel_err"] <= 1e-10, errs


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
def test_tangent_route_on_the_card(width, cuda_device):
    """``fast_grad="tangent"`` on the card (the kernels) equals the same
    entries on the CPU (the plain versions), with an active mean, at N =
    3000 on 64 lanes a chain: the value, its autograd gradient,
    ``value_and_grad_batch`` over 3 rows; ``compute`` factors on the card
    and the kernels of the width launched."""
    from celerite_torch import GP, terms
    from celerite_torch.ops import fused, pallas_solver, tangent

    t, y, yerr = make_data(3000, seed=9, t_max=300.0)
    out = {}
    for dev in ("cpu", "cuda"):
        gp = GP(width_kernel(terms, width), mean=0.1, fit_mean=True,
                device=dev)
        gp.compute(t, yerr)
        lp = gp.build_logprob(t, y, yerr=yerr, solver="fused",
                              block_size=64, fast_grad="tangent")
        assert lp.loglik.route == "tangent"
        theta = torch.tensor(gp.get_parameter_vector(), device=dev,
                             requires_grad=True)
        rows = theta.detach()[None] + 0.01 * torch.arange(
            3, device=dev, dtype=theta.dtype)[:, None]
        counts = [fused.kernel_cuda.launches, tangent.jac_cuda.launches,
                  tangent.elements_jvp_cuda.launches,
                  tangent.factor_jvp_cuda.launches,
                  pallas_solver.elements_cuda.launches]
        ll, ok = lp.loglik(theta)
        (grad,) = torch.autograd.grad(ll, theta)
        vals, grads = lp.value_and_grad_batch(rows)
        counts = [c1 - c0 for c0, c1 in zip(counts, [
            fused.kernel_cuda.launches, tangent.jac_cuda.launches,
            tangent.elements_jvp_cuda.launches,
            tangent.factor_jvp_cuda.launches,
            pallas_solver.elements_cuda.launches])]
        if dev == "cuda":
            assert counts == ([1, 2, 0, 0, 0] if width <= 8
                              else [0, 0, 2, 2, 1]), counts
        assert bool(ok)
        out[dev] = np.concatenate([[float(ll.detach())], grad.cpu().numpy(),
                                   vals.cpu().numpy(),
                                   grads.cpu().numpy().ravel()])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-8,
                               atol=1e-8 * float(np.abs(out["cpu"]).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 3, 5, 8, 13, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_onepass_kernels_match_plain(width, dtype, cuda_device):
    """Each of the three one-pass kernels equals its plain version on the
    same streams, every output: 1e-10 in float64; in float32 ten times the
    float32 plain version's own distance from float64 on these streams
    (the sweep is ill-conditioned in float32 by design).  N = 1000 in
    blocks of 96 steps: 11 lanes (odd) and a padded tail."""
    from celerite_torch import terms
    from celerite_torch.testing import (compare_onepass_kernels,
                                        onepass_f32_floor)

    t, y, yerr = make_data(1000, seed=1, t_max=50.0)
    kern = width_kernel(terms, width)
    streams = blocked_streams(kern, t, y, yerr, 96, dtype=dtype,
                              device=cuda_device)
    errs = compare_onepass_kernels(*streams)
    if dtype == torch.float64:
        limit = {k: 1e-10 for k in errs}
    else:
        floor = onepass_f32_floor(blocked_streams(
            kern, t, y, yerr, 96, device=cuda_device))
        limit = {k: 10 * f for k, f in floor.items()}
    bad = {k: (e["outputs"], limit[k]) for k, e in errs.items()
           if e["max_rel_err"] > limit[k]}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
@pytest.mark.parametrize("shape", [(13, 1), (1000, 3), (777, 96),
                                   (6500, 3)])
def test_onepass_kernels_odd_shapes(width, shape, cuda_device):
    """The one-pass kernels in float64, their transpose seeded by a random
    end-state cotangent hC, on blocks of 1 step (13 lanes), of 3 steps
    (334 lanes) and of 96 steps (9 lanes): lanes shorter than the sweeps'
    rings, and lane counts no block of them divides; and on 2167 lanes of
    3 steps, which the sweep and sweep_fwd take in four-warp blocks (16
    lanes a block at P = 8, 8 at P = 16; at least one a streaming
    multiprocessor) with a ragged last block."""
    from celerite_torch import terms
    from celerite_torch.testing import compare_onepass_kernels

    n, L = shape
    t, y, yerr = make_data(n, seed=3, t_max=n / 20.0)
    streams = blocked_streams(width_kernel(terms, width), t, y, yerr, L,
                              device=cuda_device)
    errs = compare_onepass_kernels(*streams)
    bad = {k: e["outputs"] for k, e in errs.items()
           if e["max_rel_err"] > 1e-10}
    assert not bad, bad


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 16])
def test_onepass_on_the_card(width, cuda_device):
    """``onepass.gp_log_likelihood`` on the card (rows 19-21) equals the
    same call on the CPU (the plain versions), value and autograd gradient
    with respect to the coefficients, at N = 3000 on 32 lanes; the value
    alone launches row 19 once, the gradient rows 20 and 21 once each."""
    from celerite_torch import terms
    from celerite_torch.ops import onepass
    from celerite_torch.ops.lower import Coefficients, lower

    t, y, yerr = make_data(3000, seed=9, t_max=300.0)
    kern = width_kernel(terms, width)
    out = {}
    for dev in ("cpu", "cuda"):
        th = torch.tensor(kern.get_parameter_vector(), device=dev,
                          requires_grad=True)
        ssm = lower(Coefficients(*kern.get_padded_coefficients(th),
                                 jitter=kern.get_jitter(th)),
                    torch.as_tensor(t, device=dev),
                    torch.as_tensor(yerr**2, device=dev))
        yt = torch.as_tensor(y, device=dev)
        counts = [getattr(onepass, k + "_cuda").launches
                  for k in onepass.ONEPASS_KERNELS]
        with torch.no_grad():
            value, _ = onepass.gp_log_likelihood(ssm, yt, 32)
        ll, ok = onepass.gp_log_likelihood(ssm, yt, 32)
        (grad,) = torch.autograd.grad(ll, th)
        launched = [getattr(onepass, k + "_cuda").launches - c
                    for k, c in zip(onepass.ONEPASS_KERNELS, counts)]
        assert bool(ok)
        assert launched == ([1, 1, 1] if dev == "cuda" else [0, 0, 0])
        out[dev] = np.concatenate([[float(value), float(ll.detach())],
                                   grad.cpu().numpy()])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-9,
                               atol=1e-9 * float(np.abs(out["cpu"]).max()))


@pytest.mark.cuda
@pytest.mark.parametrize("width", [2, 8, 16, 20])
def test_blocked_factor_on_the_card(width, cuda_device):
    """``blocked.factor`` on the card (the three-pass kernels' elements and
    factor at width 16 or less, the plain passes above) equals the plain
    factor on the CPU, D and W; and the GP facade's ``apply_inverse``,
    ``predict`` and ``sample`` on the card (``blocked``) equal the CPU's
    (the native core, or ``scan`` without g++)."""
    from celerite_torch import GP, terms
    from celerite_torch.ops import blocked, pallas_solver
    from celerite_torch.ops.lower import Coefficients, lower

    t, y, yerr = make_data(3000, seed=9, t_max=300.0)
    kern = width_kernel(terms, width)
    th = torch.as_tensor(kern.get_parameter_vector())
    coeffs = Coefficients(*kern.get_padded_coefficients(th),
                          jitter=kern.get_jitter(th))
    facts = {}
    for dev in ("cpu", "cuda"):
        ssm = lower(coeffs, torch.as_tensor(t, device=dev),
                    torch.as_tensor(yerr**2, device=dev))
        before = pallas_solver.factor_cuda.launches
        facts[dev] = blocked.factor(ssm, 64)
        launched = pallas_solver.factor_cuda.launches - before
        assert launched == (1 if dev == "cuda" and width <= 16 else 0)
    for got, want in zip(facts["cuda"][:2], facts["cpu"][:2]):
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-10,
                                   atol=1e-10 * float(want.abs().max()))
    x = np.linspace(-5.0, 305.0, 50)
    out = {}
    for dev in ("cpu", "cuda"):
        gp = GP(kern, device=dev)
        gp.compute(t, yerr)
        assert dev == "cpu" or gp.solver._route == "blocked"
        out[dev] = np.concatenate([gp.apply_inverse(y),
                                   gp.predict(y, x, return_cov=False),
                                   gp.sample(seed=3)])
    np.testing.assert_allclose(out["cuda"], out["cpu"], rtol=1e-10,
                               atol=1e-10 * float(np.abs(out["cpu"]).max()))


def _config2_logprob(dev, n=4096):
    """config[2] at N points on ``dev`` with the Gaussian prior, through
    ``build_logprob`` at the default route (the gradient kernels on the
    card)."""
    from celerite_torch import GP, terms
    from celerite_torch.testing import config2_kernel

    t, y, yerr = make_data(n, seed=9, t_max=400.0)
    gp = GP(config2_kernel(terms), device=dev)
    lp = gp.build_logprob(
        t, y, yerr=yerr,
        log_prior=lambda th: -0.5 * torch.sum((th / 3.0) ** 2))
    return lp, torch.as_tensor(gp.get_parameter_vector(), device=dev)


def _grad_launches():
    return [getattr(fused4, k + "_cuda").launches
            for k in fused4.GRAD_KERNELS]


@pytest.mark.cuda
def test_advi_and_laplace_on_the_card(cuda_device):
    """config[2] at N = 4096 on the card: an ADVI step's closed-form
    gradient on fixed draws equals the CPU route's (plain versions) within
    1e-8; the Laplace Hessian's folded call (2 dim rows, one batched call)
    equals central differences of 2 dim one-theta ``value_and_grad`` calls
    within 1e-8 relative; ``fit_advi`` and ``laplace_fit`` run 20 steps
    to finite results and a symmetric positive-definite covariance, every
    step launching the four gradient kernels: an ADVI step is one batched
    call of its 8 draws, the Laplace Hessian one of 2 dim rows."""
    from celerite_torch.inference import advi

    lp, theta = _config2_logprob("cuda")
    lp_cpu, _ = _config2_logprob("cpu")
    dim = theta.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    eps = torch.randn(8, dim, generator=gen, dtype=torch.float64,
                      device="cuda")
    v = torch.cat([theta, torch.full((dim,), -2.0, dtype=torch.float64,
                                     device="cuda")])
    got = advi._neg_elbo_and_grad(lp.value_and_grad_batch, v, eps)
    want = advi._neg_elbo_and_grad(lp_cpu.value_and_grad_batch, v.cpu(),
                                   eps.cpu())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-8,
                                   atol=1e-8 * float(b.abs().max()))

    before = _grad_launches()
    hess = advi._fd_hessian(lp.value_and_grad_batch, theta)
    assert [a - b for a, b in zip(_grad_launches(), before)] == [1] * 4
    h = 1e-4 * (1.0 + torch.abs(theta))
    cols = torch.stack([
        -(lp.value_and_grad(theta + h[i] * e)[1]
          - lp.value_and_grad(theta - h[i] * e)[1]) / (2.0 * h[i])
        for i, e in enumerate(torch.eye(dim, dtype=torch.float64,
                                        device="cuda"))])
    ref = 0.5 * (cols + cols.T)
    assert float((hess - ref).abs().max()) <= 1e-8 * float(ref.abs().max())

    rows = []
    batch = lp.value_and_grad_batch

    def counted(qs):
        rows.append(qs.shape[0])
        return batch(qs)

    lp.value_and_grad_batch = counted
    before = _grad_launches()
    res = advi.fit_advi(lp, theta, gen, num_steps=20, num_mc=8)
    assert rows == [8] * 20
    mode, cov = advi.laplace_fit(lp, theta, num_steps=20,
                                 learning_rate=2e-2)
    assert rows == [8] * 20 + [2 * dim]
    launched = [a - b for a, b in zip(_grad_launches(), before)]
    assert min(launched) >= 20 + 20 + 1
    for x in (res.mu, res.sigma, res.elbo_trace, mode, cov):
        assert bool(torch.isfinite(x).all())
    assert float((cov - cov.T).abs().max()) <= 1e-10 * float(
        cov.abs().max())


@pytest.mark.cuda
def test_smc_on_the_card(cuda_device):
    """``sample_smc`` on 64 particles of config[2] at N = 4096 for two
    stages: the likelihood and every leapfrog of the cloud are batched
    calls (64 rows), the four gradient kernels launch, and the result is
    finite with the temperature rising."""
    from celerite_torch.inference import smc

    like, theta = _config2_logprob("cuda")
    rows = []
    batch = like.value_and_grad_batch

    def counted(qs):
        rows.append(qs.shape[0])
        return batch(qs)

    like.value_and_grad_batch = counted

    def prior(x):
        return -0.5 * torch.sum((x / 3.0) ** 2)

    prior.value_and_grad_batch = lambda qs: (
        -0.5 * torch.sum((qs / 3.0) ** 2, dim=-1), -qs / 9.0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    init = theta + 0.3 * torch.randn(64, theta.shape[0], generator=gen,
                                     dtype=torch.float64, device="cuda")
    before = _grad_launches()
    res = smc.sample_smc(prior, like, init, gen, num_mutations=2,
                         num_leapfrog=4, max_stages=2)
    launched = [a - b for a, b in zip(_grad_launches(), before)]
    assert res.num_stages == 2
    assert set(rows) == {64}
    assert min(launched) >= len(rows)
    assert bool(torch.isfinite(res.particles).all())
    assert math.isfinite(float(res.log_evidence))
    assert 0.0 < float(res.final_accept) <= 1.0


def test_predict_var_on_the_card(cuda_device):
    """``GP.predict(..., return_var=True)`` for config[2] at N = 4096 with
    512 test points on the card (the blocked Kalman/RTS engine, the grid
    merged by a stable argsort) against the CPU route (the sequential
    engine), and ``predict_var_parallel`` on the card on the sorted and on
    shuffled points against it, within 1e-9 of the largest value; the
    three-pass kernels launch in ``compute``."""
    from celerite_torch import GP, terms
    from celerite_torch.ops import pallas_solver, pkalman
    from celerite_torch.ops.lower import Coefficients
    from celerite_torch.testing import config2_kernel

    t, y, yerr = make_data(4096, seed=3, t_max=100.0)
    x = np.sort(np.random.default_rng(4).uniform(-1.0, 101.0, 512))
    before = pallas_solver.factor_cuda.launches
    gp = GP(config2_kernel(terms))
    gp.compute(t, yerr)
    assert pallas_solver.factor_cuda.launches > before
    cpu = GP(config2_kernel(terms), device="cpu")
    cpu.compute(t, yerr)
    want = cpu.predict(y, x, return_var=True)
    coeffs = Coefficients(*gp.kernel.coefficients, jitter=gp.kernel.jitter)
    perm = np.random.default_rng(5).permutation(len(x))
    shuffled = pkalman.predict_var_parallel(coeffs, t, yerr**2, y, x[perm],
                                            device="cuda")
    for got in (gp.predict(y, x, return_var=True),
                pkalman.predict_var_parallel(coeffs, t, yerr**2, y, x,
                                             device="cuda"),
                tuple(v[np.argsort(perm)] for v in shuffled)):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=1e-9 * np.abs(w).max())
    assert np.all(want[1] >= 0)


def test_carma_on_the_card(cuda_device):
    """``CARMASolver`` on the card against its CPU route within 1e-10, at
    p = 3, q = 1 on 500 points."""
    from celerite_torch import CARMASolver

    t, y, yerr = make_data(500, seed=6, t_max=50.0)
    args = (0.1, [1.3, 0.4, 0.1], [0.5])
    ll = CARMASolver(*args).log_likelihood(t, y, yerr)
    want = CARMASolver(*args, device="cpu").log_likelihood(t, y, yerr)
    assert abs(ll - want) <= 1e-10 * abs(want)


def _fleet(n_curves, seed=21):
    """A LightCurveBatch of ``n_curves`` curves of 20-60 points."""
    from celerite_torch.data import LightCurveBatch

    rng = np.random.default_rng(seed)
    ts, ys, es = [], [], []
    for _ in range(n_curves):
        n = int(rng.integers(20, 61))
        t = np.sort(rng.uniform(0, 10, n))
        e = rng.uniform(0.1, 0.2, n)
        ts.append(t)
        ys.append(np.sin(t) + e * rng.standard_normal(n))
        es.append(e)
    return LightCurveBatch.from_ragged(ts, ys, es)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chain", [1, 2, 16])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_fleet_kernels_match_plain(n_chain, dtype, cuda_device):
    """Rows 1-5 on a fleet plan (``make_plan4_curves``: one lane and one
    state segment a curve, ``seg = 1``): 1001 curves, so 7 pad lanes at
    one chain and 3 a chain at two; 16 chains of 1001 lanes.  Every
    lane's primal outputs and every gradient kernel's against the plain
    versions, a coefficient row a chain; the pad lanes' ll is 0."""
    jr, jc, vals = CASES[2]
    b = _fleet(1001)
    plan = lanes4.make_plan4_curves(b.t, b.y, b.yerr**2, b.lengths,
                                    n_chain=n_chain, dtype=dtype,
                                    device=cuda_device)
    lanes = plan.num_blocks
    assert lanes == {1: 1008, 2: 2008, 16: 16016}[n_chain]
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device,
                         dtype=dtype)
    if n_chain > 1:
        cf = torch.stack([cf * (0.9 + 0.2 * c / n_chain)
                          for c in range(n_chain)])
    got = fused4.primal_cuda(cf, plan, jr, jc, seg=1)
    want = fused4.primal_reference(cf, plan, jr, jc, seg=1)
    rtol = 1e-10 if dtype == torch.float64 else GRAD_F32_RTOL
    if dtype == torch.float32:
        _assert_lanes_close(got, want, F32_PLAIN_RTOL)
    else:
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                       rtol=1e-10, atol=1e-10)
    _check_grad_kernels(cf, plan, jr, jc, rtol, seg=1)
    ll, ok = fused4.run_primal(cf, plan, jr, jc,
                               n_seg=lanes if n_chain == 1 else n_chain,
                               state_seg=1)
    assert bool(ok.all())
    if n_chain == 1:
        assert ll.shape == (lanes,) and bool((ll[1001:] == 0).all())


@pytest.mark.cuda
def test_fleet_loglik_on_the_card(cuda_device):
    """``data.make_fleet_loglik`` on the card against the CPU route
    (``batched_gp_log_likelihood``, float64): per-curve ll (1e-10) and
    the shared gradient (1e-8 of its norm), and the value alone (the
    primal); four folded chains against one-chain sums (1e-12); and
    ``make_curve_logprob``'s batched entry (rows 2-5, a coefficient row a
    lane) against its CPU plain versions."""
    from celerite_torch import data, terms

    b = _fleet(300)
    kernel = terms.SHOTerm(0.1, 1.0, 0.5)
    theta = torch.tensor([0.1, 1.0, 0.5], dtype=torch.float64)

    def vg(fn, th):
        th = th.detach().requires_grad_()
        ll, ok = fn(th)
        (g,) = torch.autograd.grad(ll.sum(), th)
        return ll.detach(), ok, g

    want, okw, gw = vg(lambda th: data.batched_gp_log_likelihood(
        kernel, th, b, device="cpu"), theta)
    fleet = data.make_fleet_loglik(kernel, b, device=cuda_device)
    ll, ok, g = vg(fleet, theta.to(cuda_device))
    assert bool(ok.all()) and bool(okw.all()) and ll.shape == (300,)
    np.testing.assert_allclose(ll.cpu().numpy(), want.numpy(), rtol=1e-10)
    assert float((g.cpu() - gw).norm() / gw.norm()) < 1e-8
    before = fused4.primal_cuda.launches
    with torch.no_grad():
        val, _ = fleet(theta.to(cuda_device))
    assert fused4.primal_cuda.launches == before + 1
    np.testing.assert_allclose(val.cpu().numpy(), want.numpy(), rtol=1e-10)

    thetas = theta + 0.05 * torch.as_tensor(
        np.random.default_rng(3).standard_normal((4, 3)))
    folded = data.make_fleet_loglik(kernel, b, n_chain=4, device=cuda_device)
    ll4, ok4, g4 = vg(folded, thetas.to(cuda_device))
    assert bool(ok4.all())
    for c in range(4):
        l1, _, g1 = vg(fleet, thetas[c].to(cuda_device))
        np.testing.assert_allclose(float(ll4[c]), float(l1.sum()),
                                   rtol=1e-12)
        assert float((g4[c] - g1).norm() / g1.norm()) < 1e-12

    lp = data.make_curve_logprob(kernel)
    rows = {k: v[:16] for k, v in data.curve_rows(b, device="cpu").items()}
    th16 = thetas[torch.arange(16) % 4]
    vc, gc = lp.value_and_grad_batch(rows, th16)
    vk, gk = lp.value_and_grad_batch(
        {k: v.to(cuda_device) for k, v in rows.items()},
        th16.to(cuda_device))
    np.testing.assert_allclose(vk.cpu().numpy(), vc.numpy(), rtol=1e-10)
    np.testing.assert_allclose(gk.cpu().numpy(), gc.numpy(), rtol=1e-8,
                               atol=1e-8 * float(gc.abs().max()))


# General (A, U, V) blocks: phi = 1 columns after the kernel's, lowered from
# general_problem's data (benchmarks/general_row.py) on general_kernel's
# padded width 4; general rank 4 gives P = 8, rank 9 P = 13.
GENERAL_RANKS = {8: 4, 13: 9}


def _general(width, n=4099):
    from celerite_torch import terms
    from celerite_torch.testing import general_kernel, general_problem

    t, y, yerr, A, U, V = general_problem(n, GENERAL_RANKS[width])
    return general_kernel(terms), t, y, yerr, (A, U, V)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 13])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_general_rows_match_plain(width, dtype, cuda_device):
    """Rows 8-18 on phi = 1 streams with general columns against their
    plain versions, every output: 1e-10 in float64, the kernels' float32
    bars in float32.  N = 4099: the three-pass kernels in blocks of 96
    steps (43 lanes, a padded tail); the adjoint kernels, the single-sweep
    kernel (P = 8) and the tangent kernels (the jac call at P = 8) on 64
    lanes with the kernel parameters' tangents, zero on the general
    columns."""
    from celerite_torch.testing import general_lane_streams

    f64 = dtype == torch.float64
    kern, t, y, yerr, gen = _general(width)
    streams = blocked_streams(kern, t, y, yerr, 96, dtype=dtype,
                              device=cuda_device, general=gen)
    assert streams[0].shape[1] == width
    assert bool((streams[2][:, 4:] == 1).all())
    errs = compare_solver_kernels(*streams)
    rtol = 1e-10 if f64 else SOLVER_F32_RTOL
    bad = {k: e["outputs"] for k, e in errs.items() if e["max_rel_err"] > rtol}
    s, d = general_lane_streams(kern, t, y, yerr, gen, 64, dtype=dtype,
                                device=cuda_device)
    assert float(d[0][:, :, 4:].abs().max()) == 0.0
    errs = compare_adjoint_kernels(*s)
    rtol = 1e-10 if f64 else ADJ_F32_RTOL
    bad.update({k: e["outputs"] for k, e in errs.items()
                if e["max_rel_err"] > rtol})
    kernels = ("elements_jvp", "factor_jvp") + (("jac",) if width <= 8
                                                else ())
    errs = compare_tangent_kernels(s, d, kernels=kernels)
    if width <= 8:
        errs.update(compare_fused_kernel(*s))
    limits = {"fused": FUSED_F32_RTOL, **TANGENT_F32_RTOL}
    bad.update({k: e["outputs"] for k, e in errs.items()
                if e["max_rel_err"] > (1e-10 if f64 else limits[k])})
    assert not bad, bad


GENERAL_ROUTES = [("auto", None), ("fused", None), ("pallas", None),
                  ("blocked", True), ("fused", True), ("fused", "tangent"),
                  ("pallas", "tangent")]


@pytest.mark.cuda
@pytest.mark.parametrize("width", [8, 13])
@pytest.mark.parametrize("solver,fast_grad", GENERAL_ROUTES)
def test_general_build_loglik_on_the_card(width, solver, fast_grad,
                                          cuda_device):
    """``build_loglik`` with general blocks on the card against the CPU
    float64 ``blocked`` route, ll (1e-10) and gradient (1e-8 of its norm),
    at N = 4099, by every kernel route: "fused" (row 15 at P = 8, rows
    12-14 at 13), "pallas" (rows 12-14), ``fast_grad=True`` (the adjoint
    rows 8-11) and "tangent" (row 18 at P = 8, rows 16-17 at 13); the
    route's kernels launch."""
    from celerite_torch import GP
    from celerite_torch.ops import adjoint, fused, pallas_solver, tangent

    kern, t, y, yerr, gen = _general(width)
    out = {}
    for dev in ("cpu", "cuda"):
        gp = GP(kern, device=dev)
        gp.compute(t, yerr, A=gen[0], U=gen[1], V=gen[2])
        fn = gp.build_loglik(t, y, yerr=yerr, solver=(
            "blocked" if dev == "cpu" else solver), fast_grad=(
            None if dev == "cpu" else fast_grad))
        theta = torch.tensor(gp.get_parameter_vector(), device=dev,
                             requires_grad=True)
        counters = [fused.kernel_cuda, tangent.jac_cuda,
                    tangent.factor_jvp_cuda, adjoint.factor_bwd_cuda,
                    pallas_solver.subst_cuda]
        before = [c.launches for c in counters]
        ll, ok = fn(theta)
        (grad,) = torch.autograd.grad(ll, theta)
        launched = [c.launches - b for c, b in zip(counters, before)]
        assert bool(ok)
        out[dev] = (float(ll.detach()), grad.cpu(), launched)
    want = {("fused", None): 0 if width <= 8 else 4,
            ("pallas", None): 4, ("fused", True): 3,
            ("pallas", "tangent"): 4,
            ("fused", "tangent"): 0 if width <= 8 else 4}
    launched = out["cuda"][2]
    if (solver, fast_grad) in want:
        assert launched[want[solver, fast_grad]] >= 1, launched
    if fast_grad == "tangent":
        assert launched[1 if width <= 8 else 2] >= 1, launched
    if fast_grad is True:
        assert launched[3] >= 1, launched
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-10)
    g, gw = out["cuda"][1], out["cpu"][1]
    assert float((g - gw).norm() / gw.norm()) < 1e-8
