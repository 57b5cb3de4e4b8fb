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
from celerite_torch.testing import (CASES, compare_grad_kernels, make_data,
                                    pack_values)

# The float32 gradient kernels against their float32 plain versions on the
# same plan: ten times the largest error chip_smoke.py measured (PERF.md).
GRAD_F32_RTOL = 4e-5


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


@pytest.mark.cuda
def test_primal_kernel_segments_one_cf_row(cuda_device):
    """One coefficient row over several segments: no state crosses them."""
    jr, jc, vals = CASES[2]
    t, y, yerr = make_data(2053, seed=4, t_max=200.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=torch.float64,
                             device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    got = fused4.primal_cuda(cf, plan, jr, jc, seg=16)
    want = fused4.primal_reference(cf, plan, jr, jc, seg=16)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(),
                                   rtol=1e-10, atol=1e-10)


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
def test_grad_kernels_every_width(jr, jc, vals, cuda_device):
    t, y, yerr = make_data(2053, seed=5, t_max=200.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=torch.float64,
                             device=cuda_device)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=cuda_device)
    _check_grad_kernels(cf, plan, jr, jc, 1e-10)


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
