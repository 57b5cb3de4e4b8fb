#!/usr/bin/env python
"""Drive celerite_torch's main path on one CUDA card and check its kernel.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Builds the fused primal kernel (celerite_torch/csrc/fused4_primal.cu) and
the four gradient kernels (celerite_torch/csrc/fused4_grad.cu) with nvcc for
every padded width it uses, one nvcc process per library, all at once; holds
each kernel against its plain PyTorch version on the card; then drives the
port's main paths through the entry points a user calls:

- A: ``GP.build_loglik`` for bench.py's model (one ComplexTerm, P = 2) at
  N = 1e6 in float32 and float64, with the lane-count (B) sweep;
- B: ``GP.build_logprob`` for config[2] (two SHO terms + jitter, P = 8) at
  N = 1e5 (benchmarks/nuts_config2.py), in float32 and float64;
- C: the gradient: ``build_logprob(...).value_and_grad`` (one theta) and
  ``value_and_grad_batch`` (16 thetas folded onto the kernels' lanes) for
  config[2] at N = 1e5, and ``value_and_grad`` for bench.py's model at
  N = 1e6, held against autograd through the plain primal in float64, with
  the lane sweeps of the value-and-gradient path;
- sampler_C: dense-mass HMC on config[2] at N = 1e5 in float64, 16 chains
  folded: step-size search, 100 warmup transitions (dual averaging, dense
  inverse mass from the second half), 100 sampling transitions.

Each main path resets every kernel's launch counter just before it runs and
reads the counters just after; a kernel of the path that did not launch
fails the run.

Prints one JSON line per phase, a ``kernels`` line, the card's name and
power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing anything.
"""

import functools
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

import celerite_torch
from celerite_torch import _build, inference, terms
from celerite_torch.inference import adaptation, diagnostics
from celerite_torch.ops import fused4, lanes4
from celerite_torch.ops.lower import Coefficients
from celerite_torch.testing import (CASES, bench_kernel, compare_grad_kernels,
                                    config2_kernel, make_data, pack_values)

# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate and the
# non-tensor-core float rates.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
WIDTHS = (1, 2, 4, 8)           # padded widths this script runs
F64_RTOL = 1e-10                # f64 kernel against f64 plain
F32_RTOL = 1e-4                 # f32 against f64 (input-quantization floor)
F32_PLAIN_RTOL = 2e-5           # f32 kernel against f32 plain, same plan
SWEEP_LANES = (1024, 2048, 4096, 8192, 16384, 32768, 65536)
# Gradient kernels against their plain versions, every output (the hcf
# rows as per-segment sums against the sums' norm): float64, and float32
# kernel against float32 plain on the same plan (ten times the largest
# reading, PERF.md).
GRAD_F64_RTOL = 1e-10
GRAD_F32_RTOL = 4e-5
# The same on the gradient path's plans, whose 196-step lanes carry
# factor_fwd's affine map (M, m) and quadratic (Qm, qv, q0) through eight
# times the steps of the cases above: 9.3 times the largest reading
# (PERF.md), with the float32 plain version's own distance from float64
# on the same plan reported beside it.
GRAD_F32_PATH_RTOL = 2e-3
GRAD_AUTOGRAD_RTOL = 1e-8       # main path C's f64 gradient, in norm
# The CUDA kernels of csrc/fused4_primal.cu and csrc/fused4_grad.cu, by
# their names in a profile.
PORT_KERNELS = ("elem_kernel", "elem_round", "factor_kernel", "affine_round",
                "assemble") + tuple(k + "_kernel" for k in fused4.GRAD_KERNELS)
SAMPLER_CHAINS = 16


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    raise RuntimeError(msg)


def rel(a, b):
    return abs(float(a) - float(b)) / abs(float(b))


def smi_name_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def nvcc_version():
    out = subprocess.run([_build.nvcc(), "--version"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[-1]


def ptxas_summary(path):
    """{kernel<dtype>: {"registers", "spill_stores", "spill_loads"}}."""
    out, cur, props = {}, None, None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '_Z\d+(\w+?)I([df])E", line)
        if m:
            cur = "{0}<{1}>".format(m.group(1),
                                    "f32" if m.group(2) == "f" else "f64")
            out[cur] = {}
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur and props and cur.split("<")[0] in props:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and cur:
            out[cur]["registers"] = int(m.group(1))
    return out


def sync_time_ms(fn, reps, warm=2):
    """Mean ms per call by CUDA events around ``reps`` back-to-back calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def eval_spread_ms(fn, theta, batches=9, per_batch=20):
    """Median, p10, p90 ms/eval over batches, host clock, synchronized."""
    for _ in range(per_batch):
        fn(theta)
    torch.cuda.synchronize()
    per = []
    for _ in range(batches):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(per_batch):
            fn(theta)
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3 / per_batch)
    per = np.asarray(per)
    return {"median": float(np.median(per)),
            "p10": float(np.percentile(per, 10)),
            "p90": float(np.percentile(per, 90))}


def profile_evals(fn, theta, evals=10):
    """Where one eval's time goes: torch.profiler (CUPTI) over ``evals``.

    Returns wall ms/eval (profiler on), device-busy ms/eval (sum of the CUDA
    kernels' times), the device's idle share, the top kernels and host ops,
    each of the port's kernels' ms/eval, and the rest of the CUDA launches
    (``glue``: the float64 prefixes and their VJPs, the coefficient
    lowering, the prior) with their ms/eval and share of the busy time.
    """
    from torch.profiler import ProfilerActivity, profile

    fn(theta)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(evals):
            fn(theta)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / evals
    kernels, host, ours = [], [], {}
    glue_ms = glue_launches = 0.0
    for e in prof.key_averages():
        dev = max(getattr(e, "self_device_time_total", 0) or 0,
                  getattr(e, "device_time_total", 0) or 0)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms = dev / 1e3 / evals
            kernels.append({"name": e.key[:60], "per_eval": e.count / evals,
                            "ms_per_eval": ms})
            m = re.match(r"void (\w+)<", e.key)
            if m and m.group(1) in PORT_KERNELS:
                ours[m.group(1)] = ours.get(m.group(1), 0.0) + ms
            else:
                glue_ms += ms
                glue_launches += e.count / evals
        else:
            host.append({"name": e.key[:60], "per_eval": e.count / evals,
                         "self_cpu_ms_per_eval":
                             e.self_cpu_time_total / 1e3 / evals})
    busy = sum(k["ms_per_eval"] for k in kernels)
    kernels.sort(key=lambda k: -k["ms_per_eval"])
    host.sort(key=lambda h: -h["self_cpu_ms_per_eval"])
    return {"wall_ms_per_eval": wall, "device_busy_ms_per_eval": busy,
            "device_idle_share": 1.0 - busy / wall,
            "kernel_launches_per_eval": sum(k["per_eval"] for k in kernels),
            "kernel_ms_per_eval": ours, "glue_ms_per_eval": glue_ms,
            "glue_launches_per_eval": glue_launches,
            "glue_share_of_busy": glue_ms / max(busy, 1e-12),
            "top_kernels": kernels[:10], "top_host_ops": host[:10]}


def plain_ll(cf, plan, jr, jc, nc=1):
    """(ll per segment, ok) from the plain version on the plan's device."""
    quad, ld, mind = fused4.primal_reference(cf, plan, jr, jc)
    seg = plan.num_blocks // nc
    ll = -0.5 * (quad.reshape(nc, seg).sum(1) + ld.reshape(nc, seg).sum(1)
                 + plan.n * math.log(2 * math.pi))
    ok = (mind.reshape(nc, seg).amin(1) > 0) & torch.isfinite(ll)
    return ll, ok


def packed_cf(gp, theta):
    """The float64 packed coefficients the closures compute for ``theta``."""
    kp = theta[:gp.kernel.full_size]
    return lanes4.pack_cf(Coefficients(*gp.kernel.get_padded_coefficients(kp),
                                       jitter=gp.kernel.get_jitter(kp)),
                          dtype=torch.float64)


def bound_ms(plan, jr, jc):
    """Least time for one fused primal: max(bytes / rate, ops / peak).

    Bytes: the six (L, B) input streams and the coefficients read once,
    the three (B,) outputs written once.  Operations: what the function
    needs for this plan's shape (transcendentals as one each), not what
    this kernel does.  Per point, once each: the lowering, the Riccati
    step, the element update and the factor statistics.  Per prefix, a
    work-efficient scan of 2 B compositions: an element composition (seven
    P x P products and a P x P Gauss-Jordan) and an affine one.
    """
    L, b = plan.t.shape
    p = jr + 2 * jc
    item = plan.t.element_size()
    nbytes = (6 * L * b + (2 * p + 1) + 3 * b) * item
    lower_ops = jr * 4 + jc * 40 + 3
    per_point = lower_ops + (7 * p * p + 4 * p + 1) + (8 * p * p + 2 * p) \
        + (8 * p * p + 7 * p + 12)
    per_compose = (14 * p**3 + 4 * p**3 + 3 * p * p) + (2 * p**3 + 2 * p * p)
    ops = per_point * L * b + 2 * b * per_compose
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[plan.t.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_kernel_cases(dev, errs):
    """Kernel against plain on the card: small and N = 1e5 shapes."""
    for n, seed in ((4099, 7), (100_000, 11)):
        t, y, yerr = make_data(n, seed=seed, t_max=n / 10.0)
        nb = lanes4.default_num_blocks4(n, dev) if n > 10_000 else 256
        plans = {dt: lanes4.make_plan4(t, y, yerr**2, nb, dtype=dt, device=dev)
                 for dt in (torch.float32, torch.float64)}
        for jr, jc, vals in CASES:
            cf = torch.as_tensor(pack_values(jr, jc, vals), device=dev)
            ref, okp = plain_ll(cf, plans[torch.float64], jr, jc)
            ref32, _ = plain_ll(cf, plans[torch.float32], jr, jc)
            ll64, ok64 = fused4.run_primal(cf, plans[torch.float64], jr, jc)
            ll32, ok32 = fused4.run_primal(cf, plans[torch.float32], jr, jc)
            e64, e32 = rel(ll64, ref[0]), rel(ll32, ref[0])
            e32p = rel(ll32, ref32[0])
            errs.append(abs(float(ll64) - float(ref[0])))
            emit("kernel_vs_plain", n=n, lanes=nb, jr=jr, jc=jc,
                 ll_plain_f64=float(ref[0]), ll_kernel_f64=float(ll64),
                 rel_err_f64=e64, rel_err_f32_vs_f64=e32,
                 rel_err_f32_vs_f32_plain=e32p)
            if not (bool(okp[0]) and bool(ok64) and bool(ok32)):
                fail("kernel case not positive definite: {0}".format((jr, jc)))
            if e64 > F64_RTOL or e32 > F32_RTOL or e32p > F32_PLAIN_RTOL:
                fail("kernel disagrees with plain: {0}".format((n, jr, jc)))

    # Chain-folded (4, C) batch: one launch, four independent segments.
    jr, jc, vals = CASES[3]
    t, y, yerr = make_data(4099, seed=8, t_max=400.0)
    plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=torch.float64,
                             n_chain=4, device=dev)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=dev)
    cfs = torch.stack([cf * s for s in (1.0, 0.9, 1.1, 1.2)])
    llk, okk = fused4.run_primal(cfs, plan, jr, jc)
    llp, okp = plain_ll(cfs, plan, jr, jc, nc=4)
    e = float(((llk - llp).abs() / llp.abs()).max())
    errs.append(float((llk - llp).abs().max()))
    emit("kernel_vs_plain_folded", n_chain=4, jr=jr, jc=jc, max_rel_err=e)
    if not (bool(okk.all()) and bool(okp.all())) or e > F64_RTOL:
        fail("chain-folded kernel disagrees with plain")

    # Not positive definite: both sides say so.
    plan = lanes4.make_plan4(t, y, yerr**2, 128, dtype=torch.float64,
                             device=dev)
    cf = torch.as_tensor(pack_values(0, 1, [0.1, 3.0, 0.05, 2.0], jitter=0.0),
                         device=dev)
    llk, okk = fused4.run_primal(cf, plan, 0, 1)
    _, okp = plain_ll(cf, plan, 0, 1)
    emit("kernel_vs_plain_non_pd", ok_kernel=bool(okk), ok_plain=bool(okp[0]),
         ll_kernel=float(llk))
    if bool(okk) or bool(okp[0]) or float(llk) != -math.inf:
        fail("non-PD case not flagged")


# ---------------------------------------------------------------------------
# The gradient kernels (celerite_torch/csrc/fused4_grad.cu)
# ---------------------------------------------------------------------------

GRAD_REPLACES = {
    "elem_fwd": "celerite_tpu/ops/fused4.py:499",
    "factor_fwd": "celerite_tpu/ops/fused4.py:619",
    "factor_bwd": "celerite_tpu/ops/fused4.py:686",
    "elem_bwd": "celerite_tpu/ops/fused4.py:533",
}


def grad_bound_ms(name, plan, jr, jc, rows=1):
    """Least time for one launch of gradient kernel ``name``.

    max(bytes / rate, operations / peak).  Bytes: the (L, B) streams the
    kernel reads (five, six with y), its ``rows`` coefficient rows, its
    saves written (forward) or read (backward) once, the float64 seeds or
    cotangents it takes and the per-lane outputs it writes.  Operations
    per point, each once: the lowering, the Riccati step (forward) or its
    intermediates (backward), the element update or the factor
    statistics, and in the backward kernels their transposes and the
    coefficient chain; counted from the kernels' code.
    """
    L, b = plan.t.shape
    p = jr + 2 * jc
    it = plan.t.element_size()
    c = 2 * jr + 4 * jc + 1
    pts = L * b
    cin = c * rows
    lower = jr * 4 + jc * 40 + 3
    step = 7 * p * p + 4 * p + 1         # riccati_step
    front = 4 * p * p + 4 * p + 1        # riccati_front
    adjoint = 18 * p * p + 15 * p + 2    # riccati_adjoint
    chain = jr * 5 + jc * 25 + 2         # chain_step
    elem = 8 * p * p + 2 * p             # A, J update
    factor = 8 * p * p + 7 * p + 12      # M, m, Qm, qv, q0, ld, mind
    nbytes, per_point = {
        "elem_fwd": ((5 * pts + cin + 3 * p * p * b + 2 * p * p * pts) * it,
                     lower + step + elem),
        "factor_fwd": ((6 * pts + cin + (2 * p * p + 2 * p + 1) * b
                        + (2 * p * p + p) * pts) * it
                       + (p * p + 2) * b * 8,
                       lower + step + factor),
        "factor_bwd": ((6 * pts + cin + (2 * p * p + p) * pts + pts
                        + (c + p * p) * b) * it
                       + (2 * p * p + 2 * p + 2) * b * 8,
                       lower + front + adjoint + chain
                       + 17 * p * p + 24 * p + 20),
        "elem_bwd": ((5 * pts + cin + 2 * p * p * pts + c * b) * it
                     + 3 * p * p * b * 8,
                     lower + front + adjoint + chain + 15 * p * p + 10 * p),
    }[name]
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = per_point * pts / PEAK_FLOPS[plan.t.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def grad_kernel_calls(cf, plan, jr, jc):
    """{name: (kernel call, plain call)} on the same inputs, for timing.

    ``cf`` is one row or one row per chain of a folded plan."""
    p, b = jr + 2 * jc, plan.t.shape[1]
    dev = plan.t.device
    A, J, C, sv0 = fused4.elem_fwd_cuda(cf, plan, jr, jc)
    nc = 1 if cf.ndim == 1 else cf.shape[0]
    sh0 = fused4.prefix_sh0(A, J, C, b // nc)
    fwd1 = fused4.factor_fwd_cuda(cf, plan, jr, jc, plan.y, sh0)
    gen = torch.Generator(device=dev).manual_seed(1)
    cots = [torch.randn(s, generator=gen, dtype=torch.float64, device=dev)
            for s in ((p, p, b), (p, b), (p, p, b), (p, b), (b,), (b,))]
    c3 = [torch.randn(p, p, b, generator=gen, dtype=torch.float64,
                      device=dev) for _ in range(3)]
    args = {
        "elem_fwd": (),
        "factor_fwd": (plan.y, sh0),
        "factor_bwd": (plan.y, fwd1[7], *cots),
        "elem_bwd": (sv0, *c3),
    }
    return {name: (
        lambda f=getattr(fused4, name + "_cuda"), a=a: f(cf, plan, jr, jc, *a),
        lambda f=getattr(fused4, name + "_reference"), a=a:
            f(cf, plan, jr, jc, *a))
        for name, a in args.items()}


def grad_case(grad_errs, tag, cf, plan, jr, jc, seg=None,
              f32_limit=GRAD_F32_RTOL, **info):
    """One grad_kernel_vs_plain case: every output of the four kernels
    against the plain versions' at the dtype's limit.  ``grad_errs[name]``
    collects each kernel's float64 max abs error."""
    errs = compare_grad_kernels(cf, plan, jr, jc, seg=seg)
    f64 = plan.t.dtype == torch.float64
    limit = GRAD_F64_RTOL if f64 else f32_limit
    emit("grad_kernel_vs_plain", case=tag, jr=jr, jc=jc,
         dtype=str(plan.t.dtype).split(".")[1], limit=limit,
         max_rel_err={k: e["max_rel_err"] for k, e in errs.items()},
         outputs={k: e["outputs"] for k, e in errs.items()}, **info)
    for name, e in errs.items():
        if f64:
            grad_errs[name].append(e["max_abs_err"])
        if not e["max_rel_err"] <= limit:
            fail("{0} kernel disagrees with plain: {1} {2}".format(
                name, tag, (jr, jc, str(plan.t.dtype))))


def check_grad_kernels(dev, grad_errs):
    """grad_kernel_vs_plain: each gradient kernel against its plain version.

    The CASES shapes at N = 4099 and N = 1e5 in both dtypes, a
    chain-folded (4, C) batch and one cf row over 16-lane segments.
    """
    run = functools.partial(grad_case, grad_errs)
    for n, seed in ((4099, 7), (100_000, 11)):
        t, y, yerr = make_data(n, seed=seed, t_max=n / 10.0)
        nb = lanes4.default_num_blocks4(n, dev) if n > 10_000 else 256
        for dt in (torch.float64, torch.float32):
            plan = lanes4.make_plan4(t, y, yerr**2, nb, dtype=dt, device=dev)
            for jr, jc, vals in CASES:
                cf = torch.as_tensor(pack_values(jr, jc, vals), device=dev)
                run("cases", cf, plan, jr, jc, n=n, lanes=nb)
    jr, jc, vals = CASES[3]
    t, y, yerr = make_data(4099, seed=8, t_max=400.0)
    cf = torch.as_tensor(pack_values(jr, jc, vals), device=dev)
    for dt in (torch.float64, torch.float32):
        folded = lanes4.make_plan4(t, y, yerr**2, 64, dtype=dt, n_chain=4,
                                   device=dev)
        run("folded", torch.stack([cf * s for s in (1.0, 0.9, 1.1, 1.2)]),
            folded, jr, jc, n=4099, lanes=256, n_chain=4)
        plan = lanes4.make_plan4(t, y, yerr**2, 64, dtype=dt, device=dev)
        run("segments", cf, plan, jr, jc, seg=16, n=4099, lanes=64)


def plain_f32_floor(cf64, plans, jr, jc):
    """factor_fwd's outputs by the plain version in float32 against float64,
    each on its own plan of the same data, relative to the largest float64
    value: the rounding floor under a float32 kernel-vs-plain reading."""
    outs = {}
    for dt, plan in plans.items():
        cf = cf64.to(dt)
        seg = plan.t.shape[1] // (1 if cf.ndim == 1 else cf.shape[0])
        A, J, C, _ = fused4.elem_fwd_reference(cf, plan, jr, jc, seg=seg)
        sh0 = fused4.prefix_sh0(A, J, C, seg)
        outs[dt] = fused4.factor_fwd_reference(cf, plan, jr, jc, plan.y, sh0,
                                               seg=seg)[:7]
    names = ("M", "m", "Qm", "qv", "q0", "ld", "mind")
    return {k: float((a.double() - b).abs().max() / b.abs().max())
            for k, a, b in zip(names, outs[torch.float32],
                               outs[torch.float64])}


def grad_kernels_on_path(gp, lps, theta, thetas, grad_errs):
    """The gradient kernels on the plans main path C launches them on.

    ``value_ok_grad_batch.folded_plan(nc)`` for one row (``value_and_grad``)
    and for the 16 rows of ``value_and_grad_batch``, float64 and float32:
    each kernel against its plain version (grad_kernel_vs_plain, case
    ``main_path``), then each kernel's and its plain version's ms and the
    bound on those inputs.  Returns ``{nc: {name: row}}``.
    """
    pr, pc = gp.kernel.padded_size
    cfs = torch.stack([packed_cf(gp, th) for th in thetas])
    rows = {}
    for nc in (1, SAMPLER_CHAINS):
        cf64 = packed_cf(gp, theta) if nc == 1 else cfs[:nc]
        plans = {dt: lps[dt].loglik.value_ok_grad_batch.folded_plan(nc)
                 for dt in (torch.float64, torch.float32)}
        floor = plain_f32_floor(cf64, plans, pr, pc)
        for dt, plan in plans.items():
            cf = cf64.to(dt)
            lanes, steps = plan.t.shape[1], plan.t.shape[0]
            grad_case(grad_errs, "main_path", cf, plan, pr, pc,
                      f32_limit=GRAD_F32_PATH_RTOL, n=plan.n, n_chain=nc,
                      lanes=lanes, steps_per_lane=steps,
                      **({} if dt == torch.float64 else
                         {"factor_fwd_plain_f32_vs_f64": floor}))
            key = str(dt).split(".")[1]
            for name, (kern, plain) in grad_kernel_calls(cf, plan, pr,
                                                         pc).items():
                row = rows.setdefault(nc, {}).setdefault(name, {})
                row["ms_" + key] = sync_time_ms(kern, reps=20)
                row["plain_ms_" + key] = sync_time_ms(plain, reps=1, warm=1)
                row["bound_ms_" + key], row["bound_by_" + key] = \
                    grad_bound_ms(name, plan, pr, pc, rows=nc)
        emit("grad_kernel_time_C", n=plan.n, n_chain=nc, lanes=lanes,
             steps_per_lane=steps, kernels=rows[nc])
    return rows


def grad_counts():
    return {name: getattr(fused4, name + "_cuda").launches
            for name in fused4.GRAD_KERNELS}


def reset_counts():
    fused4.primal_cuda.launches = 0
    for name in fused4.GRAD_KERNELS:
        getattr(fused4, name + "_cuda").launches = 0


def reference_value_and_grad(gp, plan, theta, prior):
    """log prob and its gradient by autograd through the plain primal on
    ``plan`` (float64): independent of the gradient kernels."""
    th = theta.detach().double().requires_grad_()
    kp = th[:gp.kernel.full_size]
    cf = lanes4.pack_cf(Coefficients(*gp.kernel.get_padded_coefficients(kp),
                                     jitter=gp.kernel.get_jitter(kp)),
                        dtype=torch.float64)
    pr, pc = gp.kernel.padded_size
    ll, _ = plain_ll(cf, plan, pr, pc)
    lp = ll[0] + prior(th)
    (grad,) = torch.autograd.grad(lp, th)
    return float(lp.detach()), grad


def grad_rel(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


def path_c_thetas(theta, dev):
    """The 16 rows main path C's batched call takes: theta + 0.02 N(0, 1)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    return theta[None] + 0.02 * torch.randn(
        SAMPLER_CHAINS, theta.shape[0], generator=gen, dtype=theta.dtype,
        device=dev)


def main_path_c(gp, lps, prior, theta, thetas):
    """config[2] at N = 1e5 through ``value_and_grad`` (one theta) and
    ``value_and_grad_batch`` (16 thetas, folded), float32 and float64.

    Gates: the float64 values and gradients against autograd through the
    plain primal on the value plan, the batch against one-theta calls,
    and the float32 values against float64 at the value path's limit."""
    plan64 = lps[torch.float64].loglik.plan
    reset_counts()
    single = {dt: lp.value_and_grad(theta) for dt, lp in lps.items()}
    batch = {dt: lp.value_and_grad_batch(thetas) for dt, lp in lps.items()}
    counts = grad_counts()
    emit("main_path_C_launches", **counts,
         primal=fused4.primal_cuda.launches)
    if min(counts.values()) < 4:
        fail("main path C did not launch every gradient kernel: "
             "{0}".format(counts))

    lp_ref, g_ref = reference_value_and_grad(gp, plan64, theta, prior)
    v64, g64 = single[torch.float64]
    v32, g32 = single[torch.float32]
    e_single = grad_rel(g64, g_ref)
    e_value = rel(v64, lp_ref)
    refs = {r: reference_value_and_grad(gp, plan64, thetas[r], prior)
            for r in (0, SAMPLER_CHAINS - 1)}
    b64, b32 = batch[torch.float64], batch[torch.float32]
    e_batch_ref = max(grad_rel(b64[1][r], g) for r, (_, g) in refs.items())
    e_batch_value_ref = max(rel(b64[0][r], v) for r, (v, _) in refs.items())
    per_theta = [lps[torch.float64].value_and_grad(th) for th in thetas]
    e_batch_single = max(grad_rel(b64[1][r], per_theta[r][1])
                         for r in range(SAMPLER_CHAINS))
    e_batch_value = max(rel(b64[0][r], per_theta[r][0])
                        for r in range(SAMPLER_CHAINS))
    e_value32 = max([rel(v32, v64)] + [rel(b32[0][r], b64[0][r])
                                       for r in range(SAMPLER_CHAINS)])
    spread = {}
    for dt, lp in lps.items():
        key = str(dt).split(".")[1]
        spread["single_" + key] = eval_spread_ms(lp.value_and_grad, theta,
                                                 batches=7, per_batch=10)
        spread["batch16_" + key] = eval_spread_ms(lp.value_and_grad_batch,
                                                  thetas, batches=5,
                                                  per_batch=5)
    emit("main_path_C", model="config[2] 2xSHO + jitter (P=8)",
         n=plan64.n, lanes_value=plan64.num_blocks,
         lanes_per_chain_grad=lps[torch.float64].loglik.value_ok_grad_batch
         .folded_plan(1).num_blocks,
         fold_cap=lps[torch.float64].loglik.value_ok_grad_batch.fold_cap,
         logprob_f64=float(v64), logprob_plain_f64=lp_ref,
         logprob_f32=float(v32), rel_err_value_f64=e_value,
         rel_err_batch_value_vs_autograd=e_batch_value_ref,
         rel_err_batch_value_vs_single=e_batch_value,
         rel_err_value_f32_vs_f64=e_value32,
         rel_err_grad_f64_vs_autograd=e_single,
         rel_err_grad_f32_vs_f64=grad_rel(g32, g64),
         rel_err_batch_grad_vs_autograd=e_batch_ref,
         rel_err_batch_grad_vs_single=e_batch_single,
         grad_f64=g64.tolist(), ms_per_call=spread)
    if not (math.isfinite(float(v64)) and math.isfinite(float(v32))
            and bool(torch.isfinite(b64[0]).all())
            and bool(torch.isfinite(b32[0]).all())
            and bool(torch.isfinite(b64[1]).all())
            and bool(torch.isfinite(b32[1]).all())):
        fail("main path C gave a non-finite log probability or gradient")
    if max(e_value, e_batch_value_ref, e_batch_value) > F64_RTOL:
        fail("main path C: log probability disagrees with the plain primal")
    if e_value32 > F32_RTOL:
        fail("main path C: float32 log probability off float64 by "
             "{0}".format(e_value32))
    if max(e_single, e_batch_ref, e_batch_single) > GRAD_AUTOGRAD_RTOL:
        fail("main path C: gradient disagrees with autograd")
    emit("profile_C", dtype="float64", call="value_and_grad",
         **profile_evals(lps[torch.float64].value_and_grad, theta))
    emit("profile_C", dtype="float64", call="value_and_grad_batch(16)",
         **profile_evals(lps[torch.float64].value_and_grad_batch, thetas,
                        evals=5))
    return counts


def grad_call_ms(plan, jr, jc, cf, reps=10):
    """ms of one value-and-gradient through build_ll_and_grad (fwd + bwd)."""
    fn = fused4.build_ll_and_grad(plan, jr, jc,
                                  n_chain=1 if cf.ndim == 1 else cf.shape[0])

    def call():
        c = cf.detach().requires_grad_()
        ll, _ = fn(c)
        ll.sum().backward()

    return sync_time_ms(call, reps=reps, warm=1)


def lane_sweeps_c(t, y, yerr, cf, pr, pc, tag, lanes, dev):
    """Single-chain value-and-gradient ms over the lane count B."""
    for nb in lanes:
        out = {}
        for dt in (torch.float32, torch.float64):
            plan = lanes4.make_plan4(t, y, yerr**2, nb, dtype=dt, device=dev)
            out["ms_" + str(dt).split(".")[1]] = grad_call_ms(
                plan, pr, pc, cf.to(dt))
            del plan
        emit("lane_sweep_grad_" + tag, lanes=nb,
             steps_per_lane=-(-len(t) // nb), **out)


def fold_sweep_c(t, y, yerr, cf, pr, pc, dev, chains=SAMPLER_CHAINS):
    """16 chains' value-and-gradient: lanes per chain x chains a launch."""
    cfs = cf[None].repeat(chains, 1)
    for per_launch in (4, 8, 16):
        for nb in (64, 128, 256, 512, 1024):
            plan = lanes4.make_plan4(t, y, yerr**2, nb, dtype=torch.float64,
                                     n_chain=per_launch, device=dev)
            ms = grad_call_ms(plan, pr, pc, cfs[:per_launch], reps=5)
            emit("fold_sweep_grad_C", dtype="float64", chains=chains,
                 chains_per_launch=per_launch, lanes_per_chain=nb,
                 ms_all_chains=ms * chains / per_launch)
            del plan


def sampler_c(lp, theta, dev, warmup=100, samples=100, leapfrog=8):
    """Dense-mass HMC on config[2], 16 folded chains, float64."""
    gen = torch.Generator(device=dev).manual_seed(2026)
    dim = theta.shape[0]
    q = theta[None] + 0.02 * torch.randn(SAMPLER_CHAINS, dim, generator=gen,
                                         dtype=torch.float64, device=dev)
    reset_counts()
    calls = [0]
    vag = lp.value_and_grad_batch

    def counted(qs):
        calls[0] += 1
        return vag(qs)

    target = lambda th: lp(th)  # noqa: E731
    target.value_and_grad_batch = counted

    def shared_length():
        return int(torch.randint(leapfrog // 2 + 1, leapfrog + 1, (),
                                 generator=gen, device=dev))

    # Windowed warmup as the JAX package's NUTS warmup runs it: one step
    # size for all chains by dual averaging on the pooled acceptance; the
    # second half's first 35 transitions feed the dense covariance, and at
    # the window's end the metric is set and dual averaging restarts for a
    # 15-transition terminal buffer.
    in_window, window_end = adaptation.window_boundaries(
        warmup, init_buffer=warmup // 2, term_buffer=15,
        base_window=warmup // 2 - 15)
    t0 = time.perf_counter()
    eps0 = inference.find_reasonable_step_size(target, q, gen)
    step = float(torch.median(eps0))
    da = adaptation.da_init(step, target=0.8, mu=math.log(step))
    cov = adaptation.welford_cov_init(dim, device=dev)
    inv_mass = torch.ones(dim, dtype=torch.float64, device=dev)
    leaps, accept_w, div_w = 0, [], 0
    for i in range(warmup):
        n = shared_length()
        q, info = inference.hmc_kernel(target, q, gen, math.exp(da.log_step),
                                       inv_mass, num_leapfrog=n, jitter=False)
        leaps += n
        da = adaptation.da_update(da, info.accept_prob.mean())
        accept_w.append(float(info.accept_prob.mean()))
        div_w += int(info.diverging.sum())
        if in_window[i]:
            cov = adaptation.welford_cov_update(cov, q)
        if window_end[i]:
            est = adaptation.welford_covariance(cov)
            if bool(torch.isfinite(est).all()):
                inv_mass = est
            da = adaptation.da_init(math.exp(da.log_step), target=0.8)
            cov = adaptation.welford_cov_init(dim, device=dev)
    t_warm = time.perf_counter() - t0
    step_s = float(adaptation.da_final(da))
    draws, acc, divs, energies = [], [], 0, []
    calls_s, t1 = calls[0], time.perf_counter()
    leaps_s = 0
    for _ in range(samples):
        n = shared_length()
        q, info = inference.hmc_kernel(target, q, gen, step_s, inv_mass,
                                       num_leapfrog=n, jitter=False)
        leaps_s += n
        draws.append(q.cpu().numpy())
        acc.append(float(info.accept_prob.mean()))
        divs += int(info.diverging.sum())
        energies.append(info.energy.cpu().numpy())
    torch.cuda.synchronize()
    t_samp = time.perf_counter() - t1
    chains = np.stack(draws, axis=1)  # (chains, draws, dim)
    summ = diagnostics.summary(chains)
    grew = grad_counts()
    last_acc = float(np.mean(accept_w[-(warmup // 2):]))
    out = {
        "n_chains": SAMPLER_CHAINS, "dim": dim, "warmup": warmup,
        "samples": samples, "leapfrog": leapfrog,
        "step_size_search": step, "step_size_sampling": step_s,
        "warmup_s": t_warm, "sampling_s": t_samp,
        "transitions_per_s": samples / t_samp,
        "leapfrogs_per_s": leaps_s / t_samp,
        "ms_per_value_and_grad_batch": t_samp * 1e3 / (calls[0] - calls_s),
        "value_and_grad_batch_calls": calls[0],
        "leapfrogs": leaps + leaps_s,
        "mean_accept_last_half_warmup": last_acc,
        "mean_accept_sampling": float(np.mean(acc)),
        "divergences_warmup": div_w, "divergences_sampling": divs,
        "max_rhat": float(np.max(summ["rhat"])),
        "min_ess": float(np.min(summ["ess"])),
        "ebfmi": [float(x) for x in diagnostics.ebfmi(
            np.stack(energies, axis=1))],
        "kernel_launches": grew,
        "inv_mass_diag": torch.diagonal(inv_mass).tolist(),
    }
    emit("sampler_C", **out)
    if not np.all(np.isfinite(chains)):
        fail("sampler_C: a chain ended non-finite")
    if not last_acc > 0.3:
        fail("sampler_C: mean acceptance over the last half of warmup "
             "{0} <= 0.3".format(last_acc))
    if min(grew.values()) < leaps + leaps_s:
        fail("sampler_C: gradient kernels launched fewer times than "
             "leapfrogs: {0}".format(grew))
    return grew


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_name_power()
    try:
        import triton
        triton_version = triton.__version__
    except ImportError:
        triton_version = None
    emit("environment", python=sys.version.split()[0], torch=torch.__version__,
         cuda=torch.version.cuda, nvcc=nvcc_version(), triton=triton_version,
         celerite_torch=celerite_torch.__version__,
         device=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
         nvidia_smi=smi)

    t0 = time.perf_counter()
    sources = ("fused4_primal.cu", "fused4_grad.cu")
    paths = _build.build([(src, {"CELERITE_P": p})
                          for src in sources for p in WIDTHS])
    emit("build", seconds=time.perf_counter() - t0, widths=list(WIDTHS),
         flags={src: list(_build.FLAGS + _build.SOURCE_FLAGS.get(src, ()))
                for src in sources},
         ptxas={src: {p: ptxas_summary(path.with_suffix(".ptxas.txt"))
                      for p, path in zip(WIDTHS, paths[i * len(WIDTHS):])}
                for i, src in enumerate(sources)})

    errs = []
    check_kernel_cases(dev, errs)
    grad_errs = {name: [] for name in fused4.GRAD_KERNELS}
    check_grad_kernels(dev, grad_errs)

    # ---- main path A: bench.py's model at N = 1e6 through build_loglik ----
    n = 1_000_000
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000.0, n))
    yerr = np.full(n, 0.1)
    y = rng.standard_normal(n)
    gp = celerite_torch.GP(bench_kernel(terms))
    pr, pc = gp.kernel.padded_size
    fns = {dt: gp.build_loglik(t, y, yerr=yerr, dtype=dt)
           for dt in (torch.float32, torch.float64)}
    theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)
    reset_counts()
    lls = {dt: fn(theta) for dt, fn in fns.items()}
    launches_a = fused4.primal_cuda.launches
    plan32, plan64 = fns[torch.float32].plan, fns[torch.float64].plan
    cf = packed_cf(gp, theta)
    ref64, _ = plain_ll(cf, plan64, pr, pc)
    ref32, _ = plain_ll(cf, plan32, pr, pc)
    e64 = rel(lls[torch.float64][0], ref64[0])
    e32 = rel(lls[torch.float32][0], ref64[0])
    e32p = rel(lls[torch.float32][0], ref32[0])
    errs.append(abs(float(lls[torch.float64][0]) - float(ref64[0])))
    spread = {str(dt).split(".")[1]: eval_spread_ms(fn, theta)
              for dt, fn in fns.items()}
    emit("main_path_A", model="bench.py ComplexTerm (P=2)", n=n,
         lanes=plan32.num_blocks, steps_per_lane=plan32.t.shape[0],
         ll_f32=float(lls[torch.float32][0]),
         ll_f64=float(lls[torch.float64][0]), ll_plain_f64=float(ref64[0]),
         rel_err_f64_kernel_vs_plain=e64, rel_err_f32_vs_f64=e32,
         rel_err_f32_kernel_vs_f32_plain=e32p, launches=launches_a,
         ms_per_eval=spread, evals_per_s_f32=1e3 / spread["float32"]["median"])
    if launches_a < 2:
        fail("main path A did not launch the kernel")
    if not all(bool(ok) for _, ok in lls.values()):
        fail("main path A not positive definite")
    if e64 > F64_RTOL or e32 > F32_RTOL or e32p > F32_PLAIN_RTOL:
        fail("main path A: kernel disagrees with plain")

    # Kernel alone (the wrapper) and the plain version on the same inputs.
    cf32 = cf.to(torch.float32)
    ms_kernel = sync_time_ms(
        lambda: fused4.primal_cuda(cf32, plan32, pr, pc), reps=50)
    ms_plain = sync_time_ms(
        lambda: fused4.primal_reference(cf32, plan32, pr, pc), reps=3, warm=1)
    ms_kernel64 = sync_time_ms(
        lambda: fused4.primal_cuda(cf, plan64, pr, pc), reps=50)
    bms, bby = bound_ms(plan32, pr, pc)
    bms64, bby64 = bound_ms(plan64, pr, pc)
    emit("kernel_time_A", ms_f32=ms_kernel, plain_ms_f32=ms_plain,
         bound_ms_f32=bms, bound_by_f32=bby, ms_f64=ms_kernel64,
         bound_ms_f64=bms64, bound_by_f64=bby64)

    # Lane-count sweep at N = 1e6 (kernel time and f32 seeding error).
    for nb in SWEEP_LANES:
        p32 = lanes4.make_plan4(t, y, yerr**2, nb, dtype=torch.float32,
                                device=dev)
        p64 = lanes4.make_plan4(t, y, yerr**2, nb, dtype=torch.float64,
                                device=dev)
        l32, ok32 = fused4.run_primal(cf32, p32, pr, pc)
        l64, _ = fused4.run_primal(cf, p64, pr, pc)
        emit("lane_sweep_A", lanes=nb, steps_per_lane=p32.t.shape[0],
             ms_f32=sync_time_ms(
                 lambda: fused4.primal_cuda(cf32, p32, pr, pc), reps=20),
             ms_f64=sync_time_ms(
                 lambda: fused4.primal_cuda(cf, p64, pr, pc), reps=20),
             ok_f32=bool(ok32), rel_err_f32_vs_f64=rel(l32, ref64[0]),
             rel_err_f64_vs_default_lanes=rel(l64, ref64[0]))
        del p32, p64

    emit("profile_A", dtype="float32", **profile_evals(fns[torch.float32],
                                                        theta))

    # ---- main path C at bench.py's model: one theta's value and gradient ----
    def prior_a(th):
        return -0.5 * torch.sum((th / 3.0) ** 2)

    lpa = {dt: gp.build_logprob(t, y, yerr=yerr, log_prior=prior_a, dtype=dt)
           for dt in (torch.float32, torch.float64)}
    reset_counts()
    vag_a = {dt: lp.value_and_grad(theta) for dt, lp in lpa.items()}
    counts_ca = grad_counts()
    if min(counts_ca.values()) < 2:
        fail("main path C (bench) did not launch every gradient kernel: "
             "{0}".format(counts_ca))
    lpa_ref, ga_ref = reference_value_and_grad(
        gp, lpa[torch.float64].loglik.plan, theta, prior_a)
    ea = grad_rel(vag_a[torch.float64][1], ga_ref)
    eva = rel(vag_a[torch.float64][0], lpa_ref)
    eva32 = rel(vag_a[torch.float32][0], vag_a[torch.float64][0])
    emit("main_path_C_bench", model="bench.py ComplexTerm (P=2)", n=n,
         lanes=lpa[torch.float64].loglik.value_ok_grad_batch.folded_plan(
             1).num_blocks, launches=counts_ca,
         logprob_f64=float(vag_a[torch.float64][0]), logprob_plain_f64=lpa_ref,
         logprob_f32=float(vag_a[torch.float32][0]), rel_err_value_f64=eva,
         rel_err_value_f32_vs_f64=eva32,
         rel_err_grad_f64_vs_autograd=ea,
         rel_err_grad_f32_vs_f64=grad_rel(vag_a[torch.float32][1],
                                          vag_a[torch.float64][1]),
         ms_per_call={str(dt).split(".")[1]: eval_spread_ms(
             lp.value_and_grad, theta, batches=7, per_batch=10)
             for dt, lp in lpa.items()})
    if ea > GRAD_AUTOGRAD_RTOL or not all(
            bool(torch.isfinite(g).all()) for _, g in vag_a.values()):
        fail("main path C (bench): gradient disagrees with autograd")
    if eva > F64_RTOL or eva32 > F32_RTOL:
        fail("main path C (bench): log probability off the plain primal "
             "(f64 {0}, f32 vs f64 {1})".format(eva, eva32))
    emit("profile_C_bench", dtype="float32", call="value_and_grad",
         **profile_evals(lpa[torch.float32].value_and_grad, theta))
    lane_sweeps_c(t, y, yerr, cf, pr, pc, "A",
                  (512, 1024, 2048, 4096, 8192, 32768), dev)
    del lpa, fns

    # ---- main path B: config[2] at N = 1e5 through build_logprob ----
    n = 100_000
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 100.0, n))
    yerr = np.full(n, 0.3)
    y = np.sin(t) + 0.5 * np.sin(3.1 * t) + yerr * rng.standard_normal(n)
    gp = celerite_torch.GP(config2_kernel(terms))
    pr, pc = gp.kernel.padded_size

    def prior(th):
        return -0.5 * torch.sum((th / 3.0) ** 2)

    lps = {dt: gp.build_logprob(t, y, yerr=yerr, log_prior=prior, dtype=dt)
           for dt in (torch.float32, torch.float64)}
    theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)
    reset_counts()
    vals = {dt: float(lp(theta)) for dt, lp in lps.items()}
    launches_b = fused4.primal_cuda.launches
    plan64 = lps[torch.float64].loglik.plan
    cfb = packed_cf(gp, theta)
    plan32 = lps[torch.float32].loglik.plan
    cfb32 = cfb.to(torch.float32)
    refb, _ = plain_ll(cfb, plan64, pr, pc)
    refb32, _ = plain_ll(cfb32, plan32, pr, pc)
    lp_ref = float(refb[0] + prior(theta))
    lp_ref32 = float(refb32[0] + prior(theta))
    eb64, eb32 = rel(vals[torch.float64], lp_ref), rel(vals[torch.float32], lp_ref)
    eb32p = rel(vals[torch.float32], lp_ref32)
    errs.append(abs(vals[torch.float64] - lp_ref))
    spread_b = {str(dt).split(".")[1]: eval_spread_ms(lp, theta)
                for dt, lp in lps.items()}
    bms_b, bby_b = bound_ms(plan64, pr, pc)
    bms_b32, bby_b32 = bound_ms(plan32, pr, pc)
    emit("main_path_B", model="config[2] 2xSHO + jitter (P=8)", n=n,
         lanes=plan64.num_blocks, steps_per_lane=plan64.t.shape[0],
         logprob_f32=vals[torch.float32], logprob_f64=vals[torch.float64],
         logprob_plain_f64=lp_ref, rel_err_f64_kernel_vs_plain=eb64,
         rel_err_f32_vs_f64=eb32, rel_err_f32_kernel_vs_f32_plain=eb32p,
         launches=launches_b, ms_per_eval=spread_b,
         kernel_ms_f32=sync_time_ms(
             lambda: fused4.primal_cuda(cfb32, plan32, pr, pc), reps=20),
         kernel_ms_f64=sync_time_ms(
             lambda: fused4.primal_cuda(cfb, plan64, pr, pc), reps=20),
         plain_ms_f64=sync_time_ms(
             lambda: fused4.primal_reference(cfb, plan64, pr, pc), reps=2,
             warm=1),
         bound_ms_f32=bms_b32, bound_by_f32=bby_b32,
         bound_ms_f64=bms_b, bound_by_f64=bby_b)
    emit("profile_B", dtype="float64", **profile_evals(lps[torch.float64],
                                                        theta))
    for nb in (256, 512, 1024, 2048, 4096, 8192):
        p32 = lanes4.make_plan4(t, y, yerr**2, nb, dtype=torch.float32,
                                device=dev)
        p64 = lanes4.make_plan4(t, y, yerr**2, nb, dtype=torch.float64,
                                device=dev)
        l32, ok32 = fused4.run_primal(cfb32, p32, pr, pc)
        emit("lane_sweep_B", lanes=nb, steps_per_lane=p32.t.shape[0],
             ok_f32=bool(ok32), rel_err_f32_vs_f64=rel(l32, refb[0]),
             ms_f32=sync_time_ms(
                 lambda: fused4.primal_cuda(cfb32, p32, pr, pc), reps=10),
             ms_f64=sync_time_ms(
                 lambda: fused4.primal_cuda(cfb, p64, pr, pc), reps=10))
        del p32, p64
    if launches_b < 2:
        fail("main path B did not launch the kernel")
    if not all(math.isfinite(v) for v in vals.values()):
        fail("main path B gave a non-finite log probability")
    if eb64 > F64_RTOL or eb32 > F32_RTOL or eb32p > F32_PLAIN_RTOL:
        fail("main path B: kernel disagrees with plain")

    # ---- main path C: config[2]'s value and gradient, single and folded ----
    # First the gradient kernels against their plain versions, and timed,
    # on the very plans (lanes a chain, chains a launch) the path uses.
    thetas = path_c_thetas(theta, dev)
    grad_rows = grad_kernels_on_path(gp, lps, theta, thetas, grad_errs)
    counts_c = main_path_c(gp, lps, prior, theta, thetas)
    lane_sweeps_c(t, y, yerr, cfb, pr, pc, "C",
                  (256, 512, 1024, 2048, 4096, 8192), dev)
    fold_sweep_c(t, y, yerr, cfb, pr, pc, dev)

    # ---- sampler_C: dense-mass HMC over 16 folded chains, float64 ----
    grew = sampler_c(lps[torch.float64], theta, dev)

    kernels = [{
        "name": "fused4_primal",
        "route": "cuda",
        "source": "celerite_torch/csrc/fused4_primal.cu",
        "replaces": "celerite_tpu/ops/fused4.py:275",
        "launches": launches_a + launches_b,
        "max_abs_err": max(errs),
        "ms": ms_kernel,
        "plain_ms": ms_plain,
        "bound_ms": bms,
        "bound_by": bby,
        "library_ms": None,
    }]
    # The gradient kernels' ms at the shape of nearly all their launches:
    # sampler_C's 16 chains folded, float64.
    for name in fused4.GRAD_KERNELS:
        row = grad_rows[SAMPLER_CHAINS][name]
        kernels.append({
            "name": "fused4_" + name,
            "route": "cuda",
            "source": "celerite_torch/csrc/fused4_grad.cu",
            "replaces": GRAD_REPLACES[name],
            "launches": counts_ca[name] + counts_c[name] + grew[name],
            "max_abs_err": max(grad_errs[name]),
            "ms": row["ms_float64"],
            "plain_ms": row["plain_ms_float64"],
            "bound_ms": row["bound_ms_float64"],
            "bound_by": row["bound_by_float64"],
            "library_ms": None,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
