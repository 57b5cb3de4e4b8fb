#!/usr/bin/env python
"""Drive celerite_torch's main path on one CUDA card and check its kernel.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Builds the fused primal kernel (celerite_torch/csrc/fused4_primal.cu) with
nvcc for every padded width it uses, holds the kernel against its plain
PyTorch version on the card, then drives the port's main path through the
entry points a user calls:

- A: ``GP.build_loglik`` for bench.py's model (one ComplexTerm, P = 2) at
  N = 1e6 in float32 and float64, with the lane-count (B) sweep;
- B: ``GP.build_logprob`` for config[2] (two SHO terms + jitter, P = 8) at
  N = 1e5 (benchmarks/nuts_config2.py), in float32 and float64.

Prints one JSON line per phase, a ``kernels`` line, the card's name and
power limit as nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing anything.
"""

import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

import celerite_torch
from celerite_torch import _build, terms
from celerite_torch.ops import fused4, lanes4
from celerite_torch.ops.lower import Coefficients
from celerite_torch.testing import (CASES, bench_kernel, config2_kernel,
                                    make_data, pack_values)

# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate and the
# non-tensor-core float rates.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
WIDTHS = (1, 2, 4, 8)           # padded widths this script runs
F64_RTOL = 1e-10                # f64 kernel against f64 plain
F32_RTOL = 1e-4                 # f32 against f64 (input-quantization floor)
F32_PLAIN_RTOL = 2e-5           # f32 kernel against f32 plain, same plan
SWEEP_LANES = (1024, 2048, 4096, 8192, 16384, 32768, 65536)


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
    kernels' times), the device's idle share, and the top kernels and host
    ops.
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
    kernels, host = [], []
    for e in prof.key_averages():
        dev = max(getattr(e, "self_device_time_total", 0) or 0,
                  getattr(e, "device_time_total", 0) or 0)
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": e.key[:60], "per_eval": e.count / evals,
                            "ms_per_eval": dev / 1e3 / evals})
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
    paths = _build.build([("fused4_primal.cu", {"CELERITE_P": p})
                          for p in WIDTHS])
    emit("build", seconds=time.perf_counter() - t0, widths=list(WIDTHS),
         ptxas={p: ptxas_summary(path.with_suffix(".ptxas.txt"))
                for p, path in zip(WIDTHS, paths)})

    errs = []
    check_kernel_cases(dev, errs)

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
    fused4.primal_cuda.launches = 0
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
    fused4.primal_cuda.launches = 0
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

    print(json.dumps({"kernels": [{
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
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
