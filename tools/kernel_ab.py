#!/usr/bin/env python
"""Time one tree's kernels of rows 1-5, 8-21 (PERF.md
section 6) on the plans chip_smoke.py times them on, so that two trees can
be compared on one card.

Usage (on a machine with an NVIDIA H100), from the root of a checkout:

    python3 tools/kernel_ab.py [--tree DIR] [--rows 4,8] [--call-c] [--call-g]
                               [--sass OUT]

``DIR`` (default: this checkout) is the root of a tree whose
``celerite_torch`` and ``chip_smoke.py`` are imported; an older commit
unpacked with ``git archive`` into a git-ignored directory (``build/``)
serves.  Run the trees in turns in one command (old, new, new, old) to
compare them on one card.  ``--rows`` times only the rows named (1, 2, 3,
4, 5, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21; 2-5 build
together, as do 8-11, 12-14, 16-17 and 19-21; ``--rows ""`` none).
``--call-c`` and ``--call-g`` also time main path C's calls and G's on
E's model.  ``--sass OUT`` writes ``cuobjdump -sass`` of every library
the rows build (not those built beside the timings) to ``OUT``, one file
a source and width: ``diff -r`` of two trees' ``OUT`` shows whether a
shared header's change reached their code.

Builds what the rows take of ``fused4_primal.cu`` at every P = 1-12,
``fused4_grad.cu`` at P = 8 (at every P = 1-12 for row 2's ptxas
figures), ``tangent.cu`` at 8, 13 and 16, ``adjoint.cu`` at 13 and 16,
``pallas_solver.cu`` at 4, 13 and 16, ``fused.cu`` at every P = 1-8 and
``onepass.cu`` at 2, 8 and 16 (at every P = 1-16 for rows 19 and 20's
ptxas figures, those widths built beside the timings), and prints one
JSON line a measurement, each with the tree, the card's name and power
limit (nvidia-smi) and ptxas's registers and spill bytes of the kernels
timed:

- ``row1``: the fused primal (``fused4.primal_cuda``) on main path A's
  plan (bench.py's model, N = 1e6: 32768 lanes of 31 steps, P = 2) and
  on main path B's (config[2], N = 1e5: 4096 lanes of 25 steps, P = 8),
  float64 and float32, with the device ms and launches a call of each of
  its kernels from torch.profiler and ptxas's figures at P = 1-12;
- ``row2``, ``row5``, ``row3`` and ``row4``: fused4 ``elem_fwd``,
  ``factor_bwd``, ``elem_bwd`` and ``factor_fwd`` on main path C's
  16-chain batch plan (config[2], N = 1e5, 16 x 512 lanes of 196 steps),
  and rows 2 and 4 also on its one-theta plan (512 lanes), float64 and
  float32;
- ``row18``: the tangent route's ``jac`` call on sampler_G's 4-chain plan
  (4 x 256 lanes of 391 steps, T = 7) and on main path G's 16-chain
  batch plan, float64, with the device time of each of its four launches
  from torch.profiler;
- ``row16`` and ``row17``: the split pair's ``elements_jvp`` and
  ``factor_jvp`` on main path G's folded batch plan of E's model (P = 16,
  T = 13) and on its one-theta plan, ``row17`` in float64, ``row16`` in
  float64 and float32, with ptxas's figures at P = 13 and 16 (of the
  kernel that launches: ``tangent_elements`` or ``tangent_factor`` in a
  tree that has one, else the jac sweep's);
- ``row8``, ``row9``, ``row10`` and ``row11``: the adjoint
  ``elements_fwd``, ``elements_bwd``, ``factor_fwd`` and ``factor_bwd`` on
  sampler_E's 4-chain plan and on main path E's 16-chain batch plan (E's
  model, P = 16, 128 lanes a chain of 782 steps), float64 and float32,
  with ptxas's figures at P = 13 and 16 and, for rows 9 and 11, the
  launch's shape (threads and lanes a block, dynamic shared memory, blocks
  an SM) where the tree's ``chip_smoke.adjoint_bwd_layout`` gives it;
- ``row12``, ``row13`` and ``row14``: the three-pass ``elements``,
  ``factor`` and ``subst`` on main path F's value plan of E's model (one
  theta, P = 16: 128 lanes of 782 steps) and on ``solver="pallas"``'s
  blocks of E's width (P = 16, N = 1e5 in blocks of
  ``pallas_solver.default_block_size``), float64 and float32, with
  ptxas's figures at P = 4, 13 and 16;
- ``row15``: the single-sweep kernel on main path G's value plan of
  config[2] (one theta, P = 8: 256 lanes of 391 steps), float64 and
  float32, with the device ms and launches a call of each of its kernels
  from torch.profiler and ptxas's figures at P = 1-8;
- ``row19``, ``row20`` and ``row21``: the one-pass ``sweep``,
  ``sweep_fwd`` and ``sweep_bwd`` on main path H's three plans (config[2]
  and E's model on B's data at N = 1e5, 4096 lanes of 25 steps at P = 8
  and 16; bench.py's model at N = 1e6, 32768 lanes of 31 steps at P = 2),
  rows 19 and 20 in float64 and float32, row 21 in float64, each also
  timed with its calls queued behind a spinning kernel (``queued_ms``,
  the card's time alone) and by its launch's device ms from
  torch.profiler; an ``onepass_ptxas`` line closes
  with ptxas's figures of ``onepass.cu`` at every P = 1-16 where rows 19
  or 20 were asked for;
- ``callC`` (``--call-c``): main path C's ``value_and_grad`` at one theta
  and ``value_and_grad_batch`` at 16, float64, the host clock's median,
  p10 and p90 ms a call (``chip_smoke.eval_spread_ms``) and a profile's
  device-busy ms, idle share, the port's kernels' ms and the glue's
  (``chip_smoke.profile_evals``);
- ``callG`` (``--call-g``): the same for main path G's two calls on E's
  model (``fast_grad="tangent"``, P = 16, T = 13).

Times are the mean of CUDA events around back-to-back calls.
"""

import argparse
import concurrent.futures
import json
import os
import sys
import time


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=".",
                    help="root of the tree whose celerite_torch is timed")
    ap.add_argument("--rows",
                    default="1,2,3,4,5,8,9,10,11,12,13,14,15,16,17,18,19,"
                    "20,21",
                    help="comma-separated rows to time")
    ap.add_argument("--call-c", action="store_true",
                    help="also time main path C's calls")
    ap.add_argument("--call-g", action="store_true",
                    help="also time main path G's calls on E's model")
    ap.add_argument("--sass", metavar="OUT",
                    help="write cuobjdump -sass of each library the rows "
                    "build to OUT/<source>_p<P>.sass")
    args = ap.parse_args()
    rows = {int(r) for r in args.rows.split(",") if r}
    root = os.path.abspath(args.tree)
    sys.path.insert(0, root)

    import numpy as np
    import torch

    import celerite_torch
    import chip_smoke as cs
    from celerite_torch import _build, terms
    from celerite_torch.ops import fused
    from celerite_torch.testing import config2_kernel

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    if not celerite_torch.__file__.startswith(root):
        raise RuntimeError("imported celerite_torch from {0}, not {1}".format(
            celerite_torch.__file__, root))
    dev = torch.device("cuda")
    smi = cs.smi_name_power()
    t0 = time.perf_counter()
    jobs = [job for job, of in (
        (("fused4_grad.cu", 8), {2, 3, 4, 5}), (("tangent.cu", 8), {18}),
        (("tangent.cu", 13), {16, 17}), (("tangent.cu", 16), {16, 17}),
        (("adjoint.cu", 13), {8, 9, 10, 11}),
        (("adjoint.cu", 16), {8, 9, 10, 11}),
        (("pallas_solver.cu", 4), {12, 13, 14}),
        (("pallas_solver.cu", 13), {12, 13, 14}),
        (("pallas_solver.cu", 16), {12, 13, 14}), (("fused.cu", 8), {15}),
        (("onepass.cu", 8), {19, 20, 21}), (("onepass.cu", 2), {19, 20}),
        (("onepass.cu", 16), {19, 20}))
        if rows & of]
    if 1 in rows:
        jobs += [("fused4_primal.cu", p) for p in range(1, 13)]
    if 2 in rows:
        jobs += [("fused4_grad.cu", p) for p in range(1, 13) if p != 8]
    if 15 in rows:
        jobs += [("fused.cu", p) for p in range(1, 8)]
    paths = _build.build([(s, {"CELERITE_P": p}) for s, p in jobs])
    ptxas = {"{0}:{1}".format(s, p): cs.ptxas_summary(
        path.with_suffix(".ptxas.txt")) for (s, p), path in zip(jobs, paths)}
    build_s = time.perf_counter() - t0
    if args.sass:
        dump_sass(_build, jobs, paths, args.sass)
    # onepass.cu's other widths, for ptxas's figures alone, build beside
    # the timings.
    later = ([("onepass.cu", p) for p in range(1, 17) if p not in (2, 8, 16)]
             if rows & {19, 20} else [])
    beside = concurrent.futures.ThreadPoolExecutor(1)
    later_paths = beside.submit(
        _build.build, [(s, {"CELERITE_P": p}) for s, p in later])

    def pick(src, p, *names):
        rows = ptxas["{0}:{1}".format(src, p)]
        return {k: v for k, v in rows.items()
                if any(k.startswith(n) for n in names)}

    def emit(row, **fields):
        print(json.dumps({"row": row, "tree": args.tree, "card": smi,
                          **fields}), flush=True)

    emit("build", seconds=build_s)

    # config[2] at N = 1e5 on main path B's data (chip_smoke.main).
    n = 100_000
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 100.0, n))
    yerr = np.full(n, 0.3)
    y = np.sin(t) + 0.5 * np.sin(3.1 * t) + yerr * rng.standard_normal(n)
    gp = celerite_torch.GP(config2_kernel(terms))
    pr, pc = gp.kernel.padded_size

    def prior(th):
        return -0.5 * torch.sum((th / 3.0) ** 2)

    theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)
    thetas = cs.path_c_thetas(theta, dev)
    if 1 in rows:
        time_row1(cs, gp, t, y, yerr, theta, emit, pick)
    if args.call_c:
        time_calls(cs, "callC", gp, t, y, yerr, prior, theta, thetas, emit)

    # Rows 2, 5, 3 and 4 on C's 16-chain plan, rows 2 and 4 also on its
    # one-theta plan.
    nc = cs.SAMPLER_CHAINS
    cfs = torch.stack([cs.packed_cf(gp, th) for th in thetas[:nc]])
    for dt in (torch.float64, torch.float32) if rows & {2, 3, 4, 5} else ():
        lp = gp.build_logprob(t, y, yerr=yerr, log_prior=prior, dtype=dt)
        for ncc in (nc, 1) if rows & {2, 4} else (nc,):
            plan = lp.loglik.value_ok_grad_batch.folded_plan(ncc)
            cf = cfs if ncc > 1 else cs.packed_cf(gp, theta)
            calls = cs.grad_kernel_calls(cf.to(dt), plan, pr, pc)
            for row, name in ((2, "elem_fwd"), (5, "factor_bwd"),
                              (3, "elem_bwd"), (4, "factor_fwd")):
                if row in rows and (ncc > 1 or row in (2, 4)):
                    emit("row{0}".format(row), kernel="fused4 " + name,
                         dtype=str(dt)[6:], chains=ncc,
                         lanes=plan.t.shape[1], steps=plan.t.shape[0],
                         ms=cs.sync_time_ms(calls[name][0], reps=20),
                         ptxas={p: pick("fused4_grad.cu", p, name)
                                for p in (range(1, 13) if row == 2
                                          else (8,))})
            del plan, calls
            torch.cuda.empty_cache()
        del lp
    gpe = celerite_torch.GP(config2_kernel(terms, modes=3))
    thetae = torch.as_tensor(gpe.get_parameter_vector(), device=dev)
    thetase = cs.path_c_thetas(thetae, dev)
    if args.call_g:
        time_calls(cs, "callG", gpe, t, y, yerr, prior, thetae, thetase, emit,
                   fast_grad="tangent")
    if 18 in rows:
        time_row18(cs, gp, t, y, yerr, prior, thetas, emit, pick)
    if rows & {16, 17}:
        time_rows16_17(cs, gpe, t, y, yerr, prior, thetase, emit, pick,
                       rows)

    # Rows 8-11 on sampler_E's 4-chain plan and E's 16-chain plan.
    layout = getattr(cs, "adjoint_bwd_layout", None)
    for dt in (torch.float64, torch.float32) if rows & {8, 9, 10, 11} else ():
        lpe = gpe.build_logprob(t, y, yerr=yerr, log_prior=prior, dtype=dt)
        for nce in (cs.SAMPLER_E_CHAINS, cs.SAMPLER_CHAINS):
            plan = lpe.loglik.value_ok_grad_batch.folded_plan(nce)
            streams = cs.lane_streams(gpe, plan, thetase[:nce])
            calls = cs.adjoint_kernel_calls(streams,
                                            streams[0].shape[-1] // nce)
            for row, name in ((8, "elements_fwd"), (9, "elements_bwd"),
                              (10, "factor_fwd"), (11, "factor_bwd")):
                if row not in rows:
                    continue
                emit("row{0}".format(row), kernel="adjoint " + name,
                     dtype=str(dt)[6:], chains=nce,
                     lanes=streams[0].shape[-1], steps=streams[0].shape[0],
                     ms=cs.sync_time_ms(calls[name][0], reps=10),
                     ptxas={p: pick("adjoint.cu", p, "adjoint_" + name)
                            for p in (13, 16)},
                     layout=None if layout is None or row in (8, 10)
                     else layout(name, 16, dt))
            del plan, streams, calls
            torch.cuda.empty_cache()
        del lpe

    # Rows 12-14 on F's plans of E's width, row 15 on G's of config[2].
    if rows & {12, 13, 14}:
        time_rows12_14(cs, gpe, thetae, t, y, yerr, prior, emit, pick, rows)
    if 15 in rows:
        for dt in (torch.float64, torch.float32):
            lpg = gp.build_logprob(t, y, yerr=yerr, log_prior=prior,
                                   dtype=dt, fast_grad="tangent")
            s = cs.lane_streams(gp, lpg.loglik.plan, theta)
            b = s[0].shape[-1]

            def call():
                return fused.kernel_cuda(*s, b)

            emit("row15", kernel="fused kernel", dtype=str(dt)[6:], lanes=b,
                 steps=s[0].shape[0], ms=cs.sync_time_ms(call, reps=10),
                 split=launch_split(call),
                 ptxas={p: pick("fused.cu", p, "fused_")
                        for p in range(1, 9)})
            del lpg, s
    torch.cuda.empty_cache()

    if rows & {19, 20, 21}:
        time_rows19_21(cs, gp, gpe, t, y, yerr, emit, pick, rows)
    for (s, p), path in zip(later, later_paths.result()):
        ptxas["{0}:{1}".format(s, p)] = cs.ptxas_summary(
            path.with_suffix(".ptxas.txt"))
    beside.shutdown()
    if rows & {19, 20}:
        emit("onepass_ptxas", ptxas={p: pick("onepass.cu", p, "onepass_")
                                     for p in range(1, 17)})
    return 0


def dump_sass(build, jobs, paths, out):
    """``cuobjdump -sass`` of each built library into ``out``, one file a
    (source, P), so that two trees' code can be compared with ``diff -r``."""
    import subprocess

    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    os.makedirs(out, exist_ok=True)
    for (src, p), path in zip(jobs, paths):
        name = "{0}_p{1}.sass".format(src.split(".")[0], p)
        with open(os.path.join(out, name), "w") as f:
            subprocess.run([tool, "-sass", str(path)], stdout=f, check=True)


def time_rows19_21(cs, gp, gpe, t, y, yerr, emit, pick, rows):
    """Rows 19 and 20 (the one-pass sweep and sweep_fwd) on main path H's
    three plans in float64 and float32, each with its kernel's device ms a
    call from torch.profiler; row 21 (sweep_bwd) on the config[2] plan in
    float64."""
    import celerite_torch
    import torch
    from celerite_torch import terms
    from celerite_torch.testing import bench_kernel

    dev = torch.device("cuda")
    ta, ya, yerra = cs.bench_data()
    models = {"B": (gp, t, y, yerr), "E": (gpe, t, y, yerr),
              "A": (celerite_torch.GP(bench_kernel(terms)), ta, ya, yerra)}
    for tag, (g, tt, yy, ye) in models.items():
        if tag != "B" and not rows & {19, 20}:
            continue
        s64 = cs.h_streams(g, tt, yy, ye, dev)
        p = s64[0].shape[1]
        for dt in (torch.float64, torch.float32):
            s = tuple(x.to(dt) for x in s64)
            calls = cs.onepass_kernel_calls(s)
            for row, name, prefix in ((19, "sweep", "onepass_sweep"),
                                      (20, "sweep_fwd", "onepass_fwd"),
                                      (21, "sweep_bwd", "onepass_bwd")):
                if row not in rows or (row == 21 and (
                        tag != "B" or dt != torch.float64)):
                    continue
                kern = calls[name][0]
                emit("row{0}".format(row), kernel="onepass " + name,
                     plan=tag, dtype=str(dt)[6:], lanes=s[0].shape[-1],
                     steps=s[0].shape[0],
                     ms=cs.sync_time_ms(kern, reps=20),
                     queued_ms=queued_time_ms(cs, kern, reps=20),
                     split=launch_split(kern),
                     ptxas=pick("onepass.cu", p, prefix))
            del s, calls
        del s64
        torch.cuda.empty_cache()


def queued_time_ms(cs, fn, reps):
    """Mean ms per call by CUDA events around ``reps`` calls queued behind a
    spinning kernel: ``cs.sync_time_ms(..., queued=True)`` where the tree's
    chip_smoke has it; for an older tree, the same with its spin and check
    here."""
    import inspect

    import torch

    if "queued" in inspect.signature(cs.sync_time_ms).parameters:
        return cs.sync_time_ms(fn, reps, queued=True)
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(getattr(cs, "QUEUE_CYCLES", 40_000_000))
    start.record()
    for _ in range(reps):
        fn()
    spun_out = start.query()
    end.record()
    end.synchronize()
    if spun_out:
        raise RuntimeError("queued timing: the spin ended before the last "
                           "call was queued")
    return start.elapsed_time(end) / reps


def launch_split(fn, warmup=3, active=10):
    """Each CUDA kernel that one call of ``fn`` launches, by name: its
    device ms and launches a call, from torch.profiler over ``active``
    calls after ``warmup`` untraced ones."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(active):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count:
            us = max(getattr(e, "self_device_time_total", 0) or 0,
                     getattr(e, "device_time_total", 0) or 0)
            name = re.sub(r"^void ", "", e.key).split("(")[0]
            row = split.setdefault(name, {"ms": 0.0, "launches": 0.0})
            row["ms"] += us / 1e3 / active
            row["launches"] += e.count / active
    return split


def time_row1(cs, gpb, tb, yb, yerrb, thetab, emit, pick):
    """Row 1 (the fused primal) on main path A's plan and on B's, float64
    and float32, with its launches' split."""
    import celerite_torch
    import torch
    from celerite_torch import terms
    from celerite_torch.ops import fused4
    from celerite_torch.testing import bench_kernel

    dev = torch.device("cuda")
    gpa = celerite_torch.GP(bench_kernel(terms))
    thetaa = torch.as_tensor(gpa.get_parameter_vector(), device=dev)
    for tag, gp, theta, (t, y, yerr) in (
            ("A", gpa, thetaa, cs.bench_data()),
            ("B", gpb, thetab, (tb, yb, yerrb))):
        pr, pc = gp.kernel.padded_size
        cf64 = cs.packed_cf(gp, theta)
        for dt in (torch.float64, torch.float32):
            plan = gp.build_loglik(t, y, yerr=yerr, dtype=dt).plan
            cf = cf64.to(dt)

            def call():
                return fused4.primal_cuda(cf, plan, pr, pc)

            emit("row1", kernel="fused4 primal", plan=tag, dtype=str(dt)[6:],
                 lanes=plan.t.shape[1], steps=plan.t.shape[0],
                 ms=cs.sync_time_ms(call, reps=20), split=launch_split(call),
                 ptxas={p: pick("fused4_primal.cu", p, "")
                        for p in range(1, 13)})
            del plan
            torch.cuda.empty_cache()


def time_calls(cs, tag, gp, t, y, yerr, prior, theta, thetas, emit,
               **options):
    """A main path's two calls (``value_and_grad`` at ``theta``,
    ``value_and_grad_batch`` at ``thetas``) in float64 through
    ``gp.build_logprob(..., **options)``, on the host clock and profiled."""
    import torch

    lp = gp.build_logprob(t, y, yerr=yerr, log_prior=prior,
                          dtype=torch.float64, **options)
    for call, fn, arg, batches, per_batch in (
            ("single", lp.value_and_grad, theta, 15, 10),
            ("batch16", lp.value_and_grad_batch, thetas, 15, 5)):
        ms = cs.eval_spread_ms(fn, arg, batches=batches, per_batch=per_batch)
        prof = cs.profile_evals(fn, arg)
        emit(tag, call=call, dtype="float64", ms=ms,
             busy_ms=prof["device_busy_ms_per_eval"],
             idle_share=prof["device_idle_share"],
             kernel_ms=prof["kernel_ms_per_eval"],
             glue_ms=prof["glue_ms_per_eval"],
             glue_launches=prof["glue_launches_per_eval"])
    del lp
    torch.cuda.empty_cache()


def time_row18(cs, gp, t, y, yerr, prior, thetas, emit, pick):
    """Row 18 on sampler_G's and G's batch plans, with its launches'
    split."""
    import torch

    from celerite_torch.ops import tangent

    nc = cs.SAMPLER_CHAINS
    lpg = gp.build_logprob(t, y, yerr=yerr, log_prior=prior,
                           dtype=torch.float64, fast_grad="tangent")
    vog = lpg.loglik.value_ok_grad_batch
    for tag, ncg in (("sampler4_B", cs.SAMPLER_G_CHAINS),
                     ("batch16_B", min(nc, vog.fold_cap))):
        plan = vog.folded_plan(ncg)
        s, d = cs.path_tangent_streams(gp, plan, thetas[:ncg])
        seg = s[0].shape[-1] // ncg

        def call():
            return tangent.jac_cuda(*s, *d, seg=seg)

        ms = cs.sync_time_ms(call, reps=10)
        split = launch_split(call)
        emit("row18", kernel="tangent jac", plan=tag, dtype="float64",
             chains=ncg, lanes=s[0].shape[-1], steps=s[0].shape[0],
             directions=d[0].shape[1], ms=ms, split_ms=split,
             ptxas=pick("tangent.cu", 8, "jac_"))
        del s, d
        torch.cuda.empty_cache()


def time_rows12_14(cs, gpe, thetae, t, y, yerr, prior, emit, pick, rows):
    """Rows 12-14 (those of ``rows``) on main path F's value plan of E's
    model and on ``solver="pallas"``'s blocks at P = 16, float64 and
    float32."""
    import torch

    from celerite_torch import terms
    from celerite_torch.ops import pallas_solver
    from celerite_torch.testing import blocked_streams, width_kernel

    dev = torch.device("cuda")
    L = pallas_solver.default_block_size(dev)
    s64 = blocked_streams(width_kernel(terms, 16), t, y, yerr, L, device=dev)
    names = [(row, name) for row, name in
             zip((12, 13, 14), pallas_solver.SOLVER_KERNELS) if row in rows]
    for dt in (torch.float64, torch.float32):
        lpe = gpe.build_logprob(t, y, yerr=yerr, log_prior=prior, dtype=dt)
        for plan, s in (("value_plan",
                         cs.lane_streams(gpe, lpe.loglik.value_plan, thetae)),
                        ("pallas_E", tuple(x.to(dt) for x in s64))):
            calls = cs.solver_kernel_calls(s)
            for row, name in names:
                emit("row{0}".format(row), kernel="pallas_solver " + name,
                     plan=plan, dtype=str(dt)[6:], lanes=s[0].shape[-1],
                     steps=s[0].shape[0],
                     ms=cs.sync_time_ms(calls[name][0], reps=20),
                     ptxas={p: pick("pallas_solver.cu", p, "solver_" + name)
                            for p in (4, 13, 16)})
            del s, calls
        del lpe
        torch.cuda.empty_cache()


def time_rows16_17(cs, gpe, t, y, yerr, prior, thetase, emit, pick, rows):
    """Rows 16 and 17 (the split pair) on main path G's batch plan of E's
    model and on its one-theta plan, row 16 in float64 and float32."""
    import torch

    nc = cs.SAMPLER_CHAINS
    for dt in (torch.float64, torch.float32):
        names = [n for row, n in ((16, "elements_jvp"), (17, "factor_jvp"))
                 if row in rows and (row == 16 or dt == torch.float64)]
        if not names:
            continue
        lpg = gpe.build_logprob(t, y, yerr=yerr, log_prior=prior, dtype=dt,
                                fast_grad="tangent")
        vog = lpg.loglik.value_ok_grad_batch
        for ncg in (min(nc, vog.fold_cap), 1):
            s, d = cs.path_tangent_streams(gpe, vog.folded_plan(ncg),
                                           thetase[:ncg])
            calls = cs.tangent_kernel_calls(s, d, s[0].shape[-1] // ncg,
                                            names)
            for name in names:
                # The kernel that launches: the split pair's own
                # (tangent_elements, tangent_factor) in a tree that has it,
                # else the jac sweep.
                ptxas = {p: pick("tangent.cu", p, "tangent_" + name[:-4]) or
                         pick("tangent.cu", p, "jac_" + name[:-4])
                         for p in (13, 16)}
                emit("row{0}".format(16 if name == "elements_jvp" else 17),
                     kernel="tangent " + name, dtype=str(dt)[6:], chains=ncg,
                     lanes=s[0].shape[-1], steps=s[0].shape[0],
                     directions=d[0].shape[1],
                     ms=cs.sync_time_ms(calls[name][0], reps=5), ptxas=ptxas)
            del s, d, calls
            torch.cuda.empty_cache()
        del lpg, vog


if __name__ == "__main__":
    sys.exit(main())
