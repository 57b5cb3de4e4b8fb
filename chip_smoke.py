#!/usr/bin/env python
"""Drive celerite_torch's main path on one CUDA card and check its kernel.

Usage (from the root of a checkout, on a machine with an NVIDIA H100):

    python3 chip_smoke.py

Builds the fused primal kernel (celerite_torch/csrc/fused4_primal.cu), the
four gradient kernels (celerite_torch/csrc/fused4_grad.cu), the two
exact-mode kernels (celerite_torch/csrc/dsfused.cu), the four adjoint
kernels (celerite_torch/csrc/adjoint.cu), the three three-pass kernels
(celerite_torch/csrc/pallas_solver.cu), the single-sweep kernel
(celerite_torch/csrc/fused.cu), the three tangent kernels
(celerite_torch/csrc/tangent.cu) and the three one-pass kernels
(celerite_torch/csrc/onepass.cu) with nvcc for every padded width it
uses (the primal and the gradient kernels at every width 1-12 and the
single-sweep kernel at 1-8, for ptxas's figures), one nvcc process per
library, all at once; holds each kernel against
its plain PyTorch version on the card; then drives the port's main paths
through the entry points a user calls:

- A: ``GP.build_loglik`` for bench.py's model (one ComplexTerm, P = 2) at
  N = 1e6 in float32 and float64, with the primal's launches' split by
  torch.profiler and the lane-count (B) sweep;
- B: ``GP.build_logprob`` for config[2] (two SHO terms + jitter, P = 8) at
  N = 1e5 (benchmarks/nuts_config2.py), in float32 and float64, with the
  primal's split and the lane sweep;
- C: the gradient: ``build_logprob(...).value_and_grad`` (one theta) and
  ``value_and_grad_batch`` (16 thetas folded onto the kernels' lanes) for
  config[2] at N = 1e5, and ``value_and_grad`` for bench.py's model at
  N = 1e6, held against autograd through the plain primal in float64, with
  the lane sweeps of the value-and-gradient path;
- sampler_C: dense-mass HMC on config[2] at N = 1e5 in float64, 16 chains
  folded: step-size search, SAMPLER_C_WARMUP warmup transitions (dual
  averaging, dense inverse mass from the second half) and
  SAMPLER_C_SAMPLES sampling transitions;
- J: the rest of the inference engine on config[2] at N = 1e5 in float64
  (B's ``build_logprob``): ``inference.laplace_fit`` (its Hessian's folded
  call held against one-theta calls), ``fit_advi`` (J_ADVI_MC draws a
  step, one folded call), ``optimize.map_fit`` and ``sample_smc`` over
  J_SMC_PARTICLES prior draws (the cloud's likelihood and every leapfrog
  one folded call), and ``examples.config3_complex_advi.main`` at its N =
  512, cut to J_EXAMPLE_STEPS steps; the call counts gated, folded rows
  held against one-theta calls, and the gradient kernels against their
  plain versions on the ADVI and SMC folded plans;
- ds_kernels: the exact-mode kernels against their plain versions at every
  width and on the plans of main path D and sampler_D (1, 4 and 16
  chains), timed there, and the sweep of the directions a launch
  (tan_chunk);
- D: exact mode, ``build_logprob(..., precision="ds")`` for config[2] at
  N = 1e5: ``value_and_grad`` (one theta) and ``value_and_grad_batch``
  (16 thetas folded), held against the float64 fused4 route;
- sampler_D: dense-mass NUTS (``inference.sample_nuts``) in exact mode over
  SAMPLER_D_CHAINS folded chains, SAMPLER_D_WARMUP warmup and
  SAMPLER_D_SAMPLES sampling transitions, tree depth SAMPLER_WARMUP_DEPTH
  in warmup and SAMPLER_D_DEPTH in sampling;
- adjoint_kernels: the four adjoint kernels against their plain versions at
  padded widths 13 and 16 on a small plan and on main path E's own plans
  (1, 4 and 16 chains), timed there;
- E: config[2] with three oscillation modes (four SHO terms + jitter, P =
  16, 13 parameters) at N = 1e5, the adjoint route:
  ``build_logprob(...).value_and_grad`` (one theta) and
  ``value_and_grad_batch`` (16 thetas folded), float32 and float64, held
  against autograd through the plain adjoint pipeline and, on a 4096-point
  prefix, the sequential solver; with the lanes-a-chain sweep;
- sampler_E: dense-mass NUTS on E's log probability in float64 over 4
  folded chains, SAMPLER_E_WARMUP warmup and SAMPLER_E_SAMPLES sampling
  transitions, tree depth SAMPLER_WARMUP_DEPTH in warmup and
  SAMPLER_E_DEPTH in sampling;
- solver_kernels: the three pallas_solver kernels against their plain
  versions at padded widths 2, 8, 13 and 16 on small plans (an odd lane
  count and a padded tail) and on main path F's own plans, timed there;
- F: the log-likelihood value of wide models: E's model and data through
  ``build_logprob(...)(theta)`` and ``GP.log_likelihood`` (the value
  closure of the adjoint route, the three-pass kernels over the value
  plan), ``build_loglik(solver="pallas")`` on E's and B's models and on
  bench.py's model at N = 1e6 in float32, ``solver="blocked"`` on E's
  model, and config[2] with four modes (P = 20) through
  ``solver="auto"`` (the plain blocked solver), value and autograd
  gradient, float32 and float64; gated against the adjoint route's
  ``value_ok_grad``, the fused route and the sequential solver on a
  4096-point prefix;
- lane_sweep_F: the value plan's lanes a chain and the L of
  ``solver="pallas"`` and ``"blocked"``, the counts in turn over rounds;
- tangent_kernels: the single-sweep kernel (celerite_torch/csrc/fused.cu)
  and the three tangent kernels (celerite_torch/csrc/tangent.cu) against
  their plain versions at padded widths 2, 8, 13 and 16 on small plans
  and on main path G's own plans, timed there (the jac call's four
  launches and the single-sweep call's seven each by torch.profiler);
- G: ``fast_grad="tangent"``: ``build_logprob(..., fast_grad="tangent")``
  for config[2] (P = 8) and E's model (P = 16) at N = 1e5, one theta's
  value, ``value_and_grad`` and ``value_and_grad_batch`` over 16 thetas,
  float32 and float64, held against the fused4 and adjoint routes; and
  ``ops.best_ll`` at P = 8 against ``blocked``;
- lane_sweep_G: the tangent route's lanes a chain;
- sampler_G: dense-mass NUTS on config[2] through the tangent route over
  SAMPLER_G_CHAINS folded chains, SAMPLER_G_WARMUP warmup and
  SAMPLER_G_SAMPLES sampling transitions, tree depth SAMPLER_WARMUP_DEPTH
  in warmup and SAMPLER_G_DEPTH in sampling;
- onepass_kernels: the three one-pass kernels against their plain
  versions at padded widths 2, 8 and 16 on small plans and on main path
  H's own plans, timed there;
- H: the one-pass solver, ``ops.onepass.gp_log_likelihood`` in float64:
  config[2] (P = 8) and E's model (P = 16) on B's data at N = 1e5, value
  and autograd gradient, held against the fused4 and adjoint routes;
  bench.py's model at N = 1e6, the value; float32 printed, not gated;
- I: the GP facade on the card (``GP.compute``, ``apply_inverse``, ``dot``,
  ``dot_L``, ``sample``, ``predict``, ``get_matrix``; the factor on the
  three-pass kernels) for config[2] at N = 1e5, held against the CPU
  float64 route and, on a 4096-point prefix, the sequential solver;
- K: ``GP.predict(..., return_var=True)`` for config[2] at N = 1e5 (the
  blocked Kalman/RTS engine of ``ops/pkalman``, sorted and shuffled test
  points) held against the lag-state mean, ``GP.log_likelihood`` and the
  dense variance, the blocked and flat engines against the sequential
  one, their timings (and A's N = 1e6), ``sample_prior``,
  ``CARMASolver`` against its CPU route and its celerite conversion, and
  ``utils.check_backends_agree`` with the three-pass kernels (which
  launches subst);
- L: the light-curve fleet (BASELINE config[4]) at benchmarks/
  fleet_smc.py's size, 10,240 curves of 96-160 points, one lane a curve:
  ``data.make_fleet_loglik`` at one chain (per-curve ll and the shared
  gradient, float64 and float32) against the CPU route, at 16 folded
  chains against one-chain calls, the config[4] example's ``sample_smc``
  and ``inference.sample_nuts_batch`` on per-curve fits; then rows 1-5
  against their plain versions on the fleet plans (pad lanes included)
  and the fleet's value and gradient timed and profiled;
- M: general (A, U, V) blocks (benchmarks/general_row.py's data and its
  two SHO terms as ComplexTerms, padded width 4) at general rank 4, 9 and
  14 (P = 8 at N = 65,536, 13 at 16,384, 18 at 4,096): ``GP.compute``
  (the three-pass factor), ``build_loglik`` by "auto", "fused", "pallas"
  and ``fast_grad`` True and "tangent", value and gradient against the
  CPU float64 ``blocked`` route, float32 against float64, "fused" raising
  above P = 16; ``dot``, ``apply_inverse``, ``predict(return_var=True)``
  and ``sample`` on 4,096 points against the dense K; ``sample_nuts`` on
  that model; then rows 8-18 against their plain versions on the phi = 1
  streams and each route's value and gradient timed and profiled.

Each main path resets every kernel's launch counter just before it runs and
reads the counters just after; a kernel of the path that did not launch
fails the run.

Prints one JSON line per phase, a ``redesigned_kernels`` line (ptxas's
registers and spills and the timings of the kernels redesigned for the
card and of those sharing their code, beside the card's name and power
limit), a ``kernels`` line, the card's name and power limit as
nvidia-smi gives them, and last
``{"ok": true, "device": {...}}``.  Any failure raises and exits non-zero;
without a CUDA device it exits non-zero before printing anything.
"""

import concurrent.futures
import contextlib
import ctypes
import functools
import io
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

import celerite_torch
from celerite_torch import _build, data, inference, ops, terms
from celerite_torch.examples import config3_complex_advi, config4_pod_smc
from celerite_torch.inference import adaptation, advi, diagnostics, optimize
from celerite_torch.ops import (adjoint, blocked, dsfused, fused, fused4,
                                lanes, lanes4, onepass, pallas_solver,
                                pkalman, smoother, tangent)
from celerite_torch.ops.lower import Coefficients, lower
from celerite_torch.testing import (CASES, bench_kernel, blocked_streams,
                                    compare_adjoint_kernels,
                                    compare_ds_kernels, compare_fused_kernel,
                                    compare_grad_kernels,
                                    compare_onepass_kernels,
                                    compare_solver_kernels,
                                    compare_tangent_kernels, config2_kernel,
                                    general_kernel, general_lane_streams,
                                    general_problem, lane_tangent_streams,
                                    make_data,
                                    onepass_cotangents, onepass_f32_floor,
                                    pack_values, pack_values_ds, wide_kernel,
                                    width_kernel)
from celerite_torch.utils import check_backends_agree

# H100 SXM published peaks (NVIDIA data sheet, dense): memory rate and the
# non-tensor-core float rates.
PEAK_BYTES_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}
WIDTHS = (1, 2, 4, 8)           # padded widths this script runs
# fused4_grad.cu and fused4_primal.cu are also built at every other width
# they take, fused.cu at every width the port takes it, for ptxas's figures
# in the redesigned_kernels line.
GRAD_PTXAS_WIDTHS = tuple(range(1, 13))
FUSED_PTXAS_WIDTHS = tuple(range(1, 9))
# Clock cycles a queued timing spins before its calls (~20 ms at the
# H100's 1.98 GHz): more than the host takes to queue them.
QUEUE_CYCLES = 40_000_000
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
# The exact-mode kernels against their plain versions, every output against
# its largest reference value, as the gradient kernels are held; each word's
# error against its own scale is reported beside it.
DS_F64_RTOL = 1e-10
# The adjoint kernels against their plain versions, every output against
# its largest reference value: float64, and float32 kernel against
# float32 plain on the same plan, ten times the largest reading on the
# small plans (6.9e-5) and on main path E's 782-step plans (2.65e-4;
# float32 plain is itself up to 1.8e-4 from float64 there), PERF.md.
ADJ_F64_RTOL = 1e-10
ADJ_F32_RTOL = 7e-4
ADJ_F32_PATH_RTOL = 3e-3
# The three-pass kernels against their plain versions, every output
# against its largest reference value: float64, and float32 kernel against
# float32 plain on the same streams, ten times the largest reading on the
# small plans (1.04e-4, factor's w at P = 13) and on main path F's plans
# (7.4e-5 on the value plan's 782-step lanes), PERF.md; float32 plain is
# itself up to 1.7e-4 from float64 there, reported beside it.
SOLVER_F64_RTOL = 1e-10
SOLVER_F32_RTOL = 1.05e-3
SOLVER_F32_PATH_RTOL = 7.5e-4
# The single-sweep kernel and the tangent kernels against their plain
# versions, every output against its largest reference value: float64, and
# float32 kernel against float32 plain on the same inputs, ten times each
# kernel's largest reading on the small plans and main path G's plans
# (PERF.md).  The float32 plain version's own distance from float64 is
# reported beside each reading: factor_jvp's dq0 at P = 13 read 1.26e-2
# against float32 plain's own 1.17e-2, the tangent of a sum whose terms
# cancel.
TANGENT_F64_RTOL = 1e-10
TANGENT_F32_RTOL = {"fused": 9.4e-5, "elements_jvp": 5.1e-4,
                    "factor_jvp": 0.13, "jac": 1.3e-3}
# The CUDA kernels of csrc/*.cu, by their names in a profile (the primal
# runs elem_fwd_kernel and factor_fwd_kernel without saves).
PORT_KERNELS = ("primal_scan_kernel", "primal_seed_kernel",
                "primal_assemble_kernel") + tuple(
    k + "_kernel" for k in fused4.GRAD_KERNELS + dsfused.DS_KERNELS) + tuple(
    "adjoint_" + k + "_kernel" for k in adjoint.ADJOINT_KERNELS) + tuple(
    "solver_" + k + "_kernel" for k in pallas_solver.SOLVER_KERNELS) + tuple(
    "fused_" + k + "_kernel" for k in ("elements", "chunk", "spine", "seed",
                                       "factor", "quad", "assemble")) + tuple(
    "jac_" + k + "_kernel" for k in ("elements", "seed", "factor",
                                     "assemble")) + (
    "onepass_sweep_kernel", "onepass_fwd_kernel", "onepass_bwd_kernel")
SAMPLER_CHAINS = 16
# sampler_C's warmup and sampling transitions (nuts_config2.py's HMC
# settings; each cut from 60 to 40 to make room for main path G, and the
# sampling 40 -> 16 for main path J, PERF.md §4).
SAMPLER_C_WARMUP = 40
SAMPLER_C_SAMPLES = 16
# Directions a launch swept on main path D's 16-chain plan (C = 17 at
# config[2]).
TAN_SWEEP = (1, 2, 4, 8, 17)
# sampler_D's chains, transitions and sampling tree depth, cut to keep the
# whole script well inside its 1200 s limit: its sampling trees reach the
# depth cap (at 8, 255 leapfrogs a transition, half the phase's ~300 s; at
# 6, 63), and 16 chains took ~175 s, 8 chains ~100 s, so 4 (PERF.md).
# Fewer than 20 warmup
# transitions leave one dual-averaging update after the metric is set, and
# 4 draws are the fewest split R-hat takes.
SAMPLER_D_CHAINS = 4
SAMPLER_D_WARMUP = 20
SAMPLER_D_SAMPLES = 4
SAMPLER_D_DEPTH = 6
# The NUTS samplers' (D, E, G) warmup tree depth: warmup is most of each
# phase (on a slow host 93 of sampler_D's 114 s, 58 of E's 59, 40 of G's
# 53 at depth 6), so 6 -> 5 gave the script back margin under its 1200 s
# limit when main path J came in (PERF.md §4).
SAMPLER_WARMUP_DEPTH = 5
# Padded widths of the adjoint kernels this script builds and holds, lanes
# a chain swept on main path E, and sampler_E's chains (the example's
# --chains default, examples/config2_asteroseismic.py) and transitions,
# cut to keep the phase near two minutes (PERF.md): 20 warmup transitions
# as sampler_D's and sampler_G's, since a run on a slow host took 1106 s
# of the 1200 (PERF.md §4).
WIDE_WIDTHS = (13, 16)
E_LANES = (64, 128, 256, 512, 1024)
SAMPLER_E_CHAINS = 4
SAMPLER_E_WARMUP = 20
SAMPLER_E_SAMPLES = 4
# sampler_E's sampling tree depth: 6, as sampler_D's and sampler_G's (the
# example's 8 took ~35 s of sampling for 4 transitions, PERF.md §4).
SAMPLER_E_DEPTH = 6
# Padded widths of the three-pass kernels this script builds and holds, and
# main path F's sweeps: the value plan's lanes a chain, the L of
# solver="pallas" and solver="blocked", the counts in turn over rounds.
SOLVER_WIDTHS = (2, 8, 13, 16)
F_LANES = (64, 128, 256, 512, 1024, 2048, 4096)
F_BLOCKS = (64, 128, 256, 512, 1024, 2048)
F_SWEEP_ROUNDS = 2
# Padded widths of the single-sweep kernel and of the tangent kernels this
# script builds and holds, main path G's lanes a chain swept, and
# sampler_G's chains and transitions (config[2]'s NUTS settings cut as
# sampler_D's are, PERF.md).
FUSED_WIDTHS = (2, 8)
TANGENT_WIDTHS = (2, 8, 13, 16)
G_LANES = (32, 64, 128, 256, 512)
SAMPLER_G_CHAINS = 4
SAMPLER_G_WARMUP = 20
SAMPLER_G_SAMPLES = 4
SAMPLER_G_DEPTH = 6
# The floors the NUTS samplers' (D, E, G) sampling transitions must clear:
# their mean acceptance, and at least one of them not divergent.  A warmup
# too short to adapt the step after the metric is set fails them: at 16
# warmup transitions sampler_E read 0.0 and sampler_G 0.016 with 16 and 15
# of 16 divergent; at 20, E 0.034, G 0.27 and D 0.73 (PERF.md §4).
SAMPLER_ACCEPT_FLOOR = 0.02
# The plan each new kernel's line in the kernels JSON is timed on: where
# most of its launches run (main path G's value plan, sampler_G's 4-chain
# plan, G's folded batch of E's model).
TANGENT_ROW_PLAN = {"fused": "value_plan_B_float64",
                    "jac": "sampler4_B_float64",
                    "elements_jvp": "batch_E_float64",
                    "factor_jvp": "batch_E_float64"}


T_START = time.perf_counter()


def emit(phase, **fields):
    """One JSON line; ``t_s`` is the seconds since the script started."""
    print(json.dumps({"phase": phase, **fields,
                      "t_s": round(time.perf_counter() - T_START, 1)}),
          flush=True)


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


def _template_args(s, i):
    """The template arguments of a mangled name from s[i] (just past its
    ``I``) to the matching ``E``, as text: bools, ints, float / double and
    class templates; returns ``(args, index past the E)``."""
    args = []
    while i < len(s) and s[i] != "E":
        if s[i] == "L":
            j = s.index("E", i)
            tok = s[i + 1:j]
            args.append({"b0": "false", "b1": "true"}.get(tok, tok.lstrip("i")))
            i = j + 1
        elif s[i] in "df":
            args.append({"d": "f64", "f": "f32"}[s[i]])
            i += 1
        elif s[i].isdigit():
            n = re.match(r"\d+", s[i:]).group()
            i += len(n)
            name = s[i:i + int(n)]
            i += int(n)
            if i < len(s) and s[i] == "I":
                sub, i = _template_args(s, i + 1)
                name += "<" + ",".join(sub) + ">"
            args.append(name)
        else:
            return args + [s[i:]], len(s)
    return args, i + 1


def kernel_name(mangled):
    """A kernel's name in ptxas's summary: ``kernel<[threads a lane,]
    dtype or tan/value[, warps a block]>`` for the templates that have
    those arguments, else its name and template arguments as text."""
    tags = {"f": "f32", "d": "f64", "Lb1E": "tan", "Lb0E": "value"}
    m = re.match(r"_Z\d+(\w+?)I(?:Li(\d+)E)?([df]|Lb[01]E)(?:Li(\d+)E)?Ev",
                 mangled)
    if m:
        return "{0}<{1}{2}{3}>".format(
            m.group(1), "" if m.group(2) is None else m.group(2) + ",",
            tags[m.group(3)], "" if m.group(4) is None else "," + m.group(4))
    m = re.match(r"_Z(\d+)", mangled)
    start = m.end() + int(m.group(1))
    name = mangled[m.end():start]
    if mangled[start:start + 1] == "I":
        args, _ = _template_args(mangled, start + 1)
        name += "<" + ",".join(args) + ">"
    return name


def ptxas_summary(path):
    """{kernel name (``kernel_name``): {"registers", "spill_stores",
    "spill_loads"}}."""
    out, cur, props = {}, None, None
    for line in path.read_text().splitlines():
        m = re.search(r"Compiling entry function '(_Z\w+)'", line)
        if m:
            cur = kernel_name(m.group(1))
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


def sync_time_ms(fn, reps, warm=2, queued=False):
    """Mean ms per call by CUDA events around ``reps`` back-to-back calls.
    With ``queued`` the calls are queued behind a kernel that spins for
    QUEUE_CYCLES, so that the card runs them back to back and the host's
    work between launches stays off the clock (kernels shorter than their
    wrapper's call).  Raises if the spin ended before the last call was
    queued, which would put the host's gaps back on the clock."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    spun_out = queued and start.query()
    end.record()
    end.synchronize()
    if spun_out:
        raise RuntimeError(
            "queued timing: the card reached the first call before the host "
            "had queued the last; raise QUEUE_CYCLES")
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
            m = re.match(r"(?:void )?(\w+)[<(]", e.key)
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
    return kernel_cf(gp.kernel, theta[:gp.kernel.full_size])


def kernel_cf(kernel, kp):
    """The float64 packed coefficients of ``kernel`` at its parameters
    ``kp``."""
    return lanes4.pack_cf(Coefficients(*kernel.get_padded_coefficients(kp),
                                       jitter=kernel.get_jitter(kp)),
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


def ds_counts():
    return {name: getattr(dsfused, name + "_cuda").launches
            for name in dsfused.DS_KERNELS}


def reset_counts():
    fused4.primal_cuda.launches = 0
    for name in fused4.GRAD_KERNELS:
        getattr(fused4, name + "_cuda").launches = 0
    for name in dsfused.DS_KERNELS:
        getattr(dsfused, name + "_cuda").launches = 0
    for name in adjoint.ADJOINT_KERNELS:
        getattr(adjoint, name + "_cuda").launches = 0
    for name in pallas_solver.SOLVER_KERNELS:
        getattr(pallas_solver, name + "_cuda").launches = 0
    fused.kernel_cuda.launches = 0
    for name in tangent.TANGENT_KERNELS:
        getattr(tangent, name + "_cuda").launches = 0
    for name in onepass.ONEPASS_KERNELS:
        getattr(onepass, name + "_cuda").launches = 0


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


def sampler_c(lp, theta, dev, warmup=SAMPLER_C_WARMUP,
              samples=SAMPLER_C_SAMPLES, leapfrog=8):
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
    # second half but its last 15 transitions feeds the dense covariance, and at
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


# ---------------------------------------------------------------------------
# Main path J: ADVI with its Laplace check, MAP fitting and SMC on
# config[2] (the folded gradient kernels), and the config[3] example
# ---------------------------------------------------------------------------

# Steps of laplace_fit (Adam at J_LAPLACE_LR), of fit_advi (J_ADVI_MC draws
# a step) and of map_fit; SMC's particles and settings; the config[3]
# example's steps (examples/config3_complex_advi.py runs 3000).
J_LAPLACE_STEPS = 150
J_LAPLACE_LR = 2e-2
J_ADVI_STEPS = 150
J_ADVI_MC = 8
J_MAP_STEPS = 50
J_SMC_PARTICLES = 128
J_SMC = {"num_mutations": 2, "num_leapfrog": 4, "max_stages": 6}
J_EXAMPLE_STEPS = 100
# The Laplace Hessian's folded call against 2 dim one-theta calls, against
# its largest entry: the same kernels on a 16-chain and a one-chain plan
# (a chain's lanes are the same in both).
J_HESS_RTOL = 1e-8
# Rows of ADVI's and SMC's folded calls on the main path's own inputs
# against one-theta calls, value and gradient each against its largest
# entry: a chain's lanes are the same as the one-chain plan's, so the two
# differ at most by rounding (the Hessian's reads 0).
J_ROWS_RTOL = 1e-12


class CountedLogprob:
    """A log probability passed through unchanged, counting its
    value-and-gradient calls, the rows of its batched ones and each batched
    call's row count (``rows_per_call``, the distinct counts)."""

    def __init__(self, lp):
        self.lp = lp
        self.calls = self._zero()

    @staticmethod
    def _zero():
        return {"value_and_grad": 0, "value_and_grad_batch": 0, "rows": 0,
                "rows_per_call": []}

    def __call__(self, theta):
        return self.lp(theta)

    def value_and_grad(self, theta):
        self.calls["value_and_grad"] += 1
        return self.lp.value_and_grad(theta)

    def value_and_grad_batch(self, thetas):
        self.calls["value_and_grad_batch"] += 1
        self.calls["rows"] += thetas.shape[0]
        if thetas.shape[0] not in self.calls["rows_per_call"]:
            self.calls["rows_per_call"].append(thetas.shape[0])
        return self.lp.value_and_grad_batch(thetas)

    def take(self):
        out, self.calls = self.calls, self._zero()
        return out


def fold_chunk(rows, cap):
    """The chains of each folded call ``value_and_grad_batch`` makes of
    ``rows`` rows: the power of two above, at most ``cap``."""
    return min(1 << max(0, rows - 1).bit_length(), cap)


def rows_vs_one_theta(lp, qs, picks):
    """Rows ``picks`` of one folded ``value_and_grad_batch(qs)`` call
    against one-theta ``value_and_grad`` calls: the largest relative
    difference of the value and of the gradient (each against its largest
    entry), inf where their finite entries differ in place."""
    lp_b, g_b = lp.value_and_grad_batch(qs)
    worst = 0.0
    for i in picks:
        lp1, g1 = lp.value_and_grad(qs[i])
        for a, b in ((lp_b[i].reshape(1), lp1.reshape(1)), (g_b[i], g1)):
            fin = torch.isfinite(b)
            if not torch.equal(torch.isfinite(a), fin):
                return math.inf
            if bool(fin.any()):
                worst = max(worst, float((a[fin] - b[fin]).abs().max()
                                         / b[fin].abs().max().clamp_min(
                                             1e-300)))
    return worst


def grad_kernels_on_j(gp, grad_errs, plans, around):
    """The gradient kernels on the folded plans phase J launches them on
    that main path C did not check: each kernel against its plain version
    (grad_kernel_vs_plain, case ``main_path_J``) on ``nc`` rows of
    ``around + 0.02 N(0, 1)``, float64.  ``plans``: ``{tag: (plan, nc)}``.
    """
    pr, pc = gp.kernel.padded_size
    gen = torch.Generator(device=around.device).manual_seed(6)
    for tag, (plan, nc) in plans.items():
        ths = around[None] + 0.02 * torch.randn(
            nc, around.shape[0], generator=gen, dtype=around.dtype,
            device=around.device)
        cf = torch.stack([packed_cf(gp, th) for th in ths])
        grad_case(grad_errs, "main_path_J", cf, plan, pr, pc, n=plan.n,
                  n_chain=nc, lanes=plan.t.shape[1],
                  steps_per_lane=plan.t.shape[0], call=tag)


def timed(fn):
    """``(fn(), seconds)``, synchronized on the card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def all_finite(*xs):
    return all(bool(torch.isfinite(torch.as_tensor(x)).all()) for x in xs)


def main_path_j(gp, lp, prior, theta, t, y, yerr, dev, grad_errs):
    """config[2] at B's data (N = 1e5, float64) through the inference
    engine's entry points: ``laplace_fit``, ``fit_advi``, ``map_fit`` and
    ``sample_smc`` (prior draws, the likelihood's and the tempered target's
    batched entries folded onto the gradient kernels' lanes), and
    ``examples.config3_complex_advi.main`` at its own N = 512.

    Gates: finite results; the ELBO's mean over the last 10% of steps above
    the first 10%'s; |grad| at the Laplace mode below |grad| at the start;
    ``cov`` symmetric to 1e-10 and positive definite; the Hessian's folded
    call against 2 dim one-theta calls to J_HESS_RTOL; SMC's temperature
    strictly rising, its evidence finite and its last acceptance in (0.05,
    1]; one batched call a step for ADVI (J_ADVI_MC rows), one of 2 dim
    rows for the Hessian and J_SMC_PARTICLES rows in every SMC call; rows
    of an ADVI-sized and an SMC-sized folded call on the path's own draws
    against one-theta calls to J_ROWS_RTOL; each of fused4's four gradient
    kernels launched.  After the counts are read, the kernels are held
    against their plain versions on the ADVI and SMC folded plans (the
    Hessian's 2 dim rows fold onto C's 16-chain plan of the same closure,
    checked there)."""
    t_j = time.perf_counter()
    reset_counts()
    target = CountedLogprob(lp)
    dim = theta.shape[0]
    g_start = lp.value_and_grad(theta)[1]
    (mode, cov), s_lap = timed(lambda: inference.laplace_fit(
        target, theta, num_steps=J_LAPLACE_STEPS,
        learning_rate=J_LAPLACE_LR))
    calls_lap = target.take()
    g_mode = lp.value_and_grad(mode)[1]
    hess = advi._fd_hessian(lp.value_and_grad_batch, mode)
    h = 1e-4 * (1.0 + torch.abs(mode))
    eye = torch.eye(dim, dtype=mode.dtype, device=dev)
    cols = torch.stack([-(lp.value_and_grad(mode + h[i] * eye[i])[1]
                          - lp.value_and_grad(mode - h[i] * eye[i])[1])
                        / (2.0 * h[i]) for i in range(dim)])
    one_theta = 0.5 * (cols + cols.T)
    e_hess = float((hess - one_theta).abs().max() / one_theta.abs().max())
    e_sym = float((cov - cov.T).abs().max() / cov.abs().max())
    eig = torch.linalg.eigvalsh(0.5 * (cov + cov.T))

    gen = torch.Generator(device=dev).manual_seed(2030)
    res, s_advi = timed(lambda: inference.fit_advi(
        target, theta, gen, num_steps=J_ADVI_STEPS, num_mc=J_ADVI_MC))
    calls_advi = target.take()
    k = max(1, J_ADVI_STEPS // 10)
    elbo_first = float(res.elbo_trace[:k].mean())
    elbo_last = float(res.elbo_trace[-k:].mean())
    sd_laplace = torch.sqrt(torch.diagonal(cov))
    drift_sd = float((torch.abs(res.mu - mode) / sd_laplace).max())

    gp_map = celerite_torch.GP(config2_kernel(terms))
    (params, trace), s_map = timed(lambda: optimize.map_fit(
        gp_map, t, y, yerr=yerr, log_prior=prior, num_steps=J_MAP_STEPS))

    def flat(th):
        return torch.zeros((), dtype=th.dtype, device=th.device)

    like = CountedLogprob(gp.build_logprob(t, y, yerr=yerr, log_prior=flat))

    def prior_rows(qs):
        return (-0.5 * torch.sum((qs / 3.0) ** 2, dim=-1), -qs / 9.0)

    prior_smc = lambda th: prior(th)  # noqa: E731
    prior_smc.value_and_grad_batch = prior_rows
    init = 3.0 * torch.randn(J_SMC_PARTICLES, dim, generator=gen,
                             dtype=theta.dtype, device=dev)
    smc_res, s_smc = timed(lambda: inference.sample_smc(
        prior_smc, like, init, gen, **J_SMC))
    calls_smc = like.take()

    captured = io.StringIO()
    with contextlib.redirect_stdout(captured):
        example, s_example = timed(lambda: config3_complex_advi.main(
            num_steps=J_EXAMPLE_STEPS))
    counts = grad_counts()
    betas = smc_res.betas.tolist()

    # Launches below compare; they are not the path's.
    nc_advi = fold_chunk(J_ADVI_MC, lp.loglik.value_ok_grad_batch.fold_cap)
    fold_cap = like.lp.loglik.value_ok_grad_batch.fold_cap
    nc_smc = fold_chunk(J_SMC_PARTICLES, fold_cap)
    nc_hess = fold_chunk(2 * dim, lp.loglik.value_ok_grad_batch.fold_cap)
    plans = {"fit_advi": (lp.loglik.value_ok_grad_batch.folded_plan(nc_advi),
                          nc_advi),
             "sample_smc": (like.lp.loglik.value_ok_grad_batch.folded_plan(
                 nc_smc), nc_smc)}
    grad_kernels_on_j(gp, grad_errs, plans, mode)
    e_rows_advi = rows_vs_one_theta(lp, res.sample(gen, J_ADVI_MC),
                                    (0, J_ADVI_MC - 1))
    picks = sorted({0, nc_smc - 1, min(nc_smc, J_SMC_PARTICLES - 1),
                    J_SMC_PARTICLES - 1})
    e_rows_smc = rows_vs_one_theta(like.lp, smc_res.particles, picks)
    emit("main_path_J", model="config[2] 2xSHO + jitter (P=8)", n=len(t),
         dtype="float64",
         laplace={"steps": J_LAPLACE_STEPS, "seconds": s_lap,
                  "ms_per_step": 1e3 * s_lap / J_LAPLACE_STEPS,
                  "calls": calls_lap, "mode": mode.tolist(),
                  "sd": sd_laplace.tolist(),
                  "grad_norm_start": float(g_start.norm()),
                  "grad_norm_mode": float(g_mode.norm()),
                  "rel_err_hessian_folded_vs_one_theta": e_hess,
                  "hessian_rows_fold_onto": nc_hess,
                  "cov_asymmetry": e_sym, "cov_eigenvalues": eig.tolist()},
         advi={"steps": J_ADVI_STEPS, "num_mc": J_ADVI_MC,
               "seconds": s_advi, "ms_per_step": 1e3 * s_advi / J_ADVI_STEPS,
               "calls": calls_advi, "mu": res.mu.tolist(),
               "sigma": res.sigma.tolist(), "elbo_first_10pct": elbo_first,
               "elbo_last_10pct": elbo_last,
               "drift_in_laplace_sd": drift_sd,
               "rel_err_rows_folded_vs_one_theta": e_rows_advi},
         map_fit={"steps": J_MAP_STEPS, "seconds": s_map,
                  "ms_per_step": 1e3 * s_map / J_MAP_STEPS,
                  "params": params.tolist(), "logprob_first": float(trace[0]),
                  "logprob_last": float(trace[-1])},
         smc={"particles": J_SMC_PARTICLES, **J_SMC, "seconds": s_smc,
              "stages": smc_res.num_stages,
              "ms_per_stage": 1e3 * s_smc / max(1, smc_res.num_stages),
              "calls": calls_smc,
              "ms_per_batched_call": 1e3 * s_smc / max(
                  1, calls_smc["value_and_grad_batch"]),
              "fold_cap": fold_cap, "chains_per_call": nc_smc,
              "rel_err_rows_folded_vs_one_theta": e_rows_smc,
              "betas": betas, "beta_reached": betas[-1] if betas else 0.0,
              "log_evidence": float(smc_res.log_evidence),
              "final_accept": float(smc_res.final_accept)},
         example_config3={"n": 512, "steps": J_EXAMPLE_STEPS,
                          "seconds": s_example,
                          "drift_in_laplace_sd": example["drift_sd"],
                          "printed": captured.getvalue().splitlines()},
         launches=counts, seconds=time.perf_counter() - t_j)
    ex = example["advi"]
    if not all_finite(mode, cov, g_mode, res.mu, res.sigma, res.elbo_trace,
                      params, trace, smc_res.particles,
                      smc_res.log_evidence, ex.mu, ex.sigma, ex.elbo_trace,
                      example["mode"], example["cov"]):
        fail("main path J gave a non-finite result")
    if not elbo_last > elbo_first:
        fail("main path J: the ELBO did not improve ({0} -> {1})".format(
            elbo_first, elbo_last))
    if not float(g_mode.norm()) < float(g_start.norm()):
        fail("main path J: |grad| at the Laplace mode is not below the "
             "start's")
    if e_sym > 1e-10 or not float(eig.min()) > 0:
        fail("main path J: the Laplace covariance is not symmetric positive "
             "definite (asymmetry {0}, eigenvalues {1})".format(
                 e_sym, eig.tolist()))
    if e_hess > J_HESS_RTOL:
        fail("main path J: the folded Hessian call is {0} from one-theta "
             "calls".format(e_hess))
    if not (betas and all(b > a for a, b in zip([0.0] + betas, betas))):
        fail("main path J: SMC's temperature did not rise: {0}".format(
            betas))
    if not 0.05 < float(smc_res.final_accept) <= 1.0:
        fail("main path J: SMC's last acceptance {0} outside (0.05, 1]"
             .format(float(smc_res.final_accept)))
    want_lap = {"value_and_grad": J_LAPLACE_STEPS, "value_and_grad_batch": 1,
                "rows": 2 * dim, "rows_per_call": [2 * dim]}
    want_advi = {"value_and_grad": 0, "value_and_grad_batch": J_ADVI_STEPS,
                 "rows": J_ADVI_STEPS * J_ADVI_MC,
                 "rows_per_call": [J_ADVI_MC]}
    if calls_lap != want_lap or calls_advi != want_advi:
        fail("main path J: laplace_fit / fit_advi made {0} / {1} calls, "
             "not {2} / {3}".format(calls_lap, calls_advi, want_lap,
                                    want_advi))
    if (calls_smc["value_and_grad"] != 0
            or calls_smc["rows_per_call"] != [J_SMC_PARTICLES]):
        fail("main path J: sample_smc's calls were not all of the whole "
             "cloud: {0}".format(calls_smc))
    if nc_hess != SAMPLER_CHAINS:
        fail("main path J: the Hessian's {0} rows fold onto a {1}-chain "
             "plan, which C did not check".format(2 * dim, nc_hess))
    if not max(e_rows_advi, e_rows_smc) <= J_ROWS_RTOL:
        fail("main path J: folded rows differ from one-theta calls (ADVI "
             "{0}, SMC {1})".format(e_rows_advi, e_rows_smc))
    if min(counts.values()) < 1:
        fail("main path J did not launch every gradient kernel: "
             "{0}".format(counts))
    return counts


# ---------------------------------------------------------------------------
# Exact mode: the dsfused kernels (celerite_torch/csrc/dsfused.cu), main
# path D and sampler_D
# ---------------------------------------------------------------------------

DS_REPLACES = {
    "elem_ds": "celerite_tpu/ops/dsfused.py:379",
    "factor_ds": "celerite_tpu/ops/dsfused.py:432",
}


def packed_cf_ds(gp, theta):
    """The exact-mode packed coefficients (raw jitter last) for ``theta``."""
    kp = theta[:gp.kernel.full_size]
    return dsfused.pack_cf_ds(Coefficients(
        *gp.kernel.get_padded_coefficients(kp),
        jitter=gp.kernel.get_jitter(kp)))


def ds_bound_ms(name, plan, jr, jc, T, rows=1):
    """Least time for one launch of exact-mode kernel ``name`` over ``T``
    directions: max(bytes / rate, operations / float64 peak).

    Bytes: the (L, B) streams the kernel reads (five, six with y), its
    coefficient rows, the factor's 1 + T seed words, and the (1 + T)
    output words a lane written once.  Operations per point (an fma two),
    what the function needs, not what the kernel does: the value step once
    and the tangent step once a direction.  The value: the lowering, the
    Riccati step (Phi Sh Phi 2p^2, S u 2p^2, d w w^T 2p^2) and the element
    update (uA 2p^2, A 3p^2, J 2p^2) or the factor's (g 2p^2, M 3p^2,
    Qm 2p^2).  A tangent, along a unit seed that moves one or two columns:
    Phi dSh Phi 2p^2, dS u 2p^2, the tangent of d w w^T as x w^T + w y^T
    4p^2, then elem's duA 2p^2, dA 5p^2 and dJ 4p^2 or the factor's dg
    2p^2, dM 5p^2 and dQm 4p^2; every term of the seed (the lowering's
    tangent, S or A or M on the seed's rows or columns) is O(p).
    """
    L, b = plan.t.shape
    p = jr + 2 * jc
    c = dsfused.cf_len(jr, jc)
    pts = L * b
    w = 1 + T
    lower = jr * 4 + jc * 40 + 3
    step = 6 * p * p + 4 * p + 1
    tan_step = 10 + 8 * p * p + 25 * p
    if name == "elem_ds":
        words = 5 * pts + c * rows + 3 * w * p * p * b
        per_point = lower + step + 7 * p * p + 2 * p \
            + T * (tan_step + 11 * p * p + 11 * p)
    else:
        words = 6 * pts + c * rows + w * p * p * b \
            + (w * (2 * p * p + 2 * p + 2) + 1) * b
        per_point = lower + step + 7 * p * p + 7 * p + 12 \
            + T * (tan_step + 11 * p * p + 24 * p + 18)
    t_bytes = words * 8 / PEAK_BYTES_S * 1e3
    t_ops = per_point * pts / PEAK_FLOPS[torch.float64] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def ds_case(ds_errs, tag, cf, plan, jr, jc, toff=0, T=None, **info):
    """Both exact-mode kernels against their plain versions, float64.
    Returns each plain version's ms."""
    errs = compare_ds_kernels(cf, plan, jr, jc, toff, T)
    emit("ds_kernel_vs_plain", case=tag, jr=jr, jc=jc, toff=toff,
         directions=dsfused.cf_len(jr, jc) - toff if T is None else T,
         limit=DS_F64_RTOL,
         max_rel_err={k: e["max_rel_err"] for k, e in errs.items()},
         max_rel_err_word={k: e["max_rel_err_word"] for k, e in errs.items()},
         outputs={k: e["outputs"] for k, e in errs.items()}, **info)
    for name, e in errs.items():
        ds_errs[name].append(e["max_abs_err"])
        if not e["max_rel_err"] <= DS_F64_RTOL:
            fail("{0} kernel disagrees with plain: {1} {2}".format(
                name, tag, (jr, jc, toff, T)))
    return {name: e["plain_ms"] for name, e in errs.items()}


def ds_kernel_calls(cf, plan, jr, jc):
    """{name: kernel call} over every direction, for timing."""
    seg = plan.t.shape[1] // (1 if cf.ndim == 1 else cf.shape[0])
    sh0 = dsfused.prefix_sh0_ds(*dsfused.elem_ds_cuda(cf, plan, jr, jc), seg)
    return {
        "elem_ds": lambda: dsfused.elem_ds_cuda(cf, plan, jr, jc),
        "factor_ds": lambda: dsfused.factor_ds_cuda(cf, plan, jr, jc, plan.y,
                                                    sh0),
    }


def check_ds_kernels(dev, gp, lpd, theta, thetas, ds_errs):
    """ds_kernels: both exact-mode kernels against their plain versions.

    At every width (CASES, N = 4099, 256 lanes) over all directions, one
    direction and none (the value launch); a chain-folded (4, C) batch;
    then on the plans main path D and sampler_D run them on
    (``folded_plan(1)``, ``(4)`` and ``(16)``), where each kernel and its
    plain version are timed and the bound computed; then the tan_chunk
    sweep at 16 chains.  Returns ``{nc: {name: row}}``.
    """
    run = functools.partial(ds_case, ds_errs)
    t, y, yerr = make_data(4099, seed=7, t_max=400.0)
    plan = dsfused.make_plan_ds(t, y, yerr**2, 256, device=dev)
    for jr, jc, vals in CASES:
        cf = torch.as_tensor(pack_values_ds(vals), device=dev)
        c = dsfused.cf_len(jr, jc)
        for toff, T in ((0, None), (c // 2, 1), (0, 0)):
            run("cases", cf, plan, jr, jc, toff, T, n=4099, lanes=256)
    jr, jc, vals = CASES[3]
    t, y, yerr = make_data(4099, seed=8, t_max=400.0)
    folded = dsfused.make_plan_ds(t, y, yerr**2, 64, n_chain=4, device=dev)
    cf = torch.as_tensor(pack_values_ds(vals), device=dev)
    run("folded", torch.stack([cf * s for s in (1.0, 0.9, 1.1, 1.2)]),
        folded, jr, jc, n=4099, lanes=256, n_chain=4)

    pr, pc = gp.kernel.padded_size
    c = dsfused.cf_len(pr, pc)
    cfs = torch.stack([packed_cf_ds(gp, th) for th in thetas])
    rows = {}
    for nc in (1, SAMPLER_D_CHAINS, SAMPLER_CHAINS):
        t_nc = time.perf_counter()
        plan = lpd.loglik.value_ok_grad_batch.folded_plan(nc)
        cf = packed_cf_ds(gp, theta) if nc == 1 else cfs[:nc]
        lanes, steps = plan.t.shape[1], plan.t.shape[0]
        plain_ms = run("main_path", cf, plan, pr, pc, n=plan.n, n_chain=nc,
                       lanes=lanes, steps_per_lane=steps)
        for name, kern in ds_kernel_calls(cf, plan, pr, pc).items():
            row = rows.setdefault(nc, {}).setdefault(name, {})
            row["ms"] = sync_time_ms(kern, reps=10)
            row["plain_ms"] = plain_ms[name]
            row["bound_ms"], row["bound_by"] = ds_bound_ms(name, plan, pr, pc,
                                                           c, rows=nc)
        emit("ds_kernel_time_D", n=plan.n, n_chain=nc, lanes=lanes,
             steps_per_lane=steps, directions=c, kernels=rows[nc],
             seconds=time.perf_counter() - t_nc)

    # Directions a launch: the whole value-and-gradient and its kernels.
    plan = lpd.loglik.value_ok_grad_batch.folded_plan(SAMPLER_CHAINS)
    seg = plan.t.shape[1] // SAMPLER_CHAINS
    sh0 = dsfused.prefix_sh0_ds(*dsfused.elem_ds_cuda(cfs, plan, pr, pc), seg)
    for chunk in TAN_SWEEP:
        fn = dsfused.build_ll_and_grad_ds(plan, pr, pc,
                                          n_chain=SAMPLER_CHAINS,
                                          tan_chunk=chunk)
        parts = [(o, min(chunk, c - o)) for o in range(0, c, chunk)]
        elem_ms = sum(sync_time_ms(
            lambda o=o, T=T: dsfused.elem_ds_cuda(cfs, plan, pr, pc, o, T),
            reps=3) for o, T in parts)
        factor_ms = sum(sync_time_ms(
            lambda o=o, T=T: dsfused.factor_ds_cuda(
                cfs, plan, pr, pc, plan.y,
                torch.cat([sh0[:1], sh0[1 + o:1 + o + T]]), o, T),
            reps=3) for o, T in parts)
        emit("tan_chunk_sweep_D", n_chain=SAMPLER_CHAINS, tan_chunk=chunk,
             launches_per_call=2 * len(parts),
             ms_call=sync_time_ms(lambda: fn(cfs), reps=3, warm=1),
             ms_elem_ds=elem_ms, ms_factor_ds=factor_ms)
    return rows


def lane_sweep_d(t, y, yerr, cf, cfs, pr, pc, dev):
    """Exact mode's value-and-gradient ms over lanes a chain, for one chain
    and for 16 folded: the kernels want many lanes, the glue few."""
    for nc, rows in ((1, cf), (SAMPLER_CHAINS, cfs)):
        for lanes in (64, 128, 256, 512, 1024):
            plan = dsfused.make_plan_ds(t, y, yerr**2, lanes, n_chain=nc,
                                        device=dev)
            fn = dsfused.build_ll_and_grad_ds(plan, pr, pc, n_chain=nc)
            emit("lane_sweep_D", n_chain=nc, lanes_per_chain=lanes,
                 steps_per_lane=plan.t.shape[0],
                 ms_call=sync_time_ms(lambda: fn(rows), reps=3, warm=1))
            del plan, fn


def main_path_d(gp, lpd, lp64, theta, thetas):
    """config[2] at N = 1e5 in exact mode: ``value_and_grad`` (one theta),
    ``value_and_grad_batch`` (16 folded) and the value closure, gated
    against the float64 fused4 route at the same thetas."""
    reset_counts()
    v1, g1 = lpd.value_and_grad(theta)
    vb, gb = lpd.value_and_grad_batch(thetas)
    v0 = lpd(theta)
    counts = ds_counts()
    others = dict(grad_counts(), primal=fused4.primal_cuda.launches)
    emit("main_path_D_launches", **counts, fused4=others)
    if min(counts.values()) < 3:
        fail("main path D did not launch every exact-mode kernel: "
             "{0}".format(counts))
    r1, rg1 = lp64.value_and_grad(theta)
    rb, rgb = lp64.value_and_grad_batch(thetas)
    e_value = max(rel(v1, r1), rel(v0, r1))
    e_grad = grad_rel(g1, rg1)
    e_bvalue = max(rel(vb[r], rb[r]) for r in range(SAMPLER_CHAINS))
    e_bgrad = max(grad_rel(gb[r], rgb[r]) for r in range(SAMPLER_CHAINS))
    spread = {
        "single": eval_spread_ms(lpd.value_and_grad, theta, batches=7,
                                 per_batch=5),
        "batch16": eval_spread_ms(lpd.value_and_grad_batch, thetas,
                                  batches=5, per_batch=3),
        "value_only": eval_spread_ms(lpd, theta, batches=5, per_batch=5),
    }
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lpd.value_and_grad_batch(thetas)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("main_path_D", model="config[2] 2xSHO + jitter (P=8)",
         precision="ds", route=lpd.loglik.route, n=lpd.loglik.plan.n,
         lanes_per_chain=lpd.loglik.plan.num_blocks,
         directions=dsfused.cf_len(*gp.kernel.padded_size),
         fold_cap=lpd.loglik.value_ok_grad_batch.fold_cap,
         logprob_ds=float(v1), logprob_f64_fused4=float(r1),
         rel_err_value_vs_f64_route=e_value,
         rel_err_grad_vs_f64_route=e_grad,
         rel_err_batch_value_vs_f64_route=e_bvalue,
         rel_err_batch_grad_vs_f64_route=e_bgrad,
         grad_ds=g1.tolist(), ms_per_call=spread,
         peak_mib_batch16=peak / 2**20)
    if not (math.isfinite(float(v1)) and bool(torch.isfinite(vb).all())
            and bool(torch.isfinite(g1).all())
            and bool(torch.isfinite(gb).all())):
        fail("main path D gave a non-finite log probability or gradient")
    if max(e_value, e_bvalue) > F64_RTOL:
        fail("main path D: log probability off the f64 route by "
             "{0}".format(max(e_value, e_bvalue)))
    if max(e_grad, e_bgrad) > GRAD_AUTOGRAD_RTOL:
        fail("main path D: gradient off the f64 route by "
             "{0}".format(max(e_grad, e_bgrad)))
    emit("profile_D", call="value_and_grad",
         **profile_evals(lpd.value_and_grad, theta, evals=5))
    emit("profile_D", call="value_and_grad_batch(16)",
         **profile_evals(lpd.value_and_grad_batch, thetas, evals=3))
    return counts


# ---------------------------------------------------------------------------
# Wide models: the adjoint kernels (celerite_torch/csrc/adjoint.cu), main
# path E and sampler_E
# ---------------------------------------------------------------------------

ADJ_REPLACES = {
    "elements_fwd": "celerite_tpu/ops/adjoint.py:63",
    "elements_bwd": "celerite_tpu/ops/adjoint.py:98",
    "factor_fwd": "celerite_tpu/ops/adjoint.py:188",
    "factor_bwd": "celerite_tpu/ops/adjoint.py:253",
}


def adjoint_counts():
    return {name: getattr(adjoint, name + "_cuda").launches
            for name in adjoint.ADJOINT_KERNELS}


def lane_streams(gp, plan, theta):
    """``(u, v, ph, a, y)`` of a lane plan for one theta, or one row a
    chain of a folded plan (the kernel's parameters; the mean is 0)."""
    kern, nk = gp.kernel, gp.kernel.full_size

    def coeffs(th):
        kp = th[:nk]
        return tuple(Coefficients(*kern.get_padded_coefficients(kp),
                                  jitter=kern.get_jitter(kp)))

    c = coeffs(theta) if theta.ndim == 1 else torch.func.vmap(coeffs)(theta)
    return (*lanes.lower_lanes(c, plan), plan.y)


def adjoint_bound_ms(name, u):
    """Least time for one launch of adjoint kernel ``name`` on streams
    shaped like ``u`` ``(L, P, B)``: max(bytes / rate, operations / peak).

    Bytes: the streams the kernel reads (u, v, ph and a, with y for the
    factor kernels), its saves written (forward) or read (backward), the
    per-lane seeds or cotangents it reads and the outputs it writes, each
    once.  Operations per point, counted from the kernels' code: the
    step's intermediates (S, su, d, w), the step's update or its
    transpose, once each.
    """
    L, p, b = u.shape
    it = u.element_size()
    pts, pp = L * b, p * p
    front = 4 * pp + 4 * p + 1
    adjoint_step = 16 * pp + 10 * p + 4   # F5-F1 (riccati_back)
    words, per_point = {
        "elements_fwd": ((3 * p + 1 + 2 * pp) * pts + 3 * pp * b,
                         front + 11 * pp + p),
        "elements_bwd": ((2 * (3 * p + 1) + 2 * pp) * pts + 3 * pp * b,
                         front + 13 * pp + 6 * p + adjoint_step),
        "factor_fwd": ((3 * p + 2 + 2 * pp + p) * pts
                       + (3 * pp + 2 * p + 1) * b,
                       front + 11 * pp + 12 * p + 14),
        "factor_bwd": ((3 * p + 2 + 2 * pp + p + 3 * p + 2) * pts
                       + (3 * pp + 2 * p + 2) * b,
                       front + 17 * pp + 12 * p + 30 + adjoint_step),
    }[name]
    t_bytes = (words * it + (2 * b * 8 if name == "factor_fwd" else 0)) \
        / PEAK_BYTES_S * 1e3
    t_ops = per_point * pts / PEAK_FLOPS[u.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def adjoint_bwd_layout(name, p, dtype):
    """The launch shape of adjoint backward kernel ``name`` at width ``p``
    and ``dtype``, as its library reports it: threads and lanes a block,
    dynamic shared memory in bytes a block, and blocks an SM at most (the
    occupancy API on this card)."""
    lib = _build.load("adjoint.cu", {"CELERITE_P": p})
    fn = getattr(lib, "celerite_adjoint_bwd_layout_{0}".format(
        "f32" if dtype == torch.float32 else "f64"))
    out = (ctypes.c_int * 4)()
    err = fn(("elements_bwd", "factor_bwd").index(name), out)
    if err != 0:
        fail("adjoint {0} layout query failed: CUDA error {1}".format(
            name, err))
    return dict(zip(("threads", "lanes", "smem_bytes", "blocks_per_sm"),
                    out))


def adjoint_kernel_calls(streams, seg):
    """{name: (kernel call, plain call)} on the same inputs, for timing."""
    u, v, ph, a, y = streams
    p, b = u.shape[1:]
    A, J, C, sv0 = adjoint.elements_fwd_cuda(u, v, ph, a)
    sh0 = fused4.prefix_sh0(A, J, C, seg)
    sv1 = adjoint.factor_fwd_cuda(sh0, u, v, ph, a, y)[7]
    del A, J, C
    gen = torch.Generator(device=u.device).manual_seed(1)
    cots = [torch.randn(s, generator=gen, dtype=torch.float64,
                        device=u.device)
            for s in ((p, p, b), (p, b), (p, p, b), (p, b), (b,), (b,))]
    c3 = [torch.randn(p, p, b, generator=gen, dtype=torch.float64,
                      device=u.device) for _ in range(3)]
    args = {
        "elements_fwd": (u, v, ph, a),
        "elements_bwd": (u, v, ph, a, sv0, *c3),
        "factor_fwd": (sh0, u, v, ph, a, y),
        "factor_bwd": (u, v, ph, a, y, sv1, *cots),
    }
    return {name: (
        lambda f=getattr(adjoint, name + "_cuda"), x=x: f(*x),
        lambda f=getattr(adjoint, name + "_reference"), x=x: f(*x))
        for name, x in args.items()}


def adjoint_case(adj_errs, tag, streams, seg, limit, **info):
    """One adjoint_kernel_vs_plain case: every output of the four kernels
    against the plain versions' at ``limit``.  ``adj_errs[name]`` collects
    each kernel's float64 max abs error."""
    errs = compare_adjoint_kernels(*streams, seg=seg)
    f64 = streams[0].dtype == torch.float64
    emit("adjoint_kernel_vs_plain", case=tag, width=streams[0].shape[1],
         dtype=str(streams[0].dtype).split(".")[1], limit=limit,
         max_rel_err={k: e["max_rel_err"] for k, e in errs.items()},
         outputs={k: e["outputs"] for k, e in errs.items()}, **info)
    for name, e in errs.items():
        if f64:
            adj_errs[name].append(e["max_abs_err"])
        if not e["max_rel_err"] <= limit:
            fail("adjoint {0} kernel disagrees with plain: {1} {2}".format(
                name, tag, info))


def plain_adjoint_f32_floor(gp, plans, rows):
    """factor_fwd's outputs by the plain version in float32 against
    float64, each on its own plan of the same data, relative to the
    largest float64 value: the rounding floor under a float32
    kernel-vs-plain reading."""
    outs = {}
    for dt, plan in plans.items():
        u, v, ph, a, y = lane_streams(gp, plan, rows)
        seg = plan.t.shape[-1] // plan.n_chain
        A, J, C, _ = adjoint.elements_fwd_reference(u, v, ph, a)
        sh0 = fused4.prefix_sh0(A, J, C, seg)
        outs[dt] = adjoint.factor_fwd_reference(sh0, u, v, ph, a, y)[:7]
        del A, J, C, sh0
    names = ("M", "m", "Qm", "qv", "q0", "ld", "mind")
    return {k: float((x.double() - w).abs().max() / w.abs().max())
            for k, x, w in zip(names, outs[torch.float32],
                               outs[torch.float64])}


def check_adjoint_kernels(dev, gp, lpe, theta, thetas, adj_errs, ptxas):
    """adjoint_kernels: the four kernels against their plain versions.

    Widths 13 and 16 on a small plan (N = 4099, 64 lanes) in float64 and
    float32, then on main path E's own plans (``folded_plan(1)``, ``(4)``
    for sampler_E and ``(16)``), where each kernel and its plain version
    are timed and the bound computed; each adjoint_kernel_time_E line
    also gives the two backward kernels' ptxas registers and spill bytes
    (``ptxas``: adjoint.cu's summaries by width) and launch shapes.
    Returns ``{nc: {name: row}}``.
    """
    backward = {name: {
        "ptxas": {p: {k: v for k, v in kerns.items()
                      if k.startswith("adjoint_" + name)}
                  for p, kerns in ptxas.items()},
        "layout_p16": {str(dt).split(".")[1]: adjoint_bwd_layout(name, 16, dt)
                       for dt in (torch.float64, torch.float32)}}
        for name in ("elements_bwd", "factor_bwd")}
    t, y, yerr = make_data(4099, seed=7, t_max=400.0)
    for width in (13, 16):
        g = celerite_torch.GP(wide_kernel(terms, width))
        th = torch.as_tensor(g.get_parameter_vector(), device=dev)
        for dt in (torch.float64, torch.float32):
            plan = lanes.make_plan(t, y, yerr**2, 64, dtype=dt, device=dev)
            adjoint_case(adj_errs, "small", lane_streams(g, plan, th), 64,
                         ADJ_F64_RTOL if dt == torch.float64
                         else ADJ_F32_RTOL, n=4099, lanes=64)
    rows = {}
    for nc in (1, SAMPLER_E_CHAINS, SAMPLER_CHAINS):
        rth = theta if nc == 1 else thetas[:nc]
        plans = {dt: lp.loglik.value_ok_grad_batch.folded_plan(nc)
                 for dt, lp in lpe.items()}
        floor = plain_adjoint_f32_floor(gp, plans, rth) if nc == 1 else None
        for dt, plan in plans.items():
            streams = lane_streams(gp, plan, rth)
            lanes_, steps = plan.t.shape[-1], plan.t.shape[0]
            seg = lanes_ // nc
            f64 = dt == torch.float64
            adjoint_case(adj_errs, "main_path", streams, seg,
                         ADJ_F64_RTOL if f64 else ADJ_F32_PATH_RTOL,
                         n=plan.n, n_chain=nc, lanes=lanes_,
                         steps_per_lane=steps,
                         **({"factor_fwd_plain_f32_vs_f64": floor}
                            if floor and not f64 else {}))
            key = str(dt).split(".")[1]
            for name, (kern, plain) in adjoint_kernel_calls(streams,
                                                            seg).items():
                row = rows.setdefault(nc, {}).setdefault(name, {})
                row["ms_" + key] = sync_time_ms(kern, reps=10)
                if f64:  # one run of the plain version: no yardstick
                    row["plain_ms_" + key] = sync_time_ms(plain, reps=1,
                                                          warm=0)
                row["bound_ms_" + key], row["bound_by_" + key] = \
                    adjoint_bound_ms(name, streams[0])
            del streams
            torch.cuda.empty_cache()
        emit("adjoint_kernel_time_E", n=plan.n, n_chain=nc, lanes=lanes_,
             steps_per_lane=steps, kernels=rows[nc], backward=backward)
    return rows


def plain_adjoint_value_and_grad(gp, plan, theta, prior):
    """log prob and its gradient by autograd through the plain adjoint
    pipeline on a one-chain ``plan`` (float64): the plain versions of the
    kernels, fused4's glue, autograd for every transpose."""
    th = theta.detach().double().requires_grad_()
    u, v, ph, a, y = lane_streams(gp, plan, th)
    seg = plan.t.shape[-1]
    A, J, C, _ = adjoint.elements_fwd_reference(u, v, ph, a)
    sh0 = fused4.prefix_sh0(A, J, C, seg)
    M, m, Qm, qv, q0, ld, _, _ = adjoint.factor_fwd_reference(sh0, u, v, ph,
                                                              a, y)
    ll = fused4.assemble_ll(fused4.lane_quad(M, m, Qm, qv, q0, seg), ld,
                            plan.n, seg)[0]
    lp = ll + prior(th)
    (grad,) = torch.autograd.grad(lp, th)
    return float(lp.detach()), grad


def seq_prefix_value_and_grad(t, y, yerr, prior, theta, n=4096):
    """The first ``n`` points' log prob and gradient: the sequential
    solver with autograd on the CPU, independent arithmetic, beside the
    adjoint route on the card at the same points."""
    gp_cpu = celerite_torch.GP(config2_kernel(terms, modes=3), device="cpu")
    lp_seq = gp_cpu.build_logprob(t[:n], y[:n], yerr=yerr[:n],
                                  log_prior=prior, solver="seq",
                                  fast_grad=False)
    th = theta.detach().cpu().requires_grad_()
    want = lp_seq(th)
    (gwant,) = torch.autograd.grad(want, th)
    gp = celerite_torch.GP(config2_kernel(terms, modes=3))
    lp = gp.build_logprob(t[:n], y[:n], yerr=yerr[:n], log_prior=prior)
    if lp.loglik.route != "adjoint":
        fail("config[2] with three modes took the {0} route".format(
            lp.loglik.route))
    got, ggot = lp.value_and_grad(theta)
    return rel(got, want.detach()), grad_rel(ggot.cpu(), gwant)


def main_path_e(gp, lpe, prior, theta, thetas, t, y, yerr):
    """config[2] with three modes (P = 16) at N = 1e5 through
    ``value_and_grad`` (one theta) and ``value_and_grad_batch`` (16
    thetas, folded), float32 and float64.

    Gates: float64 against autograd through the plain adjoint pipeline on
    the card (log prob 1e-10, gradient 1e-8 in norm; the batch's first and
    last rows too), the batch against one-theta calls, a 4096-point prefix
    against the sequential solver, and float32's log prob within 1e-4 of
    float64's."""
    plan1 = lpe[torch.float64].loglik.value_ok_grad_batch.folded_plan(1)
    reset_counts()
    single = {dt: lp.value_and_grad(theta) for dt, lp in lpe.items()}
    batch = {dt: lp.value_and_grad_batch(thetas) for dt, lp in lpe.items()}
    counts = adjoint_counts()
    emit("main_path_E_launches", **counts,
         fused4=dict(grad_counts(), primal=fused4.primal_cuda.launches),
         dsfused=ds_counts())
    if min(counts.values()) < 4:
        fail("main path E did not launch every adjoint kernel: "
             "{0}".format(counts))
    lp_ref, g_ref = plain_adjoint_value_and_grad(gp, plan1, theta, prior)
    v64, g64 = single[torch.float64]
    v32, g32 = single[torch.float32]
    e_value, e_grad = rel(v64, lp_ref), grad_rel(g64, g_ref)
    b64, b32 = batch[torch.float64], batch[torch.float32]
    refs = {r: plain_adjoint_value_and_grad(gp, plan1, thetas[r], prior)
            for r in (0, SAMPLER_CHAINS - 1)}
    e_bvalue_ref = max(rel(b64[0][r], v) for r, (v, _) in refs.items())
    e_bgrad_ref = max(grad_rel(b64[1][r], g) for r, (_, g) in refs.items())
    per_theta = [lpe[torch.float64].value_and_grad(th) for th in thetas]
    e_bvalue = max(rel(b64[0][r], per_theta[r][0])
                   for r in range(SAMPLER_CHAINS))
    e_bgrad = max(grad_rel(b64[1][r], per_theta[r][1])
                  for r in range(SAMPLER_CHAINS))
    e_seq_value, e_seq_grad = seq_prefix_value_and_grad(t, y, yerr, prior,
                                                        theta)
    e_value32 = max([rel(v32, v64)] + [rel(b32[0][r], b64[0][r])
                                       for r in range(SAMPLER_CHAINS)])
    e_grad32 = max([grad_rel(g32, g64)] + [grad_rel(b32[1][r], b64[1][r])
                                           for r in range(SAMPLER_CHAINS)])
    spread = {}
    for dt, lp in lpe.items():
        key = str(dt).split(".")[1]
        spread["single_" + key] = eval_spread_ms(lp.value_and_grad, theta,
                                                 batches=5, per_batch=5)
        spread["batch16_" + key] = eval_spread_ms(lp.value_and_grad_batch,
                                                  thetas, batches=5,
                                                  per_batch=3)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lpe[torch.float64].value_and_grad_batch(thetas)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    emit("main_path_E", model="config[2] 4xSHO + jitter (P=16, modes=3)",
         route=lpe[torch.float64].loglik.route, n=plan1.n,
         dim=theta.shape[0], lanes_per_chain=plan1.t.shape[-1],
         steps_per_lane=plan1.t.shape[0],
         fold_cap=lpe[torch.float64].loglik.value_ok_grad_batch.fold_cap,
         logprob_f64=float(v64), logprob_plain_f64=lp_ref,
         logprob_f32=float(v32), rel_err_value_f64_vs_plain=e_value,
         rel_err_grad_f64_vs_plain_autograd=e_grad,
         rel_err_batch_value_vs_plain=e_bvalue_ref,
         rel_err_batch_grad_vs_plain_autograd=e_bgrad_ref,
         rel_err_batch_value_vs_single=e_bvalue,
         rel_err_batch_grad_vs_single=e_bgrad,
         rel_err_value_vs_seq_prefix4096=e_seq_value,
         rel_err_grad_vs_seq_prefix4096=e_seq_grad,
         rel_err_value_f32_vs_f64=e_value32,
         rel_err_grad_f32_vs_f64=e_grad32,
         grad_f64=g64.tolist(), ms_per_call=spread,
         peak_mib_batch16_f64=peak / 2**20)
    if not (math.isfinite(float(v64)) and math.isfinite(float(v32))
            and all(bool(torch.isfinite(x).all())
                    for x in (*b64, *b32, g64, g32))):
        fail("main path E gave a non-finite log probability or gradient")
    if max(e_value, e_bvalue_ref, e_bvalue, e_seq_value) > F64_RTOL:
        fail("main path E: log probability off the plain pipeline or the "
             "sequential solver")
    if max(e_grad, e_bgrad_ref, e_bgrad, e_seq_grad) > GRAD_AUTOGRAD_RTOL:
        fail("main path E: gradient off autograd through the plain "
             "pipeline or the sequential solver")
    if e_value32 > F32_RTOL:
        fail("main path E: float32 log probability off float64 by "
             "{0}".format(e_value32))
    emit("profile_E", dtype="float64", call="value_and_grad",
         **profile_evals(lpe[torch.float64].value_and_grad, theta, evals=5))
    emit("profile_E", dtype="float64", call="value_and_grad_batch(16)",
         **profile_evals(lpe[torch.float64].value_and_grad_batch, thetas,
                        evals=3))
    return counts


def lane_sweep_e(gp, t, y, yerr, prior, theta, thetas, rounds=2):
    """E's value-and-gradient ms over lanes a chain, float64, for one
    theta, for sampler_E's 4 folded and for 16 folded: the kernels want
    many lanes, the glue few.  The lane counts take turns, ``rounds``
    rounds of 3 calls each, and each count's median round is reported
    (the calls are host-bound and the host drifts)."""
    lps = {nb: gp.build_logprob(t, y, yerr=yerr, log_prior=prior,
                                block_size=nb) for nb in E_LANES}
    calls = {"one": lambda lp: lp.value_and_grad(theta),
             "batch4": lambda lp: lp.value_and_grad_batch(
                 thetas[:SAMPLER_E_CHAINS]),
             "batch16": lambda lp: lp.value_and_grad_batch(thetas)}
    ms = {(nb, k): [] for nb in E_LANES for k in calls}
    for _ in range(rounds):
        for nb, lp in lps.items():
            for k, call in calls.items():
                ms[nb, k].append(sync_time_ms(lambda: call(lp), reps=3,
                                              warm=1))
            torch.cuda.empty_cache()
    for nb in E_LANES:
        emit("lane_sweep_E", lanes_per_chain=nb,
             steps_per_lane=-(-len(t) // nb),
             **{"ms_" + k: float(np.median(ms[nb, k])) for k in calls},
             rounds={k: ms[nb, k] for k in calls})


def sampler_nuts(phase, lp, theta, dev, counts, chains, warmup, samples,
                 seed, max_tree_depth=8):
    """Dense-mass NUTS on ``lp`` over ``chains`` folded chains:
    ``sample_nuts`` with the step-size search, windowed warmup, target
    0.8, tree depth SAMPLER_WARMUP_DEPTH in warmup and ``max_tree_depth``
    in sampling.
    ``counts()`` reads the launch counters of the route's kernels; every
    one must have launched at least once a batched call."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    dim = theta.shape[0]
    q0 = theta[None] + 0.02 * torch.randn(chains, dim, generator=gen,
                                          dtype=torch.float64, device=dev)
    reset_counts()
    calls = [0]
    vag = lp.value_and_grad_batch

    def counted(qs):
        calls[0] += 1
        return vag(qs)

    target = lambda th: lp(th)  # noqa: E731
    target.value_and_grad_batch = counted
    marks = []

    def progress(rec):
        torch.cuda.synchronize()
        marks.append((rec["phase"], time.perf_counter(), calls[0]))

    t0 = time.perf_counter()
    chain, info = inference.sample_nuts(
        target, q0, gen, num_warmup=warmup, num_samples=samples,
        max_tree_depth=max_tree_depth,
        warmup_max_tree_depth=SAMPLER_WARMUP_DEPTH,
        target_accept=0.8,
        initial_step_size="auto", dense_mass=True, chunk_size=10,
        progress=progress)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    _, t_warm_end, calls_warm = [m for m in marks if m[0] == "warmup"][-1]
    t_samp = t_end - t_warm_end
    draws = chain.cpu().numpy()
    summ = diagnostics.summary(draws)
    grew = counts()
    min_ess = float(np.min(summ["ess"]))
    moved = [bool((chain[c] != q0[c]).any()) for c in range(chains)]
    out = {
        "n_chains": chains, "dim": dim, "warmup": warmup,
        "samples": samples, "max_tree_depth": max_tree_depth,
        "warmup_max_tree_depth": SAMPLER_WARMUP_DEPTH, "target_accept": 0.8,
        "step_size": float(info["step_size"]),
        "warmup_s": t_warm_end - t0, "sampling_s": t_samp,
        "transitions_per_s": samples / t_samp,
        "leapfrog_slots_per_s": float(info["num_steps"]) / t_samp,
        "batched_calls_per_s": (calls[0] - calls_warm) / t_samp,
        "ms_per_value_and_grad_batch":
            t_samp * 1e3 / max(calls[0] - calls_warm, 1),
        "value_and_grad_batch_calls": calls[0],
        "calls_sampling": calls[0] - calls_warm,
        "leapfrog_slots_sampling": int(info["num_steps"]),
        "mean_accept_warmup_last_half": float(
            info["warmup_accept_prob"][-(warmup // 2):].mean()),
        "mean_accept_sampling": float(info["accept_prob"]),
        "divergences_warmup": int(info["warmup_divergences"]),
        "divergences_sampling": int(info["divergences"]),
        "max_rhat": float(np.max(summ["rhat"])), "min_ess": min_ess,
        "min_ess_per_s": min_ess / t_samp,
        "ebfmi": [float(x) for x in diagnostics.ebfmi(
            info["energy"].cpu().numpy())],
        "chains_moved": sum(moved), "kernel_launches": grew,
        "inv_mass_diag": torch.diagonal(info["inv_mass"]).tolist(),
    }
    emit(phase, **out)
    if not np.all(np.isfinite(draws)):
        fail("{0}: a draw is not finite".format(phase))
    if not all(moved):
        fail("{0}: a chain never moved".format(phase))
    if (out["mean_accept_sampling"] < SAMPLER_ACCEPT_FLOOR
            or out["divergences_sampling"] >= chains * samples):
        fail("{0}: sampling collapsed: mean acceptance {1}, {2} of {3} "
             "transitions divergent".format(
                 phase, out["mean_accept_sampling"],
                 out["divergences_sampling"], chains * samples))
    if min(grew.values()) < calls[0]:
        fail("{0}: kernels launched fewer times than batched calls: "
             "{1}".format(phase, grew))
    return grew


SOLVER_REPLACES = {
    "elements": "celerite_tpu/ops/pallas_solver.py:62",
    "factor": "celerite_tpu/ops/pallas_solver.py:114",
    "subst": "celerite_tpu/ops/pallas_solver.py:154",
}


def solver_counts():
    return {name: getattr(pallas_solver, name + "_cuda").launches
            for name in pallas_solver.SOLVER_KERNELS}


def solver_bound_ms(name, u):
    """Least time for one launch of three-pass kernel ``name`` on blocked
    streams shaped like ``u`` ``(L, P, B)``: max(bytes / rate, operations
    / peak).

    Bytes, each input read once and each output written once: elements
    reads u, v, ph, a (3P + 1 words a point) and writes (A, J, C) (3P^2 a
    lane); factor reads those and y (3P + 2 a point) and the seed (P^2 a
    lane), writes d and w (P + 1 a point) and (M, m) (P^2 + P a lane);
    subst reads u, ph, w, y, d (3P + 2 a point) and h0 (P a lane), writes
    three words a lane.  Operations per point, counted from the kernels'
    code: the Riccati step's front (S, su, d, w: 4 P^2 + 4 P + 1) and
    update (3 P^2), then elements' A and J updates (8 P^2 + 3 P),
    factor's M and m updates (5 P^2 + 6 P + 2), subst's 5 P + 11.
    """
    L, p, b = u.shape
    it = u.element_size()
    pts, pp = L * b, p * p
    front = 7 * pp + 4 * p + 1
    words, per_point = {
        "elements": ((3 * p + 1) * pts + 3 * pp * b, front + 8 * pp + 3 * p),
        "factor": ((4 * p + 3) * pts + (2 * pp + p) * b,
                   front + 5 * pp + 6 * p + 2),
        "subst": ((3 * p + 2) * pts + p * b + 3 * b, 5 * p + 11),
    }[name]
    t_bytes = words * it / PEAK_BYTES_S * 1e3
    t_ops = per_point * pts / PEAK_FLOPS[u.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def solver_kernel_calls(streams):
    """{name: (kernel call, plain call)} on the same inputs, for timing."""
    u, v, ph, a, y = streams
    b = u.shape[-1]
    sh0 = fused4.prefix_sh0(*pallas_solver.elements_cuda(u, v, ph, a), b)
    d, w, M, m = pallas_solver.factor_cuda(sh0, u, v, ph, a, y)
    h0 = fused4.prefix_h0(M, m, b)
    ps = pallas_solver
    return {
        "elements": (lambda: ps.elements_cuda(u, v, ph, a),
                     lambda: ps.elements_reference(u, v, ph, a)),
        "factor": (lambda: ps.factor_cuda(sh0, u, v, ph, a, y),
                   lambda: ps.factor_reference(sh0, u, v, ph, a, y)),
        "subst": (lambda: ps.subst_cuda(h0, u, ph, w, y, d),
                  lambda: ps.subst_reference(h0, u, ph, w, y, d)),
    }


def plain_solver_f32_floor(streams64):
    """Each plain pass in float32 against float64 on the same streams (the
    float32 ones rounded from them), every output against its largest
    float64 value: the rounding floor under a float32 kernel-vs-plain
    reading."""
    ps = pallas_solver
    outs = {}
    for dt in (torch.float32, torch.float64):
        u, v, ph, a, y = (x.to(dt) for x in streams64)
        b = u.shape[-1]
        el = ps.elements_reference(u, v, ph, a)
        fa = ps.factor_reference(fused4.prefix_sh0(*el, b), u, v, ph, a, y)
        su = ps.subst_reference(fused4.prefix_h0(*fa[2:], b), u, ph, fa[1],
                                y, fa[0])
        outs[dt] = dict(zip(("A", "J", "C", "d", "w", "M", "m", "quad",
                             "logdet", "mind"), (*el, *fa, *su)))
    return {k: float((x.double() - outs[torch.float64][k]).abs().max()
                     / outs[torch.float64][k].abs().max())
            for k, x in outs[torch.float32].items()}


def solver_case(solver_errs, tag, streams, limit, floor=None, **info):
    """One solver_kernel_vs_plain case: every output of the three kernels
    against the plain versions' at ``limit``.
    ``solver_errs[name]`` collects each kernel's float64 max abs error."""
    errs = compare_solver_kernels(*streams)
    u = streams[0]
    f64 = u.dtype == torch.float64
    emit("solver_kernel_vs_plain", case=tag, width=u.shape[1],
         dtype=str(u.dtype).split(".")[1], limit=limit, lanes=u.shape[-1],
         steps_per_lane=u.shape[0],
         max_rel_err={k: e["max_rel_err"] for k, e in errs.items()},
         outputs={k: e["outputs"] for k, e in errs.items()},
         **({"plain_f32_vs_f64": floor} if floor else {}), **info)
    for name, e in errs.items():
        if f64:
            solver_errs.setdefault(name, []).append(e["max_abs_err"])
        if not e["max_rel_err"] <= limit:
            fail("pallas_solver {0} kernel disagrees with plain: {1} "
                 "{2}".format(name, tag, info))


def time_solver_kernels(streams, plain=True):
    """{name: {"ms", "plain_ms", "bound_ms", "bound_by"}} on ``streams``:
    each kernel by CUDA events over 10 launches, its plain version once."""
    rows = {}
    for name, (kern, plain_fn) in solver_kernel_calls(streams).items():
        row = rows[name] = {"ms": sync_time_ms(kern, reps=10)}
        if plain:
            row["plain_ms"] = sync_time_ms(plain_fn, reps=1, warm=0)
        row["bound_ms"], row["bound_by"] = solver_bound_ms(name, streams[0])
    return rows


def check_solver_kernels(dev, gpe, lpe, thetae, solver_errs):
    """solver_kernels: the three kernels against their plain versions.

    Widths 2, 8, 13 and 16 on a small plan (N = 4099 in blocks of 96
    steps: 43 lanes and a padded tail of 29 rows) in float64 and float32,
    then on main path F's own plans, where each kernel and its plain
    version are timed and the bound computed: the value plan of E's model
    (float64 and float32), and the ``solver="pallas"`` blocks of E's and
    B's models at N = 1e5 (float64) and of bench.py's model at N = 1e6
    (float32).  Returns ``{plan: {name: row}}``.
    """
    t, y, yerr = make_data(4099, seed=7, t_max=400.0)
    for width in SOLVER_WIDTHS:
        kern = width_kernel(terms, width)
        s64 = blocked_streams(kern, t, y, yerr, 96, device=dev)
        floor = plain_solver_f32_floor(s64)
        solver_case(solver_errs, "small", s64, SOLVER_F64_RTOL, n=4099)
        solver_case(solver_errs, "small",
                    tuple(x.float() for x in s64), SOLVER_F32_RTOL,
                    floor=floor, n=4099)
    rows = {}
    vplans = {dt: lp.loglik.value_plan for dt, lp in lpe.items()}
    for dt, vplan in vplans.items():
        streams = lane_streams(gpe, vplan, thetae)
        f64 = dt == torch.float64
        floor = None if f64 else plain_solver_f32_floor(
            lane_streams(gpe, vplans[torch.float64], thetae))
        solver_case(solver_errs, "value_plan", streams,
                    SOLVER_F64_RTOL if f64 else SOLVER_F32_PATH_RTOL,
                    floor=floor, n=vplan.n)
        key = "value_plan_" + str(dt).split(".")[1]
        rows[key] = time_solver_kernels(streams, plain=f64)
        emit("solver_kernel_time_F", plan=key, n=vplan.n,
             lanes=streams[0].shape[-1], steps_per_lane=streams[0].shape[0],
             kernels=rows[key])
    L = pallas_solver.default_block_size(dev)
    n = 100_000
    rng = np.random.default_rng(2)
    tb = np.sort(rng.uniform(0, 100.0, n))
    yerrb = np.full(n, 0.3)
    yb = np.sin(tb) + 0.5 * np.sin(3.1 * tb) + yerrb * rng.standard_normal(n)
    tm, ym, yerrm = bench_data()
    cases = (("pallas_E", 16, (tb, yb, yerrb), torch.float64),
             ("pallas_B", 8, (tb, yb, yerrb), torch.float64),
             ("pallas_bench", 2, (tm, ym, yerrm), torch.float32))
    for key, width, data, dt in cases:
        s64 = blocked_streams(width_kernel(terms, width), *data, L,
                              device=dev)
        streams = tuple(x.to(dt) for x in s64)
        f64 = dt == torch.float64
        solver_case(solver_errs, key, streams,
                    SOLVER_F64_RTOL if f64 else SOLVER_F32_PATH_RTOL,
                    floor=None if f64 else plain_solver_f32_floor(s64),
                    n=len(data[0]), block_size=L)
        del s64
        rows[key] = time_solver_kernels(streams)
        emit("solver_kernel_time_F", plan=key, n=len(data[0]),
             dtype=str(dt).split(".")[1], lanes=streams[0].shape[-1],
             steps_per_lane=streams[0].shape[0], kernels=rows[key])
        del streams
        torch.cuda.empty_cache()
    return rows


def bench_data(n=1_000_000):
    """Main path A's data: bench.py's N = 1e6 series."""
    rng = np.random.default_rng(42)
    t = np.sort(rng.uniform(0, 1000.0, n))
    return t, rng.standard_normal(n), np.full(n, 0.1)


def b_data(n=100_000):
    """Main path B's data: config[2]'s two modes in noise, N = 1e5."""
    rng = np.random.default_rng(2)
    t = np.sort(rng.uniform(0, 100.0, n))
    yerr = np.full(n, 0.3)
    y = np.sin(t) + 0.5 * np.sin(3.1 * t) + yerr * rng.standard_normal(n)
    return t, y, yerr


def autograd_value_and_grad(fn, theta):
    """(ll, ok, d ll / d theta) of a closure by one reverse pass."""
    th = theta.detach().clone().requires_grad_()
    ll, ok = fn(th)
    (grad,) = torch.autograd.grad(ll, th)
    return ll.detach(), ok, grad


def seq_prefix_values(gp_of, t, y, yerr, theta, calls, n=4096):
    """The first ``n`` points through the sequential solver on the CPU
    (value and autograd gradient) and through each of ``calls`` (name ->
    ``gp -> fn``, built on the card at the same points): their relative
    distances, value and gradient (norm)."""
    gp_cpu = gp_of("cpu")
    fseq = gp_cpu.build_loglik(t[:n], y[:n], yerr=yerr[:n], solver="seq")
    ll_s, _, g_s = autograd_value_and_grad(fseq, theta.cpu())
    gp = gp_of(None)
    out = {}
    for name, make in calls.items():
        ll, ok, g = autograd_value_and_grad(
            make(gp, t[:n], y[:n], yerr[:n]), theta)
        if not bool(ok):
            fail("main path F: {0} on the 4096-point prefix is not "
                 "positive definite".format(name))
        out[name] = (rel(ll, ll_s), grad_rel(g.cpu(), g_s))
    return out


def main_path_f(gpe, lpe, prior, thetae, t, y, yerr):
    """The value of wide models (P = 16 and 20) at N = 1e5, and
    ``solver="pallas"`` on P = 16, 8 and 2 (bench.py's model at N = 1e6),
    ``solver="blocked"`` on P = 16: the entry points a user calls, float32
    and float64, and under autograd.

    Gates: every float64 value within 1e-10 of its model's own reference
    (the adjoint route's ``value_ok_grad`` for E's model, the fused route
    for B's and bench.py's) and, on a 4096-point prefix, of the sequential
    solver; float32 within 1e-4 of float64; the gradients of the value
    closure (``fast_grad`` False and True), of ``solver="pallas"`` and of
    ``solver="blocked"`` within 1e-8 (norm) of ``value_ok_grad``'s; P = 20
    within 1e-10 and 1e-8 of the sequential solver on the prefix.  The
    three kernels must each launch in the path's run.
    """
    dev = thetae.device
    dts = (torch.float32, torch.float64)
    gp8 = celerite_torch.GP(config2_kernel(terms))
    theta8 = torch.as_tensor(gp8.get_parameter_vector(), device=dev)
    gpb = celerite_torch.GP(bench_kernel(terms))
    thetab = torch.as_tensor(gpb.get_parameter_vector(), device=dev)
    tb, yb, yerrb = bench_data()
    gp20 = celerite_torch.GP(config2_kernel(terms, modes=4))
    theta20 = torch.as_tensor(gp20.get_parameter_vector(), device=dev)
    fns = {
        ("value", dt): lpe[dt] for dt in dts}
    fns.update({("pallas_E", dt): gpe.build_loglik(
        t, y, yerr=yerr, solver="pallas", dtype=dt) for dt in dts})
    fns.update({("pallas_B", dt): gp8.build_loglik(
        t, y, yerr=yerr, solver="pallas", dtype=dt) for dt in dts})
    fns.update({("pallas_bench", dt): gpb.build_loglik(
        tb, yb, yerr=yerrb, solver="pallas", dtype=dt) for dt in dts})
    fns.update({("blocked_E", dt): gpe.build_loglik(
        t, y, yerr=yerr, solver="blocked", dtype=dt) for dt in dts})
    fns.update({("auto_P20", dt): gp20.build_loglik(t, y, yerr=yerr,
                                                     dtype=dt) for dt in dts})
    value_fast = gpe.build_loglik(t, y, yerr=yerr, fast_grad=True)
    thetas = {"value": thetae, "pallas_E": thetae, "pallas_B": theta8,
              "pallas_bench": thetab, "blocked_E": thetae,
              "auto_P20": theta20}
    routes = {k: getattr(fn, "loglik", fn).route for k, fn in fns.items()}
    if routes["auto_P20", torch.float64] != "blocked" or routes[
            "value", torch.float64] != "adjoint":
        fail("main path F took the routes {0}".format(routes))
    gpe.compute(t, yerr)

    # ---- the path: counters reset just before, read just after ----
    reset_counts()
    vals = {k: fn(thetas[k[0]]) for k, fn in fns.items()}
    ll_gp = gpe.log_likelihood(y)
    grads = {
        "value": autograd_value_and_grad(lpe[torch.float64].loglik, thetae),
        "value_fast_grad": autograd_value_and_grad(value_fast, thetae),
        "pallas_E": autograd_value_and_grad(fns["pallas_E", torch.float64],
                                            thetae),
        "blocked_E": autograd_value_and_grad(fns["blocked_E", torch.float64],
                                             thetae),
        "auto_P20": autograd_value_and_grad(fns["auto_P20", torch.float64],
                                            theta20),
    }
    torch.cuda.synchronize()
    counts = solver_counts()
    emit("main_path_F_launches", **counts, adjoint=adjoint_counts(),
         fused4=dict(grad_counts(), primal=fused4.primal_cuda.launches))
    if min(counts.values()) < 1:
        fail("main path F did not launch every pallas_solver kernel: "
             "{0}".format(counts))

    # ---- references and gates ----
    ll_vog, ok_vog, g_vog = lpe[torch.float64].loglik.value_ok_grad(thetae)
    ref = {"value": float(ll_vog) + float(prior(thetae)),
           "pallas_E": float(ll_vog), "blocked_E": float(ll_vog)}
    for key, gp, th, data in (("pallas_B", gp8, theta8, (t, y, yerr)),
                              ("pallas_bench", gpb, thetab,
                               (tb, yb, yerrb))):
        ll_f, ok_f = gp.build_loglik(*data[:2], yerr=data[2])(th)
        ref[key] = float(ll_f)
    errs = {}
    for key in ref:
        v64, v32 = (vals[key, dt] for dt in (torch.float64, torch.float32))
        v64 = v64 if torch.is_tensor(v64) and v64.ndim == 0 else v64[0]
        v32 = v32 if torch.is_tensor(v32) and v32.ndim == 0 else v32[0]
        errs[key] = {"f64": rel(v64, ref[key]), "f32_vs_f64": rel(v32, v64),
                     "value_f64": float(v64), "value_f32": float(v32)}
    ll20 = {dt: float(vals["auto_P20", dt][0]) for dt in dts}
    errs["auto_P20"] = {"f32_vs_f64": rel(ll20[torch.float32],
                                          ll20[torch.float64]),
                        "value_f64": ll20[torch.float64]}
    errs["GP.log_likelihood"] = {"f64": rel(ll_gp, ll_vog)}
    grad_errs = {k: grad_rel(g[2], g_vog) for k, g in grads.items()
                 if k != "auto_P20"}
    prefix = seq_prefix_values(
        lambda d: celerite_torch.GP(config2_kernel(terms, modes=3),
                                    device=d), t, y, yerr, thetae,
        {"value": lambda gp, *d: gp.build_loglik(*d[:2], yerr=d[2]),
         "pallas": lambda gp, *d: gp.build_loglik(*d[:2], yerr=d[2],
                                                  solver="pallas"),
         "blocked": lambda gp, *d: gp.build_loglik(*d[:2], yerr=d[2],
                                                   solver="blocked")})
    prefix.update(seq_prefix_values(
        lambda d: celerite_torch.GP(config2_kernel(terms, modes=4),
                                    device=d), t, y, yerr, theta20,
        {"auto_P20": lambda gp, *d: gp.build_loglik(*d[:2], yerr=d[2])}))

    spread = {}
    for (key, dt), fn in fns.items():
        reps = 2 if key in ("blocked_E", "auto_P20") else 10
        spread[key + "_" + str(dt).split(".")[1]] = eval_spread_ms(
            fn, thetas[key], batches=5, per_batch=reps)
    spread["value_and_autograd_grad_float64"] = eval_spread_ms(
        lambda th: autograd_value_and_grad(lpe[torch.float64].loglik, th),
        thetae, batches=3, per_batch=2)
    spread["value_fast_grad_and_autograd_grad_float64"] = eval_spread_ms(
        lambda th: autograd_value_and_grad(value_fast, th), thetae,
        batches=3, per_batch=2)
    vplan = lpe[torch.float64].loglik.value_plan
    emit("main_path_F", model_E="config[2] 4xSHO + jitter (P=16, modes=3)",
         model_B="config[2] 2xSHO + jitter (P=8)",
         model_bench="bench.py ComplexTerm (P=2), N=1e6",
         model_P20="config[2] 5xSHO + jitter (P=20, modes=4)", n=len(t),
         routes={"{0}_{1}".format(k, str(dt).split(".")[1]): r
                 for (k, dt), r in routes.items()},
         value_plan_lanes=vplan.t.shape[-1],
         value_plan_steps=vplan.t.shape[0],
         pallas_block_size=pallas_solver.default_block_size(dev),
         blocked_block_size=blocked.default_block_size(len(t), dev),
         ll_value_ok_grad_f64=float(ll_vog), ll_gp_log_likelihood=ll_gp,
         rel_err=errs, rel_err_grad_vs_value_ok_grad=grad_errs,
         rel_err_vs_seq_prefix4096=prefix, ms_per_call=spread)
    flat64 = [e["f64"] for e in errs.values() if "f64" in e]
    flat64 += [p[0] for p in prefix.values()]
    if not all(math.isfinite(e["value_f64"]) for e in errs.values()
               if "value_f64" in e) or max(flat64) > F64_RTOL:
        fail("main path F: a float64 value off its reference: "
             "{0} {1}".format(errs, prefix))
    if max(e["f32_vs_f64"] for e in errs.values()
           if "f32_vs_f64" in e) > F32_RTOL:
        fail("main path F: a float32 value off float64: {0}".format(errs))
    if max(list(grad_errs.values()) + [p[1] for p in prefix.values()]) \
            > GRAD_AUTOGRAD_RTOL:
        fail("main path F: a gradient off value_ok_grad's or the "
             "sequential solver's: {0} {1}".format(grad_errs, prefix))
    emit("profile_F", dtype="float64", call="build_logprob(...)(theta)",
         **profile_evals(lpe[torch.float64], thetae, evals=10))
    emit("profile_F", dtype="float64", call="solver='pallas'",
         **profile_evals(fns["pallas_E", torch.float64], thetae, evals=10))
    return counts


def lane_sweep_f(gpe, t, y, yerr, thetae, rounds=F_SWEEP_ROUNDS):
    """F's float64 value ms over the value plan's lanes a chain
    (``block_size`` of the adjoint route), over the L of
    ``solver="pallas"`` and over the L of ``solver="blocked"``.  The
    counts take turns, ``rounds`` rounds of 3 calls each after one warm-up
    call (the blocked solver's: 1 call, no warm-up; it has nothing to warm
    and takes seconds at large L), and each count's median round is
    reported."""
    fns = {("value", nb): gpe.build_loglik(t, y, yerr=yerr, block_size=nb)
           for nb in F_LANES}
    for solver in ("pallas", "blocked"):
        fns.update({(solver, L): gpe.build_loglik(
            t, y, yerr=yerr, solver=solver, block_size=L) for L in F_BLOCKS})
    ms = {k: [] for k in fns}
    for _ in range(rounds):
        for k, fn in fns.items():
            reps, warm = (1, 0) if k[0] == "blocked" else (3, 1)
            ms[k].append(sync_time_ms(lambda: fn(thetae), reps=reps,
                                      warm=warm))
    for (what, count), m in ms.items():
        if what == "value":
            shape = dict(lanes=count, steps_per_lane=-(-len(t) // count))
        else:
            shape = dict(lanes=-(-len(t) // count), steps_per_lane=count)
        emit("lane_sweep_F", solver=what, **shape, ms=float(np.median(m)),
             rounds=m)


# ---------------------------------------------------------------------------
# The single-sweep value and the tangent kernels: tangent_kernels, main path
# G, lane_sweep_G, sampler_G
# ---------------------------------------------------------------------------

TANGENT_REPLACES = {
    "fused": "celerite_tpu/ops/fused.py:130",
    "elements_jvp": "celerite_tpu/ops/tangent.py:71",
    "factor_jvp": "celerite_tpu/ops/tangent.py:138",
    "jac": "celerite_tpu/ops/tangent.py:591",
}
TANGENT_SOURCES = {"fused": "celerite_torch/csrc/fused.cu",
                   "elements_jvp": "celerite_torch/csrc/tangent.cu",
                   "factor_jvp": "celerite_torch/csrc/tangent.cu",
                   "jac": "celerite_torch/csrc/tangent.cu"}
TANGENT_NAMES = tuple(TANGENT_REPLACES)


def tangent_counts():
    out = {"fused": fused.kernel_cuda.launches}
    for name in tangent.TANGENT_KERNELS:
        out[name] = getattr(tangent, name + "_cuda").launches
    return out


def tangent_bound_ms(name, u, T, nseg=1):
    """Least time for one call of kernel ``name`` on lane streams shaped
    like ``u`` ``(L, P, B)`` with ``T`` tangent directions and ``nseg``
    segments: max(bytes / rate, operations / peak).

    Bytes, each input read once and each output written once: the single
    sweep (fused) reads u, v, ph, a, y (3P + 2 words a point); with
    tangents every stream's T tangents too ((3P + 1)(1 + T) words a point
    for the elements, (3P + 2)(1 + T) for the factor and jac), the factor
    the seeds (P^2 (1 + T) a lane); the elements write (A, J, C) and their
    tangents (3 P^2 (1 + T) a lane), the factor (M, m, Qm, qv, q0, ld,
    mind) and theirs ((2 P^2 + 2 P + 3)(1 + T) a lane), fused and jac a
    few words a segment.  Operations, counted from csrc/tangent.cu and
    lanes_common.cuh: a sweep's value step is ~15 P^2 a point and each
    direction's tangent step ~41 P^2 (the value counted once, not once a
    direction as the elements kernel runs it or once a chunk of at most
    seven directions as the factor kernel does); the seed scan ~12 P^3 a lane and
    ~16 P^3 a lane and direction, the assembly ~4 P^2 and ~8 P^2.
    """
    L, p, b = u.shape
    it = u.element_size()
    pts, pp = L * b, p * p
    sweep_v, sweep_t = 15 * pp, 41 * pp
    scans = b * (12 * p ** 3 + 4 * pp + T * (16 * p ** 3 + 8 * pp))
    words, ops = {
        "fused": ((3 * p + 2) * pts + 3 * nseg,
                  2 * sweep_v * pts + b * (12 * p ** 3 + 4 * pp)),
        "elements_jvp": ((3 * p + 1) * (1 + T) * pts + 3 * pp * (1 + T) * b,
                         (sweep_v + T * sweep_t) * pts),
        "factor_jvp": ((3 * p + 2) * (1 + T) * pts
                       + (3 * pp + 2 * p + 3) * (1 + T) * b,
                       (sweep_v + T * sweep_t) * pts),
        "jac": ((3 * p + 2) * (1 + T) * pts + (3 + 2 * T) * nseg,
                2 * (sweep_v + T * sweep_t) * pts + scans),
    }[name]
    t_bytes = words * it / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_FLOPS[u.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def path_tangent_streams(gp, plan, rows):
    """Lane streams of ``plan`` for the parameter ``rows`` (one a chain;
    the kernel's parameters, the mean 0) and their tangents along the
    parameters' basis directions, as ``lanes.gp_log_likelihood_jac``
    builds them."""
    streams, tangents = lanes.lane_tangents(
        lambda th: lane_streams(gp, plan, th), rows)
    return (tuple(x.contiguous() for x in streams),
            tuple(x.contiguous() for x in tangents))


def tangent_kernel_calls(streams, tangents, seg, kernels):
    """{name: (kernel call, plain call)} on the same inputs, for timing."""
    s, d = streams, tangents
    calls = {}
    if "fused" in kernels:
        calls["fused"] = (lambda: fused.kernel_cuda(*s, seg),
                          lambda: fused.kernel_reference(*s, seg))
    if "jac" in kernels:
        calls["jac"] = (lambda: tangent.jac_cuda(*s, *d, seg=seg),
                        lambda: tangent.jac_reference(*s, *d, seg=seg))
    if "elements_jvp" in kernels or "factor_jvp" in kernels:
        el = tangent.elements_jvp_cuda(*s[:4], *d[:4])
        sh = dsfused.prefix_sh0_ds(*(torch.cat([x[None], dx]) for x, dx in
                                     zip(el[:3], el[3:])), seg)
        fa = (sh[0], sh[1:], *s, *d)
        calls["elements_jvp"] = (
            lambda: tangent.elements_jvp_cuda(*s[:4], *d[:4]),
            lambda: tangent.elements_jvp_reference(*s[:4], *d[:4]))
        calls["factor_jvp"] = (lambda: tangent.factor_jvp_cuda(*fa),
                               lambda: tangent.factor_jvp_reference(*fa))
    return {k: v for k, v in calls.items() if k in kernels}


def _plain_outputs(streams, tangents, seg, kernels):
    """The plain versions' outputs by name, for the float32 floor."""
    s, d = streams, tangents
    out = {}
    if "fused" in kernels:
        out.update(zip(("fused.quad", "fused.ld", "fused.mind"),
                       fused.kernel_reference(*s, seg)))
    if "jac" in kernels:
        out.update(zip(("jac.quad", "jac.ld", "jac.mind", "jac.dquad",
                        "jac.dld"), tangent.jac_reference(*s, *d, seg=seg)))
    if "elements_jvp" in kernels or "factor_jvp" in kernels:
        el = tangent.elements_jvp_reference(*s[:4], *d[:4])
        out.update(zip(("elements_jvp." + k for k in
                        ("A", "J", "C", "DA", "DJ", "DC")), el))
        sh = dsfused.prefix_sh0_ds(*(torch.cat([x[None], dx]) for x, dx in
                                     zip(el[:3], el[3:])), seg)
        out.update(zip(("factor_jvp." + k for k in
                        ("M", "m", "Qm", "qv", "q0", "ld", "mind", "DM",
                         "Dm", "DQm", "Dqv", "Dq0", "Dld")),
                       tangent.factor_jvp_reference(sh[0], sh[1:], *s, *d)))
    return out


def plain_tangent_f32_floor(streams64, tangents64, seg, kernels):
    """Each plain version in float32 against float64 on the same inputs
    (the float32 ones rounded from them), every output against its largest
    float64 value: the rounding floor under a float32 kernel-vs-plain
    reading."""
    outs = {dt: _plain_outputs(tuple(x.to(dt) for x in streams64),
                               tuple(x.to(dt) for x in tangents64 or ()),
                               seg, kernels)
            for dt in (torch.float32, torch.float64)}
    return {k: float((x.double() - outs[torch.float64][k]).abs().max()
                     / outs[torch.float64][k].abs().max())
            for k, x in outs[torch.float32].items()}


def tangent_case(errs, tag, streams, tangents, seg, kernels, floor=None,
                 **info):
    """One tangent_kernel_vs_plain case: every output of ``kernels`` (the
    tangents None for the single-sweep kernel alone) against the plain
    versions' at TANGENT_F64_RTOL or, in float32, the kernel's
    TANGENT_F32_RTOL.  ``errs[name]`` collects each kernel's float64 max
    abs error."""
    got = {}
    if "fused" in kernels:
        got.update(compare_fused_kernel(*streams, seg=seg))
    rest = tuple(k for k in kernels if k != "fused")
    if rest:
        got.update(compare_tangent_kernels(streams, tangents, seg=seg,
                                           kernels=rest))
    u = streams[0]
    f64 = u.dtype == torch.float64
    limit = {k: TANGENT_F64_RTOL if f64 else TANGENT_F32_RTOL[k]
             for k in got}
    emit("tangent_kernel_vs_plain", case=tag, width=u.shape[1],
         dtype=str(u.dtype).split(".")[1], limit=limit, lanes=u.shape[-1],
         segment=seg, steps_per_lane=u.shape[0],
         directions=tangents[0].shape[1] if tangents else 0,
         max_rel_err={k: e["max_rel_err"] for k, e in got.items()},
         outputs={k: e["outputs"] for k, e in got.items()},
         **({"plain_f32_vs_f64": floor} if floor else {}), **info)
    for name, e in got.items():
        if f64:
            errs.setdefault(name, []).append(e["max_abs_err"])
        if not e["max_rel_err"] <= limit[name]:
            fail("{0} kernel disagrees with plain: {1} {2}".format(
                name, tag, info))


def launch_split_ms(fn, warmup=5, active=10):
    """Device ms of each CUDA kernel one call of ``fn`` launches, by name:
    torch.profiler over ``active`` calls after ``warmup`` traced and
    dropped (late in this script, a window without a warmup caught few or
    none of the jac call's launches), each kernel's mean over the launches
    traced."""
    from torch.profiler import ProfilerActivity, profile, schedule

    steps = warmup + active
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=warmup, active=active,
                                   repeat=1)) as prof:
        for i in range(steps):
            fn()
            if i == steps - 1:
                torch.cuda.synchronize()
            prof.step()
    split = {}
    for e in prof.key_averages():
        # ProfilerStep* is the schedule's span of each traced call.
        if (e.device_type == torch.autograd.DeviceType.CUDA and e.count
                and not e.key.startswith("ProfilerStep")):
            us = max(getattr(e, "self_device_time_total", 0) or 0,
                     getattr(e, "device_time_total", 0) or 0)
            split[re.split(r"[<(]", re.sub(r"^void ", "", e.key))[0]] = \
                us / 1e3 / e.count
    return split


def time_tangent_kernels(streams, tangents, seg, kernels, plain=True):
    """{name: {"ms", "plain_ms", "bound_ms", "bound_by"}}: each kernel by
    CUDA events over 5 calls, its plain version once; the jac call's four
    launches and the single-sweep call's seven also by torch.profiler
    (``split_ms``, ms a launch)."""
    rows = {}
    T = tangents[0].shape[1] if tangents else 0
    nseg = streams[0].shape[-1] // seg
    for name, (kern, plain_fn) in tangent_kernel_calls(
            streams, tangents, seg, kernels).items():
        row = rows[name] = {"ms": sync_time_ms(kern, reps=5)}
        if name in ("jac", "fused"):
            row["split_ms"] = launch_split_ms(kern)
        if plain:
            row["plain_ms"] = sync_time_ms(plain_fn, reps=1, warm=0)
        row["bound_ms"], row["bound_by"] = tangent_bound_ms(
            name, streams[0], T, nseg)
    return rows


def build_logprob_g(gpb, gpe, t, y, yerr, prior):
    """Main path G's closures: ``build_logprob(..., fast_grad="tangent")``
    for config[2] (B) and E's model, float32 and float64."""
    return {(m, dt): g.build_logprob(t, y, yerr=yerr, log_prior=prior,
                                     dtype=dt, fast_grad="tangent")
            for m, g in (("B", gpb), ("E", gpe))
            for dt in (torch.float32, torch.float64)}


def check_tangent_kernels(dev, gpb, gpe, lpg, thetab, thetasb, thetae,
                          thetase, errs):
    """tangent_kernels: the single-sweep kernel and the three tangent
    kernels against their plain versions.

    Small plans: N = 2000 on two chains of 16 lanes, the parameters'
    basis tangents, at padded widths 2, 8 (the single-sweep kernel, the
    jac kernel and the split pair) and 13, 16 (the split pair), in float64
    and float32 (tests/test_torch_kernels.py adds width 5).  Then main
    path G's own plans (their float64 streams, cast for float32), where
    each kernel and its plain version are timed and the bound computed: the single-sweep kernel on config[2]'s value plan
    (float64 and float32); the jac kernel on G's 16-chain batch plan
    (float64 and float32) and on sampler_G's 4-chain plan; the split pair
    on E's model's folded batch plan (float64) and one-chain plan
    (float32).  Returns ``{plan: {name: row}}``.
    """
    t2, y2, yerr2 = make_data(2000, seed=7, t_max=200.0)
    for width in TANGENT_WIDTHS:
        kernels = ("fused", "jac", "elements_jvp", "factor_jvp") \
            if width <= 8 else ("elements_jvp", "factor_jvp")
        s64, d64 = lane_tangent_streams(width_kernel(terms, width), t2, y2,
                                        yerr2, 16, n_chain=2, device=dev)
        tangent_case(errs, "small", s64, d64, 16, kernels, n=2000)
        floor = plain_tangent_f32_floor(s64, d64, 16, kernels)
        tangent_case(errs, "small", tuple(x.float() for x in s64),
                     tuple(x.float() for x in d64), 16, kernels,
                     floor=floor, n=2000)
    rows = {}
    planb = lpg["B", torch.float64].loglik.plan
    s64 = lane_streams(gpb, planb, thetab)
    b = s64[0].shape[-1]
    for dt in (torch.float64, torch.float32):
        key = "value_plan_B_" + str(dt).split(".")[1]
        s = tuple(x.to(dt) for x in s64)
        f64 = dt == torch.float64
        floor = None if f64 else plain_tangent_f32_floor(s64, None, b,
                                                         ("fused",))
        tangent_case(errs, key, s, None, b, ("fused",), floor=floor,
                     n=planb.n)
        rows[key] = time_tangent_kernels(s, None, b, ("fused",), plain=f64)
        emit("tangent_kernel_time_G", plan=key, n=planb.n, lanes=b,
             steps_per_lane=s[0].shape[0], kernels=rows[key])
    cases = [("batch16_B", gpb, lpg["B", torch.float64], thetasb,
              ("jac",), (torch.float64, torch.float32)),
             ("sampler4_B", gpb, lpg["B", torch.float64],
              thetasb[:SAMPLER_G_CHAINS], ("jac",), (torch.float64,)),
             ("batch_E", gpe, lpg["E", torch.float64], thetase,
              ("elements_jvp", "factor_jvp"), (torch.float64,)),
             ("one_E", gpe, lpg["E", torch.float64], thetae[None],
              ("elements_jvp", "factor_jvp"), (torch.float32,))]
    for key, gp, lp, rows_th, kernels, dts in cases:
        vog = lp.loglik.value_ok_grad_batch
        nc = min(rows_th.shape[0], vog.fold_cap)
        plan = vog.folded_plan(nc)
        s64, d64 = path_tangent_streams(gp, plan, rows_th[:nc])
        seg = s64[0].shape[-1] // nc
        for dt in dts:
            s = tuple(x.to(dt) for x in s64)
            d = tuple(x.to(dt) for x in d64)
            f64 = dt == torch.float64
            floor = None if f64 else plain_tangent_f32_floor(s64, d64, seg,
                                                             kernels)
            tag = key + "_" + str(dt).split(".")[1]
            tangent_case(errs, tag, s, d, seg, kernels, floor=floor,
                         n=plan.n, chains=nc)
            rows[tag] = time_tangent_kernels(s, d, seg, kernels, plain=f64)
            emit("tangent_kernel_time_G", plan=tag, n=plan.n, chains=nc,
                 lanes=s[0].shape[-1], steps_per_lane=s[0].shape[0],
                 directions=d[0].shape[1], kernels=rows[tag])
            del s, d
        del s64, d64
        torch.cuda.empty_cache()
    return rows


def main_path_g(gpb, gpe, lpg, prior, thetab, thetasb, thetae, thetase, t,
                y, yerr, dev):
    """``build_logprob(..., fast_grad="tangent")`` at N = 1e5: config[2]
    (B's model, P = 8, T = 7) and E's model (P = 16, T = 13), one theta's
    value, one theta's ``value_and_grad`` and 16 thetas through
    ``value_and_grad_batch`` (C's rows), float32 and float64.

    Gates: float64 log prob within 1e-10 of the fused4 route (B) and the
    adjoint route (E) on the same calls, gradients within 1e-8 (norm);
    float32 within 1e-4 of float64; every kernel of the route launched;
    ``ops.best_ll`` at P = 8 (the single-sweep kernel) within 1e-10 of
    ``blocked``.  Returns the launch counts."""
    rows = {"B": (thetab, thetasb), "E": (thetae, thetase)}
    reset_counts()
    out = {}
    for (m, dt), lp in lpg.items():
        th, ths = rows[m]
        out[m, dt] = (lp(th), lp.value_and_grad(th),
                      lp.value_and_grad_batch(ths))
    torch.cuda.synchronize()
    counts = tangent_counts()
    emit("main_path_G_launches", **counts, pallas_solver=solver_counts(),
         adjoint=adjoint_counts(),
         fused4=dict(grad_counts(), primal=fused4.primal_cuda.launches))
    if min(counts.values()) < 2:
        fail("main path G did not launch every kernel of the route: "
             "{0}".format(counts))
    refs = {"B": gpb.build_logprob(t, y, yerr=yerr, log_prior=prior),
            "E": gpe.build_logprob(t, y, yerr=yerr, log_prior=prior)}
    result = {}
    for m, ref in refs.items():
        th, ths = rows[m]
        v_ref, (vg_ref, g_ref), (vb_ref, gb_ref) = (
            ref(th), ref.value_and_grad(th), ref.value_and_grad_batch(ths))
        v64, (vg64, g64), (vb64, gb64) = out[m, torch.float64]
        v32, (vg32, g32), (vb32, gb32) = out[m, torch.float32]
        result[m] = dict(
            route=lpg[m, torch.float64].loglik.route,
            reference_route=ref.loglik.route,
            logprob_f64=float(v64), logprob_f32=float(v32),
            logprob_reference_f64=float(v_ref),
            rel_err_value_f64=max(rel(v64, v_ref), rel(vg64, vg_ref)),
            rel_err_grad_f64=grad_rel(g64, g_ref),
            rel_err_batch_value_f64=max(rel(vb64[r], vb_ref[r])
                                        for r in range(len(ths))),
            rel_err_batch_grad_f64=max(grad_rel(gb64[r], gb_ref[r])
                                       for r in range(len(ths))),
            rel_err_value_f32_vs_f64=max(
                [rel(v32, v64), rel(vg32, vg64)]
                + [rel(vb32[r], vb64[r]) for r in range(len(ths))]),
            rel_err_grad_f32_vs_f64=max(
                [grad_rel(g32, g64)] + [grad_rel(gb32[r], gb64[r])
                                        for r in range(len(ths))]))
        del ref
    del refs
    torch.cuda.empty_cache()
    spread = {}
    for (m, dt), lp in lpg.items():
        th, ths = rows[m]
        key = "{0}_{1}".format(m, str(dt).split(".")[1])
        spread["value_" + key] = eval_spread_ms(lp, th, batches=5,
                                                per_batch=5)
        spread["single_" + key] = eval_spread_ms(lp.value_and_grad, th,
                                                 batches=5, per_batch=5)
        spread["batch16_" + key] = eval_spread_ms(
            lp.value_and_grad_batch, ths, batches=5 if m == "B" else 3,
            per_batch=3 if m == "B" else 2)
    for m in ("B", "E"):
        vog = lpg[m, torch.float64].loglik.value_ok_grad_batch
        plan = vog.folded_plan(1)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        lpg[m, torch.float64].value_and_grad_batch(rows[m][1])
        torch.cuda.synchronize()
        result[m].update(
            dim=rows[m][0].shape[0], n=plan.n,
            lanes_per_chain=plan.t.shape[-1], steps_per_lane=plan.t.shape[0],
            fold_cap=vog.fold_cap,
            peak_mib_batch16_f64=torch.cuda.max_memory_allocated() / 2**20)
    # ops.best_ll at P = 8, N = 1e5: the single-sweep kernel on the card.
    t64 = torch.as_tensor(t, device=dev)
    kern = gpb.kernel
    ssm = lower(Coefficients(*kern.get_padded_coefficients(thetab),
                             jitter=kern.get_jitter(thetab)), t64,
                torch.as_tensor(yerr, device=dev) ** 2)
    resid = torch.as_tensor(y, device=dev)
    before = fused.kernel_cuda.launches
    best = ops.best_ll(ssm, resid)
    best_launches = fused.kernel_cuda.launches - before
    e_best = rel(best, blocked.gp_log_likelihood(ssm, resid)[0])
    emit("main_path_G", models={"B": "config[2] 2xSHO + jitter (P=8)",
                                "E": "config[2] 4xSHO + jitter (P=16)"},
         **result, ms_per_call=spread, best_ll_f64=float(best),
         rel_err_best_ll_vs_blocked=e_best,
         best_ll_fused_launches=best_launches)
    for m, r in result.items():
        if r["route"] != "tangent":
            fail("main path G took the {0} route".format(r["route"]))
        if max(r["rel_err_value_f64"], r["rel_err_batch_value_f64"]) \
                > F64_RTOL:
            fail("main path G ({0}): log probability off the {1} "
                 "route".format(m, r["reference_route"]))
        if max(r["rel_err_grad_f64"], r["rel_err_batch_grad_f64"]) \
                > GRAD_AUTOGRAD_RTOL:
            fail("main path G ({0}): gradient off the {1} route".format(
                m, r["reference_route"]))
        if r["rel_err_value_f32_vs_f64"] > F32_RTOL:
            fail("main path G ({0}): float32 log probability off float64 "
                 "by {1}".format(m, r["rel_err_value_f32_vs_f64"]))
    if best_launches != 1 or e_best > F64_RTOL:
        fail("ops.best_ll at P = 8: {0} launches, {1} off blocked".format(
            best_launches, e_best))
    # Profiles, float64; E's value closure is main path F's (profile_F).
    for m, th, ths in (("B", thetab, thetasb), ("E", thetae, thetase)):
        lp = lpg[m, torch.float64]
        if m == "B":
            emit("profile_G", model=m, dtype="float64", call="value",
                 **profile_evals(lp, th, evals=3))
        emit("profile_G", model=m, dtype="float64", call="value_and_grad",
             **profile_evals(lp.value_and_grad, th, evals=3 if m == "B"
                             else 2))
        emit("profile_G", model=m, dtype="float64",
             call="value_and_grad_batch(16)",
             **profile_evals(lp.value_and_grad_batch, ths,
                             evals=2 if m == "B" else 1))
    return counts


def lane_sweep_g(gpb, t, y, yerr, prior, thetab, thetasb, rounds=1):
    """G's config[2] calls over lanes a chain, float64: one theta's value
    and value-and-gradient, sampler_G's 4 folded and 16 folded.  The lane
    counts take turns, ``rounds`` rounds of 3 calls each; each count's
    median round is reported."""
    lps = {nb: gpb.build_logprob(t, y, yerr=yerr, log_prior=prior,
                                 block_size=nb, fast_grad="tangent")
           for nb in G_LANES}
    calls = {"value": lambda lp: lp(thetab),
             "one": lambda lp: lp.value_and_grad(thetab),
             "batch4": lambda lp: lp.value_and_grad_batch(
                 thetasb[:SAMPLER_G_CHAINS]),
             "batch16": lambda lp: lp.value_and_grad_batch(thetasb)}
    ms = {(nb, k): [] for nb in G_LANES for k in calls}
    for _ in range(rounds):
        for nb, lp in lps.items():
            for k, call in calls.items():
                ms[nb, k].append(sync_time_ms(lambda: call(lp), reps=3,
                                              warm=1))
            torch.cuda.empty_cache()
    for nb in G_LANES:
        emit("lane_sweep_G", lanes_per_chain=nb,
             steps_per_lane=-(-len(t) // nb),
             **{"ms_" + k: float(np.median(ms[nb, k])) for k in calls},
             rounds={k: ms[nb, k] for k in calls})


ONEPASS_REPLACES = {
    "sweep": "celerite_tpu/ops/onepass.py:111",
    "sweep_fwd": "celerite_tpu/ops/onepass.py:162",
    "sweep_bwd": "celerite_tpu/ops/onepass.py:219",
}
# Padded widths of the one-pass kernels this script builds and holds.
ONEPASS_WIDTHS = (2, 8, 16)
# Main path H against the existing routes in float64: the value within
# 1e-9 and the gradient within 1e-6 (norm), tests/test_onepass.py's own
# tolerances (the closed-form seed correction amplifies rounding by
# 1/det(I - S Qm), onepass.py:36-49).  Main path I's facade ops within
# 1e-10 of the CPU float64 route and of the sequential solver.
H_VALUE_RTOL = 1e-9
H_GRAD_RTOL = 1e-6
I_RTOL = 1e-10


def onepass_counts():
    return {name: getattr(onepass, name + "_cuda").launches
            for name in onepass.ONEPASS_KERNELS}


def onepass_bound_ms(name, u):
    """Least time for one launch of one-pass kernel ``name`` on streams
    shaped like ``u`` ``(L, P, B)``: max(bytes / rate, operations / peak).

    Bytes, each input read once and each output written once: the streams
    (u, v, ph, a, y: 3P + 2 words a point); sweep and sweep_fwd write the
    summaries (C, M0, Qm, m0, qv, mind: 3P^2 + 2P + 1 words a lane, and
    q0, ld0 in float64), sweep_fwd the saves too (2P^2 + P words a point);
    sweep_bwd reads the saves and the summaries' cotangents (3P^2 + 2P + 2
    a lane) and writes the stream cotangents (3P + 2 a point).  Operations
    per point, counted from the code: the Riccati step's intermediates
    (S, su, d, w) and the factor step (adjoint_bound_ms's factor_fwd), or
    its transpose (factor_bwd).
    """
    L, p, b = u.shape
    it = u.element_size()
    pts, pp = L * b, p * p
    front = 4 * pp + 4 * p + 1
    adjoint_step = 16 * pp + 10 * p + 4
    summaries = (3 * pp + 2 * p + 1) * b
    words, per_point = {
        "sweep": ((3 * p + 2) * pts + summaries,
                  front + 11 * pp + 12 * p + 14),
        "sweep_fwd": ((3 * p + 2 + 2 * pp + p) * pts + summaries,
                      front + 11 * pp + 12 * p + 14),
        "sweep_bwd": ((3 * p + 2 + 2 * pp + p + 3 * p + 2) * pts
                      + (3 * pp + 2 * p + 2) * b,
                      front + 17 * pp + 12 * p + 30 + adjoint_step),
    }[name]
    t_bytes = (words * it + (2 * b * 8 if name != "sweep_bwd" else 0)) \
        / PEAK_BYTES_S * 1e3
    t_ops = per_point * pts / PEAK_FLOPS[u.dtype] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def onepass_kernel_calls(streams):
    """{name: (kernel call, plain call)} on the same inputs, for timing."""
    saves = onepass.sweep_fwd_cuda(*streams)[8]
    cots = onepass_cotangents(streams[0])
    return {
        "sweep": (lambda: onepass.sweep_cuda(*streams),
                  lambda: onepass.sweep_reference(*streams)),
        "sweep_fwd": (lambda: onepass.sweep_fwd_cuda(*streams),
                      lambda: onepass.sweep_fwd_reference(*streams)),
        "sweep_bwd": (
            lambda: onepass.sweep_bwd_cuda(*streams, saves, *cots),
            lambda: onepass.sweep_bwd_reference(*streams, saves, *cots)),
    }


def onepass_case(errs, tag, streams, limit, **info):
    """One onepass_kernel_vs_plain case: every output of the three kernels
    against the plain versions' at ``limit`` (a number, or one a kernel).
    ``errs[name]`` collects each kernel's float64 max abs error."""
    got = compare_onepass_kernels(*streams)
    u = streams[0]
    f64 = u.dtype == torch.float64
    if not isinstance(limit, dict):
        limit = {k: limit for k in got}
    emit("onepass_kernel_vs_plain", case=tag, width=u.shape[1],
         dtype=str(u.dtype).split(".")[1], limit=limit, lanes=u.shape[-1],
         steps_per_lane=u.shape[0],
         max_rel_err={k: e["max_rel_err"] for k, e in got.items()},
         outputs={k: e["outputs"] for k, e in got.items()}, **info)
    for name, e in got.items():
        if f64:
            errs.setdefault(name, []).append(e["max_abs_err"])
        if not e["max_rel_err"] <= limit[name]:
            fail("onepass {0} kernel disagrees with plain: {1} {2}".format(
                name, tag, info))


def onepass_f32_case(errs, tag, streams64, **info):
    """The float32 case on the float32 rounding of ``streams64``: each
    kernel's limit is ten times its float32 plain version's distance from
    float64 on these streams (the sweep is ill-conditioned in float32 by
    design, onepass.py:36-49)."""
    floor = onepass_f32_floor(streams64)
    onepass_case(errs, tag, tuple(x.float() for x in streams64),
                 {k: 10 * f for k, f in floor.items()},
                 plain_f32_vs_f64=floor, **info)


def theta_ssm(gp, t, yerr, dev):
    """``theta -> lower(...)`` of a GP's kernel at its active parameters,
    float64 on ``dev`` (the mean is frozen at 0), differentiable."""
    kern, nk = gp.kernel, gp.kernel.full_size
    fixed = torch.as_tensor(gp.parameter_vector, device=dev)
    idx = torch.as_tensor(np.flatnonzero(gp.unfrozen_mask), device=dev)
    t64 = torch.as_tensor(t, device=dev)
    diag = torch.as_tensor(yerr, device=dev) ** 2

    def ssm_of(theta):
        kp = fixed.index_put((idx,), theta)[:nk]
        return lower(Coefficients(*kern.get_padded_coefficients(kp),
                                  jitter=kern.get_jitter(kp)), t64, diag)

    return ssm_of


def h_streams(gp, t, y, yerr, dev):
    """The lane streams main path H's value runs on (float64)."""
    theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)
    ssm = theta_ssm(gp, t, yerr, dev)(theta)
    b = fused.default_num_blocks(len(t), dev)
    return fused._to_lanes(ssm, torch.as_tensor(y, device=dev), b)[:5]


def check_onepass_kernels(dev, models, errs):
    """onepass_kernels: the three kernels against their plain versions.

    Widths 2, 8 and 16 on a small plan (N = 1000 in blocks of 96 steps: 11
    lanes and a padded tail), then on main path H's own plans (``models``:
    tag -> (gp, t, y, yerr)), float64 at 1e-10 and float32 at ten times
    the float32 plain version's distance from float64.  Each kernel and
    its plain version are timed on H's plans (float64, and the kernel in
    float32), beside its bound: the kernel by CUDA events around
    back-to-back calls (``ms_*``, its wrapper's allocations and launch
    included, which bound these short kernels on the host) and around the
    same calls queued behind a spinning kernel, the card's time alone
    (``device_ms_*``).  Returns ``{tag: {name: row}}``."""
    ts, ys, yerrs = make_data(1000, seed=1, t_max=50.0)
    for width in ONEPASS_WIDTHS:
        s64 = blocked_streams(width_kernel(terms, width), ts, ys, yerrs, 96,
                              device=dev)
        onepass_case(errs, "small", s64, F64_RTOL, n=1000)
        onepass_f32_case(errs, "small", s64, n=1000)
    rows = {}
    for tag, (g, t, y, yerr) in models.items():
        s64 = h_streams(g, t, y, yerr, dev)
        info = dict(model=tag, n=len(t))
        onepass_case(errs, "main_path_H", s64, F64_RTOL, **info)
        onepass_f32_case(errs, "main_path_H", s64, **info)
        for dt in (torch.float64, torch.float32):
            streams = tuple(x.to(dt) for x in s64)
            key = str(dt).split(".")[1]
            for name, (kern, plain) in onepass_kernel_calls(
                    streams).items():
                row = rows.setdefault(tag, {}).setdefault(name, {})
                row["ms_" + key] = sync_time_ms(kern, reps=10)
                row["device_ms_" + key] = sync_time_ms(kern, reps=10,
                                                       queued=True)
                if dt == torch.float64:  # one run: no yardstick
                    row["plain_ms"] = sync_time_ms(plain, reps=1, warm=0)
                row["bound_ms_" + key], row["bound_by_" + key] = \
                    onepass_bound_ms(name, streams[0])
            del streams
        emit("onepass_kernel_time_H", model=tag, n=len(t),
             lanes=s64[0].shape[-1], steps_per_lane=s64[0].shape[0],
             kernels=rows[tag])
        del s64
        torch.cuda.empty_cache()
    return rows


def main_path_h(models, refs, dev):
    """``onepass.gp_log_likelihood`` in float64 at N = 1e5 on B's data:
    config[2] (P = 8) and E's model (P = 16), the value and its autograd
    gradient with respect to theta (the lowering under autograd, rows 20
    and 21); bench.py's model (P = 2) at N = 1e6, the value (row 19).
    ``refs``: tag -> the model's ``build_loglik`` closure (the fused4 and
    adjoint routes), whose ``value_ok_grad`` holds the value within
    H_VALUE_RTOL and the gradient within H_GRAD_RTOL; the value is also
    held against ``fused.gp_log_likelihood`` (bench.py's model against it
    alone).  Float32 (the float64 lowering rounded) is printed, not gated.
    Returns the launch counts."""
    fns, thetas = {}, {}
    for tag, (g, t, y, yerr) in models.items():
        ssm_of = theta_ssm(g, t, yerr, dev)
        y64 = torch.as_tensor(y, device=dev)

        def value(theta, ssm_of=ssm_of, y64=y64):
            return onepass.gp_log_likelihood(ssm_of(theta), y64)

        def value_f32(theta, ssm_of=ssm_of, y64=y64):
            ssm = ssm_of(theta)
            return onepass.gp_log_likelihood(
                type(ssm)(*(x.float() for x in ssm)), y64.float())

        fns[tag] = (value, value_f32)
        thetas[tag] = torch.as_tensor(g.get_parameter_vector(), device=dev)
    reset_counts()
    out = {}
    for tag, (value, value_f32) in fns.items():
        th = thetas[tag]
        with torch.no_grad():
            v = value(th)
        vag = (autograd_value_and_grad(value, th) if tag in refs else None)
        with torch.no_grad():
            v32 = value_f32(th)
        out[tag] = (v, vag, v32)
    torch.cuda.synchronize()
    counts = onepass_counts()
    emit("main_path_H_launches", **counts)
    if min(counts.values()) < 1:
        fail("main path H did not launch every one-pass kernel: "
             "{0}".format(counts))
    result = {}
    for tag, (v, vag, v32) in out.items():
        g, t, y, yerr = models[tag]
        th = thetas[tag]
        ssm = theta_ssm(g, t, yerr, dev)(th)
        ll_fused, _ = fused.gp_log_likelihood(ssm, torch.as_tensor(
            y, device=dev))
        r = dict(n=len(t), width=ssm.U.shape[1], ll_f64=float(v[0]),
                 ok_f64=bool(v[1]), ll_fused_f64=float(ll_fused),
                 rel_err_value_vs_fused=rel(v[0], ll_fused),
                 ll_f32=float(v32[0]), ok_f32=bool(v32[1]),
                 rel_err_f32_vs_f64=(rel(v32[0], v[0])
                                     if bool(v32[1]) else None))
        if vag is not None:
            ll_r, ok_r, g_r = refs[tag].value_ok_grad(th)
            r.update(reference_route=refs[tag].route,
                     ll_reference_f64=float(ll_r),
                     rel_err_value_vs_route=rel(vag[0], ll_r),
                     rel_err_grad_vs_route=grad_rel(vag[2], g_r))
        result[tag] = r
    spread = {}
    for tag, (value, _) in fns.items():
        th = thetas[tag]

        def value_nograd(theta, value=value):
            with torch.no_grad():
                return value(theta)

        spread["value_" + tag] = eval_spread_ms(value_nograd, th, batches=5,
                                                per_batch=5)
        if tag in refs:
            spread["value_and_grad_" + tag] = eval_spread_ms(
                lambda theta, value=value: autograd_value_and_grad(
                    value, theta), th, batches=5, per_batch=3)
    emit("main_path_H", models={"B": "config[2] 2xSHO + jitter (P=8)",
                                "E": "config[2] 4xSHO + jitter (P=16)",
                                "A": "bench.py ComplexTerm (P=2)"},
         **result, ms_per_call=spread)
    for tag, r in result.items():
        if not r["ok_f64"] or r["rel_err_value_vs_fused"] > H_VALUE_RTOL:
            fail("main path H ({0}): float64 value off fused: {1}".format(
                tag, r))
        if "rel_err_grad_vs_route" in r and (
                r["rel_err_value_vs_route"] > H_VALUE_RTOL
                or r["rel_err_grad_vs_route"] > H_GRAD_RTOL):
            fail("main path H ({0}): off the {1} route: {2}".format(
                tag, r["reference_route"], r))
    for tag in refs:
        value = fns[tag][0]

        def value_nograd(theta, value=value):
            with torch.no_grad():
                return value(theta)

        emit("profile_H", model=tag, dtype="float64", call="value",
             **profile_evals(value_nograd, thetas[tag], evals=3))
        emit("profile_H", model=tag, dtype="float64", call="value_and_grad",
             **profile_evals(lambda theta, value=value:
                             autograd_value_and_grad(value, theta),
                             thetas[tag], evals=2))
    return counts


def facade_coefficients(gp):
    """The GP's padded coefficients and jitter, as its solver takes them."""
    kp = torch.as_tensor(gp.parameter_vector)[:gp.kernel.full_size]
    return (float(gp.kernel.get_jitter(kp)),
            [c.detach().numpy() for c in gp.kernel.get_padded_coefficients(
                kp)])


def main_path_i(t, y, yerr, dev):
    """The GP facade on the card (``solver.CholeskySolver``, ``blocked``:
    the factor on the three-pass kernels' elements and factor, the solves
    and products as torch): config[2] on B's data, N = 1e5, float64.
    ``compute``; ``apply_inverse``, held by its residual ||K x - y|| / ||y||
    with K x from ``GP.dot`` plus the diagonal; ``apply_inverse`` on 64
    right-hand sides; ``dot_L`` on 4 and ``sample(seed=7, size=16)``;
    ``predict``'s mean at 1000 points and its covariance at 100;
    ``get_matrix`` on a 2048-point prefix.  Each op is held within I_RTOL
    of the CPU float64 route (``GP(device="cpu")``: ``blocked`` in plain
    torch) and, on a 4096-point prefix, of the sequential solver (``scan``
    on the CPU); each op's ms.  Returns the launch counts."""
    n = len(t)
    rng = np.random.default_rng(11)
    Y = rng.standard_normal((n, 64))
    Z = rng.standard_normal((n, 4))
    xs = np.sort(rng.uniform(0.0, t[-1], 1000))
    ops_ = {
        "apply_inverse": lambda g: g.apply_inverse(y),
        "solve_64": lambda g: g.apply_inverse(Y),
        "dot_L_4": lambda g: g.solver.dot_L(Z),
        "sample_16": lambda g: g.sample(size=16, seed=7),
        "dot": lambda g: g.dot(y),
        "predict_mean_1000": lambda g: g.predict(y, xs, return_cov=False),
        "predict_cov_100": lambda g: np.concatenate(
            [m.ravel() for m in g.predict(y, xs[:100])]),
    }
    reset_counts()
    gp = celerite_torch.GP(config2_kernel(terms))
    ms = {}
    t0 = time.perf_counter()
    gp.compute(t, yerr)
    ms["compute_first"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    gp.compute(t, yerr)
    ms["compute"] = (time.perf_counter() - t0) * 1e3
    got = {}
    for name, op in ops_.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got[name] = op(gp)
        ms[name] = (time.perf_counter() - t0) * 1e3
    gp_m = celerite_torch.GP(config2_kernel(terms))
    gp_m.compute(t[:2048], yerr[:2048])
    t0 = time.perf_counter()
    got["get_matrix_2048"] = gp_m.get_matrix()
    ms["get_matrix_2048"] = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    counts = solver_counts()
    emit("main_path_I_launches", route=gp.solver._route, **counts)
    if gp.solver._route != "blocked" or min(
            counts["elements"], counts["factor"]) < 1:
        fail("main path I did not factor on the three-pass kernels: "
             "{0} {1}".format(gp.solver._route, counts))
    x = got["apply_inverse"]
    residual = float(np.linalg.norm(gp.dot(x) + yerr**2 * x - y)
                     / np.linalg.norm(y))
    # The CPU float64 route on the same inputs.
    cpu = celerite_torch.GP(config2_kernel(terms), device="cpu")
    cpu.compute(t, yerr)
    cpu_m = celerite_torch.GP(config2_kernel(terms), device="cpu")
    cpu_m.compute(t[:2048], yerr[:2048])
    want = {name: op(cpu) for name, op in ops_.items()}
    want["get_matrix_2048"] = cpu_m.get_matrix()
    errs = {name: float(np.abs(got[name] - w).max() / np.abs(w).max())
            for name, w in want.items()}
    errs["log_determinant"] = rel(gp.solver.log_determinant(),
                                  cpu.solver.log_determinant())
    # The sequential solver on a 4096-point prefix, against the card.
    m = 4096
    gp4 = celerite_torch.GP(config2_kernel(terms))
    gp4.compute(t[:m], yerr[:m])
    seq4 = celerite_torch.CholeskySolver("scan", device="cpu")
    jitter, coeffs = facade_coefficients(gp4)
    seq4.compute(jitter, *coeffs, t=t[:m], diag=yerr[:m] ** 2)
    x4 = xs[xs < t[m - 1]]
    pairs = {
        "solve": (gp4.apply_inverse(Y[:m, :8]), seq4.solve(Y[:m, :8])),
        "dot_L": (gp4.solver.dot_L(Z[:m]), seq4.dot_L(Z[:m])),
        "predict": (gp4.predict(y[:m], x4, return_cov=False),
                    seq4.predict(y[:m], x4)),
        "dot": (gp4.dot(Y[:m, 0]), seq4.dot(jitter, *coeffs, None, None,
                                             None, t[:m], Y[:m, 0])),
    }
    errs_seq = {k: float(np.abs(a - b).max() / np.abs(b).max())
                for k, (a, b) in pairs.items()}
    errs_seq["log_determinant"] = rel(gp4.solver.log_determinant(),
                                      seq4.log_determinant())
    emit("main_path_I", model="config[2] 2xSHO + jitter (P=8)", n=n,
         route=gp.solver._route, ms=ms,
         residual_apply_inverse=residual, rel_err_vs_cpu=errs,
         rel_err_prefix_vs_seq=errs_seq, prefix=m,
         sample_shape=list(got["sample_16"].shape))
    if residual > I_RTOL:
        fail("main path I: apply_inverse residual {0}".format(residual))
    bad = {k: e for k, e in {**errs, **{"seq_" + k: e for k, e in
                                         errs_seq.items()}}.items()
           if not e <= I_RTOL}
    if bad:
        fail("main path I: facade ops off the references: {0}".format(bad))
    return counts


# ---- main path K: the predictive variance, CARMA and the backend check ----
K_M = 10_000                    # test points at B's N = 1e5
K_A_M = 100_000                 # test points at A's N = 1e6
K_REPS = 5                      # medians of K_REPS calls
K_ENGINES_N = 4096              # merged points, engines against sequential
K_PREFIX = 2000                 # var against the dense fallback
K_BACKENDS_N = 4096             # check_backends_agree's prefix
K_CARMA = {2: (0.0, [1.0, 0.5], [0.1]), 3: (0.1, [1.3, 0.4, 0.1], [0.5])}
K_MEAN_RTOL = 1e-8    # smoother mean against the lag-state mean, of max |mu|
K_LL_RTOL = 1e-9      # the blocked engine's ll against GP.log_likelihood
K_VAR_RTOL = 1e-8     # var against the dense fallback, of k(0): the dense
                      # variance is k(0) less a quadratic form, so its
                      # rounding scales with k(0), not with var
K_MOMENTS = {"rtol": 1e-9, "atol": 1e-11}  # the JAX suite's engine bars
K_ENGINE_LL_RTOL = 1e-11
K_SHUFFLE_RTOL = 1e-12  # shuffled test points against sorted, of max
K_CARMA_RTOL = 1e-10    # CARMA on the card against the CPU f64 route
K_CARMA_CHOL_RTOL = 1e-8  # its converted kernel's ll (the JAX suite's bar)
K_BACKENDS_RTOL = 1e-9
# Built beside the run for main path K: CARMA(3, 1)'s celerite conversion
# factors on the card at padded width 3.
K_BUILDS = (("pallas_solver.cu", 3),)


def unrealizable_kernel(terms):
    """A product of two SHO terms: positive definite as a whole, its second
    complex term with a c < b d, so with no Gauss-Markov realization."""
    return (terms.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=0.5)
            * terms.SHOTerm(log_S0=0.0, log_Q=1.0, log_omega0=1.5))


def timed_ms(fn, reps=K_REPS):
    """(median ms, last result) of ``reps`` synchronised calls, host
    clock."""
    per, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        per.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(per)), out


def max_rel(got, want):
    """max |got - want| over max |want|."""
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / np.abs(want).max())


def moments_within(got, want, rtol, atol):
    """Whether two arrays agree elementwise at (rtol, atol)."""
    got, want = np.asarray(got), np.asarray(want)
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def kalman_coefficients(gp):
    """The GP kernel's coefficients as ops.smoother takes them."""
    return Coefficients(*gp.kernel.coefficients, jitter=gp.kernel.jitter)


def engine_grid(t, yerr, y, m, jitter, dev, seed):
    """A merged grid: the ``len(t)`` training points and ``m`` sorted test
    points over their span, as tensors on ``dev`` (dt, yv, rv, obs)."""
    xs = np.sort(np.random.default_rng(seed).uniform(t[0], t[-1], m))
    dt, yv, rv, obs, _, _ = smoother._merge_grid(t, yerr**2, y, xs, jitter)
    return xs, [torch.as_tensor(x, device=dev) for x in (dt, yv, rv, obs)]


def main_path_k(t, y, yerr, dev):
    """The predictive variance, CARMA and the backend check on the card
    (ROADMAP queue 1 items 11, 16 and 18), float64.

    config[2] on B's data (N = 1e5): ``GP.predict(y, x, return_var=True)``
    at K_M sorted and shuffled points (the blocked Kalman/RTS engine, the
    grid merged on the card by a stable argsort), its mean held against
    ``predict(return_cov=False)``'s lag-state mean, the searchsorted merge
    equal to the argsort one bit for bit on the same points, shuffled
    against sorted, 0 <= var <= k(0); the blocked engine's ll on the
    training grid against ``GP.log_likelihood``; on a K_PREFIX-point
    prefix the variance against the dense fallback, and an unrealizable
    kernel's (the dense fallback on the card) against the CPU route; the
    blocked and flat engines against the sequential one at K_ENGINES_N
    merged points; timings: the predict (median of K_REPS, profiled
    once), A's N = 1e6 with K_A_M points in one call, ``sample_prior`` at
    N = 1e5 (the engines' sweeps that set their constants are
    tools/kalman_tune.py's).  CARMA at p =
    2 and 3 on 2000 of B's points against the CPU route and its converted
    kernel's ll through the facade.  ``utils.check_backends_agree`` with
    the three-pass kernels on a K_BACKENDS_N-point prefix.  Returns the
    three-pass kernels' launch counts."""
    t_k = time.perf_counter()
    reset_counts()
    n = len(t)
    gp = celerite_torch.GP(config2_kernel(terms))
    gp.compute(t, yerr)
    coeffs = kalman_coefficients(gp)
    real_ = smoother.realize(coeffs)
    k0 = float(gp.kernel.get_value(0.0))
    rng = np.random.default_rng(19)
    xs = np.sort(rng.uniform(0.0, t[-1], K_M))
    perm = rng.permutation(K_M)
    checks, out, parts = {}, {}, {}
    mark = [t_k]

    def part(name):
        """Seconds since the last part, under ``name``."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    # The blocked predict, sorted and shuffled, against the lag-state mean.
    ms_sorted, (mu, var) = timed_ms(
        lambda: gp.predict(y, xs, return_var=True))
    ms_shuffled, (mu_sh, var_sh) = timed_ms(
        lambda: gp.predict(y, xs[perm], return_var=True))
    mu_lag = gp.predict(y, xs, return_cov=False)
    out["rel_err_mean_vs_lag_state"] = max_rel(mu, mu_lag)
    out["rel_err_shuffled_vs_sorted"] = max(max_rel(mu_sh, mu[perm]),
                                            max_rel(var_sh, var[perm]))
    out["var_min"], out["var_max"], out["k0"] = (float(var.min()),
                                                 float(var.max()), k0)
    checks["mean"] = out["rel_err_mean_vs_lag_state"] <= K_MEAN_RTOL
    checks["shuffled"] = out["rel_err_shuffled_vs_sorted"] <= K_SHUFFLE_RTOL
    checks["var_range"] = bool(0.0 <= var.min() and var.max() <= k0
                               and np.all(np.isfinite(mu)))
    # The two device merges on the same sorted points: one grid.
    put = functools.partial(torch.as_tensor, dtype=torch.float64, device=dev)
    args = (put(t), put(yerr**2), put(y), put(xs))
    L = pkalman._BLOCK
    merged = {s: pkalman._predict_var_device(
        real_, *args, coeffs.jitter, pkalman.blocked_filter_smoother,
        sorted_test=s) for s in (True, False)}
    checks["merges_bitwise"] = all(
        torch.equal(a, b) for a, b in zip(merged[True], merged[False]))
    del merged, args
    part("predict")

    # The blocked engine's ll on the training grid.
    grid = [put(x) for x in (np.concatenate([[0.0], np.diff(t)]), y,
                             yerr**2 + coeffs.jitter, np.ones(n))]
    _, _, ll_b = pkalman.blocked_filter_smoother(real_, *grid)
    ll_gp = gp.log_likelihood(y)
    out["ll_blocked"], out["ll_gp"] = float(ll_b), ll_gp
    out["rel_err_ll_blocked_vs_gp"] = rel(ll_b, ll_gp)
    checks["ll"] = out["rel_err_ll_blocked_vs_gp"] <= K_LL_RTOL
    del grid
    part("ll")

    # The variance against the dense fallback on a prefix; an unrealizable
    # kernel (the dense fallback on the card) against the CPU route.
    m = K_PREFIX
    x2 = np.sort(rng.uniform(0.0, t[m - 1], 200))
    gp2 = celerite_torch.GP(config2_kernel(terms))
    gp2.compute(t[:m], yerr[:m])
    ms_prefix, (_, var2) = timed_ms(
        lambda: gp2.predict(y[:m], x2, return_var=True), reps=1)
    dense = gp2._dense_var(x2)
    out["rel_err_var_vs_dense"] = float(np.abs(var2 - dense).max()) / k0
    out["rel_err_var_vs_dense_of_max_var"] = max_rel(var2, dense)
    gpu = celerite_torch.GP(unrealizable_kernel(terms))
    gpu.compute(t[:m], yerr[:m])
    cpu = celerite_torch.GP(unrealizable_kernel(terms), device="cpu")
    cpu.compute(t[:m], yerr[:m])
    mu_u, var_u = gpu.predict(y[:m], x2, return_var=True)
    mu_c, var_c = cpu.predict(y[:m], x2, return_var=True)
    out["unrealizable"] = smoother.realize(kalman_coefficients(gpu)) is None
    out["rel_err_unrealizable_vs_cpu"] = max(
        max_rel(mu_u, mu_c),
        float(np.abs(var_u - var_c).max()) / float(
            gpu.kernel.get_value(0.0)))
    checks["var_dense"] = out["rel_err_var_vs_dense"] <= K_VAR_RTOL
    checks["unrealizable"] = (out["unrealizable"] and
                              out["rel_err_unrealizable_vs_cpu"] <= K_VAR_RTOL
                              and bool(np.all(var_u >= 0)))
    part("dense")

    # The blocked and flat engines against the sequential one at
    # K_ENGINES_N merged points.
    nt = K_ENGINES_N * 7 // 8
    _, g = engine_grid(t[:nt], yerr[:nt], y[:nt], K_ENGINES_N - nt,
                       coeffs.jitter, dev, seed=23)
    ms_seq, seq = timed_ms(lambda: smoother._filter_smoother(real_, *g),
                           reps=1)
    seq = [x.cpu().numpy() for x in seq]
    ms_engines = {"seq": ms_seq}
    out["engines_rel_err"] = {}
    checks["engines"] = True
    for name, engine in (("blocked", pkalman.blocked_filter_smoother),
                         ("flat", pkalman.parallel_filter_smoother)):
        ms_engines[name], got = timed_ms(lambda: engine(real_, *g), reps=3)
        got = [x.cpu().numpy() for x in got]
        out["engines_rel_err"][name] = {"mean": max_rel(got[0], seq[0]),
                                        "var": max_rel(got[1], seq[1]),
                                        "ll": rel(got[2], seq[2])}
        checks["engines"] &= (
            moments_within(got[0], seq[0], **K_MOMENTS)
            and moments_within(got[1], seq[1], **K_MOMENTS)
            and out["engines_rel_err"][name]["ll"] <= K_ENGINE_LL_RTOL)
    del g
    prof = profile_evals(lambda _: gp.predict(y, xs, return_var=True), None,
                         evals=1)
    prof = {k: v for k, v in prof.items()
            if k in ("wall_ms_per_eval", "device_busy_ms_per_eval",
                     "device_idle_share", "kernel_launches_per_eval")}
    part("engines")

    # A's size: N = 1e6 with K_A_M test points, one call.
    ta, ya, yerra = bench_data()
    gpa = celerite_torch.GP(bench_kernel(terms))
    gpa.compute(ta, yerra)
    xa = np.sort(np.random.default_rng(29).uniform(0.0, ta[-1], K_A_M))
    ms_a, (mu_a, var_a) = timed_ms(
        lambda: gpa.predict(ya, xa, return_var=True), reps=1)
    k0a = float(gpa.kernel.get_value(0.0))
    checks["a_size"] = bool(np.all(np.isfinite(mu_a)) and var_a.min() >= 0
                            and var_a.max() <= k0a)
    a_size = {"n": len(ta), "m": K_A_M, "ms": ms_a, "block": L}
    del gpa, ta, ya, yerra, mu_a, var_a
    part("a_size")

    # sample_prior at N = 1e5 (host float64, the transitions on the card).
    t0 = time.perf_counter()
    draw = smoother.sample_prior(kalman_coefficients(
        celerite_torch.GP(config2_kernel(terms))), t, seed=2, device=dev)
    s_prior = time.perf_counter() - t0
    checks["sample_prior"] = bool(draw.shape == (n,)
                                  and np.all(np.isfinite(draw)))
    part("sample_prior")

    # CARMA on the card against the CPU route; its converted kernel.
    tc, yc, ec = t[::50], y[::50], yerr[::50]
    carma_rows = {}
    for p, (ls, ar, ma) in K_CARMA.items():
        card = celerite_torch.CARMASolver(ls, ar, ma)
        host = celerite_torch.CARMASolver(ls, ar, ma, device="cpu")
        ms_c, ll_card = timed_ms(lambda: card.log_likelihood(tc, yc, ec),
                                 reps=1)
        ms_h, ll_host = timed_ms(lambda: host.log_likelihood(tc, yc, ec),
                                 reps=1)
        chol = celerite_torch.CholeskySolver()
        chol.compute(0.0, *card.get_celerite_coeffs(), t=tc, diag=ec**2)
        ll_chol = -0.5 * (chol.dot_solve(yc) + chol.log_determinant()
                          + len(tc) * math.log(2 * math.pi))
        carma_rows[p] = {"n": len(tc), "ms": ms_c, "ms_cpu": ms_h,
                         "ll": ll_card,
                         "rel_err_vs_cpu": rel(ll_card, ll_host),
                         "rel_err_vs_celerite": rel(ll_chol, ll_card)}
    checks["carma"] = all(r["rel_err_vs_cpu"] <= K_CARMA_RTOL
                          and r["rel_err_vs_celerite"] <= K_CARMA_CHOL_RTOL
                          for r in carma_rows.values())
    part("carma")

    # utils.check_backends_agree with the three-pass kernels.
    m = K_BACKENDS_N
    resid = y - gp.mean.get_value(t)
    kc = Coefficients(*(put(c) for c in gp.kernel.coefficients),
                      jitter=put(gp.kernel.jitter))
    ssm = lower(kc, put(t[:m]), put(yerr[:m] ** 2))
    try:
        backends = check_backends_agree(ssm, put(resid[:m]),
                                        rtol=K_BACKENDS_RTOL,
                                        include_pallas=True)
        checks["backends"] = "pallas" in backends
    except AssertionError as err:
        backends = str(err)
        checks["backends"] = False
    part("backends")
    counts = solver_counts()
    emit("main_path_K", model="config[2] 2xSHO + jitter (P=8)", n=n, m=K_M,
         block=L, **out, ms_predict_sorted=ms_sorted,
         ms_predict_shuffled=ms_shuffled, profile_predict=prof,
         ms_prefix_seq=ms_prefix, ms_engines=ms_engines, a_size=a_size,
         sample_prior_s=s_prior, carma=carma_rows, backends=backends,
         launches=counts, checks=checks, seconds_by_part=parts,
         seconds=time.perf_counter() - t_k)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail("main path K failed: {0}".format(bad))
    if min(counts.values()) < 1:
        fail("main path K did not launch every three-pass kernel: "
             "{0}".format(counts))
    return counts


# ---------------------------------------------------------------------------
# Main path L: the light-curve fleet (BASELINE config[4])
# ---------------------------------------------------------------------------

# benchmarks/fleet_smc.py:49-84's fleet: L_CURVES curves of 96-160 points
# on a regular cadence (Delta = 1), yerr 0.3, drawn at seed 4 from a
# ComplexTerm (a, b, c, d) = (0.8, 0, 0.25, 2.0) plus noise; the fleet's
# likelihood at its sampler's kernel, ComplexTerm(log_a=0, log_c=-1,
# log_d=0.5) (P = 2).
L_CURVES = 10_240
L_LENGTHS = (96, 161)
L_YERR = 0.3
L_DRAW = (0.8, 0.25, 2.0)
L_THETA = (0.0, -1.0, 0.5)
# One sample_prior call draws every curve, their grids L_GAP apart: the
# decay exp(-0.25 L_GAP) is 0, so the curves are independent draws.
L_GAP = 1e4
L_CHAINS = 16
L_LL_RTOL = 1e-10     # f64 per-curve ll on the card against the CPU route
L_GRAD_RTOL = 1e-8    # the shared gradient, of its norm
L_F32_RTOL = 1e-4     # f32 against f64, per curve and of the gradient's norm
L_FOLD_RTOL = 1e-12   # a folded chain against its one-chain call
# The fleet plan with pad lanes for rows 1-5 against plain: the first
# L_PAD_CURVES curves cut to L_PAD_STEPS points (the plain versions' time
# follows the steps), 7 pad lanes alone and 3 a chain at 2 chains.
L_PAD_CURVES = 1001
L_PAD_STEPS = 48
L_REPS = 5
# The config[4] example's model and size (32 curves), 128 particles, two
# stages; benchmarks/fleet.py:113-141's per-curve NUTS fits cut to 16
# curves of 2 chains, 20 warmup and 8 sampling transitions at depth 4.
L_SMC = {"n_curves": 32, "n_particles": 128, "max_stages": 2}
L_NUTS = {"curves": 16, "chains": 2, "warmup": 20, "samples": 8,
          "depth": 4}


def fleet_batch(n_curves, dev, seed=4):
    """benchmarks/fleet_smc.py's fleet of ``n_curves`` curves: lengths
    drawn from 96-160, t = 0, 1, ..., y from ``ops.smoother.sample_prior``
    (one call over the curves' grids set L_GAP apart) plus N(0, yerr^2)
    noise.  Returns the LightCurveBatch."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(*L_LENGTHS, n_curves)
    a, c, d = L_DRAW
    coeffs = Coefficients(np.zeros(0), np.zeros(0), np.array([a]),
                          np.array([0.0]), np.array([c]), np.array([d]),
                          np.zeros(()))
    grids = [np.arange(n, dtype=np.float64) for n in lengths]
    t_all = np.concatenate([L_GAP * i + g for i, g in enumerate(grids)])
    y_all = smoother.sample_prior(coeffs, t_all, seed=seed, device=dev)
    y_all = y_all + L_YERR * rng.standard_normal(t_all.size)
    return data.LightCurveBatch.from_ragged(
        grids, np.split(y_all, np.cumsum(lengths)[:-1]),
        [np.full(n, L_YERR) for n in lengths])


def fleet_value_and_grad(fn, theta, dev):
    """``(ll, ok, grad)`` of a fleet closure: autograd of its lls' sum."""
    th = torch.as_tensor(theta).to(dev).detach().requires_grad_()
    ll, ok = fn(th)
    (grad,) = torch.autograd.grad(ll.sum(), th)
    return ll.detach(), ok, grad


def per_lane_rel(got, want):
    """max over lanes of |got - want| / |want| (0 where both are 0)."""
    got, want = got.double().cpu(), want.double().cpu()
    scale = torch.where(want == 0, torch.ones_like(want), want.abs())
    return float(((got - want).abs() / scale).max())


def fleet_kernels_vs_plain(kernel, batch, theta, thetas, dev, errs,
                           grad_errs):
    """Rows 1-5 against their plain versions on fleet plans (state_seg =
    1): the full fleet at one chain and at L_CHAINS, the first
    L_PAD_CURVES curves cut to L_PAD_STEPS points at one chain and two
    (pad lanes), float64 and float32; and the pad lanes' ll (0) from
    run_primal.  Row 1 per lane against its largest value (F64_RTOL,
    F32_PLAIN_RTOL); rows 2-5 as grad_case (GRAD_F64_RTOL, float32 at
    GRAD_F32_PATH_RTOL)."""
    jr, jc = kernel.padded_size
    cf1 = kernel_cf(kernel, theta.to(dev))
    cfs = torch.stack([kernel_cf(kernel, th) for th in thetas.to(dev)])
    head = data.LightCurveBatch(
        *(x[:L_PAD_CURVES, :L_PAD_STEPS] for x in batch[:4]),
        np.minimum(batch.lengths[:L_PAD_CURVES], L_PAD_STEPS))
    cases = [("fleet", batch, 1, cf1), ("fleet_folded", batch, L_CHAINS, cfs),
             ("pad", head, 1, cf1), ("pad_folded", head, 2, cfs[:2])]
    rows = []
    for tag, b, nc, cf64 in cases:
        for dt in (torch.float64, torch.float32):
            plan = lanes4.make_plan4_curves(
                b.t, b.y, b.yerr**2, b.lengths, n_chain=nc, dtype=dt,
                device=dev)
            cf = cf64.to(dt)
            lanes = plan.num_blocks
            got = fused4.primal_cuda(cf, plan, jr, jc, seg=1)
            want = fused4.primal_reference(cf, plan, jr, jc, seg=1)
            e_primal = max(max_rel(g.double().cpu(), w.double().cpu())
                           for g, w in zip(got, want))
            limit = F64_RTOL if dt == torch.float64 else F32_PLAIN_RTOL
            if dt == torch.float64:
                errs.append(max(float((g - w).abs().max())
                                for g, w in zip(got, want)))
            ll, ok = fused4.run_primal(cf, plan, jr, jc,
                                       n_seg=nc if nc > 1 else lanes,
                                       state_seg=1)
            pad_zero = nc > 1 or bool((ll[len(b):] == 0).all())
            rows.append({"case": tag, "dtype": str(dt).split(".")[1],
                         "curves": len(b), "n_chain": nc, "lanes": lanes,
                         "pad_lanes": lanes - len(b) * nc,
                         "steps": plan.t.shape[0],
                         "primal_max_rel_err": e_primal,
                         "ok": bool(ok.all()), "pad_ll_zero": pad_zero})
            if e_primal > limit or not bool(ok.all()) or not pad_zero:
                fail("fleet primal disagrees with plain: {0}".format(
                    rows[-1]))
            grad_case(grad_errs, tag, cf, plan, jr, jc, seg=1,
                      f32_limit=GRAD_F32_PATH_RTOL, curves=len(b),
                      n_chain=nc, lanes=lanes, steps_per_lane=plan.t.shape[0])
            del plan, got, want
    return rows


def fleet_nuts(batch, kernel, theta, dev, seed=2030):
    """``inference.sample_nuts_batch`` over the first L_NUTS["curves"]
    curves, L_NUTS["chains"] chains each: benchmarks/fleet.py's per-curve
    masked likelihood with a N(0, 3^2) prior (``data.make_curve_logprob``,
    every leapfrog one call of rows 2-5 over all rows), the step-size
    search per problem, L_NUTS's transitions and depth.  Gated on finite
    draws and the mean sampling acceptance against SAMPLER_ACCEPT_FLOOR."""
    ncur, nch = L_NUTS["curves"], L_NUTS["chains"]
    sub = data.LightCurveBatch(*(x[:ncur] for x in batch))
    lp = data.make_curve_logprob(
        kernel, lambda th: -0.5 * torch.sum((th / 3.0) ** 2))
    vag = lp.value_and_grad_batch
    calls = []

    def counted(rows, qs):
        calls.append(qs.shape[0])
        return vag(rows, qs)

    lp.value_and_grad_batch = counted
    gen = torch.Generator(device=dev).manual_seed(seed)
    init = torch.as_tensor(theta, dtype=torch.float64, device=dev) \
        + 0.05 * torch.randn(ncur, nch, 3, generator=gen,
                             dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    chains, info = inference.sample_nuts_batch(
        lp, data.curve_rows(sub, device=dev), init, gen,
        num_warmup=L_NUTS["warmup"], num_samples=L_NUTS["samples"],
        max_tree_depth=L_NUTS["depth"], initial_step_size="auto")
    torch.cuda.synchronize()
    out = {"curves": ncur, "chains": nch, "warmup": L_NUTS["warmup"],
           "samples": L_NUTS["samples"], "max_tree_depth": L_NUTS["depth"],
           "seconds": time.perf_counter() - t0,
           "batched_calls": len(calls), "rows_a_call": sorted(set(calls)),
           "shape": list(chains.shape),
           "step_size": info["step_size"].tolist(),
           "mean_accept_sampling": float(info["accept_prob"].mean()),
           "divergences_sampling": int(info["divergences"].sum()),
           "leapfrogs_sampling": int(info["num_steps"].sum()),
           "finite": bool(torch.isfinite(chains).all())}
    if not out["finite"] or out["shape"] != [ncur, nch, L_NUTS["samples"], 3]:
        fail("fleet NUTS: draws not finite or misshapen: {0}".format(out))
    if out["mean_accept_sampling"] < SAMPLER_ACCEPT_FLOOR:
        fail("fleet NUTS: sampling collapsed: {0}".format(out))
    if set(calls) != {ncur * nch}:
        fail("fleet NUTS: a call did not take every row: {0}".format(
            sorted(set(calls))))
    return out


def main_path_l(dev, errs, grad_errs):
    """The light-curve fleet on the card (ROADMAP queue 1 items 7, 13 and
    14; BASELINE config[4]), one lane a curve.

    On ``fleet_batch(L_CURVES)`` at ComplexTerm L_THETA (P = 2):
    ``data.make_fleet_loglik`` at one chain, per-curve ll and the shared
    gradient (rows 2-5) and the value alone (row 1), float64 and float32,
    against the CPU route (``batched_gp_log_likelihood``, float64) over
    all curves; at L_CHAINS chains folded (16 parameter sets), each
    chain's fleet sum and gradient against one-chain calls; the config[4]
    example (``config4_pod_smc.main``: 32 curves, 128 particles, two
    stages of ``sample_smc``, each batch of particles one folded call);
    ``inference.sample_nuts_batch`` on benchmarks/fleet.py's per-curve
    likelihood (``fleet_nuts``).  The counters are read after these; then
    rows 1-5 against their plain versions on the fleet plans
    (``fleet_kernels_vs_plain``), and the timings: a value and gradient at
    1 and L_CHAINS chains (median of L_REPS, host clock), profiled once.
    Returns the launch counts of rows 1-5."""
    t_l = time.perf_counter()
    parts, mark = {}, [t_l]

    def part(name):
        """Seconds since the last part, under ``name``."""
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    batch = fleet_batch(L_CURVES, dev)
    part("data")
    kernel = terms.ComplexTerm(*L_THETA)
    theta = torch.tensor(L_THETA, dtype=torch.float64)
    thetas = theta + 0.05 * torch.as_tensor(
        np.random.default_rng(6).standard_normal((L_CHAINS, 3)))
    ref_ll, ref_ok, ref_g = fleet_value_and_grad(
        lambda th: data.batched_gp_log_likelihood(kernel, th, batch,
                                                  device="cpu"),
        theta, "cpu")
    part("cpu_reference")
    fleets = {dt: data.make_fleet_loglik(kernel, batch, dtype=dt, device=dev)
              for dt in (torch.float64, torch.float32)}
    folded = data.make_fleet_loglik(kernel, batch, n_chain=L_CHAINS,
                                    device=dev)
    checks, out = {}, {}
    part("plans")
    reset_counts()
    got = {dt: fleet_value_and_grad(f, theta, dev)
           for dt, f in fleets.items()}
    with torch.no_grad():
        vals = {dt: f(theta.to(dev)) for dt, f in fleets.items()}
        val16 = folded(thetas.to(dev))
    got16 = fleet_value_and_grad(folded, thetas, dev)
    ones = [fleet_value_and_grad(fleets[torch.float64], th, dev)
            for th in thetas]
    part("fleet_calls")
    with contextlib.redirect_stdout(io.StringIO()) as smc_log:
        smc_res, smc_like = config4_pod_smc.main(device=dev, **L_SMC)
    part("smc_example")
    nuts = fleet_nuts(batch, kernel, theta, dev)
    part("nuts_batch")
    counts = {"primal": fused4.primal_cuda.launches, **grad_counts()}

    ll64, ok64, g64 = got[torch.float64]
    ll32, ok32, g32 = got[torch.float32]
    out["ll_shape"] = list(ll64.shape)
    out["rel_err_ll_f64_vs_cpu"] = per_lane_rel(ll64, ref_ll)
    out["rel_err_value_f64_vs_cpu"] = per_lane_rel(vals[torch.float64][0],
                                                   ref_ll)
    out["rel_err_grad_f64_vs_cpu"] = grad_rel(g64.cpu(), ref_g)
    out["rel_err_ll_f32_vs_f64"] = per_lane_rel(ll32, ll64)
    out["rel_err_value_f32_vs_f64"] = per_lane_rel(vals[torch.float32][0],
                                                   ll64)
    out["rel_err_grad_f32_vs_f64"] = grad_rel(g32.double(), g64)
    checks["shape"] = out["ll_shape"] == [L_CURVES]
    checks["ok"] = all(bool(x.all()) for x in (
        ref_ok, ok64, ok32, vals[torch.float64][1], vals[torch.float32][1],
        got16[1], val16[1]))
    checks["f64"] = (out["rel_err_ll_f64_vs_cpu"] <= L_LL_RTOL
                     and out["rel_err_value_f64_vs_cpu"] <= L_LL_RTOL
                     and out["rel_err_grad_f64_vs_cpu"] <= L_GRAD_RTOL)
    checks["f32"] = max(out["rel_err_ll_f32_vs_f64"],
                        out["rel_err_value_f32_vs_f64"],
                        out["rel_err_grad_f32_vs_f64"]) <= L_F32_RTOL
    sums = torch.stack([o[0].sum() for o in ones])
    grads = torch.stack([o[2] for o in ones])
    out["rel_err_fold_ll"] = per_lane_rel(got16[0], sums)
    out["rel_err_fold_value"] = per_lane_rel(val16[0], sums)
    out["rel_err_fold_grad"] = max(grad_rel(got16[2][c], grads[c])
                                   for c in range(L_CHAINS))
    checks["folded"] = (out["rel_err_fold_ll"] <= L_FOLD_RTOL
                        and out["rel_err_fold_grad"] <= L_FOLD_RTOL
                        and out["rel_err_fold_value"] <= F64_RTOL)
    out["smc"] = {"stages": smc_res.num_stages,
                  "log_evidence": float(smc_res.log_evidence),
                  "final_accept": float(smc_res.final_accept),
                  "betas": smc_res.betas.tolist(),
                  "particles_a_call": smc_like.chunk,
                  "lanes_a_call": smc_like.plan.num_blocks,
                  "log": smc_log.getvalue().strip().splitlines()}
    checks["smc"] = (smc_res.num_stages >= 1
                     and math.isfinite(out["smc"]["log_evidence"])
                     and out["smc"]["final_accept"] > 0.0
                     and bool(torch.isfinite(smc_res.particles).all()))
    out["nuts"] = nuts
    emit("main_path_L", model="ComplexTerm(log_a, log_c, log_d) (P=2)",
         curves=L_CURVES, points=int(batch.lengths.sum()),
         lanes=fleets[torch.float64].plan.num_blocks,
         lanes_folded=folded.plan.num_blocks,
         steps_per_lane=fleets[torch.float64].plan.t.shape[0],
         launches=counts, **out, checks=checks, seconds_by_part=parts)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail("main path L failed: {0}".format(bad))
    if min(counts.values()) < 1:
        fail("main path L did not launch rows 1-5: {0}".format(counts))

    rows = fleet_kernels_vs_plain(kernel, batch, theta, thetas, dev, errs,
                                  grad_errs)
    part("kernels_vs_plain")
    timing = {}
    for tag, fn, th, n_curves in (
            ("one_chain", fleets[torch.float64], theta, L_CURVES),
            ("folded", folded, thetas, L_CURVES * L_CHAINS)):
        def call(fn=fn, th=th):
            return fleet_value_and_grad(fn, th, dev)

        before = dict(grad_counts())
        ms, _ = timed_ms(call, reps=L_REPS)
        launched = {k: v - before[k] for k, v in grad_counts().items()}
        prof = profile_evals(lambda _: call(), None, evals=L_REPS)
        timing[tag] = {"ms_value_and_grad": ms,
                       "kernel_launches_a_call": {
                           k: v / L_REPS for k, v in launched.items()},
                       "curves_per_s": n_curves / ms * 1e3,
                       "device_idle_share": prof["device_idle_share"],
                       "device_busy_ms": prof["device_busy_ms_per_eval"],
                       "launches_a_call": prof["kernel_launches_per_eval"],
                       "kernel_ms": prof["kernel_ms_per_eval"],
                       "glue_ms": prof["glue_ms_per_eval"]}
    part("timing")
    emit("main_path_L_kernels_and_times", kernels_vs_plain=rows,
         timing=timing, seconds_by_part=parts,
         seconds=time.perf_counter() - t_l)
    return counts


# ---- main path M: general (A, U, V) blocks ----
# benchmarks/general_row.py's data and kernel (celerite_torch.testing.
# general_problem / general_kernel: padded width 4) at general rank 4, 9
# and 14: P = 8, 13 and 18, widths the script builds already (M3 above 16).
M_CASES = {"M1": (4, 65_536), "M2": (9, 16_384), "M3": (14, 4_096)}
# (name, build_loglik options) of each route at M1 and M2, and the rows
# each runs on the card: rows 12-14 for "pallas" and for "fused" above
# P = 8, row 15 for "fused" at P <= 8; "adjoint" the value on "fused" and
# the gradient on rows 8-11; "tangent" the gradient on row 18 at P <= 8,
# rows 16-17 above.  "auto" is the plain blocked solver.
M_ROUTES = {
    "M1": (("auto", {}), ("fused", {"solver": "fused"}),
           ("pallas", {"solver": "pallas"}),
           ("tangent", {"solver": "fused", "fast_grad": "tangent"})),
    "M2": (("fused", {"solver": "fused"}),
           ("adjoint", {"solver": "fused", "fast_grad": True}),
           ("tangent", {"solver": "fused", "fast_grad": "tangent"})),
}
M_LL_RTOL = 1e-10     # f64 ll on the card against the CPU f64 blocked route
M_GRAD_RTOL = 1e-8    # the gradient, of its norm
M_F32_RTOL = 1e-4     # f32 ll against f64
M_DENSE_N = 4096      # M1's prefix held against the dense K
M_DENSE_RTOL = 1e-9
M_PREDICT_M = 256
M_NUTS = {"chains": 2, "warmup": 20, "samples": 8, "depth": 4}
M_REPS = 5


def m_counts():
    """Rows 8-18's launch counters."""
    return {**adjoint_counts(), **solver_counts(), **tangent_counts()}


def m_problem(name):
    rank, n = M_CASES[name]
    t, y, yerr, A, U, V = general_problem(n, rank)
    return t, y, yerr, (A, U, V)


def m_gp(problem, device=None):
    t, _, yerr, (A, U, V) = problem
    gp = celerite_torch.GP(general_kernel(terms), device=device)
    gp.compute(t, yerr, A=A, U=U, V=V)
    return gp


def m_reference(problem):
    """(GP on the CPU, its log determinant, ll, ok, gradient): the CPU
    float64 ``blocked`` route and autograd through it."""
    t, y, yerr, _ = problem
    cpu = m_gp(problem, device="cpu")
    fn = cpu.build_loglik(t, y, yerr=yerr, solver="blocked")
    theta = torch.as_tensor(cpu.get_parameter_vector())
    ll, ok, grad = autograd_value_and_grad(fn, theta)
    return cpu.solver.log_determinant(), float(ll), bool(ok), grad


def m_dense_check(problem, dev):
    """The first M_DENSE_N points of ``problem`` on the card against the
    dense K (``dense.build_matrix`` with the general blocks, Cholesky on the
    card): ll, ``apply_inverse``, ``dot``, ``predict(return_var=True)`` at
    M_PREDICT_M points against the dense formulas; a ``sample``."""
    t, y, yerr, (A, U, V) = problem
    m = M_DENSE_N
    sub = (t[:m], y[:m], yerr[:m], (A[:m], U[:, :m], V[:, :m]))
    gp = m_gp(sub)
    t4, y4, yerr4, gen = sub
    kern = gp.kernel
    kp = torch.as_tensor(kern.get_parameter_vector())

    def d(x):
        return torch.as_tensor(np.asarray(x, np.float64), device=dev)

    coeffs = Coefficients(*(c.to(dev) for c in
                            kern.get_padded_coefficients(kp)),
                          jitter=kern.get_jitter(kp).to(dev))
    K = ops.dense.build_matrix(coeffs, d(t4), diag=d(yerr4) ** 2,
                               A_gen=d(gen[0]), U_gen=d(gen[1]),
                               V_gen=d(gen[2]))
    chol = torch.linalg.cholesky(K)
    yd = d(y4)[:, None]
    alpha = torch.cholesky_solve(yd, chol)[:, 0]
    ll_dense = float(-0.5 * (yd[:, 0] @ alpha
                             + 2 * torch.log(torch.diagonal(chol)).sum()
                             + m * math.log(2 * math.pi)))
    rng = np.random.default_rng(12)
    z = rng.standard_normal(m)
    xs = np.sort(rng.uniform(t4[0], t4[-1], M_PREDICT_M))
    Kxs = ops.dense.build_matrix(coeffs, d(xs), t2=d(t4))
    mu_dense = (Kxs @ alpha).cpu().numpy()
    var_dense = (float(kern.get_value(0.0)) - torch.sum(
        Kxs * torch.cholesky_solve(Kxs.T.contiguous(), chol).T,
        dim=1)).cpu().numpy()
    K0z = ((K - torch.diag(d(yerr4) ** 2)) @ d(z)).cpu().numpy()
    mu, var = gp.predict(y4, xs, return_var=True)
    draws = gp.sample(size=4, seed=3)
    errs = {
        "ll": rel(gp.log_likelihood(y4), ll_dense),
        "apply_inverse": max_rel(gp.apply_inverse(y4).reshape(-1),
                                 alpha.cpu().numpy()),
        "dot": max_rel(gp.dot(z), K0z),
        "predict_mean": max_rel(mu, mu_dense),
        "predict_var": max_rel(var, var_dense),
    }
    return gp, sub, errs, bool(np.all(np.isfinite(draws))), list(
        draws.shape)


def m_nuts(gp, sub, dev):
    """``inference.sample_nuts`` on the dense check's model, on data drawn
    from it (``GP.sample``; general_row.py's y is white noise, on which 20
    warmup transitions left 15 of 16 sampling transitions divergent):
    M_NUTS's chains, warmup and sampling transitions and tree depth, a
    dense mass, a Gaussian prior (sd 1) around the kernel's parameters;
    the log probability through ``solver="fused", fast_grad="tangent"``
    (the value on row 15, the gradient on row 18) under the samplers'
    autograd fallback."""
    t4, _, yerr4, _ = sub
    y4 = gp.sample(seed=2032)
    theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)

    def prior(th):
        return -0.5 * torch.sum((th - theta) ** 2)

    lp = gp.build_logprob(t4, y4, yerr=yerr4, log_prior=prior,
                          solver="fused", fast_grad="tangent")
    gen = torch.Generator(device=dev).manual_seed(2031)
    q0 = theta[None] + 0.02 * torch.randn(
        M_NUTS["chains"], theta.shape[0], generator=gen,
        dtype=torch.float64, device=dev)
    t0 = time.perf_counter()
    chain, info = inference.sample_nuts(
        lp, q0, gen, num_warmup=M_NUTS["warmup"],
        num_samples=M_NUTS["samples"], max_tree_depth=M_NUTS["depth"],
        warmup_max_tree_depth=M_NUTS["depth"], initial_step_size="auto",
        dense_mass=True)
    torch.cuda.synchronize()
    out = {"route": lp.loglik.route, "seconds": time.perf_counter() - t0,
           "step_size": float(info["step_size"]),
           "mean_accept_sampling": float(info["accept_prob"]),
           "divergences_sampling": int(info["divergences"]),
           "leapfrog_slots_sampling": int(info["num_steps"]),
           "finite": bool(torch.isfinite(chain).all()),
           "shape": list(chain.shape)}
    out["ok"] = (out["finite"]
                 and out["mean_accept_sampling"] >= SAMPLER_ACCEPT_FLOOR
                 and out["divergences_sampling"]
                 < M_NUTS["chains"] * M_NUTS["samples"])
    return out


def m_rows_vs_plain(problems, dev, adj_errs, solver_errs, tangent_errs):
    """Rows 8-18 against their plain versions on M1's and M2's phi = 1
    streams, laid out as the routes lay them: rows 12-14 on the blocks of
    ``pallas_solver.default_block_size`` steps; at M1 (P = 8) row 15 on
    ``fused.default_num_blocks`` lanes, rows 16-18 on
    ``tangent.default_jac_blocks`` lanes with the parameters' tangents
    (zero on the general columns); at M2 (P = 13) rows 8-11 on
    ``adjoint.default_adjoint_blocks`` lanes and rows 16-17 on the jac
    lanes.  Float64, at F64_RTOL and TANGENT_F64_RTOL; each kernel's
    error joins its row's ``max_abs_err``."""
    kern = general_kernel(terms)
    for name, problem in problems.items():
        t, y, yerr, gen = problem
        n = len(t)
        tag = "main_path_" + name
        info = {"n": n, "general_rank": M_CASES[name][0]}
        solver_case(solver_errs, tag, blocked_streams(
            kern, t, y, yerr, pallas_solver.default_block_size(dev),
            device=dev, general=gen), F64_RTOL, **info)
        b = tangent.default_jac_blocks(n, dev)
        s, dirs = general_lane_streams(kern, t, y, yerr, gen, b, device=dev)
        jac = ("jac",) if s[0].shape[1] <= fused.MAX_WIDTH else ()
        tangent_case(tangent_errs, tag, s, dirs, b,
                     ("elements_jvp", "factor_jvp") + jac, **info)
        del s, dirs
        if m_width(kern, gen) <= fused.MAX_WIDTH:
            b = fused.default_num_blocks(n, dev)
            s, _ = general_lane_streams(kern, t, y, yerr, gen, b,
                                        device=dev)
            tangent_case(tangent_errs, tag, s, None, b, ("fused",), **info)
        else:
            b = adjoint.default_adjoint_blocks(n, dev)
            s, _ = general_lane_streams(kern, t, y, yerr, gen, b,
                                        device=dev)
            adjoint_case(adj_errs, tag, s, b, F64_RTOL, **info)
        del s
        torch.cuda.empty_cache()


def m_width(kern, gen):
    """Padded width P of a kernel with general blocks."""
    pr, pc = kern.padded_size
    return pr + 2 * pc + gen[1].shape[0]


def m_value_and_grad_ms(fn, theta, profile_grad=True):
    """A value (no autograd) and a value and gradient: each the median ms of
    M_REPS synchronised calls (host clock) and its launches of rows 8-18 a
    call; the value's device idle share profiled over three calls, the
    value and gradient's over one where ``profile_grad`` (a backward
    through plain ``blocked`` is ~19,500 launches, ~15 s under the
    profiler, so M_ROUTES's routes that share it profile it once)."""
    def value():
        with torch.no_grad():
            return fn(theta)

    def vg():
        return autograd_value_and_grad(fn, theta)

    out = {}
    for tag, call, evals in (("value", value, 3),
                             ("value_and_grad", vg, profile_grad)):
        call()
        before = m_counts()
        ms, _ = timed_ms(call, reps=M_REPS)
        out[tag] = {"ms": ms, "row_launches_a_call": {
            k: (v - before[k]) / M_REPS for k, v in m_counts().items()
            if v > before[k]}}
        if evals:
            prof = profile_evals(lambda _: call(), None, evals=int(evals))
            out[tag].update(
                launches_a_call=prof["kernel_launches_per_eval"],
                device_busy_ms=prof["device_busy_ms_per_eval"],
                device_idle_share=prof["device_idle_share"])
    return out


def main_path_m(dev, adj_errs, solver_errs, tangent_errs):
    """General (A, U, V) semiseparable blocks on the card (ROADMAP queue 1
    item 10), on :func:`general_problem`'s data and
    :func:`general_kernel` at M_CASES's general ranks and sizes, float64
    but where stated:

    - ``GP.compute`` (rows 12-13 through ``blocked.factor`` at M1 and M2,
      the plain passes at M3): its log determinant against the CPU float64
      route, M_LL_RTOL;
    - ``build_loglik`` by each route of M_ROUTES at M1 and M2, and
      ``"auto"`` at M3: ll against the CPU float64 ``blocked`` route
      (M_LL_RTOL), the gradient (autograd through the closure, or its
      ``fast_grad`` route) against autograd through it (M_GRAD_RTOL of its
      norm); float32 ``"auto"``, ``"fused"`` and ``"pallas"`` at M1 against
      float64 (M_F32_RTOL); ``"fused"`` at M3 (P = 18) raises naming queue 2
      item 10;
    - :func:`m_dense_check` on M1's first M_DENSE_N points and
      :func:`m_nuts` on that model.

    The counters of rows 8-18 are read after these and each must have
    launched; then :func:`m_rows_vs_plain` and the timings of each route
    (:func:`m_value_and_grad_ms`).  Returns the launch counts."""
    t_m = time.perf_counter()
    parts, mark = {}, [t_m]

    def part(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    problems = {name: m_problem(name) for name in M_CASES}
    refs = {name: m_reference(p) for name, p in problems.items()}
    part("data_and_cpu_reference")
    reset_counts()
    gps, out, checks = {}, {}, {}
    for name, problem in problems.items():
        t, y, yerr, gen = problem
        gp = gps[name] = m_gp(problem)
        logdet, ll_ref, ok_ref, g_ref = refs[name]
        res = out[name] = {
            "n": len(t), "general_rank": M_CASES[name][0],
            "width": m_width(gp.kernel, gen),
            "compute_route": gp.solver._route,
            "rel_err_log_determinant": rel(gp.solver.log_determinant(),
                                           logdet),
            "ll_cpu": ll_ref, "routes": {}}
        checks[name + "_compute"] = (
            ok_ref and res["rel_err_log_determinant"] <= M_LL_RTOL)
        theta = torch.as_tensor(gp.get_parameter_vector(), device=dev)
        for route, kw in M_ROUTES.get(name, (("auto", {}),)):
            fn = gp.build_loglik(t, y, yerr=yerr, **kw)
            ll, ok, grad = autograd_value_and_grad(fn, theta)
            r = res["routes"][route] = {
                "route": fn.route, "ok": bool(ok),
                "rel_err_ll": rel(ll, ll_ref),
                "rel_err_grad": grad_rel(grad.cpu(), g_ref)}
            checks["{0}_{1}".format(name, route)] = (
                r["ok"] and r["rel_err_ll"] <= M_LL_RTOL
                and r["rel_err_grad"] <= M_GRAD_RTOL)
        if name == "M1":
            for route, kw in M_ROUTES[name][:3]:
                fn = gp.build_loglik(t, y, yerr=yerr, dtype=torch.float32,
                                     **kw)
                with torch.no_grad():
                    ll32, ok32 = fn(theta.float())
                res["routes"][route]["rel_err_ll_f32_vs_f64"] = rel(
                    ll32, ll_ref)
                checks["M1_{0}_f32".format(route)] = (
                    bool(ok32) and rel(ll32, ll_ref) <= M_F32_RTOL)
        if name == "M3":
            try:
                gp.build_loglik(t, y, yerr=yerr, solver="fused")
                res["fused_raises"] = None
            except NotImplementedError as e:
                res["fused_raises"] = str(e)
            checks["M3_fused_raises"] = "queue 2, item 10" in str(
                res["fused_raises"])
    part("routes")
    gp4, sub, dense_errs, sample_ok, sample_shape = m_dense_check(
        problems["M1"], dev)
    out["dense_M1_prefix"] = {"n": M_DENSE_N, "rel_err": dense_errs,
                              "sample_finite": sample_ok,
                              "sample_shape": sample_shape}
    checks["dense"] = (max(dense_errs.values()) <= M_DENSE_RTOL
                       and sample_ok)
    part("dense")
    nuts = out["nuts"] = m_nuts(gp4, sub, dev)
    checks["nuts"] = nuts["ok"]
    part("nuts")
    counts = m_counts()
    emit("main_path_M", model="benchmarks/general_row.py's two SHO terms "
         "as ComplexTerms (P=4) + general blocks", launches=counts,
         **out, checks=checks, seconds_by_part=parts)
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        fail("main path M failed: {0}".format(bad))
    missed = [k for k, v in counts.items() if v < 1]
    if missed:
        fail("main path M did not launch rows {0}".format(missed))

    m_rows_vs_plain({k: problems[k] for k in ("M1", "M2")}, dev, adj_errs,
                    solver_errs, tangent_errs)
    part("rows_vs_plain")
    timing = {}
    for name in ("M1", "M2"):
        t, y, yerr, _ = problems[name]
        theta = torch.as_tensor(gps[name].get_parameter_vector(),
                                device=dev)
        for route, kw in M_ROUTES[name]:
            fn = gps[name].build_loglik(t, y, yerr=yerr, **kw)
            # Without fast_grad, "fused" and "pallas" take M1 "auto"'s
            # backward (autograd through plain blocked).
            timing["{0}_{1}".format(name, route)] = m_value_and_grad_ms(
                fn, theta, profile_grad=route in ("auto", "adjoint",
                                                  "tangent"))
    part("timing")
    emit("main_path_M_times", timing=timing, seconds_by_part=parts,
         seconds=time.perf_counter() - t_m)
    return counts


def redesigned_summary(smi, ptxas, primal_rows, grad_rows, tangent_rows,
                       adj_rows, onepass_rows, solver_rows):
    """The kernels redesigned for this card and those sharing their code,
    with the card's name and power limit: ptxas's registers and spill bytes
    of each at every width built, and their timings on each plan (row 1,
    which runs rows 2's and 4's sweeps without saves, on A's and B's plans
    with its launches' split; row 15 on G's value plan, its seven launches'
    split beside; rows 2,
    5 and 4 on C's 1- and 16-chain plans, row 3, which runs row 9's
    transposed step in row 5's layout, rows 2 and 4, which run rows 8's
    and 10's steps; row 18 on G's plans, with its four launches' split;
    rows 16 and 17 on E's model, both in row 18's layout at P = 13 and 16;
    rows 8, 9, 10 and 11 on E's plans; rows 19 and 20, which run row
    10's sweep from a zero seed, and row 21, which shares row 11's sweep
    and row 5's transposed step, on H's plans, at ONEPASS_WIDTHS; rows
    12-14 on F's plans: 12 runs row 8's sweep without saves, 13 row 10's
    step without its statistics, 14 the same ring)."""
    def regs(src, prefix, widths=None):
        return {p: {k: v for k, v in kerns.items() if k.startswith(prefix)}
                for p, kerns in ptxas[src].items()
                if widths is None or p in widths}

    def grad(name):
        return {"ptxas": regs("fused4_grad.cu", name),
                "chains": {nc: rows[name] for nc, rows in grad_rows.items()}}

    def tan(name, prefix, widths):
        return {"ptxas": regs("tangent.cu", prefix, widths),
                "plans": {k: v[name] for k, v in tangent_rows.items()
                          if name in v}}

    return {
        "card": smi,
        "primal": {"ptxas": regs("fused4_primal.cu", ""),
                   "plans": primal_rows},
        "fused": {"ptxas": regs("fused.cu", "fused_"),
                  "plans": {k: v["fused"] for k, v in tangent_rows.items()
                            if "fused" in v}},
        "elem_fwd": grad("elem_fwd"),
        "factor_bwd": grad("factor_bwd"),
        "elem_bwd": grad("elem_bwd"),
        "factor_fwd": grad("factor_fwd"),
        "jac": tan("jac", "jac_", None),
        "split_pair": tan("elements_jvp", "jac_elements", (13, 16)),
        "factor_jvp": tan("factor_jvp", "jac_factor", (13, 16)),
        "adjoint_elements_fwd": {
            "ptxas": regs("adjoint.cu", "adjoint_elements_fwd"),
            "chains": {nc: rows["elements_fwd"]
                       for nc, rows in adj_rows.items()}},
        "adjoint_elements_bwd": {
            "ptxas": regs("adjoint.cu", "adjoint_elements_bwd"),
            "chains": {nc: rows["elements_bwd"]
                       for nc, rows in adj_rows.items()}},
        "adjoint_factor_fwd": {
            "ptxas": regs("adjoint.cu", "adjoint_factor_fwd"),
            "chains": {nc: rows["factor_fwd"]
                       for nc, rows in adj_rows.items()}},
        "adjoint_factor_bwd": {
            "ptxas": regs("adjoint.cu", "adjoint_factor_bwd"),
            "chains": {nc: rows["factor_bwd"]
                       for nc, rows in adj_rows.items()}},
        **{"onepass_" + name: {
            "ptxas": regs("onepass.cu", prefix),
            "models": {m: rows[name] for m, rows in onepass_rows.items()}}
           for name, prefix in (("sweep", "onepass_sweep"),
                                ("sweep_fwd", "onepass_fwd"),
                                ("sweep_bwd", "onepass_bwd"))},
        **{"solver_" + name: {
            "ptxas": regs("pallas_solver.cu", "solver_" + name),
            "plans": {k: rows[name] for k, rows in solver_rows.items()}}
           for name in pallas_solver.SOLVER_KERNELS},
    }


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
    widths = {"fused4_primal.cu": GRAD_PTXAS_WIDTHS,
              "fused4_grad.cu": GRAD_PTXAS_WIDTHS,
              "dsfused.cu": WIDTHS, "adjoint.cu": WIDE_WIDTHS,
              "pallas_solver.cu": SOLVER_WIDTHS,
              "fused.cu": FUSED_PTXAS_WIDTHS,
              "tangent.cu": TANGENT_WIDTHS, "onepass.cu": ONEPASS_WIDTHS}
    # The widths the run launches build first; those only ptxas's figures
    # take build beside the run (~25-40 s of nvcc) and are waited for at
    # the end.
    run_widths = {"fused4_primal.cu": WIDTHS, "fused4_grad.cu": WIDTHS,
                  "fused.cu": FUSED_WIDTHS}
    jobs = [(src, p) for src, ps in widths.items() for p in ps]
    first = [j for j in jobs if j[1] in run_widths.get(j[0], widths[j[0]])]
    later = [j for j in jobs if j not in first] + list(K_BUILDS)
    paths = dict(zip(first, _build.build(
        [(src, {"CELERITE_P": p}) for src, p in first])))
    ptxas = {}
    for (src, p), path in paths.items():
        ptxas.setdefault(src, {})[p] = ptxas_summary(
            path.with_suffix(".ptxas.txt"))
    beside = concurrent.futures.ThreadPoolExecutor(1)
    later_paths = beside.submit(
        _build.build, [(src, {"CELERITE_P": p}) for src, p in later])
    emit("build", seconds=time.perf_counter() - t0,
         widths={src: list(ps) for src, ps in widths.items()},
         built_beside=[list(j) for j in later],
         flags={src: list(_build.FLAGS + _build.SOURCE_FLAGS.get(src, ()))
                for src in widths})

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
    primal_rows = {"A": {
        "lanes": plan32.num_blocks, "steps": plan32.t.shape[0],
        "ms_f32": ms_kernel, "ms_f64": ms_kernel64,
        "split_ms_f32": launch_split_ms(
            lambda: fused4.primal_cuda(cf32, plan32, pr, pc)),
        "split_ms_f64": launch_split_ms(
            lambda: fused4.primal_cuda(cf, plan64, pr, pc))}}
    emit("kernel_time_A", ms_f32=ms_kernel, plain_ms_f32=ms_plain,
         bound_ms_f32=bms, bound_by_f32=bby, ms_f64=ms_kernel64,
         bound_ms_f64=bms64, bound_by_f64=bby64,
         split_ms_f32=primal_rows["A"]["split_ms_f32"],
         split_ms_f64=primal_rows["A"]["split_ms_f64"])

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
    t, y, yerr = b_data()
    n = len(t)
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
    primal_rows["B"] = {
        "lanes": plan64.num_blocks, "steps": plan64.t.shape[0],
        "ms_f32": sync_time_ms(
            lambda: fused4.primal_cuda(cfb32, plan32, pr, pc), reps=20),
        "ms_f64": sync_time_ms(
            lambda: fused4.primal_cuda(cfb, plan64, pr, pc), reps=20),
        "split_ms_f32": launch_split_ms(
            lambda: fused4.primal_cuda(cfb32, plan32, pr, pc)),
        "split_ms_f64": launch_split_ms(
            lambda: fused4.primal_cuda(cfb, plan64, pr, pc))}
    emit("main_path_B", model="config[2] 2xSHO + jitter (P=8)", n=n,
         lanes=plan64.num_blocks, steps_per_lane=plan64.t.shape[0],
         logprob_f32=vals[torch.float32], logprob_f64=vals[torch.float64],
         logprob_plain_f64=lp_ref, rel_err_f64_kernel_vs_plain=eb64,
         rel_err_f32_vs_f64=eb32, rel_err_f32_kernel_vs_f32_plain=eb32p,
         launches=launches_b, ms_per_eval=spread_b,
         kernel_ms_f32=primal_rows["B"]["ms_f32"],
         kernel_ms_f64=primal_rows["B"]["ms_f64"],
         split_ms_f32=primal_rows["B"]["split_ms_f32"],
         split_ms_f64=primal_rows["B"]["split_ms_f64"],
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

    # ---- main path J: ADVI, Laplace, MAP and SMC on config[2] ----
    counts_j = main_path_j(gp, lps[torch.float64], prior, theta, t, y, yerr,
                           dev, grad_errs)
    torch.cuda.empty_cache()

    # ---- exact mode: ds_kernels, main path D, sampler_D ----
    lpd = gp.build_logprob(t, y, yerr=yerr, log_prior=prior, precision="ds")
    if lpd.loglik.route != "dsfused":
        fail("precision='ds' on config[2] took the {0} route".format(
            lpd.loglik.route))
    ds_errs = {name: [] for name in dsfused.DS_KERNELS}
    ds_rows = check_ds_kernels(dev, gp, lpd, theta, thetas, ds_errs)
    counts_d = main_path_d(gp, lpd, lps[torch.float64], theta, thetas)
    lane_sweep_d(t, y, yerr, packed_cf_ds(gp, theta),
                 torch.stack([packed_cf_ds(gp, th) for th in thetas]), pr, pc,
                 dev)
    grew_d = sampler_nuts("sampler_D", lpd, theta, dev, ds_counts,
                          SAMPLER_D_CHAINS, SAMPLER_D_WARMUP,
                          SAMPLER_D_SAMPLES,
                          seed=2027, max_tree_depth=SAMPLER_D_DEPTH)
    del lpd, lps

    # ---- wide models: adjoint_kernels, main path E, sampler_E ----
    gpe = celerite_torch.GP(config2_kernel(terms, modes=3))
    lpe = {dt: gpe.build_logprob(t, y, yerr=yerr, log_prior=prior, dtype=dt)
           for dt in (torch.float32, torch.float64)}
    if lpe[torch.float64].loglik.route != "adjoint":
        fail("config[2] with three modes took the {0} route".format(
            lpe[torch.float64].loglik.route))
    thetae = torch.as_tensor(gpe.get_parameter_vector(), device=dev)
    thetase = path_c_thetas(thetae, dev)
    adj_errs = {name: [] for name in adjoint.ADJOINT_KERNELS}
    adj_rows = check_adjoint_kernels(dev, gpe, lpe, thetae, thetase,
                                     adj_errs, ptxas["adjoint.cu"])
    counts_e = main_path_e(gpe, lpe, prior, thetae, thetase, t, y, yerr)
    lane_sweep_e(gpe, t, y, yerr, prior, thetae, thetase)
    grew_e = sampler_nuts("sampler_E", lpe[torch.float64], thetae, dev,
                          adjoint_counts, SAMPLER_E_CHAINS, SAMPLER_E_WARMUP,
                          SAMPLER_E_SAMPLES, seed=2028,
                          max_tree_depth=SAMPLER_E_DEPTH)

    # ---- the value of wide models: solver_kernels, main path F, sweep ----
    solver_errs = {}
    solver_rows = check_solver_kernels(dev, gpe, lpe, thetae, solver_errs)
    counts_f = main_path_f(gpe, lpe, prior, thetae, t, y, yerr)
    lane_sweep_f(gpe, t, y, yerr, thetae)
    del lpe
    torch.cuda.empty_cache()

    # ---- fast_grad="tangent": tangent_kernels, main path G, sweep, NUTS ----
    t_g = time.perf_counter()
    lpg = build_logprob_g(gp, gpe, t, y, yerr, prior)
    tangent_errs = {}
    tangent_rows = check_tangent_kernels(dev, gp, gpe, lpg, theta, thetas,
                                         thetae, thetase, tangent_errs)
    emit("tangent_kernels_done", seconds=time.perf_counter() - t_g)
    t_g = time.perf_counter()
    counts_g = main_path_g(gp, gpe, lpg, prior, theta, thetas, thetae,
                           thetase, t, y, yerr, dev)
    emit("main_path_G_done", seconds=time.perf_counter() - t_g)
    t_g = time.perf_counter()
    lane_sweep_g(gp, t, y, yerr, prior, theta, thetas)
    emit("lane_sweep_G_done", seconds=time.perf_counter() - t_g)
    t_g = time.perf_counter()
    grew_g = sampler_nuts("sampler_G", lpg["B", torch.float64], theta, dev,
                          lambda: {"jac": tangent.jac_cuda.launches},
                          SAMPLER_G_CHAINS, SAMPLER_G_WARMUP,
                          SAMPLER_G_SAMPLES, seed=2029,
                          max_tree_depth=SAMPLER_G_DEPTH)
    emit("sampler_G_done", seconds=time.perf_counter() - t_g)

    # ---- the one-pass solver: onepass_kernels, main path H ----
    t_h = time.perf_counter()
    ta, ya, yerra = bench_data()
    models = {"B": (gp, t, y, yerr), "E": (gpe, t, y, yerr),
              "A": (celerite_torch.GP(bench_kernel(terms)), ta, ya, yerra)}
    onepass_errs = {}
    onepass_rows = check_onepass_kernels(dev, models, onepass_errs)
    emit("onepass_kernels_done", seconds=time.perf_counter() - t_h)
    t_h = time.perf_counter()
    refs = {"B": gp.build_loglik(t, y, yerr=yerr),
            "E": gpe.build_loglik(t, y, yerr=yerr)}
    counts_h = main_path_h(models, refs, dev)
    del refs, models
    torch.cuda.empty_cache()
    emit("main_path_H_done", seconds=time.perf_counter() - t_h)

    # ---- main path I: the GP facade on the card ----
    t_h = time.perf_counter()
    counts_i = main_path_i(t, y, yerr, dev)
    emit("main_path_I_done", seconds=time.perf_counter() - t_h)

    # ---- main path K: predict(return_var=True), CARMA, backend check ----
    counts_k = main_path_k(t, y, yerr, dev)
    torch.cuda.empty_cache()

    # ---- main path L: the light-curve fleet (config[4]) ----
    counts_l = main_path_l(dev, errs, grad_errs)
    torch.cuda.empty_cache()

    # ---- main path M: general (A, U, V) blocks through rows 8-18 ----
    counts_m = main_path_m(dev, adj_errs, solver_errs, tangent_errs)
    torch.cuda.empty_cache()

    kernels = [{
        "name": "fused4_primal",
        "route": "cuda",
        "source": "celerite_torch/csrc/fused4_primal.cu",
        "replaces": "celerite_tpu/ops/fused4.py:275",
        "launches": launches_a + launches_b + counts_l["primal"],
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
            "launches": (counts_ca[name] + counts_c[name] + grew[name]
                         + counts_j[name] + counts_l[name]),
            "max_abs_err": max(grad_errs[name]),
            "ms": row["ms_float64"],
            "plain_ms": row["plain_ms_float64"],
            "bound_ms": row["bound_ms_float64"],
            "bound_by": row["bound_by_float64"],
            "library_ms": None,
        })
    # The exact-mode kernels at the shape of nearly all their launches:
    # sampler_D's 16 chains folded, all 17 directions a launch.
    for name in dsfused.DS_KERNELS:
        row = ds_rows[SAMPLER_CHAINS][name]
        kernels.append({
            "name": "dsfused_" + name,
            "route": "cuda",
            "source": "celerite_torch/csrc/dsfused.cu",
            "replaces": DS_REPLACES[name],
            "launches": counts_d[name] + grew_d[name],
            "max_abs_err": max(ds_errs[name]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    # The adjoint kernels at the shape of most of their launches:
    # sampler_E's 4 chains folded, float64.
    for name in adjoint.ADJOINT_KERNELS:
        row = adj_rows[SAMPLER_E_CHAINS][name]
        kernels.append({
            "name": "adjoint_" + name,
            "route": "cuda",
            "source": "celerite_torch/csrc/adjoint.cu",
            "replaces": ADJ_REPLACES[name],
            "launches": counts_e[name] + grew_e[name] + counts_m[name],
            "max_abs_err": max(adj_errs[name]),
            "ms": row["ms_float64"],
            "plain_ms": row["plain_ms_float64"],
            "bound_ms": row["bound_ms_float64"],
            "bound_by": row["bound_by_float64"],
            "library_ms": None,
        })
    # The three-pass kernels at the value closure's shape (F's value plan
    # of E's model, float64).
    for name in pallas_solver.SOLVER_KERNELS:
        row = solver_rows["value_plan_float64"][name]
        kernels.append({
            "name": "pallas_solver_" + name,
            "route": "cuda",
            "source": "celerite_torch/csrc/pallas_solver.cu",
            "replaces": SOLVER_REPLACES[name],
            "launches": (counts_f[name] + counts_i[name] + counts_k[name]
                         + counts_m[name]),
            "max_abs_err": max(solver_errs[name]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    # The single-sweep kernel and the tangent kernels, each at the plan of
    # most of its launches (TANGENT_ROW_PLAN).
    for name in TANGENT_NAMES:
        row = tangent_rows[TANGENT_ROW_PLAN[name]][name]
        kernels.append({
            "name": ("" if name == "fused" else "tangent_") + name,
            "route": "cuda",
            "source": TANGENT_SOURCES[name],
            "replaces": TANGENT_REPLACES[name],
            "launches": (counts_g[name] + grew_g.get(name, 0)
                         + counts_m[name]),
            "max_abs_err": max(tangent_errs[name]),
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": None,
        })
    # The one-pass kernels at main path H's config[2] plan, float64; ms by
    # events around back-to-back calls, as every other row (the wrapper on
    # the host at this size), device_ms the card's time alone.
    for name in onepass.ONEPASS_KERNELS:
        row = onepass_rows["B"][name]
        kernels.append({
            "name": "onepass_" + name,
            "route": "cuda",
            "source": "celerite_torch/csrc/onepass.cu",
            "replaces": ONEPASS_REPLACES[name],
            "launches": counts_h[name],
            "max_abs_err": max(onepass_errs[name]),
            "ms": row["ms_float64"],
            "device_ms": row["device_ms_float64"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms_float64"],
            "bound_by": row["bound_by_float64"],
            "library_ms": None,
        })
    # result() raises if a build beside the run failed.
    for (src, p), path in zip(later, later_paths.result()):
        ptxas.setdefault(src, {})[p] = ptxas_summary(
            path.with_suffix(".ptxas.txt"))
    beside.shutdown()
    emit("ptxas", ptxas={src: dict(sorted(ps.items()))
                         for src, ps in ptxas.items()})
    emit("redesigned_kernels", **redesigned_summary(
        smi, ptxas, primal_rows, grad_rows, tangent_rows, adj_rows,
        onepass_rows, solver_rows))
    emit("done", seconds=time.perf_counter() - T_START)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
