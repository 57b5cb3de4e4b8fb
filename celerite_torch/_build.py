"""Build and load the port's CUDA kernels: nvcc -> shared library -> ctypes.

Each kernel source under ``celerite_torch/csrc/`` has a plain C interface
and includes no PyTorch header, so one ``nvcc`` call takes seconds.  A
source is compiled once per set of ``-D`` defines (the fused primal kernel
is specialised on its padded width P) into ``build/kernels/`` beside the
package, named by a hash of the source, the shared headers
(``csrc/*.cuh``), the defines and the flags, so an edited source or header
never loads a stale library.  Builds happen at first use, or all together
through :func:`build` (one ``nvcc`` process per library, started at
once).  ``ptxas -v`` output (registers, spills) is kept next to each
library as ``<name>.ptxas.txt``.

No ``--use_fast_math``: it would turn ``expf``/``sincosf`` into approximate
intrinsics and flush denormals.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC", "SOURCE_FLAGS", "build", "load", "nvcc"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Extra flags per source.  The gradient kernels are compiled without fma
# contraction so that they round as their plain versions do, which keep
# every multiply and add separate; the primal keeps the default.
SOURCE_FLAGS = {"fused4_grad.cu": ("-fmad=false",)}

_loaded: dict = {}


def nvcc():
    """Path of the CUDA compiler; raises if the toolkit is missing."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin and on PATH): the CUDA "
        "kernels of celerite_torch build on a machine with the CUDA toolkit"
    )


def _target(source, defines):
    src = CSRC / source
    defs = tuple("-D{0}={1}".format(k, v) for k, v in sorted(defines.items()))
    # The shared headers are part of every source's key.
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    extra = defs + SOURCE_FLAGS.get(source, ())
    key = hashlib.sha256(
        src.read_bytes() + headers + repr((extra, FLAGS)).encode()
    ).hexdigest()[:12]
    tag = "_".join("{0}{1}".format(k.lower(), v)
                   for k, v in sorted(defines.items()))
    out = BUILD_DIR / "{0}_{1}_{2}.so".format(src.stem, tag, key)
    return src, extra, out


def build(jobs):
    """Compile every ``(source, defines)`` job not yet built, in parallel.

    Returns the library paths in job order.  Raises with nvcc's output if
    any compile fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = [_target(s, d) for s, d in jobs]
    procs = []
    for src, extra, out in targets:
        if out.exists():
            continue
        tmp = out.with_suffix(".{0}.tmp".format(os.getpid()))
        cmd = [nvcc(), *FLAGS, *extra, "-o", str(tmp), str(src)]
        procs.append((out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    errors = []
    for out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".ptxas.txt").write_text(log)
        if proc.returncode != 0:
            errors.append("{0}:\n{1}".format(out.name, log))
            continue
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return [out for _, _, out in targets]


def load(source, defines):
    """The loaded library for ``source`` built with ``defines``."""
    (path,) = build([(source, defines)])
    if path not in _loaded:
        _loaded[path] = ctypes.CDLL(str(path))
    return _loaded[path]
