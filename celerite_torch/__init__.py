"""celerite_torch: the PyTorch / CUDA port of celerite_tpu.

Scalable 1-D Gaussian-process likelihoods with celerite kernels, computed
on an NVIDIA H100 through hand-written CUDA kernels, with plain PyTorch
versions of the same functions for the CPU.  The module names mirror the
JAX package's (``celerite_tpu``), which stays the reference; this package
imports neither JAX nor ``celerite_tpu``.

Entry points compute on ``cuda`` unless given ``device="cpu"``.
"""

from . import data, modeling, ops, solver, terms
from .gp import GP
from .solver import CARMASolver, CholeskySolver, LinAlgError
from .modeling import ConstantModel, Model, ModelSet

__version__ = "0.1.0"
__library_version__ = solver.__library_version__

__all__ = [
    "GP",
    "CholeskySolver",
    "CARMASolver",
    "LinAlgError",
    "Model",
    "ModelSet",
    "ConstantModel",
    "data",
    "modeling",
    "ops",
    "solver",
    "terms",
    "__version__",
    "__library_version__",
]
