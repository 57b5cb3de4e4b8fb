"""Sampler-chain checkpoint / resume.

Port of ``celerite_tpu/inference/checkpoint.py``, in the same file format:
the long-running artifact is the sampler state (chain positions, step
size, mass matrix and the random state), stored as compressed ``.npz``
with a flattened key -> array mapping and the JSON meta as ``__meta__``
bytes, so a checkpoint written by either package loads in the other and
needs no framework at load time.  Tensors are saved from wherever they
live as numpy arrays; a ``torch.Generator`` is saved as its state
(``get_state()``, uint8), which ``generator.set_state(
torch.from_numpy(state["rng_key"]))`` restores.
"""

from __future__ import annotations

import json

import numpy as np
import torch

__all__ = ["save_state", "load_state", "SamplerState"]


def _array(obj):
    if isinstance(obj, torch.Generator):
        obj = obj.get_state()
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _flatten(prefix, obj, out):
    if isinstance(obj, dict):
        for k, v in obj.items():
            _flatten("{0}.{1}".format(prefix, k) if prefix else str(k), v, out)
    elif isinstance(obj, (list, tuple)):
        for i, v in enumerate(obj):
            _flatten("{0}[{1}]".format(prefix, i), v, out)
    else:
        out[prefix] = _array(obj)


def save_state(path, state, meta=None):
    """Save a nested dict/list of arrays, tensors or generators."""
    flat = {}
    _flatten("", state, flat)
    if meta is not None:
        flat["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                         dtype=np.uint8)
    np.savez_compressed(path, **flat)


def load_state(path):
    """Load a checkpoint; returns (flat_dict of numpy arrays, meta)."""
    with np.load(path, allow_pickle=False) as data:
        out = {}
        meta = None
        for k in data.files:
            if k == "__meta__":
                meta = json.loads(bytes(data[k].tobytes()).decode())
            else:
                out[k] = data[k]
    return out, meta


class SamplerState(dict):
    """Convenience dict for NUTS chain state.

    Keys: ``positions`` (C, D), ``step_size`` (), ``inv_mass`` (D,),
    ``rng_key`` (the generator's state as uint8; the JAX package's key is
    (2,) uint32), ``iteration`` ().
    """

    @classmethod
    def create(cls, positions, step_size, inv_mass, rng_key, iteration=0):
        return cls(
            positions=_array(positions),
            step_size=_array(step_size),
            inv_mass=_array(inv_mass),
            rng_key=_array(rng_key),
            iteration=_array(iteration),
        )

    def save(self, path):
        save_state(path, dict(self))

    @classmethod
    def load(cls, path):
        flat, _ = load_state(path)
        return cls(flat)
