"""Named-parameter modeling protocol.

Behavioral parity with the reference modeling layer
(/root/reference/celerite/modeling.py:11-447): named parameters that can be
set positionally or by keyword, per-parameter ``(min, max)`` bounds, a
freeze/thaw mask, flat parameter-vector get/set with frozen filtering, a box
log-prior, a ``dirty`` invalidation flag, and composite models whose
parameters are addressed as ``"submodel:param"``.

This is the port's own copy of ``celerite_tpu/modeling.py`` (numpy only):
importing that module through its package would pull in JAX.  Parameter
storage is a plain ``dict`` of name -> float plus a set of frozen names.
Gradient hooks (``compute_gradient``) are retained for API parity; the
port differentiates the pure log-likelihood with ``torch.autograd``.
"""

from __future__ import annotations

from collections import OrderedDict
from itertools import chain

import numpy as np

__all__ = ["Model", "ModelSet", "ConstantModel"]


class Model:
    """Base class of the named-parameter protocol.

    Subclasses declare ``parameter_names`` and (usually) ``get_value``.
    Initial values are given positionally in ``parameter_names`` order or by
    keyword.  ``bounds`` may be a dict (missing names unbounded) or a list of
    ``(min, max)`` pairs of length ``full_size``.
    """

    parameter_names: tuple = tuple()

    def __init__(self, *args, **kwargs):
        bounds = kwargs.pop("bounds", None)
        quiet = kwargs.pop("quiet", False)

        names = self.parameter_names
        self._frozen = dict((k, False) for k in names)
        self.dirty = True

        if bounds is None:
            bound_list = [(None, None) for _ in names]
        elif hasattr(bounds, "get"):
            bound_list = [tuple(bounds.get(k, (None, None))) for k in names]
        else:
            bound_list = [tuple(b) for b in bounds]
        if len(bound_list) != len(names):
            raise ValueError(
                "the number of bounds must equal the number of parameters"
            )
        if any(len(b) != 2 for b in bound_list):
            raise ValueError(
                "the bounds for each parameter must have the format: "
                "'(min, max)'"
            )
        self.parameter_bounds = bound_list

        if args:
            if len(args) != len(names):
                raise ValueError(
                    "expected {0} arguments but got {1}".format(
                        len(names), len(args)
                    )
                )
            if kwargs:
                raise ValueError(
                    "parameters must be fully specified by arguments or "
                    "keyword arguments, not both"
                )
            values = list(args)
        else:
            values = []
            for k in names:
                if k not in kwargs:
                    raise ValueError("missing parameter '{0}'".format(k))
                values.append(kwargs.pop(k))
            if kwargs:
                raise ValueError(
                    "unrecognized parameter(s) '{0}'".format(
                        list(kwargs.keys())
                    )
                )

        self._values = OrderedDict(
            (k, float(v)) for k, v in zip(names, values)
        )

        if not quiet and not np.isfinite(self.log_prior()):
            raise ValueError("non-finite log prior value")

    # -- values are exposed as attributes for parity ------------------------
    def __getattr__(self, name):
        values = self.__dict__.get("_values")
        if values is not None and name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name, value):
        values = self.__dict__.get("_values")
        if values is not None and name in values:
            values[name] = float(value)
            self.__dict__["dirty"] = True
        else:
            super().__setattr__(name, value)

    # -- shape queries ------------------------------------------------------
    @property
    def full_size(self):
        """Number of parameters, including frozen ones."""
        return len(self.parameter_names)

    @property
    def vector_size(self):
        """Number of active (unfrozen) parameters."""
        return sum(not self._frozen[k] for k in self.parameter_names)

    @property
    def unfrozen_mask(self):
        return np.array(
            [not self._frozen[k] for k in self.parameter_names], dtype=bool
        )

    def __len__(self):
        return self.vector_size

    # -- vector get/set -----------------------------------------------------
    @property
    def parameter_vector(self):
        return np.array(
            [self._values[k] for k in self.parameter_names], dtype=float
        )

    @parameter_vector.setter
    def parameter_vector(self, v):
        names = self.parameter_names
        if len(v) != len(names):
            raise ValueError("dimension mismatch")
        for k, value in zip(names, v):
            self._values[k] = float(value)
        self.dirty = True

    def get_parameter_vector(self, include_frozen=False):
        v = self.parameter_vector
        if include_frozen:
            return v
        return v[self.unfrozen_mask]

    def set_parameter_vector(self, vector, include_frozen=False):
        v = self.parameter_vector
        if include_frozen:
            v[:] = vector
        else:
            v[self.unfrozen_mask] = vector
        self.parameter_vector = v
        self.dirty = True

    def get_parameter_names(self, include_frozen=False):
        if include_frozen:
            return tuple(self.parameter_names)
        mask = self.unfrozen_mask
        return tuple(
            k for k, m in zip(self.parameter_names, mask) if m
        )

    def get_parameter_bounds(self, include_frozen=False):
        if include_frozen:
            return list(self.parameter_bounds)
        mask = self.unfrozen_mask
        return [
            b for b, m in zip(self.parameter_bounds, mask) if m
        ]

    def get_parameter_dict(self, include_frozen=False):
        return OrderedDict(
            zip(
                self.get_parameter_names(include_frozen=include_frozen),
                self.get_parameter_vector(include_frozen=include_frozen),
            )
        )

    # -- item access (by active-index or name) ------------------------------
    def _get_name(self, name_or_index):
        try:
            int(name_or_index)
        except (TypeError, ValueError):
            return name_or_index
        return self.get_parameter_names()[int(name_or_index)]

    def __getitem__(self, name_or_index):
        return self.get_parameter(self._get_name(name_or_index))

    def __setitem__(self, name_or_index, value):
        self.set_parameter(self._get_name(name_or_index), value)

    # -- named access --------------------------------------------------------
    def _index_of(self, name):
        try:
            return self.parameter_names.index(name)
        except ValueError:
            raise ValueError("unrecognized parameter '{0}'".format(name))

    def get_parameter(self, name):
        return self._values[self.parameter_names[self._index_of(name)]]

    def set_parameter(self, name, value):
        self._values[self.parameter_names[self._index_of(name)]] = float(
            value
        )
        self.dirty = True

    # -- freeze/thaw ---------------------------------------------------------
    def freeze_parameter(self, name):
        self._frozen[self.parameter_names[self._index_of(name)]] = True

    def thaw_parameter(self, name):
        self._frozen[self.parameter_names[self._index_of(name)]] = False

    def freeze_all_parameters(self):
        for k in self.parameter_names:
            self._frozen[k] = True

    def thaw_all_parameters(self):
        for k in self.parameter_names:
            self._frozen[k] = False

    # -- model hooks ---------------------------------------------------------
    def get_value(self, *args, **kwargs):
        raise NotImplementedError("overloaded by subclasses")

    def compute_gradient(self, *args, **kwargs):
        raise NotImplementedError("overloaded by subclasses")

    def get_gradient(self, *args, **kwargs):
        include_frozen = kwargs.pop("include_frozen", False)
        g = self.compute_gradient(*args, **kwargs)
        if include_frozen:
            return g
        return g[self.unfrozen_mask]

    def log_prior(self):
        """Box-bounds log-prior: 0 inside the bounds, -inf outside."""
        for value, (lo, hi) in zip(
            self.parameter_vector, self.parameter_bounds
        ):
            if lo is not None and value < lo:
                return -np.inf
            if hi is not None and value > hi:
                return -np.inf
        return 0.0


class ModelSet(Model):
    """A composite of named submodels.

    Parameter names are prefixed with the submodel name:
    ``"sub:param"``; freeze/thaw/get/set route through the prefix.
    """

    def __init__(self, models):
        self.models = OrderedDict(models)

    def __getattr__(self, name):
        models = self.__dict__.get("models")
        if models is not None and name in models:
            return models[name]
        raise AttributeError(name)

    # -- aggregate views -----------------------------------------------------
    @property
    def dirty(self):
        return any(m.dirty for m in self.models.values())

    @dirty.setter
    def dirty(self, value):
        for m in self.models.values():
            m.dirty = value

    @property
    def full_size(self):
        return sum(m.full_size for m in self.models.values())

    @property
    def vector_size(self):
        return sum(m.vector_size for m in self.models.values())

    @property
    def unfrozen_mask(self):
        return np.concatenate(
            [m.unfrozen_mask for m in self.models.values()]
        )

    @property
    def parameter_names(self):
        out = []
        for name, m in self.models.items():
            out.extend("{0}:{1}".format(name, k) for k in m.parameter_names)
        return tuple(out)

    @property
    def parameter_bounds(self):
        return list(
            chain(*(m.parameter_bounds for m in self.models.values()))
        )

    @property
    def parameter_vector(self):
        return np.concatenate(
            [m.parameter_vector for m in self.models.values()]
        )

    @parameter_vector.setter
    def parameter_vector(self, v):
        i = 0
        for m in self.models.values():
            n = m.full_size
            m.parameter_vector = v[i : i + n]
            i += n

    # -- prefixed routing ----------------------------------------------------
    def _route(self, method, name, *args):
        prefix, _, rest = name.partition(":")
        if prefix not in self.models:
            raise ValueError("unrecognized parameter '{0}'".format(name))
        return getattr(self.models[prefix], method)(rest, *args)

    def get_parameter(self, name):
        return self._route("get_parameter", name)

    def set_parameter(self, name, value):
        self.dirty = True
        return self._route("set_parameter", name, value)

    def freeze_parameter(self, name):
        self._route("freeze_parameter", name)

    def thaw_parameter(self, name):
        self._route("thaw_parameter", name)

    def freeze_all_parameters(self):
        for m in self.models.values():
            m.freeze_all_parameters()

    def thaw_all_parameters(self):
        for m in self.models.values():
            m.thaw_all_parameters()

    def log_prior(self):
        total = 0.0
        for m in self.models.values():
            total += m.log_prior()
            if not np.isfinite(total):
                return -np.inf
        return total


class ConstantModel(Model):
    """A model that is a single constant ``value``."""

    parameter_names = ("value",)

    def get_value(self, x):
        return self.value + np.zeros_like(np.asarray(x, dtype=float))

    def compute_gradient(self, x):
        return np.array([np.ones_like(np.asarray(x, dtype=float))])
