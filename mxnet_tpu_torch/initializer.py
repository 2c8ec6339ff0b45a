"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: an :class:`Initializer` is
called with ``(name, arr)`` and dispatches on the parameter name (bias,
beta and moving_mean -> 0; gamma and moving_var -> 1; weight -> the
initializer's rule).  Random rules draw from an explicit
``torch.Generator`` passed as ``generator=`` (the trainer passes its own,
seeded); they cannot reproduce the JAX package's PRNG bits, so weights
that must match across the two packages are carried in as numpy arrays.
"""
from __future__ import annotations

import json
import math
from typing import Optional

import numpy as np
import torch

from .base import MXNetError, not_ported
from .ndarray import NDArray

__all__ = ["Initializer", "Uniform", "Normal", "Xavier", "Constant", "Zero",
           "One"]


class Initializer:
    """Base: name-pattern dispatch."""

    def __call__(self, name: str, arr: NDArray,
                 generator: Optional[torch.Generator] = None) -> None:
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if name.startswith("upsampling"):
            raise not_ported("the bilinear upsampling initializer")
        elif name.endswith("bias"):
            arr[:] = 0.0
        elif name.endswith("gamma"):
            arr[:] = 1.0
        elif name.endswith("beta"):
            arr[:] = 0.0
        elif name.endswith("weight"):
            self._init_weight(name, arr, generator)
        elif name.endswith("moving_mean"):
            arr[:] = 0.0
        elif name.endswith("moving_var"):
            arr[:] = 1.0
        elif name.endswith("moving_avg"):
            arr[:] = 0.0
        else:
            raise MXNetError(
                f"Unknown initialization pattern for {name!r}: parameter "
                "names should end with weight/bias/gamma/beta/moving_mean/"
                "moving_var")

    def _init_weight(self, name, arr, generator):
        raise NotImplementedError("virtual _init_weight")

    def dumps(self) -> str:
        return json.dumps([self.__class__.__name__.lower(),
                           getattr(self, "_kwargs", {})])


def _draw(arr: NDArray, generator, fill) -> None:
    """Draw on the CPU (a ``torch.Generator`` lives on one device) and
    write into ``arr``."""
    tmp = torch.empty(arr.shape, dtype=torch.float32)
    fill(tmp, generator)
    arr[:] = tmp


class Constant(Initializer):
    """Fill every parameter with one value, bypassing name dispatch."""

    def __init__(self, value: float):
        self._kwargs = {"value": value}
        self.value = value

    def __call__(self, name: str, arr: NDArray, generator=None) -> None:
        arr[:] = self.value


class Zero(Constant):
    def __init__(self):
        super().__init__(0.0)


class One(Constant):
    def __init__(self):
        super().__init__(1.0)


class Uniform(Initializer):
    """U(-scale, scale): the trainer's default rule (scale 0.07)."""

    def __init__(self, scale: float = 0.07):
        self._kwargs = {"scale": scale}
        self.scale = scale

    def _init_weight(self, name, arr, generator):
        _draw(arr, generator,
              lambda t, g: t.uniform_(-self.scale, self.scale, generator=g))


class Normal(Initializer):
    """N(0, sigma)."""

    def __init__(self, sigma: float = 0.01):
        self._kwargs = {"sigma": sigma}
        self.sigma = sigma

    def _init_weight(self, name, arr, generator):
        _draw(arr, generator,
              lambda t, g: t.normal_(0.0, self.sigma, generator=g))


class Xavier(Initializer):
    """Xavier/Glorot, with the JAX package's fan rule."""

    def __init__(self, rnd_type: str = "uniform", factor_type: str = "avg",
                 magnitude: float = 3):
        self._kwargs = {"rnd_type": rnd_type, "factor_type": factor_type,
                        "magnitude": magnitude}
        self.rnd_type = rnd_type
        self.factor_type = factor_type
        self.magnitude = magnitude

    def _init_weight(self, name, arr, generator):
        shape = arr.shape
        hw_scale = float(np.prod(shape[2:])) if len(shape) > 2 else 1.0
        fan_in = shape[1] * hw_scale if len(shape) > 1 else hw_scale
        fan_out = shape[0] * hw_scale
        if self.factor_type == "avg":
            factor = (fan_in + fan_out) / 2.0
        elif self.factor_type == "in":
            factor = fan_in
        elif self.factor_type == "out":
            factor = fan_out
        else:
            raise MXNetError("Xavier factor_type must be avg/in/out")
        scale = math.sqrt(self.magnitude / factor)
        if self.rnd_type == "uniform":
            _draw(arr, generator,
                  lambda t, g: t.uniform_(-scale, scale, generator=g))
        elif self.rnd_type == "gaussian":
            _draw(arr, generator,
                  lambda t, g: t.normal_(0.0, scale, generator=g))
        else:
            raise MXNetError("Xavier rnd_type must be uniform/gaussian")
