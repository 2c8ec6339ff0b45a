"""Weight initializers.

Counterpart of ``mxnet_tpu/initializer.py``: an :class:`Initializer` is
called with ``(name, arr)`` and dispatches on the parameter name (bias,
beta and moving_mean -> 0; gamma and moving_var -> 1; weight -> the
initializer's rule).  Random rules draw from an explicit
``torch.Generator`` passed as ``generator=`` (the trainer passes its own,
seeded); they cannot reproduce the JAX package's PRNG bits, so weights
that must match across the two packages are carried in as numpy arrays
(or through :class:`Load`).  Names starting with ``upsampling`` get the
fixed bilinear kernel; :class:`Mixed` picks an initializer by regular
expression.
"""
from __future__ import annotations

import json
import math
import re
from typing import Dict, List, Optional

import numpy as np
import torch

from .base import MXNetError
from .ndarray import NDArray

__all__ = ["Initializer", "Uniform", "Normal", "Orthogonal", "Xavier",
           "MSRAPrelu", "Load", "Mixed", "Constant", "Zero", "One"]


class Initializer:
    """Base: name-pattern dispatch."""

    def __call__(self, name: str, arr: NDArray,
                 generator: Optional[torch.Generator] = None) -> None:
        if not isinstance(name, str):
            raise TypeError("name must be a string")
        if name.startswith("upsampling"):
            _init_bilinear(arr)
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


def _init_bilinear(arr: NDArray) -> None:
    """The fixed bilinear-upsampling kernel over the last two axes."""
    shape = arr.shape
    weight = np.zeros(int(np.prod(shape)), dtype=np.float32)
    f = np.ceil(shape[3] / 2.0)
    c = (2 * f - 1 - f % 2) / (2.0 * f)
    for i in range(int(np.prod(shape))):
        x = i % shape[3]
        y = (i // shape[3]) % shape[2]
        weight[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
    arr[:] = weight.reshape(shape)


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


class Orthogonal(Initializer):
    """An orthogonal matrix (a factor of the SVD of a uniform or normal
    draw from ``generator``), scaled by ``scale``."""

    def __init__(self, scale: float = 1.414, rand_type: str = "uniform"):
        self._kwargs = {"scale": scale, "rand_type": rand_type}
        self.scale = scale
        self.rand_type = rand_type

    def _init_weight(self, name, arr, generator):
        nout = arr.shape[0]
        nin = int(np.prod(arr.shape[1:]))
        tmp = torch.empty((nout, nin), dtype=torch.float64)
        if self.rand_type == "uniform":
            tmp.uniform_(-1.0, 1.0, generator=generator)
        else:
            tmp.normal_(0.0, 1.0, generator=generator)
        u, _, v = torch.linalg.svd(tmp, full_matrices=False)
        q = u if u.shape == tmp.shape else v
        arr[:] = (self.scale * q).reshape(arr.shape).to(torch.float32)


class MSRAPrelu(Xavier):
    """Kaiming/MSRA for PReLU nets: Gaussian Xavier with magnitude
    ``2 / (1 + slope**2)``."""

    def __init__(self, factor_type: str = "avg", slope: float = 0.25):
        magnitude = 2.0 / (1 + slope ** 2)
        super().__init__("gaussian", factor_type, magnitude)
        self._kwargs = {"factor_type": factor_type, "slope": slope}


class Load:
    """Initialise from a saved parameter dict (``arg:``/``aux:`` prefixes
    dropped), falling back to ``default_init`` for names it lacks."""

    def __init__(self, param: Dict[str, NDArray],
                 default_init: Optional[Initializer] = None,
                 verbose: bool = False):
        self.param = {
            (k[4:] if k.startswith(("arg:", "aux:")) else k): v
            for k, v in param.items()}
        self.default_init = default_init
        self.verbose = verbose

    def __call__(self, name: str, arr: NDArray,
                 generator: Optional[torch.Generator] = None) -> None:
        if name in self.param:
            src = self.param[name]
            if tuple(src.shape) != tuple(arr.shape):
                raise MXNetError(f"Load: shape mismatch for {name}: "
                                 f"{src.shape} vs {arr.shape}")
            arr[:] = src.data if isinstance(src, NDArray) else src
        else:
            if self.default_init is None:
                raise MXNetError(f"Load: no init for {name} and no default")
            self.default_init(name, arr, generator=generator)


class Mixed:
    """The first initializer whose regular expression matches the name
    (``re.match``); add ``".*"`` last for a default."""

    def __init__(self, patterns: List[str], initializers: List[Initializer]):
        if len(patterns) != len(initializers):
            raise MXNetError("Mixed: patterns and initializers length "
                             "mismatch")
        self.map = [(re.compile(p), i) for p, i in zip(patterns,
                                                      initializers)]

    def __call__(self, name: str, arr: NDArray,
                 generator: Optional[torch.Generator] = None) -> None:
        for prog, init in self.map:
            if prog.match(name):
                init(name, arr, generator=generator)
                return
        raise MXNetError(
            f"Mixed: parameter {name} did not match any pattern; add '.*' "
            "as the last pattern for a default")
