"""Models of the port: the transformer-LM functional twins."""
from . import transformer
from .transformer import init_params, params_from_numpy

__all__ = ["transformer", "init_params", "params_from_numpy"]
