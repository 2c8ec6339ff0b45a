"""Models of the port: the ResNet symbols, the transformer-LM symbol and
its functional twins.

``get_symbol`` looks up a zoo network by the JAX package's config name;
the ResNet entries and ``transformer-lm`` are ported, the others raise
``not ported`` (ROADMAP.md).
"""
from ..base import not_ported
from . import transformer
from .resnet import resnet, resnet_cifar
from .transformer import init_params, params_from_numpy, transformer_lm

__all__ = ["resnet", "resnet_cifar", "transformer", "transformer_lm",
           "init_params", "params_from_numpy", "get_symbol"]

_ZOO = {
    "resnet-28-small": resnet_cifar,
    "resnet": resnet,
    "transformer-lm": transformer_lm,
}
_NOT_PORTED = ("mlp", "lenet", "inception-bn-28-small",
               "inception-bn", "googlenet", "alexnet", "vgg")


def get_symbol(name, **kwargs):
    """Look up a zoo network by its reference config name."""
    if name in _NOT_PORTED:
        raise not_ported(f"models.get_symbol({name!r})")
    if name not in _ZOO:
        raise ValueError(f"unknown network {name!r}; available: "
                         f"{sorted(_ZOO)}")
    return _ZOO[name](**kwargs)
