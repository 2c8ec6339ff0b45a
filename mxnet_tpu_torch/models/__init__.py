"""Models of the port: the zoo's symbols and the transformer-LM's
functional twins.

``get_symbol`` looks up a zoo network by the JAX package's config name;
all ten of its names build, with the JAX package's node names.
"""
from . import transformer
from .classic import alexnet, vgg
from .inception import googlenet, inception_bn, inception_bn_small
from .mnist import lenet, mlp
from .resnet import resnet, resnet_cifar
from .transformer import init_params, params_from_numpy, transformer_lm

__all__ = ["mlp", "lenet", "resnet", "resnet_cifar", "alexnet", "vgg",
           "googlenet", "inception_bn", "inception_bn_small", "transformer",
           "transformer_lm", "init_params", "params_from_numpy",
           "get_symbol"]

_ZOO = {
    "transformer-lm": transformer_lm,
    "mlp": mlp,
    "lenet": lenet,
    "inception-bn-28-small": inception_bn_small,
    "inception-bn": inception_bn,
    "googlenet": googlenet,
    "resnet-28-small": resnet_cifar,
    "resnet": resnet,
    "alexnet": alexnet,
    "vgg": vgg,
}


def get_symbol(name, **kwargs):
    """Look up a zoo network by its reference config name."""
    if name not in _ZOO:
        raise ValueError(f"unknown network {name!r}; available: "
                         f"{sorted(_ZOO)}")
    return _ZOO[name](**kwargs)
