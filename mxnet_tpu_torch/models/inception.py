"""The Inception family: the same symbols as
``mxnet_tpu/models/inception.py`` (names and shapes equal, so weights
carry across by name).  ``inception_bn_small`` is the CIFAR-10 network of
``examples/train_cifar10.py``; ``inception_bn`` and ``googlenet`` the
ImageNet ones.
"""
from .. import symbol as sym

__all__ = ["googlenet", "inception_bn", "inception_bn_small"]


def _conv_bn_relu(data, num_filter, kernel, stride=(1, 1), pad=(0, 0)):
    net = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                          stride=stride, pad=pad)
    net = sym.BatchNorm(data=net)
    return sym.Activation(data=net, act_type="relu")


def _mixed(data, ch_1x1, ch_3x3):
    """Two-branch inception unit: 1x1 and padded 3x3, channel-concatenated."""
    a = _conv_bn_relu(data, ch_1x1, (1, 1))
    b = _conv_bn_relu(data, ch_3x3, (3, 3), pad=(1, 1))
    return sym.Concat(a, b)


def _reduce(data, ch_3x3):
    """Stride-2 reduction: 3x3 conv branch next to a stride-2 max pool."""
    a = _conv_bn_relu(data, ch_3x3, (3, 3), stride=(2, 2), pad=(1, 1))
    b = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2), pool_type="max")
    return sym.Concat(a, b)


# (ch_1x1, ch_3x3) per mixed unit, None marking the two reductions; matches
# the in3a..in5b stack of symbol_inception-bn-28-small.py:43-52.
_STACK = [(32, 32), (32, 48), 80, (112, 48), (96, 64), (80, 80),
          (48, 96), 96, (176, 160), (176, 160)]


def _inception_a(data, n1x1, n3r, n3, nd3r, nd3, pool, proj):
    """Inception-BN unit A (symbol_inception-bn.py:22-37): 1x1 | 3x3 |
    double-3x3 | pooled-projection branches."""
    b1 = _conv_bn_relu(data, n1x1, (1, 1))
    b2 = _conv_bn_relu(data, n3r, (1, 1))
    b2 = _conv_bn_relu(b2, n3, (3, 3), pad=(1, 1))
    b3 = _conv_bn_relu(data, nd3r, (1, 1))
    b3 = _conv_bn_relu(b3, nd3, (3, 3), pad=(1, 1))
    b3 = _conv_bn_relu(b3, nd3, (3, 3), pad=(1, 1))
    b4 = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type=pool)
    b4 = _conv_bn_relu(b4, proj, (1, 1))
    return sym.Concat(b1, b2, b3, b4)


def _inception_b(data, n3r, n3, nd3r, nd3):
    """Inception-BN unit B (stride-2 reduction, :39-51)."""
    b1 = _conv_bn_relu(data, n3r, (1, 1))
    b1 = _conv_bn_relu(b1, n3, (3, 3), stride=(2, 2), pad=(1, 1))
    b2 = _conv_bn_relu(data, nd3r, (1, 1))
    b2 = _conv_bn_relu(b2, nd3, (3, 3), pad=(1, 1))
    b2 = _conv_bn_relu(b2, nd3, (3, 3), stride=(2, 2), pad=(1, 1))
    b3 = sym.Pooling(data=data, kernel=(3, 3), stride=(2, 2),
                     pool_type="max")
    return sym.Concat(b1, b2, b3)


def inception_bn(num_classes=1000):
    """Full ImageNet Inception-BN (symbol_inception-bn.py:53-85)."""
    net = _conv_bn_relu(sym.Variable("data"), 64, (7, 7), stride=(2, 2),
                        pad=(3, 3))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = _conv_bn_relu(net, 64, (1, 1))
    net = _conv_bn_relu(net, 192, (3, 3), pad=(1, 1))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = _inception_a(net, 64, 64, 64, 64, 96, "avg", 32)
    net = _inception_a(net, 64, 64, 96, 64, 96, "avg", 64)
    net = _inception_b(net, 128, 160, 64, 96)
    net = _inception_a(net, 224, 64, 96, 96, 128, "avg", 128)
    net = _inception_a(net, 192, 96, 128, 96, 128, "avg", 128)
    net = _inception_a(net, 160, 128, 160, 128, 160, "avg", 128)
    net = _inception_a(net, 96, 128, 192, 160, 192, "avg", 128)
    net = _inception_b(net, 128, 192, 192, 256)
    net = _inception_a(net, 352, 192, 320, 160, 224, "avg", 128)
    net = _inception_a(net, 352, 192, 320, 192, 224, "max", 128)
    net = sym.Pooling(data=net, kernel=(7, 7), pool_type="avg",
                      global_pool=True, name="global_pool")
    net = sym.Flatten(data=net, name="flatten")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")


def _conv_relu(data, num_filter, kernel, stride=(1, 1), pad=(0, 0)):
    net = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                          stride=stride, pad=pad)
    return sym.Activation(data=net, act_type="relu")


def _gl_inception(data, n1x1, n3r, n3, n5r, n5, pool, proj):
    """GoogLeNet inception unit (symbol_googlenet.py:17-31): plain convs,
    5x5 branch, pool projection."""
    b1 = _conv_relu(data, n1x1, (1, 1))
    b2 = _conv_relu(data, n3r, (1, 1))
    b2 = _conv_relu(b2, n3, (3, 3), pad=(1, 1))
    b3 = _conv_relu(data, n5r, (1, 1))
    b3 = _conv_relu(b3, n5, (5, 5), pad=(2, 2))
    b4 = sym.Pooling(data=data, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type=pool)
    b4 = _conv_relu(b4, proj, (1, 1))
    return sym.Concat(b1, b2, b3, b4)


# (n1x1, n3r, n3, n5r, n5, pool, proj) per unit, None = stride-2 max pool;
# matches symbol_googlenet.py:41-51
_GOOGLENET_STACK = [
    (64, 96, 128, 16, 32, "max", 32), (128, 128, 192, 32, 96, "max", 64),
    None,
    (192, 96, 208, 16, 48, "max", 64), (160, 112, 224, 24, 64, "max", 64),
    (128, 128, 256, 24, 64, "max", 64), (112, 144, 288, 32, 64, "max", 64),
    (256, 160, 320, 32, 128, "max", 128),
    None,
    (256, 160, 320, 32, 128, "max", 128),
    (384, 192, 384, 48, 128, "max", 128),
]


def googlenet(num_classes=1000):
    """GoogLeNet (symbol_googlenet.py:33-56)."""
    net = _conv_relu(sym.Variable("data"), 64, (7, 7), stride=(2, 2),
                     pad=(3, 3))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    net = _conv_relu(net, 64, (1, 1))
    net = _conv_relu(net, 192, (3, 3), pad=(1, 1))
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                      pool_type="max")
    for spec in _GOOGLENET_STACK:
        if spec is None:
            net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2),
                              pool_type="max")
        else:
            net = _gl_inception(net, *spec)
    net = sym.Pooling(data=net, kernel=(7, 7), pool_type="avg",
                      global_pool=True)
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=net, name="softmax")


def inception_bn_small(num_classes=10):
    net = _conv_bn_relu(sym.Variable("data"), 96, (3, 3), pad=(1, 1))
    for spec in _STACK:
        if isinstance(spec, tuple):
            net = _mixed(net, *spec)
        else:
            net = _reduce(net, spec)
    net = sym.Pooling(data=net, pool_type="avg", kernel=(7, 7),
                      name="global_pool")
    net = sym.Flatten(data=net, name="flatten1")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
