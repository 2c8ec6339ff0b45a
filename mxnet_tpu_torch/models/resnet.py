"""ResNet family: the same symbols as ``mxnet_tpu/models/resnet.py``.

``resnet`` (bottleneck, depth 50 by default) is the framework's flagship
model.  Built with ``no_bias`` convolutions + BatchNorm, bottleneck
residual units and strided 1x1 projection shortcuts on dimension changes;
the graphs, names and shapes equal the JAX package's.
"""
from .. import symbol as sym

__all__ = ["resnet", "resnet_cifar"]


def _bn_relu_conv(data, num_filter, kernel, stride, pad, relu=True):
    net = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                          stride=stride, pad=pad, no_bias=True)
    net = sym.BatchNorm(data=net, fix_gamma=False)
    if relu:
        net = sym.Activation(data=net, act_type="relu")
    return net


def _basic_unit(data, num_filter, stride, dim_match):
    """3x3 + 3x3 residual unit (CIFAR-style)."""
    body = _bn_relu_conv(data, num_filter, (3, 3), stride, (1, 1))
    body = _bn_relu_conv(body, num_filter, (3, 3), (1, 1), (1, 1), relu=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _bn_relu_conv(data, num_filter, (1, 1), stride, (0, 0),
                                 relu=False)
    return sym.Activation(data=body + shortcut, act_type="relu")


def _bottleneck_unit(data, num_filter, stride, dim_match):
    """1x1 reduce -> 3x3 -> 1x1 expand, expansion factor 4."""
    inner = num_filter // 4
    body = _bn_relu_conv(data, inner, (1, 1), (1, 1), (0, 0))
    body = _bn_relu_conv(body, inner, (3, 3), stride, (1, 1))
    body = _bn_relu_conv(body, num_filter, (1, 1), (1, 1), (0, 0), relu=False)
    if dim_match:
        shortcut = data
    else:
        shortcut = _bn_relu_conv(data, num_filter, (1, 1), stride, (0, 0),
                                 relu=False)
    return sym.Activation(data=body + shortcut, act_type="relu")


def resnet_cifar(num_classes=10, n=3):
    """6n+2-layer CIFAR ResNet (n=3 -> 20 layers, n=9 -> 56)."""
    net = _bn_relu_conv(sym.Variable("data"), 16, (3, 3), (1, 1), (1, 1))
    for stage, num_filter in enumerate((16, 32, 64)):
        for unit in range(n):
            first = unit == 0
            stride = (2, 2) if first and stage > 0 else (1, 1)
            net = _basic_unit(net, num_filter, stride,
                              dim_match=not first or stage == 0)
    net = sym.Pooling(data=net, pool_type="avg", kernel=(7, 7),
                      global_pool=True, name="global_pool")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")


_DEPTH_UNITS = {50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}


def resnet(num_classes=1000, depth=50):
    """ImageNet bottleneck ResNet (depth 50/101/152)."""
    if depth not in _DEPTH_UNITS:
        raise ValueError(f"unsupported depth {depth}; pick "
                         f"{sorted(_DEPTH_UNITS)}")
    units = _DEPTH_UNITS[depth]
    net = _bn_relu_conv(sym.Variable("data"), 64, (7, 7), (2, 2), (3, 3))
    net = sym.Pooling(data=net, pool_type="max", kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1))
    for stage, (num_unit, num_filter) in enumerate(
            zip(units, (256, 512, 1024, 2048))):
        for unit in range(num_unit):
            first = unit == 0
            stride = (2, 2) if first and stage > 0 else (1, 1)
            net = _bottleneck_unit(net, num_filter, stride,
                                   dim_match=not first)
    net = sym.Pooling(data=net, pool_type="avg", kernel=(7, 7),
                      global_pool=True, name="global_pool")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=net, name="softmax")
