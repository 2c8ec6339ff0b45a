"""AlexNet and VGG-16: the same symbols as ``mxnet_tpu/models/classic.py``
(names and shapes equal, so weights carry across by name)."""
from .. import symbol as sym

__all__ = ["alexnet", "vgg"]


def alexnet(num_classes=1000):
    net = sym.Variable("data")
    net = sym.Convolution(data=net, kernel=(11, 11), stride=(4, 4),
                          num_filter=96)
    net = sym.Activation(data=net, act_type="relu")
    net = sym.LRN(data=net, alpha=0.0001, beta=0.75, knorm=1, nsize=5)
    net = sym.Pooling(data=net, pool_type="max", kernel=(3, 3), stride=(2, 2))
    net = sym.Convolution(data=net, kernel=(5, 5), pad=(2, 2), num_filter=256)
    net = sym.Activation(data=net, act_type="relu")
    net = sym.LRN(data=net, alpha=0.0001, beta=0.75, knorm=1, nsize=5)
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    for nf in (384, 384, 256):
        net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1),
                              num_filter=nf)
        net = sym.Activation(data=net, act_type="relu")
    net = sym.Pooling(data=net, kernel=(3, 3), stride=(2, 2), pool_type="max")
    net = sym.Flatten(data=net)
    for _ in range(2):
        net = sym.FullyConnected(data=net, num_hidden=4096)
        net = sym.Activation(data=net, act_type="relu")
        net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=net, name="softmax")


# convs per stage for VGG-16 (reference symbol_vgg.py uses the D config)
_VGG_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))


def vgg(num_classes=1000):
    net = sym.Variable("data")
    for stage, (nf, reps) in enumerate(_VGG_STAGES):
        for rep in range(reps):
            net = sym.Convolution(data=net, kernel=(3, 3), pad=(1, 1),
                                  num_filter=nf,
                                  name=f"conv{stage + 1}_{rep + 1}")
            net = sym.Activation(data=net, act_type="relu")
        net = sym.Pooling(data=net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2))
    net = sym.Flatten(data=net)
    for i in (6, 7):
        net = sym.FullyConnected(data=net, num_hidden=4096, name=f"fc{i}")
        net = sym.Activation(data=net, act_type="relu")
        net = sym.Dropout(data=net, p=0.5)
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc8")
    return sym.SoftmaxOutput(data=net, name="softmax")
