"""MNIST networks, counterparts of ``mxnet_tpu/models/mnist.py`` (the
reference's ``example/image-classification/train_mnist.py``), with the
same layer names, so weights carry across by name."""
from .. import symbol as sym


def mlp(num_classes=10):
    """784 -> 128 -> 64 -> num_classes with relu, softmax head."""
    net = sym.Variable("data")
    for i, width in enumerate((128, 64)):
        net = sym.FullyConnected(data=net, num_hidden=width, name=f"fc{i + 1}")
        net = sym.Activation(data=net, act_type="relu", name=f"relu{i + 1}")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc3")
    return sym.SoftmaxOutput(data=net, name="softmax")


def lenet(num_classes=10):
    """LeNet-5-style conv net (tanh activations, as in the reference)."""
    net = sym.Variable("data")
    for i, nf in enumerate((20, 50)):
        net = sym.Convolution(data=net, kernel=(5, 5), num_filter=nf,
                              name=f"conv{i + 1}")
        net = sym.Activation(data=net, act_type="tanh", name=f"tanh{i + 1}")
        net = sym.Pooling(data=net, pool_type="max", kernel=(2, 2),
                          stride=(2, 2), name=f"pool{i + 1}")
    net = sym.Flatten(data=net)
    net = sym.FullyConnected(data=net, num_hidden=500, name="fc1")
    net = sym.Activation(data=net, act_type="tanh", name="tanh3")
    net = sym.FullyConnected(data=net, num_hidden=num_classes, name="fc2")
    return sym.SoftmaxOutput(data=net, name="softmax")
