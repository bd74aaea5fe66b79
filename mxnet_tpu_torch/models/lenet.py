"""LeNet-5 (reference: example/image-classification/symbols/lenet.py).

PyTorch counterpart of ``mxnet_tpu/models/lenet.py``: the same graph and
names.
"""
from .. import symbol as sym


def get_symbol(num_classes=10, add_stn=False, **kwargs):
    data = sym.Variable("data")
    conv1 = sym.Convolution(data=data, kernel=(5, 5), num_filter=20)
    tanh1 = sym.Activation(data=conv1, act_type="tanh")
    pool1 = sym.Pooling(data=tanh1, pool_type="max", kernel=(2, 2),
                        stride=(2, 2))
    conv2 = sym.Convolution(data=pool1, kernel=(5, 5), num_filter=50)
    tanh2 = sym.Activation(data=conv2, act_type="tanh")
    pool2 = sym.Pooling(data=tanh2, pool_type="max", kernel=(2, 2),
                        stride=(2, 2))
    flatten = sym.Flatten(data=pool2)
    fc1 = sym.FullyConnected(data=flatten, num_hidden=500)
    tanh3 = sym.Activation(data=fc1, act_type="tanh")
    fc2 = sym.FullyConnected(data=tanh3, num_hidden=num_classes)
    return sym.SoftmaxOutput(data=fc2, name="softmax")
