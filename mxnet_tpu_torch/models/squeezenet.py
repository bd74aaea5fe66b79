"""SqueezeNet v1.1 (reference: example/image-classification/symbols/squeezenet.py
and gluon/model_zoo/vision/squeezenet.py).

PyTorch counterpart of ``mxnet_tpu/models/squeezenet.py``: the same graph
and names.
"""
from .. import symbol as sym


def fire(data, squeeze, expand1x1, expand3x3, name):
    sq = sym.Convolution(data=data, num_filter=squeeze, kernel=(1, 1),
                         name="%s_squeeze1x1" % name)
    sq = sym.Activation(data=sq, act_type="relu")
    e1 = sym.Convolution(data=sq, num_filter=expand1x1, kernel=(1, 1),
                         name="%s_expand1x1" % name)
    e1 = sym.Activation(data=e1, act_type="relu")
    e3 = sym.Convolution(data=sq, num_filter=expand3x3, kernel=(3, 3),
                         pad=(1, 1), name="%s_expand3x3" % name)
    e3 = sym.Activation(data=e3, act_type="relu")
    return sym.Concat(e1, e3, name="%s_concat" % name)


def get_symbol(num_classes=1000, **kwargs):
    data = sym.Variable("data")
    body = sym.Convolution(data=data, num_filter=64, kernel=(3, 3),
                           stride=(2, 2), name="conv1")
    body = sym.Activation(data=body, act_type="relu")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max")
    body = fire(body, 16, 64, 64, "fire2")
    body = fire(body, 16, 64, 64, "fire3")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max")
    body = fire(body, 32, 128, 128, "fire4")
    body = fire(body, 32, 128, 128, "fire5")
    body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                       pool_type="max")
    body = fire(body, 48, 192, 192, "fire6")
    body = fire(body, 48, 192, 192, "fire7")
    body = fire(body, 64, 256, 256, "fire8")
    body = fire(body, 64, 256, 256, "fire9")
    body = sym.Dropout(data=body, p=0.5)
    body = sym.Convolution(data=body, num_filter=num_classes, kernel=(1, 1),
                           name="conv10")
    body = sym.Activation(data=body, act_type="relu")
    pool = sym.Pooling(data=body, kernel=(13, 13), global_pool=True,
                       pool_type="avg")
    flat = sym.Flatten(data=pool)
    return sym.SoftmaxOutput(data=flat, name="softmax")
