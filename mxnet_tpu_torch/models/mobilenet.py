"""MobileNet v1 (reference: example/image-classification/symbols/mobilenet.py).

PyTorch counterpart of ``mxnet_tpu/models/mobilenet.py``: the same graph
and names.  The depthwise step of each separable convolution is a
grouped ``Convolution`` with ``num_group`` equal to its channels.
"""
from .. import symbol as sym


def conv_block(data, num_filter, kernel, stride=(1, 1), pad=(0, 0),
               num_group=1, name=None):
    conv = sym.Convolution(data=data, num_filter=num_filter, kernel=kernel,
                           stride=stride, pad=pad, num_group=num_group,
                           no_bias=True, name="%s_conv" % name)
    bn = sym.BatchNorm(data=conv, fix_gamma=False, name="%s_bn" % name)
    return sym.Activation(data=bn, act_type="relu", name="%s_relu" % name)


def dw_sep(data, dw_channels, channels, stride, name):
    dw = conv_block(data, dw_channels, kernel=(3, 3), stride=stride,
                    pad=(1, 1), num_group=dw_channels, name="%s_dw" % name)
    return conv_block(dw, channels, kernel=(1, 1), name="%s_pw" % name)


def get_symbol(num_classes=1000, multiplier=1.0, **kwargs):
    def ch(n):
        return max(8, int(n * multiplier))

    data = sym.Variable("data")
    body = conv_block(data, ch(32), kernel=(3, 3), stride=(2, 2),
                      pad=(1, 1), name="conv1")
    spec = [  # (dw_channels, out_channels, stride)
        (32, 64, 1), (64, 128, 2), (128, 128, 1), (128, 256, 2),
        (256, 256, 1), (256, 512, 2),
        (512, 512, 1), (512, 512, 1), (512, 512, 1), (512, 512, 1),
        (512, 512, 1),
        (512, 1024, 2), (1024, 1024, 1),
    ]
    for i, (dwc, c, s) in enumerate(spec):
        body = dw_sep(body, ch(dwc), ch(c), (s, s), name="sep%d" % (i + 1))
    pool = sym.Pooling(data=body, kernel=(7, 7), global_pool=True,
                       pool_type="avg", name="global_pool")
    flat = sym.Flatten(data=pool)
    fc = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc")
    return sym.SoftmaxOutput(data=fc, name="softmax")
