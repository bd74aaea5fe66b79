"""ResNeXt (reference: example/image-classification/symbols/resnext.py).

PyTorch counterpart of ``mxnet_tpu/models/resnext.py``: the same graph
and names.  The grouped 3x3 convolutions are ``Convolution`` with
``num_group`` (``F.conv2d``'s ``groups``).
"""
from .. import symbol as sym

BN_MOM = 0.9
BN_EPS = 2e-5


def residual_unit(data, num_filter, stride, dim_match, name, num_group=32,
                  bottle_neck=True):
    if bottle_neck:
        conv1 = sym.Convolution(data=data, num_filter=num_filter // 2,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv1")
        bn1 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv2 = sym.Convolution(data=act1, num_filter=num_filter // 2,
                                num_group=num_group, kernel=(3, 3),
                                stride=stride, pad=(1, 1), no_bias=True,
                                name=name + "_conv2")
        bn2 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + "_bn2")
        act2 = sym.Activation(data=bn2, act_type="relu", name=name + "_relu2")
        conv3 = sym.Convolution(data=act2, num_filter=num_filter,
                                kernel=(1, 1), stride=(1, 1), pad=(0, 0),
                                no_bias=True, name=name + "_conv3")
        bn3 = sym.BatchNorm(data=conv3, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + "_bn3")
        if dim_match:
            shortcut = data
        else:
            shortcut_conv = sym.Convolution(data=data, num_filter=num_filter,
                                            kernel=(1, 1), stride=stride,
                                            no_bias=True, name=name + "_sc")
            shortcut = sym.BatchNorm(data=shortcut_conv, fix_gamma=False,
                                     eps=BN_EPS, momentum=BN_MOM,
                                     name=name + "_sc_bn")
        return sym.Activation(data=bn3 + shortcut, act_type="relu",
                              name=name + "_relu")
    else:
        conv1 = sym.Convolution(data=data, num_filter=num_filter,
                                kernel=(3, 3), stride=stride, pad=(1, 1),
                                no_bias=True, name=name + "_conv1")
        bn1 = sym.BatchNorm(data=conv1, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + "_bn1")
        act1 = sym.Activation(data=bn1, act_type="relu", name=name + "_relu1")
        conv2 = sym.Convolution(data=act1, num_filter=num_filter,
                                kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                                no_bias=True, name=name + "_conv2")
        bn2 = sym.BatchNorm(data=conv2, fix_gamma=False, eps=BN_EPS,
                            momentum=BN_MOM, name=name + "_bn2")
        if dim_match:
            shortcut = data
        else:
            shortcut_conv = sym.Convolution(data=data, num_filter=num_filter,
                                            kernel=(1, 1), stride=stride,
                                            no_bias=True, name=name + "_sc")
            shortcut = sym.BatchNorm(data=shortcut_conv, fix_gamma=False,
                                     eps=BN_EPS, momentum=BN_MOM,
                                     name=name + "_sc_bn")
        return sym.Activation(data=bn2 + shortcut, act_type="relu",
                              name=name + "_relu")


def get_symbol(num_classes=1000, num_layers=50, image_shape="3,224,224",
               num_group=32, **kwargs):
    if isinstance(image_shape, str):
        image_shape = tuple(int(x) for x in image_shape.split(","))
    (nchannel, height, width) = image_shape
    if height <= 32:
        num_stages = 3
        if (num_layers - 2) % 9 == 0 and num_layers >= 164:
            per_unit = [(num_layers - 2) // 9]
            filter_list = [16, 64, 128, 256]
            bottle_neck = True
        elif (num_layers - 2) % 6 == 0 and num_layers < 164:
            per_unit = [(num_layers - 2) // 6]
            filter_list = [16, 16, 32, 64]
            bottle_neck = False
        else:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = per_unit * num_stages
    else:
        if num_layers >= 50:
            filter_list = [64, 256, 512, 1024, 2048]
            bottle_neck = True
        else:
            filter_list = [64, 64, 128, 256, 512]
            bottle_neck = False
        num_stages = 4
        units_table = {
            18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
            101: [3, 4, 23, 3], 152: [3, 8, 36, 3],
        }
        if num_layers not in units_table:
            raise ValueError("no experiments done on num_layers %d"
                             % num_layers)
        units = units_table[num_layers]

    data = sym.Variable(name="data")
    if height <= 32:
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                               no_bias=True, name="conv0")
    else:
        body = sym.Convolution(data=data, num_filter=filter_list[0],
                               kernel=(7, 7), stride=(2, 2), pad=(3, 3),
                               no_bias=True, name="conv0")
        body = sym.BatchNorm(data=body, fix_gamma=False, eps=BN_EPS,
                             momentum=BN_MOM, name="bn0")
        body = sym.Activation(data=body, act_type="relu", name="relu0")
        body = sym.Pooling(data=body, kernel=(3, 3), stride=(2, 2),
                           pad=(1, 1), pool_type="max")

    for i in range(num_stages):
        stride = (1, 1) if i == 0 else (2, 2)
        body = residual_unit(body, filter_list[i + 1], stride, False,
                             name="stage%d_unit%d" % (i + 1, 1),
                             num_group=num_group, bottle_neck=bottle_neck)
        for j in range(units[i] - 1):
            body = residual_unit(body, filter_list[i + 1], (1, 1), True,
                                 name="stage%d_unit%d" % (i + 1, j + 2),
                                 num_group=num_group, bottle_neck=bottle_neck)
    pool1 = sym.Pooling(data=body, global_pool=True, kernel=(7, 7),
                        pool_type="avg", name="pool1")
    flat = sym.Flatten(data=pool1)
    fc1 = sym.FullyConnected(data=flat, num_hidden=num_classes, name="fc1")
    return sym.SoftmaxOutput(data=fc1, name="softmax")
