"""SSD single-shot detector (BASELINE config 5).

PyTorch counterpart of ``mxnet_tpu/models/ssd.py`` (reference:
example/ssd/symbol/legacy_vgg16_ssd_300.py + symbol_builder.py): the same
graph and names.  Loc and class heads over the backbone's feature maps,
``MultiBoxPrior`` anchors, ``MultiBoxTarget`` training targets,
``SoftmaxOutput`` + smooth-L1 ``MakeLoss``; ``mode="detect"`` ends in
``MultiBoxDetection`` instead.
"""
from .. import symbol as sym


def _conv_block(data, name, num_filter, n_convs=2, pool=True):
    body = data
    for i in range(n_convs):
        body = sym.Convolution(data=body, num_filter=num_filter,
                               kernel=(3, 3), pad=(1, 1),
                               name=f"{name}_conv{i + 1}")
        body = sym.Activation(body, act_type="relu",
                              name=f"{name}_relu{i + 1}")
    if pool:
        body = sym.Pooling(body, kernel=(2, 2), stride=(2, 2),
                           pool_type="max", name=f"{name}_pool")
    return body


def _multibox_layer(feats, num_classes, sizes, ratios):
    """Per-scale loc/cls heads + anchors (reference:
    example/ssd/symbol/common.py multibox_layer)."""
    loc_layers, cls_layers, anchor_layers = [], [], []
    num_anchors = [len(s) + len(r) - 1 for s, r in zip(sizes, ratios)]
    for i, feat in enumerate(feats):
        na = num_anchors[i]
        loc = sym.Convolution(data=feat, num_filter=na * 4, kernel=(3, 3),
                              pad=(1, 1), name=f"loc_pred{i}")
        loc = sym.transpose(loc, axes=(0, 2, 3, 1))
        loc_layers.append(sym.Flatten(loc))
        cls = sym.Convolution(data=feat, num_filter=na * (num_classes + 1),
                              kernel=(3, 3), pad=(1, 1),
                              name=f"cls_pred{i}")
        cls = sym.transpose(cls, axes=(0, 2, 3, 1))
        cls_layers.append(sym.Flatten(cls))
        anchor_layers.append(sym.Reshape(
            sym.MultiBoxPrior(feat, sizes=tuple(sizes[i]),
                              ratios=tuple(ratios[i]), clip=True,
                              name=f"anchors{i}"),
            shape=(1, -1, 4)))
    loc_preds = sym.Concat(*loc_layers, dim=1, name="multibox_loc_pred")
    cls_concat = sym.Concat(*cls_layers, dim=1)
    cls_preds = sym.Reshape(cls_concat, shape=(0, -1, num_classes + 1))
    cls_preds = sym.transpose(cls_preds, axes=(0, 2, 1),
                              name="multibox_cls_pred")   # (N, C+1, A)
    anchors = sym.Concat(*anchor_layers, dim=1, name="multibox_anchors")
    return loc_preds, cls_preds, anchors


def _train_head(loc_preds, cls_preds, anchors):
    """Training losses (reference: symbol_builder.py get_symbol_train)."""
    label = sym.Variable("label")
    tmp = sym.MultiBoxTarget(
        anchors, label, cls_preds, overlap_threshold=0.5,
        ignore_label=-1.0, negative_mining_ratio=3.0,
        negative_mining_thresh=0.5, name="multibox_target")
    loc_target = tmp[0]
    loc_target_mask = tmp[1]
    cls_target = tmp[2]
    cls_prob = sym.SoftmaxOutput(data=cls_preds, label=cls_target,
                                 ignore_label=-1.0, use_ignore=True,
                                 multi_output=True, normalization="valid",
                                 name="cls_prob")
    loc_diff = loc_target_mask * (loc_preds - loc_target)
    loc_loss = sym.MakeLoss(sym.smooth_l1(loc_diff, scalar=1.0),
                            normalization="valid", name="loc_loss")
    # detach'd targets exposed for metrics (reference: cls_label MakeLoss
    # with grad_scale=0)
    cls_label = sym.MakeLoss(data=sym.BlockGrad(cls_target), grad_scale=0.0,
                             name="cls_label")
    return sym.Group([cls_prob, loc_loss, cls_label])


def _vgg16_reduced_features(data):
    """VGG16 through conv5 + dilated fc6/fc7 convs + extra SSD scales
    (reference: legacy_vgg16_ssd_300.py)."""
    b1 = _conv_block(data, "stage1", 64, 2)
    b2 = _conv_block(b1, "stage2", 128, 2)
    b3 = _conv_block(b2, "stage3", 256, 3)
    # conv4_3 scale, taken before its pool: 37x37 at a 300 input (the
    # 2x2 pools floor 75 to 37, where the paper's Caffe ceil mode gives 38)
    c4 = _conv_block(b3, "stage4", 512, 3, pool=False)
    b4 = sym.Pooling(c4, kernel=(2, 2), stride=(2, 2), pool_type="max")
    c5 = _conv_block(b4, "stage5", 512, 3, pool=False)
    b5 = sym.Pooling(c5, kernel=(3, 3), stride=(1, 1), pad=(1, 1),
                     pool_type="max")
    fc6 = sym.Convolution(b5, num_filter=1024, kernel=(3, 3), pad=(6, 6),
                          dilate=(6, 6), name="fc6")
    fc6 = sym.Activation(fc6, act_type="relu")
    fc7 = sym.Convolution(fc6, num_filter=1024, kernel=(1, 1), name="fc7")
    fc7 = sym.Activation(fc7, act_type="relu")

    feats = [c4, fc7]
    body = fc7
    for i, nf in enumerate((256, 128, 128, 128)):
        body = sym.Convolution(body, num_filter=nf, kernel=(1, 1),
                               name=f"extra{i}_1x1")
        body = sym.Activation(body, act_type="relu")
        body = sym.Convolution(body, num_filter=nf * 2, kernel=(3, 3),
                               stride=(2, 2), pad=(1, 1),
                               name=f"extra{i}_3x3")
        body = sym.Activation(body, act_type="relu")
        feats.append(body)
    return feats


def ssd_vgg16(num_classes=20, image_shape=(3, 300, 300), mode="train"):
    """SSD-300 with VGG16-reduced backbone (BASELINE config 5 shape)."""
    data = sym.Variable("data")
    feats = _vgg16_reduced_features(data)
    sizes = [(0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961)]
    # per-scale anchor ratios (reference: legacy_vgg16_ssd_300.py — 3
    # ratios at conv4_3 and the last two scales, 5 in between)
    ratios = [(1, 2, 0.5),
              (1, 2, 0.5, 3, 1.0 / 3), (1, 2, 0.5, 3, 1.0 / 3),
              (1, 2, 0.5, 3, 1.0 / 3),
              (1, 2, 0.5), (1, 2, 0.5)]
    loc, cls, anchors = _multibox_layer(feats, num_classes, sizes, ratios)
    if mode == "train":
        return _train_head(loc, cls, anchors)
    det = sym.MultiBoxDetection(sym.SoftmaxActivation(cls, mode="channel"),
                                loc, anchors, name="detection")
    return det


def ssd_toy(num_classes=2, image_shape=(3, 64, 64), mode="train"):
    """Small 2-scale SSD for tests/CI — same head/target/loss structure
    as ssd_vgg16 on a 3-block backbone."""
    data = sym.Variable("data")
    b1 = _conv_block(data, "t1", 16, 1)       # 32x32
    b2 = _conv_block(b1, "t2", 32, 1)         # 16x16
    b3 = _conv_block(b2, "t3", 64, 1)         # 8x8
    feats = [b2, b3]
    sizes = [(0.25, 0.35), (0.55, 0.75)]
    ratios = [(1, 2, 0.5)] * 2
    loc, cls, anchors = _multibox_layer(feats, num_classes, sizes, ratios)
    if mode == "train":
        return _train_head(loc, cls, anchors)
    det = sym.MultiBoxDetection(sym.SoftmaxActivation(cls, mode="channel"),
                                loc, anchors, name="detection")
    return det
