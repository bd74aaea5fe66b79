"""Image API (reference: python/mxnet/image/); PyTorch counterpart of
``mxnet_tpu/image``."""
from .image import (imdecode, imread, imresize, resize_short, fixed_crop,
                    random_crop, center_crop, color_normalize,
                    random_size_crop, scale_down,
                    Augmenter, ResizeAug, ForceResizeAug, RandomCropAug,
                    RandomSizedCropAug, CenterCropAug, HorizontalFlipAug,
                    CastAug, BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, ColorJitterAug, LightingAug,
                    ColorNormalizeAug, RandomOrderAug, SequentialAug,
                    CreateAugmenter, ImageIter)
from .detection import (ImageDetRecordIter, ImageDetIter, make_det_label,
                        parse_det_label, pack_det_dataset,
                        DetAugmenter, DetBorrowAug, DetHorizontalFlipAug,
                        DetRandomCropAug, DetRandomPadAug,
                        CreateDetAugmenter)
