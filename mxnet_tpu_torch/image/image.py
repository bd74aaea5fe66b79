"""Image decode, augment and iterate.

PyTorch counterpart of ``mxnet_tpu/image/image.py`` (reference:
python/mxnet/image/image.py): ``imdecode``, ``imresize``, the crops,
``color_normalize``, the augmenters, ``CreateAugmenter`` and
``ImageIter``.  As in the JAX package this is host-side work: images are
numpy arrays, decoded and resized by PIL, augmented with the same Python
``random`` and numpy draws, and each result is an NDArray on the current
context (``gpu(0)`` unless a ``with mt.cpu():`` block says otherwise), as
the JAX package's ``nd_array`` puts it on its default device.  The
record iterators' batched path (``image_record_iter.py``) and
``recordio.unpack_img`` in a GPU context decode on the card instead.
"""
from __future__ import annotations

import io as _io
import logging
import os
import random as pyrandom

import numpy as np

from ..ndarray import NDArray
from ..ndarray.ndarray import array as nd_array
from ..io import DataIter, DataBatch, DataDesc
from .. import recordio


def _as_np(img):
    if isinstance(img, NDArray):
        return img.asnumpy()
    return np.asarray(img)


def imdecode(buf, flag=1, to_rgb=1, to_ndarray=True):
    """Decode an image byte string to HWC uint8
    (reference: image.py imdecode wrapping cv2/mx.img.imdecode op)."""
    from PIL import Image
    if isinstance(buf, np.ndarray):
        buf = buf.tobytes()
    img = Image.open(_io.BytesIO(buf))
    img = img.convert('RGB' if flag else 'L')
    arr = np.asarray(img, dtype=np.uint8)
    if not flag:
        arr = arr[:, :, None]
    if flag and not to_rgb:
        arr = arr[:, :, ::-1]  # BGR like OpenCV default
    return nd_array(arr) if to_ndarray else arr


def imread(filename, flag=1, to_rgb=1):
    with open(filename, 'rb') as f:
        return imdecode(f.read(), flag, to_rgb)


def imresize(src, w, h, interp=2):
    """reference: image.py imresize (cv2.resize)."""
    from PIL import Image
    arr = _as_np(src)
    squeeze = arr.shape[2] == 1
    pil = Image.fromarray(arr[:, :, 0] if squeeze else arr)
    resample = {0: Image.NEAREST, 1: Image.BILINEAR, 2: Image.BICUBIC,
                3: Image.LANCZOS, 4: Image.LANCZOS}.get(interp,
                                                        Image.BILINEAR)
    out = np.asarray(pil.resize((w, h), resample), dtype=arr.dtype)
    if squeeze:
        out = out[:, :, None]
    return nd_array(out)


def scale_down(src_size, size):
    """reference: image.py scale_down."""
    w, h = size
    sw, sh = src_size
    if sh < h:
        w, h = float(w * sh) / h, sh
    if sw < w:
        w, h = sw, float(h * sw) / w
    return int(w), int(h)


def resize_short(src, size, interp=2):
    """Resize so the shorter edge == size (reference: image.py:142)."""
    arr = _as_np(src)
    h, w = arr.shape[:2]
    if h > w:
        new_h, new_w = size * h // w, size
    else:
        new_h, new_w = size, size * w // h
    return imresize(arr, new_w, new_h, interp)


def fixed_crop(src, x0, y0, w, h, size=None, interp=2):
    """reference: image.py fixed_crop."""
    arr = _as_np(src)
    out = arr[y0:y0 + h, x0:x0 + w]
    if size is not None and (w, h) != size:
        return imresize(out, size[0], size[1], interp)
    return nd_array(out)


def random_crop(src, size, interp=2):
    """reference: image.py random_crop."""
    arr = _as_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = pyrandom.randint(0, w - new_w)
    y0 = pyrandom.randint(0, h - new_h)
    out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def center_crop(src, size, interp=2):
    """reference: image.py center_crop."""
    arr = _as_np(src)
    h, w = arr.shape[:2]
    new_w, new_h = scale_down((w, h), size)
    x0 = (w - new_w) // 2
    y0 = (h - new_h) // 2
    out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
    return out, (x0, y0, new_w, new_h)


def random_size_crop(src, size, min_area, ratio, interp=2):
    """Random area+aspect crop (reference: image.py random_size_crop —
    the inception-style augmentation)."""
    arr = _as_np(src)
    h, w = arr.shape[:2]
    area = h * w
    for _ in range(10):
        target_area = pyrandom.uniform(min_area, 1.0) * area
        new_ratio = pyrandom.uniform(*ratio)
        new_w = int(round(np.sqrt(target_area * new_ratio)))
        new_h = int(round(np.sqrt(target_area / new_ratio)))
        if pyrandom.random() < 0.5:
            new_h, new_w = new_w, new_h
        if new_w <= w and new_h <= h:
            x0 = pyrandom.randint(0, w - new_w)
            y0 = pyrandom.randint(0, h - new_h)
            out = fixed_crop(arr, x0, y0, new_w, new_h, size, interp)
            return out, (x0, y0, new_w, new_h)
    return center_crop(arr, size, interp)


def color_normalize(src, mean, std=None):
    """reference: image.py color_normalize."""
    arr = _as_np(src).astype(np.float32)
    if mean is not None:
        arr = arr - _as_np(mean)
    if std is not None:
        arr = arr / _as_np(std)
    return nd_array(arr)


# --------------------------------------------------------------------------
# Augmenters (reference: image.py Augmenter classes)
# --------------------------------------------------------------------------
class Augmenter:
    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src):
        raise NotImplementedError


class ResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [resize_short(src, self.size, self.interp)]


class ForceResizeAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [imresize(src, self.size[0], self.size[1], self.interp)]


class RandomCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [random_crop(src, self.size, self.interp)[0]]


class RandomSizedCropAug(Augmenter):
    def __init__(self, size, min_area, ratio, interp=2):
        super().__init__(size=size, min_area=min_area, ratio=ratio,
                         interp=interp)
        self.size = size
        self.min_area = min_area
        self.ratio = ratio
        self.interp = interp

    def __call__(self, src):
        return [random_size_crop(src, self.size, self.min_area,
                                 self.ratio, self.interp)[0]]


class CenterCropAug(Augmenter):
    def __init__(self, size, interp=2):
        super().__init__(size=size, interp=interp)
        self.size = size
        self.interp = interp

    def __call__(self, src):
        return [center_crop(src, self.size, self.interp)[0]]


class HorizontalFlipAug(Augmenter):
    def __init__(self, p):
        super().__init__(p=p)
        self.p = p

    def __call__(self, src):
        if pyrandom.random() < self.p:
            return [nd_array(_as_np(src)[:, ::-1])]
        return [src if isinstance(src, NDArray) else nd_array(src)]


class CastAug(Augmenter):
    def __init__(self, typ='float32'):
        super().__init__(type=typ)
        self.typ = typ

    def __call__(self, src):
        return [nd_array(_as_np(src).astype(self.typ))]


class BrightnessJitterAug(Augmenter):
    def __init__(self, brightness):
        super().__init__(brightness=brightness)
        self.brightness = brightness

    def __call__(self, src):
        alpha = 1.0 + pyrandom.uniform(-self.brightness, self.brightness)
        return [nd_array(_as_np(src).astype(np.float32) * alpha)]


class ContrastJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, contrast):
        super().__init__(contrast=contrast)
        self.contrast = contrast

    def __call__(self, src):
        arr = _as_np(src).astype(np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.contrast, self.contrast)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        # contrast scales around the gray mean: gray image stays put
        return [nd_array(arr * alpha + gray.mean() * (1.0 - alpha))]


class SaturationJitterAug(Augmenter):
    _coef = np.array([[[0.299, 0.587, 0.114]]], np.float32)

    def __init__(self, saturation):
        super().__init__(saturation=saturation)
        self.saturation = saturation

    def __call__(self, src):
        arr = _as_np(src).astype(np.float32)
        alpha = 1.0 + pyrandom.uniform(-self.saturation, self.saturation)
        gray = (arr * self._coef).sum(axis=2, keepdims=True)
        return [nd_array(arr * alpha + gray * (1.0 - alpha))]


class ColorJitterAug(Augmenter):
    """Random order of brightness/contrast/saturation jitters."""

    def __init__(self, brightness, contrast, saturation):
        super().__init__(brightness=brightness, contrast=contrast,
                         saturation=saturation)
        augs = []
        if brightness > 0:
            augs.append(BrightnessJitterAug(brightness))
        if contrast > 0:
            augs.append(ContrastJitterAug(contrast))
        if saturation > 0:
            augs.append(SaturationJitterAug(saturation))
        self.augs = augs

    def __call__(self, src):
        augs = list(self.augs)
        pyrandom.shuffle(augs)
        out = src
        for aug in augs:
            out = aug(out)[0]
        return [out]


class LightingAug(Augmenter):
    """PCA lighting noise (reference: image.py LightingAug)."""

    def __init__(self, alphastd, eigval, eigvec):
        super().__init__(alphastd=alphastd)
        self.alphastd = alphastd
        self.eigval = np.asarray(eigval, np.float32)
        self.eigvec = np.asarray(eigvec, np.float32)

    def __call__(self, src):
        alpha = np.random.normal(0, self.alphastd, size=(3,)) \
            .astype(np.float32)
        rgb = np.dot(self.eigvec * alpha, self.eigval)
        return [nd_array(_as_np(src).astype(np.float32) + rgb)]


class ColorNormalizeAug(Augmenter):
    def __init__(self, mean, std):
        super().__init__(mean=mean, std=std)
        self.mean = np.asarray(mean, np.float32) \
            if mean is not None else None
        self.std = np.asarray(std, np.float32) if std is not None else None

    def __call__(self, src):
        return [color_normalize(src, self.mean, self.std)]


class RandomOrderAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        ts = list(self.ts)
        pyrandom.shuffle(ts)
        srcs = [src]
        for t in ts:
            srcs = [out for s in srcs for out in t(s)]
        return srcs


class SequentialAug(Augmenter):
    def __init__(self, ts):
        super().__init__()
        self.ts = ts

    def __call__(self, src):
        srcs = [src]
        for t in self.ts:
            srcs = [out for s in srcs for out in t(s)]
        return srcs


def CreateAugmenter(data_shape, resize=0, rand_crop=False, rand_resize=False,
                    rand_mirror=False, mean=None, std=None, brightness=0,
                    contrast=0, saturation=0, pca_noise=0, inter_method=2):
    """Standard augmenter list (reference: image.py CreateAugmenter)."""
    auglist = []
    if resize > 0:
        auglist.append(ResizeAug(resize, inter_method))
    crop_size = (data_shape[2], data_shape[1])
    if rand_resize:
        assert rand_crop
        auglist.append(RandomSizedCropAug(crop_size, 0.08, (3.0 / 4.0,
                                                            4.0 / 3.0),
                                          inter_method))
    elif rand_crop:
        auglist.append(RandomCropAug(crop_size, inter_method))
    else:
        auglist.append(CenterCropAug(crop_size, inter_method))
    if rand_mirror:
        auglist.append(HorizontalFlipAug(0.5))
    auglist.append(CastAug())
    if brightness or contrast or saturation:
        auglist.append(ColorJitterAug(brightness, contrast, saturation))
    if pca_noise > 0:
        eigval = np.array([55.46, 4.794, 1.148])
        eigvec = np.array([[-0.5675, 0.7192, 0.4009],
                           [-0.5808, -0.0045, -0.8140],
                           [-0.5836, -0.6948, 0.4203]])
        auglist.append(LightingAug(pca_noise, eigval, eigvec))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(ColorNormalizeAug(mean, std))
    return auglist


class ImageIter(DataIter):
    """Image iterator supporting .rec files and path lists, with
    augmenters (reference: image.py:547 ImageIter)."""

    def __init__(self, batch_size, data_shape, label_width=1,
                 path_imgrec=None, path_imglist=None, path_root='.',
                 path_imgidx=None, shuffle=False, part_index=0,
                 num_parts=1, aug_list=None, imglist=None,
                 data_name='data', label_name='softmax_label', **kwargs):
        super().__init__()
        assert path_imgrec or path_imglist or isinstance(imglist, list)
        assert len(data_shape) == 3 and data_shape[0] in (1, 3)
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.path_root = path_root
        self.shuffle = shuffle

        self.imgrec = None
        self.imglist = None
        self.seq = None
        if path_imgrec:
            logging.info('%s: loading recordio %s...',
                         self.__class__.__name__, path_imgrec)
            if path_imgidx is None:
                path_imgidx = os.path.splitext(path_imgrec)[0] + '.idx'
            if os.path.exists(path_imgidx):
                self.imgrec = recordio.MXIndexedRecordIO(
                    path_imgidx, path_imgrec, 'r')
                self.seq = list(self.imgrec.keys)
            else:
                self.imgrec = recordio.MXRecordIO(path_imgrec, 'r')
                self.seq = None
        elif path_imglist:
            with open(path_imglist) as fin:
                imglist = {}
                imgkeys = []
                for line in fin:
                    line = line.strip().split('\t')
                    label = np.array(line[1:-1], dtype=np.float32)
                    key = int(line[0])
                    imglist[key] = (label, line[-1])
                    imgkeys.append(key)
                self.imglist = imglist
                self.seq = imgkeys
        elif imglist is not None:
            result = {}
            imgkeys = []
            for index, img in enumerate(imglist):
                key = str(index)
                label = np.array(img[0], dtype=np.float32) \
                    if not isinstance(img[0], (int, float)) else \
                    np.array([img[0]], dtype=np.float32)
                result[key] = (label, img[1])
                imgkeys.append(key)
            self.imglist = result
            self.seq = imgkeys

        if num_parts > 1 and self.seq is not None:
            assert part_index < num_parts
            N = len(self.seq)
            C = N // num_parts
            self.seq = self.seq[part_index * C:(part_index + 1) * C]

        if aug_list is None:
            self.auglist = CreateAugmenter(data_shape, **kwargs)
        else:
            self.auglist = aug_list

        self.provide_data = [DataDesc(data_name,
                                      (batch_size,) + self.data_shape)]
        if label_width > 1:
            self.provide_label = [DataDesc(label_name,
                                           (batch_size, label_width))]
        else:
            self.provide_label = [DataDesc(label_name, (batch_size,))]
        self.cur = 0
        self.reset()

    def reset(self):
        if self.shuffle and self.seq is not None:
            pyrandom.shuffle(self.seq)
        if self.imgrec is not None and self.seq is None:
            self.imgrec.reset()
        self.cur = 0

    def next_sample(self):
        """reference: image.py next_sample."""
        if self.seq is not None:
            if self.cur >= len(self.seq):
                raise StopIteration
            idx = self.seq[self.cur]
            self.cur += 1
            if self.imgrec is not None:
                s = self.imgrec.read_idx(idx)
                header, img = recordio.unpack(s)
                return header.label, img
            label, fname = self.imglist[idx]
            with open(os.path.join(self.path_root, fname), 'rb') as f:
                img = f.read()
            return label, img
        s = self.imgrec.read()
        if s is None:
            raise StopIteration
        header, img = recordio.unpack(s)
        return header.label, img

    def next(self):
        """reference: image.py next — batch assembly."""
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, c, h, w), dtype=np.float32)
        batch_label = np.zeros((batch_size, self.label_width),
                               dtype=np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                try:
                    data = [imdecode(s, 1 if c == 3 else 0)]
                except Exception as e:
                    logging.debug('Invalid image, skipping: %s', str(e))
                    continue
                for aug in self.auglist:
                    data = [ret for src in data for ret in aug(src)]
                for d in data:
                    if i >= batch_size:
                        break
                    arr = _as_np(d).astype(np.float32)
                    batch_data[i] = arr.transpose(2, 0, 1)
                    batch_label[i] = label
                    i += 1
        except StopIteration:
            if i == 0:
                raise
        pad = batch_size - i
        label_out = nd_array(batch_label[:, 0]) if self.label_width == 1 \
            else nd_array(batch_label)
        return DataBatch([nd_array(batch_data)], [label_out], pad=pad)
