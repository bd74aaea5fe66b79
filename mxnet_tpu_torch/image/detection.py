"""Detection image pipeline: ImageDetRecordIter and the det augmenters.

PyTorch counterpart of ``mxnet_tpu/image/detection.py`` (reference:
src/io/io.cc:581, src/io/iter_image_det_recordio.cc and the default
detection augmenters, src/io/image_det_aug_default.cc).

A record's label is ``[header_width, obj_width, <extra header...>, (cls
x1 y1 x2 y2 ...)*n]`` with normalized corner boxes; the iterator emits
labels (batch, max_objects, 5) padded with -1, what MultiBoxTarget
consumes.  Augmentation, with the JAX package's draws in its order:
resize to the data shape (boxes are normalized, so resize leaves them),
the random crop that keeps objects whose centres stay inside (boxes
clipped and renormalized, the crop resized back by nearest neighbour),
and the random mirror with the boxes reflected.  On the card the JPEGs
are decoded by nvJPEG and resized by I1 (``ops/image_augment.py``),
and the crop, mirror and normalization run on the batch there; the
labels are computed on the host from the same draws on either device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..io import DataDesc
from ..image_record_iter import ImageRecordIter
from .image import ImageIter
from .. import recordio
from .. import native


def make_det_label(classes, boxes, header_width=2, obj_width=5):
    """Build the flat det label for one image: ``[2, 5, cls x1 y1 x2 y2 ...]``
    (normalized corners)."""
    classes = np.asarray(classes, np.float32).reshape(-1)
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    assert len(classes) == len(boxes)
    objs = np.concatenate([classes[:, None], boxes], axis=1)
    head = np.array([header_width, obj_width], np.float32)
    return np.concatenate([head, objs.reshape(-1)])


def parse_det_label(flat, max_objects):
    """Flat record label → (max_objects, 5) padded with -1."""
    flat = np.asarray(flat, np.float32).reshape(-1)
    out = np.full((max_objects, 5), -1.0, np.float32)
    if flat.size < 2:
        return out
    hw = int(flat[0])
    ow = int(flat[1])
    body = flat[hw:]
    n = body.size // ow
    objs = body[:n * ow].reshape(n, ow)[:, :5]
    n = min(n, max_objects)
    out[:n] = objs[:n]
    return out


class ImageDetRecordIter(ImageRecordIter):
    """reference: ImageDetRecordIter (src/io/io.cc:581)."""

    def __init__(self, path_imgrec, data_shape, batch_size,
                 max_objects=16, rand_mirror=False, rand_crop=0.0,
                 min_crop_scale=0.5, label_name='label', **kwargs):
        # set before super().__init__ starts the producer thread, which
        # calls _load_batch at once
        self.max_objects = max_objects
        self._det_rand_crop_prob = float(rand_crop)
        self._min_crop_scale = float(min_crop_scale)
        self._det_mirror = rand_mirror
        kwargs.pop('label_width', None)
        super().__init__(path_imgrec, data_shape, batch_size,
                         label_width=1, rand_mirror=False,
                         rand_crop=False, label_name=label_name, **kwargs)
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, max_objects, 5))]

    def _load_batch(self, idxs):
        raws = native.read_records(self.path, self._offsets[idxs])
        labels = np.zeros((len(raws), self.max_objects, 5), np.float32)
        jpegs = []
        for i, raw in enumerate(raws):
            header, img = recordio.unpack(raw)
            labels[i] = parse_det_label(header.label, self.max_objects)
            jpegs.append(img)
        c, h, w = self.data_shape
        if self._card:
            from ..ops.image_augment import augment
            n = len(jpegs)
            # resized to (h, w) by I1 with no crop, mirror or
            # normalization: the uint8 values as float32
            arr = augment(self._decode(jpegs, c), np.zeros(n, np.int64),
                          np.zeros(n, np.int64), np.zeros(n, bool), (h, w),
                          (h, w))
            mean = torch.from_numpy(self.mean).to(self._dev)
            std = torch.from_numpy(self.std).to(self._dev)
        else:
            arr, fails = native.decode_jpeg_batch(jpegs, h, w, c,
                                                  self.nthreads)
            self.decode_failures += fails
            arr = arr.transpose(0, 3, 1, 2).astype(np.float32)
            mean, std = self.mean, self.std

        # det augmenters (boxes normalized: resize is box-invariant)
        if self._det_rand_crop_prob > 0.0:
            arr, labels = self._rand_det_crop(arr, labels)
        if self._det_mirror:
            flip = self._rng.rand(arr.shape[0]) < 0.5
            if self._card:
                sel = torch.from_numpy(np.where(flip)[0]).to(self._dev)
                arr[sel] = arr[sel].flip(-1)
            else:
                arr[flip] = arr[flip, :, :, ::-1]
            for i in np.where(flip)[0]:
                labels[i] = _flip_boxes(labels[i])
        if self.mean.any():
            arr -= mean
        if (self.std != 1.0).any():
            arr /= std
        return arr, labels

    def _rand_det_crop(self, arr, labels):
        """Random crop keeping objects whose centres stay inside
        (reference: image_det_aug_default.cc crop samplers)."""
        n, c, h, w = arr.shape
        for i in range(n):
            if self._rng.rand() >= self._det_rand_crop_prob:
                continue
            s = self._rng.uniform(self._min_crop_scale, 1.0)
            ch, cw = int(h * s), int(w * s)
            y0 = self._rng.randint(0, h - ch + 1)
            x0 = self._rng.randint(0, w - cw + 1)
            # normalized crop window
            nx0, ny0 = x0 / w, y0 / h
            nx1, ny1 = (x0 + cw) / w, (y0 + ch) / h
            lab = labels[i]
            valid = lab[:, 0] >= 0
            if valid.any():
                cx = (lab[valid, 1] + lab[valid, 3]) / 2
                cy = (lab[valid, 2] + lab[valid, 4]) / 2
                keep = (cx >= nx0) & (cx < nx1) & (cy >= ny0) & (cy < ny1)
                if not keep.any():
                    continue  # skip the crop rather than drop every object
                new = np.full_like(lab, -1.0)
                kept = lab[valid][keep]
                # clip to the window and renormalize
                kept[:, 1] = np.clip((kept[:, 1] - nx0) / (nx1 - nx0), 0, 1)
                kept[:, 3] = np.clip((kept[:, 3] - nx0) / (nx1 - nx0), 0, 1)
                kept[:, 2] = np.clip((kept[:, 2] - ny0) / (ny1 - ny0), 0, 1)
                kept[:, 4] = np.clip((kept[:, 4] - ny0) / (ny1 - ny0), 0, 1)
                new[:len(kept)] = kept
                labels[i] = new
            # crop and resize back (nearest neighbour through an index grid)
            yy = (np.arange(h) * ch / h).astype(int)
            xx = (np.arange(w) * cw / w).astype(int)
            if self._card:
                crop = arr[i, :, y0:y0 + ch, x0:x0 + cw]
                arr[i] = crop[:, torch.from_numpy(yy).to(arr.device)][
                    :, :, torch.from_numpy(xx).to(arr.device)]
            else:
                crop = arr[i, :, y0:y0 + ch, x0:x0 + cw]
                arr[i] = crop[:, yy][:, :, xx]
        return arr, labels


def pack_det_dataset(path_rec, images, classes_list, boxes_list,
                     quality=95):
    """Write a detection .rec from in-memory images (HWC uint8) and labels,
    the test and tooling analog of im2rec's det mode.  numpy images are
    encoded by PIL, as the JAX package encodes them; CUDA tensors on the
    card by nvJPEG (``recordio.pack_img``)."""
    rec = recordio.MXRecordIO(path_rec, 'w')
    for i, (im, cls, boxes) in enumerate(zip(images, classes_list,
                                             boxes_list)):
        header = recordio.IRHeader(0, make_det_label(cls, boxes), i, 0)
        rec.write(recordio.pack_img(header, im, quality=quality))
    rec.close()


class ImageDetIter(ImageIter):
    """Python-side detection iterator over .rec/.lst/in-memory image
    lists (reference: python/mxnet/image/detection.py ImageDetIter).

    Labels are detection-format (``[header, obj_width, objs...]``, the
    same contract as ImageDetRecordIter) and batch as
    ``(batch, max_objects, 5)`` padded with -1.  Augmentation uses the
    classification augmenter list for pixels (resize/color only — crops
    would move boxes; use ImageDetRecordIter's box-aware crop for that)
    plus box-aware random mirror here.
    """

    def __init__(self, batch_size, data_shape, max_objects=16,
                 rand_mirror=False, label_name='label', det_aug_list=None,
                 **kwargs):
        self.max_objects = max_objects
        self._det_mirror = rand_mirror
        # box-aware (src, label) augmenters (CreateDetAugmenter);
        # supersede the built-in mirror when given
        self.det_auglist = det_aug_list
        self._det_rng = np.random.RandomState(kwargs.pop('seed', 0))
        kwargs.pop('label_width', None)
        if kwargs.get('aug_list') is None:
            # classification CreateAugmenter would CROP (CenterCropAug),
            # silently moving boxes on non-square images; the box-invariant
            # default is a force resize to (w, h)
            from .image import ForceResizeAug
            kwargs['aug_list'] = [
                ForceResizeAug((data_shape[2], data_shape[1]))]
            kwargs.pop('resize', None)
        super().__init__(batch_size, data_shape, label_width=1,
                         label_name=label_name, **kwargs)
        self.provide_label = [DataDesc(label_name,
                                       (batch_size, max_objects, 5))]

    def next(self):
        from .image import imdecode, _as_np
        from ..io import DataBatch
        from ..ndarray.ndarray import array as nd_array
        import logging
        batch_size = self.batch_size
        c, h, w = self.data_shape
        batch_data = np.zeros((batch_size, c, h, w), np.float32)
        batch_label = np.full((batch_size, self.max_objects, 5), -1.0,
                              np.float32)
        i = 0
        try:
            while i < batch_size:
                label, s = self.next_sample()
                try:
                    data = [imdecode(s, 1 if c == 3 else 0)]
                except Exception as e:  # noqa: BLE001
                    logging.debug('Invalid image, skipping: %s', str(e))
                    continue
                if self.det_auglist is not None:
                    # box-aware path: augmenters transform (src, label)
                    # pairs; the trailing force-resize in
                    # CreateDetAugmenter pins the output size
                    d = data[0]
                    lab = parse_det_label(label, self.max_objects)
                    for aug in self.det_auglist:
                        d, lab = aug(d, lab)
                    arr = _as_np(d).astype(np.float32)
                    batch_data[i] = arr.transpose(2, 0, 1)
                    batch_label[i] = lab
                    i += 1
                    continue
                for aug in self.auglist:
                    data = [ret for src in data for ret in aug(src)]
                for d in data:
                    if i >= batch_size:
                        break
                    arr = _as_np(d).astype(np.float32)
                    lab = parse_det_label(label, self.max_objects)
                    if self._det_mirror and self._det_rng.rand() < 0.5:
                        arr = arr[:, ::-1]
                        lab = _flip_boxes(lab)
                    batch_data[i] = arr.transpose(2, 0, 1)
                    batch_label[i] = lab
                    i += 1
        except StopIteration:
            if i == 0:
                raise
        return DataBatch([nd_array(batch_data)], [nd_array(batch_label)],
                         pad=batch_size - i,
                         provide_data=self.provide_data,
                         provide_label=self.provide_label)


# ---------------------------------------------------------------------------
# Detection augmenter objects + factory
# (reference: python/mxnet/image/detection.py — DetBorrowAug,
#  DetHorizontalFlipAug, DetRandomCropAug, DetRandomPadAug,
#  CreateDetAugmenter :482.  Boxes are NORMALIZED [0,1] xyxy in columns
#  1..4 of a (max_objects, 5) label padded with -1 — the same contract
#  as ImageDetRecordIter above, so the box math is shared.)
# ---------------------------------------------------------------------------

class DetAugmenter:
    """Callable ``(src_hwc_ndarray, label) -> (src, label)``."""

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def dumps(self):
        import json
        return json.dumps([self.__class__.__name__.lower(), self._kwargs])

    def __call__(self, src, label):
        raise NotImplementedError


class DetBorrowAug(DetAugmenter):
    """Wrap a pixel-only classification augmenter; the label rides along
    (reference: DetBorrowAug — 'borrow standard augmenter')."""

    def __init__(self, augmenter):
        # store the class name, not dumps(): some augmenters carry numpy
        # arrays (ColorNormalizeAug mean/std) that json can't serialize
        super().__init__(augmenter=type(augmenter).__name__)
        self.augmenter = augmenter

    def __call__(self, src, label):
        return self.augmenter(src)[0], label


def _flip_boxes(label):
    """Reflect normalized xyxy boxes horizontally, in place, rows with
    class >= 0 only — the ONE copy of the flip-box math (used by the det
    augmenter, ImageDetIter's built-in mirror, and ImageDetRecordIter)."""
    valid = label[:, 0] >= 0
    x1 = label[valid, 1].copy()
    x2 = label[valid, 3].copy()
    label[valid, 1] = 1.0 - x2
    label[valid, 3] = 1.0 - x1
    return label


class DetHorizontalFlipAug(DetAugmenter):
    """Mirror image AND boxes with probability p."""

    def __init__(self, p=0.5, seed=0):
        super().__init__(p=p)
        self.p = p
        self._rng = np.random.RandomState(seed)

    def __call__(self, src, label):
        if self._rng.rand() < self.p:
            from .image import _as_np
            from ..ndarray.ndarray import array as nd_array
            src = nd_array(_as_np(src)[:, ::-1])
            label = _flip_boxes(label.copy())
        return src, label


class DetRandomCropAug(DetAugmenter):
    """Random scale crop keeping objects whose centers stay inside
    (the in-tree sampler ImageDetRecordIter._rand_det_crop uses; the
    reference's constrained samplers express the same center-keep rule,
    image_det_aug_default.cc)."""

    def __init__(self, p=1.0, min_crop_scale=0.5, seed=0):
        super().__init__(p=p, min_crop_scale=min_crop_scale)
        self.p = p
        self.min_crop_scale = min_crop_scale
        self._rng = np.random.RandomState(seed)

    def __call__(self, src, label):
        if self._rng.rand() >= self.p:
            return src, label
        from .image import _as_np
        from ..ndarray.ndarray import array as nd_array
        arr = _as_np(src)
        h, w = arr.shape[:2]
        s = self._rng.uniform(self.min_crop_scale, 1.0)
        ch, cw = int(h * s), int(w * s)
        y0 = self._rng.randint(0, h - ch + 1)
        x0 = self._rng.randint(0, w - cw + 1)
        nx0, ny0 = x0 / w, y0 / h
        nx1, ny1 = (x0 + cw) / w, (y0 + ch) / h
        lab = label.copy()
        valid = lab[:, 0] >= 0
        if valid.any():
            cx = (lab[valid, 1] + lab[valid, 3]) / 2
            cy = (lab[valid, 2] + lab[valid, 4]) / 2
            keep = (cx >= nx0) & (cx < nx1) & (cy >= ny0) & (cy < ny1)
            if not keep.any():
                return src, label   # keep at least one object: skip crop
            new = np.full_like(lab, -1.0)
            kept = lab[valid][keep]
            kept[:, 1] = np.clip((kept[:, 1] - nx0) / (nx1 - nx0), 0, 1)
            kept[:, 3] = np.clip((kept[:, 3] - nx0) / (nx1 - nx0), 0, 1)
            kept[:, 2] = np.clip((kept[:, 2] - ny0) / (ny1 - ny0), 0, 1)
            kept[:, 4] = np.clip((kept[:, 4] - ny0) / (ny1 - ny0), 0, 1)
            new[:len(kept)] = kept
            lab = new
        return nd_array(arr[y0:y0 + ch, x0:x0 + cw]), lab


class DetRandomPadAug(DetAugmenter):
    """Pad the image into a larger canvas (zoom OUT) and shrink boxes
    accordingly (reference: DetRandomPadAug)."""

    def __init__(self, p=1.0, max_pad_scale=2.0, pad_val=(127, 127, 127),
                 seed=0):
        super().__init__(p=p, max_pad_scale=max_pad_scale, pad_val=pad_val)
        self.p = p
        self.max_pad_scale = max_pad_scale
        self.pad_val = pad_val
        self._rng = np.random.RandomState(seed)

    def __call__(self, src, label):
        if self._rng.rand() >= self.p:
            return src, label
        from .image import _as_np
        from ..ndarray.ndarray import array as nd_array
        arr = _as_np(src)
        h, w, c = arr.shape
        s = self._rng.uniform(1.0, self.max_pad_scale)
        nh, nw = int(h * s), int(w * s)
        y0 = self._rng.randint(0, nh - h + 1)
        x0 = self._rng.randint(0, nw - w + 1)
        canvas = np.empty((nh, nw, c), arr.dtype)
        canvas[:] = np.asarray(self.pad_val[:c], arr.dtype)
        canvas[y0:y0 + h, x0:x0 + w] = arr
        lab = label.copy()
        valid = lab[:, 0] >= 0
        lab[valid, 1] = (lab[valid, 1] * w + x0) / nw
        lab[valid, 3] = (lab[valid, 3] * w + x0) / nw
        lab[valid, 2] = (lab[valid, 2] * h + y0) / nh
        lab[valid, 4] = (lab[valid, 4] * h + y0) / nh
        return nd_array(canvas), lab


def CreateDetAugmenter(data_shape, resize=0, rand_crop=0, rand_pad=0,
                       rand_mirror=False, mean=None, std=None,
                       brightness=0, contrast=0, saturation=0,
                       min_crop_scale=0.5, max_pad_scale=2.0,
                       pad_val=(127, 127, 127), inter_method=2, seed=0):
    """Standard detection augmenter list (reference: detection.py
    CreateDetAugmenter:482).  ``rand_crop``/``rand_pad`` are
    probabilities; pixel-only steps (resize, color jitter, normalize)
    ride through DetBorrowAug; geometry steps are box-aware.  The
    reference's constrained-IoU crop samplers are simplified to the
    center-keep rule shared with ImageDetRecordIter (documented above).
    A trailing force-resize pins the output to ``data_shape`` so crops
    and pads always batch."""
    from .image import (ResizeAug, ForceResizeAug, CastAug, ColorJitterAug,
                        ColorNormalizeAug)
    auglist = []
    if resize > 0:
        auglist.append(DetBorrowAug(ResizeAug(resize, inter_method)))
    # distinct streams per geometric augmenter: one shared seed would put
    # crop/pad in lockstep (same skip/apply decisions and scale draw on
    # every image), silently collapsing augmentation diversity
    if rand_crop > 0:
        auglist.append(DetRandomCropAug(p=rand_crop,
                                        min_crop_scale=min_crop_scale,
                                        seed=seed))
    if rand_pad > 0:
        auglist.append(DetRandomPadAug(p=rand_pad,
                                       max_pad_scale=max_pad_scale,
                                       pad_val=pad_val, seed=seed + 1))
    if rand_mirror:
        auglist.append(DetHorizontalFlipAug(0.5, seed=seed + 2))
    auglist.append(DetBorrowAug(ForceResizeAug((data_shape[2],
                                                data_shape[1]),
                                               inter_method)))
    auglist.append(DetBorrowAug(CastAug()))
    if brightness or contrast or saturation:
        auglist.append(DetBorrowAug(
            ColorJitterAug(brightness, contrast, saturation)))
    if mean is True:
        mean = np.array([123.68, 116.28, 103.53])
    if std is True:
        std = np.array([58.395, 57.12, 57.375])
    if mean is not None or std is not None:
        auglist.append(DetBorrowAug(ColorNormalizeAug(mean, std)))
    return auglist
