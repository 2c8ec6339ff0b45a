"""Image record pipeline: sharded reading, augmentation, normalization.

Counterpart of ``mxnet_tpu/image_io.py`` (host code, kept as a copy so the
port imports nothing of the JAX package), the rebuild of the reference's
``src/io/iter_image_recordio.cc`` (sharded RecordIO parse with
``num_parts``/``part_index``, threaded decode, shuffle),
``src/io/image_aug_default.cc`` (crop/mirror/rotate/scale/illumination
augmenter) and ``src/io/iter_normalize.h`` (mean image loaded, or
computed and saved; scale; channel means).  Decoding and augmentation are
host work: a thread pool of ``preprocess_threads`` workers decodes the
records of a batch into one host buffer.

The random draws are the JAX package's: ``RandomState(seed +
part_index)`` shuffles the shard and draws one ``randint(0, 2**31 - 1)``
seed per record of a batch, and each worker augments its image with a
``RandomState`` of that seed.  With the same cv2 a batch equals the JAX
iterator's bit for bit.

Batches are host NDArrays (``cpu()``), whatever the default context, as
the port's other iterators yield them: ``ShardedTrainer.fit`` places them
on the card through :class:`~mxnet_tpu_torch.io.DevicePrefetchIter`.  The
data buffer is a torch host tensor the workers fill through a numpy view,
so the batch is handed over without a copy.  cv2 is imported only by the
steps that call it (a codec, a resize, a rotation or scaling), so
``.raw`` records without those steps decode without it.
"""
from __future__ import annotations

import logging
import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np
import torch

from . import recordio as rec_mod
from .base import MXNetError
from .context import cpu
from .io import DataIter
from .ndarray import NDArray, array as nd_array

__all__ = ["ImageAugmenter", "ImageRecordIter"]


class ImageAugmenter:
    """Default augmenter (reference ``image_aug_default.cc:25-114``).

    Operates on HWC uint8/float numpy images; emits CHW views of
    ``data_shape``.
    """

    def __init__(self, data_shape, resize=-1, rand_crop=False,
                 rand_mirror=False, max_rotate_angle=0,
                 max_aspect_ratio=0.0, min_random_scale=1.0,
                 max_random_scale=1.0, max_random_illumination=0.0,
                 max_random_contrast=0.0, rotate_list=()):
        self.data_shape = tuple(data_shape)
        self.resize = resize
        self.rand_crop = rand_crop
        self.rand_mirror = rand_mirror
        self.max_rotate_angle = max_rotate_angle
        self.max_aspect_ratio = max_aspect_ratio
        self.min_random_scale = min_random_scale
        self.max_random_scale = max_random_scale
        self.max_random_illumination = max_random_illumination
        self.max_random_contrast = max_random_contrast
        self.rotate_list = tuple(rotate_list)

    def __call__(self, img: np.ndarray, rng: np.random.RandomState):
        if img.ndim == 2:
            img = img[:, :, None]
        _, th, tw = self.data_shape
        if self.resize > 0:
            import cv2
            # short side to `resize` keeping aspect (reference resize aug)
            h, w = img.shape[:2]
            if h < w:
                nh, nw = self.resize, max(1, int(w * self.resize / h))
            else:
                nh, nw = max(1, int(h * self.resize / w)), self.resize
            img = cv2.resize(img, (nw, nh))
            if img.ndim == 2:
                img = img[:, :, None]
        angle = 0.0
        if self.rotate_list:
            angle = float(self.rotate_list[rng.randint(len(self.rotate_list))])
        elif self.max_rotate_angle > 0:
            angle = rng.uniform(-self.max_rotate_angle, self.max_rotate_angle)
        scale = rng.uniform(self.min_random_scale, self.max_random_scale)
        if angle != 0.0 or scale != 1.0 or self.max_aspect_ratio > 0:
            import cv2
            ratio = 1.0 + (rng.uniform(-self.max_aspect_ratio,
                                       self.max_aspect_ratio)
                           if self.max_aspect_ratio > 0 else 0.0)
            h, w = img.shape[:2]
            mat = cv2.getRotationMatrix2D((w / 2, h / 2), angle, scale)
            mat[0] *= ratio
            img = cv2.warpAffine(img, mat, (w, h))
            if img.ndim == 2:
                img = img[:, :, None]
        h, w = img.shape[:2]
        if h < th or w < tw:
            import cv2
            img = cv2.resize(img, (max(tw, w), max(th, h)))
            if img.ndim == 2:
                img = img[:, :, None]
            h, w = img.shape[:2]
        if self.rand_crop:
            y = rng.randint(0, h - th + 1)
            x = rng.randint(0, w - tw + 1)
        else:
            y, x = (h - th) // 2, (w - tw) // 2
        img = img[y:y + th, x:x + tw]
        if self.rand_mirror and rng.randint(2):
            img = img[:, ::-1]
        if self.max_random_illumination > 0 or self.max_random_contrast > 0:
            img = img.astype(np.float32)
            if self.max_random_illumination > 0:
                img = img + rng.uniform(-self.max_random_illumination,
                                        self.max_random_illumination)
            if self.max_random_contrast > 0:
                img = img * (1.0 + rng.uniform(-self.max_random_contrast,
                                               self.max_random_contrast))
        # else: stay uint8 — the batch buffer assignment converts to f32
        # in one pass
        c = self.data_shape[0]
        if img.shape[2] != c:
            if c == 1:
                img = img.astype(np.float32).mean(axis=2, keepdims=True)
            elif c == 3 and img.shape[2] == 1:
                img = np.repeat(img, 3, axis=2)
            else:
                raise MXNetError(
                    f"image has {img.shape[2]} channels, want {c}")
        # a CHW strided view: the consumer copies it once into the batch
        # buffer
        return img.transpose(2, 0, 1)


class ImageRecordIter(DataIter):
    """Sharded image-record iterator.

    Parameters mirror the reference registration
    (``iter_image_recordio.cc:108-133`` + ``ImageNormalizeParam`` +
    ``BatchParam``/``PrefetcherParam``):

    * ``path_imgrec`` / ``path_imgidx`` — packed records (+ optional index;
      without it the file is scanned for the offsets).
    * ``num_parts`` / ``part_index`` — read only the k-th of N contiguous
      shards (the distributed-reader contract).
    * ``mean_img`` — mean-image file; computed over every record and
      saved (atomically) on first use when missing; ``mean_r/g/b``
      channel constants as the alternative; then ``scale``.
    * ``round_batch`` — the last batch wraps around to the shard's start
      (``getpad`` says how many rows repeat); otherwise it is dropped.
    * augmentation knobs forwarded to :class:`ImageAugmenter`.
    """

    def __init__(self, path_imgrec, data_shape, batch_size,
                 path_imgidx: Optional[str] = None, label_width: int = 1,
                 shuffle: bool = False, num_parts: int = 1,
                 part_index: int = 0, mean_img: Optional[str] = None,
                 mean_r: float = 0.0, mean_g: float = 0.0,
                 mean_b: float = 0.0, scale: float = 1.0,
                 preprocess_threads: int = 4, round_batch: bool = True,
                 seed: int = 0, data_name: str = "data",
                 label_name: str = "softmax_label", **aug_kwargs):
        super().__init__()
        if not 0 <= part_index < num_parts:
            raise MXNetError(
                f"part_index {part_index} out of range for {num_parts} parts")
        self.batch_size = batch_size
        self.data_shape = tuple(data_shape)
        self.label_width = label_width
        self.shuffle = shuffle
        self.scale = scale
        self.round_batch = round_batch
        self.data_name = data_name
        self.label_name = label_name
        self._rng = np.random.RandomState(seed + part_index)
        self._lock = threading.Lock()
        self.aug = ImageAugmenter(data_shape, **aug_kwargs)
        self._pool = ThreadPoolExecutor(max_workers=max(1, preprocess_threads))

        # index the shard: the byte offsets of the records this part owns
        self._rec = rec_mod.MXRecordIO(path_imgrec, "r")
        offsets: List[int] = []
        if path_imgidx and os.path.isfile(path_imgidx):
            with open(path_imgidx) as f:
                offsets = [int(line.strip().split("\t")[1]) for line in f]
        else:
            pos = self._rec.tell()
            while self._rec.read() is not None:
                offsets.append(pos)
                pos = self._rec.tell()
        # contiguous shard split, like dmlc InputSplit (num_parts/part_index)
        n = len(offsets)
        lo = n * part_index // num_parts
        hi = n * (part_index + 1) // num_parts
        self._all_offsets = offsets
        self._offsets = offsets[lo:hi]
        if not self._offsets:
            raise MXNetError("empty shard: no records for this part")

        self._mean: Optional[np.ndarray] = None
        if mean_img:
            self._mean = self._load_or_compute_mean(mean_img)
        elif mean_r or mean_g or mean_b:
            means = [mean_r, mean_g, mean_b][:self.data_shape[0]]
            self._mean = np.asarray(means, np.float32).reshape(-1, 1, 1)
        self.reset()

    # -- mean image (iter_normalize.h:83-210) ---------------------------
    def _load_or_compute_mean(self, path):
        if os.path.isfile(path):
            with np.load(path) as z:
                return z["mean"]
        # dataset-wide mean (all parts, not just this shard: the
        # reference's single mean file), written atomically so concurrent
        # parts never read a partial file
        logging.info("Computing mean image over %d records -> %s",
                     len(self._all_offsets), path)
        acc = np.zeros(self.data_shape, np.float64)
        center_only = ImageAugmenter(self.data_shape)
        rng = np.random.RandomState(0)
        for off in self._all_offsets:
            acc += self._decode_at(off, center_only, rng)[0]
        mean = (acc / len(self._all_offsets)).astype(np.float32)
        tmp = f"{path}.{os.getpid()}.tmp.npz"  # .npz suffix: savez keeps name
        np.savez(tmp, mean=mean)
        os.replace(tmp, path)
        return mean

    @property
    def corrupt_records(self) -> int:
        """Corrupt/truncated records skipped by the tolerant reader
        (see :class:`mxnet_tpu_torch.recordio.MXRecordIO` ``strict``)."""
        return self._rec.corrupt_count

    # -- decode path ----------------------------------------------------
    def _decode_at(self, offset, aug, rng):
        with self._lock:
            self._rec._rec.seek(offset)
            raw = self._rec.read()
        if raw is None:
            # the tolerant reader ran off EOF skipping corruption
            raise MXNetError(
                f"record at offset {offset} unreadable (file corrupt "
                f"through EOF; {self._rec.corrupt_count} corrupt records)")
        header, img = rec_mod.unpack_img(raw)
        out = aug(img, rng)
        label = np.asarray(header.label, np.float32).reshape(-1)
        if label.size < self.label_width:
            raise MXNetError(
                f"record at offset {offset} carries {label.size} label "
                f"value(s) but this iterator was created with "
                f"label_width={self.label_width}")
        return out, label[:self.label_width]

    # -- DataIter protocol ---------------------------------------------
    @property
    def num_data(self):
        return len(self._offsets)

    @property
    def steps_per_epoch(self):
        # the number of batches iter_next yields: round_batch wraps the
        # tail (ceil); otherwise the tail is dropped
        n, b = len(self._offsets), self.batch_size
        return -(-n // b) if self.round_batch else n // b

    @property
    def provide_data(self):
        return [(self.data_name, (self.batch_size,) + self.data_shape)]

    @property
    def provide_label(self):
        shape = ((self.batch_size,) if self.label_width == 1
                 else (self.batch_size, self.label_width))
        return [(self.label_name, shape)]

    def reset(self):
        self._order = list(self._offsets)
        if self.shuffle:
            self._rng.shuffle(self._order)
        self._cursor = 0

    def iter_next(self):
        remaining = len(self._order) - self._cursor
        if remaining <= 0:
            return False
        if remaining < self.batch_size and not self.round_batch:
            return False
        take = min(self.batch_size, remaining)
        offs = self._order[self._cursor:self._cursor + take]
        self._pad = self.batch_size - take
        while len(offs) < self.batch_size:
            # wrap around, repeatedly if the shard is smaller than the pad
            offs = offs + self._order[:self.batch_size - len(offs)]
        self._cursor += take
        seeds = self._rng.randint(0, 2**31 - 1, size=len(offs))
        data_t = torch.empty((self.batch_size,) + self.data_shape,
                             dtype=torch.float32)
        data = data_t.numpy()           # shares data_t's memory

        def work(i, off, s):
            # decode + augment + one uint8->f32 write into the shared
            # batch buffer, inside the worker (cv2 and numpy release the
            # GIL for the heavy parts)
            img, label = self._decode_at(off, self.aug,
                                         np.random.RandomState(s))
            data[i] = img
            return label

        futs = [self._pool.submit(work, i, off, s)
                for i, (off, s) in enumerate(zip(offs, seeds))]
        labels = [f.result() for f in futs]
        if self._mean is not None:
            data -= self._mean
        if self.scale != 1.0:
            data *= self.scale
        label = np.stack(labels)[:, :self.label_width]
        if self.label_width == 1:
            label = label[:, 0]
        self._data = NDArray(data_t, ctx=cpu())
        self._label = nd_array(label, ctx=cpu())
        return True

    def getdata(self):
        return [self._data]

    def getlabel(self):
        return [self._label]

    def getpad(self):
        return self._pad
