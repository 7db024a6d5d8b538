"""Data loaders of the port (counterpart of the collates and
``TaskDataLoader`` of rscotr_tpu/data/loader.py): per-task batching into
static shapes, one batch of numpy arrays at a time.

* cls: img (B, S, S, 3), gt_label (B,)
* det: img (B, Hb, Wb, 3) zero-padded into the smallest fitting bucket,
  img_hw (B, 2), scale_factor (B, 4), gt_bboxes (B, max_gt, 4) xyxy,
  gt_labels (B, max_gt), gt_valid (B, max_gt)
* seg: img (B, S, S, 3), gt_semantic_seg (B, S, S) padded with
  ``seg_pad_val``, img_hw (B, 2), ori_hw (B, 2)

Samples are prepared on threads, each from its own seeded generator.
``PrefetchIterator``, ``MultiDataLoader`` and the device-augment collates
wait for ROADMAP M5 / M6.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List

import numpy as np

from rscotr_tpu_torch.data.pipelines import run_pipeline


def collate_cls(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {
        "img": np.stack([s["img"] for s in samples]).astype(np.float32),
        "gt_label": np.asarray([s["gt_label"] for s in samples], np.int32),
    }


def select_det_bucket(bucket_hw, h: int, w: int):
    """The smallest-area bucket that fits (h, w); ``bucket_hw`` is one
    (H, W) pair or a list of them (``loader.det_bucket_hw``)."""
    if not isinstance(bucket_hw[0], (tuple, list)):
        buckets = [tuple(bucket_hw)]
    else:
        buckets = [tuple(b) for b in bucket_hw]
    fits = [b for b in buckets if b[0] >= h and b[1] >= w]
    if not fits:
        raise ValueError(f"image {h}x{w} exceeds every det bucket "
                         f"{buckets}; add a larger entry to "
                         "loader.det_bucket_hw")
    return min(fits, key=lambda b: b[0] * b[1])


def collate_det(samples: List[dict], bucket_hw, max_gt: int
                ) -> Dict[str, np.ndarray]:
    B = len(samples)
    hmax = max(s["img"].shape[0] for s in samples)
    wmax = max(s["img"].shape[1] for s in samples)
    H, W = select_det_bucket(bucket_hw, hmax, wmax)
    img = np.zeros((B, H, W, 3), np.float32)
    img_hw = np.zeros((B, 2), np.int32)
    scale_factor = np.ones((B, 4), np.float32)
    gt_bboxes = np.zeros((B, max_gt, 4), np.float32)
    gt_labels = np.zeros((B, max_gt), np.int32)
    gt_valid = np.zeros((B, max_gt), bool)
    for i, s in enumerate(samples):
        im = s["img"]
        h, w = im.shape[:2]
        img[i, :h, :w] = im
        img_hw[i] = (h, w)
        scale_factor[i] = s.get("scale_factor", np.ones(4, np.float32))
        boxes = s.get("gt_bboxes", np.zeros((0, 4), np.float32))
        labels = s.get("gt_labels", np.zeros((0,), np.int32))
        n = min(len(boxes), max_gt)
        gt_bboxes[i, :n] = boxes[:n]
        gt_labels[i, :n] = labels[:n]
        gt_valid[i, :n] = True
    return {"img": img, "img_hw": img_hw, "scale_factor": scale_factor,
            "gt_bboxes": gt_bboxes, "gt_labels": gt_labels,
            "gt_valid": gt_valid}


def collate_seg(samples: List[dict], size: int = 512,
                seg_pad_val: int = 255) -> Dict[str, np.ndarray]:
    """Images and labels cropped or padded to ``size``; ``img_hw`` is each
    image's region in the batch, ``ori_hw`` its size as the dataset gave
    it (the size its prediction is resized back to)."""
    B = len(samples)
    img = np.zeros((B, size, size, 3), np.float32)
    seg = np.full((B, size, size), seg_pad_val, np.int32)
    img_hw = np.zeros((B, 2), np.int32)
    ori_hw = np.zeros((B, 2), np.int32)
    for i, s in enumerate(samples):
        im = s["img"]
        h, w = im.shape[:2]
        img[i, :h, :w] = im[:size, :size]
        img_hw[i] = (min(h, size), min(w, size))
        osh = s.get("ori_shape", im.shape)
        ori_hw[i] = (osh[0], osh[1])
        if "gt_semantic_seg" in s:
            seg[i, :min(h, size), :min(w, size)] = \
                s["gt_semantic_seg"][:size, :size]
    return {"img": img, "gt_semantic_seg": seg, "img_hw": img_hw,
            "ori_hw": ori_hw}


class TaskDataLoader:
    """Epoch iterator over one dataset, samples prepared on threads.

    ``num_replicas`` / ``rank`` split the (shuffled) index list as torch's
    ``DistributedSampler`` does: padded by wrap-around to a multiple of
    ``num_replicas``, each rank taking its strided share. The shuffle is
    seeded by (seed, epoch) only, and each sample's pipeline draws from a
    generator seeded by (seed, epoch, index), as in the JAX package."""

    def __init__(self, dataset, batch_size: int, pipeline=None,
                 collate_fn: Callable = None, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True,
                 num_threads: int = 4, num_replicas: int = 1, rank: int = 0):
        if not 0 <= rank < max(num_replicas, 1):
            raise ValueError(f"rank {rank} of {num_replicas} replicas")
        self.dataset = dataset
        self.batch_size = batch_size
        self.pipeline = pipeline or []
        self.collate_fn = collate_fn
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.num_threads = max(1, num_threads)
        self.num_replicas = max(1, num_replicas)
        self.rank = rank
        self._epoch = 0
        self._pool = None

    def _executor(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(self.num_threads)
        return self._pool

    def _rank_size(self) -> int:
        n = len(self.dataset)
        return (n + self.num_replicas - 1) // self.num_replicas

    def __len__(self):
        n = self._rank_size()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def _index_order(self) -> np.ndarray:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.Generator(
                np.random.PCG64(self.seed * 1000003 + self._epoch))
            rng.shuffle(idx)
        if self.num_replicas > 1:
            total = self._rank_size() * self.num_replicas
            if total > idx.size:
                idx = np.concatenate([idx, idx[:total - idx.size]])
            idx = idx[self.rank::self.num_replicas]
        return idx

    def _prepare(self, idx: int, sample_seed: int) -> dict:
        s = self.dataset[idx]
        if self.pipeline:
            s = run_pipeline(self.pipeline, s, np.random.Generator(
                np.random.PCG64(sample_seed)))
        return s

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch, order = self._epoch, self._index_order()
        for b in range(len(self)):
            chunk = order[b * self.batch_size:(b + 1) * self.batch_size]
            seeds = [self.seed * 7 + epoch * 1000003 + int(i)
                     for i in chunk]
            if self.num_threads > 1 and len(chunk) > 1:
                samples = list(self._executor().map(
                    self._prepare, chunk, seeds))
            else:
                samples = [self._prepare(int(i), s)
                           for i, s in zip(chunk, seeds)]
            yield self.collate_fn(samples)
