"""Data loaders of the port (counterpart of rscotr_tpu/data/loader.py):
per-task batching into static shapes, one batch of numpy arrays at a time,
a background prefetch thread, and the multi-task loader of co-training.

* cls: img (B, S, S, 3), gt_label (B,)
* det: img (B, Hb, Wb, 3) zero-padded into the smallest fitting bucket,
  img_hw (B, 2), scale_factor (B, 4), gt_bboxes (B, max_gt, 4) xyxy,
  gt_labels (B, max_gt), gt_valid (B, max_gt), and with a DN ladder the
  zero-width ``dn_wide`` (0, width)
* seg: img (B, S, S, 3), gt_semantic_seg (B, S, S) padded with
  ``seg_pad_val``, img_hw (B, 2), ori_hw (B, 2)

In device-augment mode (``collate_{cls,seg,det}_aug``) img is the raw uint8
source at its static size, and the planners' ``aug_*`` records ride along,
one entry per record; det adds the zero-width ``out_template`` (B, H, W, 0)
whose shape is the output bucket.

Samples are prepared on threads, each from its own seeded generator.
``MultiDataLoader`` interleaves the per-dataset loaders under an iteration
strategy; ``PrefetchIterator`` runs an iterator (and a transfer to the card)
on a worker thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from rscotr_tpu_torch.data.pipelines import run_pipeline


def collate_cls(samples: List[dict]) -> Dict[str, np.ndarray]:
    return {
        "img": np.stack([s["img"] for s in samples]).astype(np.float32),
        "gt_label": np.asarray([s["gt_label"] for s in samples], np.int32),
    }


_CLS_AUG_KEYS = ("aug_crop_y", "aug_crop_x", "aug_crop_h", "aug_crop_w",
                 "aug_flip", "aug_op_id", "aug_op_m", "aug_erase_on",
                 "aug_erase_y", "aug_erase_x", "aug_erase_h", "aug_erase_w")
_SEG_AUG_KEYS = ("aug_resize_h", "aug_resize_w", "aug_crop_y",
                 "aug_crop_x", "aug_crop_h", "aug_crop_w", "aug_flip",
                 "aug_pm_bright", "aug_pm_c_pre", "aug_pm_hsv_on",
                 "aug_pm_sat", "aug_pm_hue", "aug_pm_c_post")
_DET_AUG_KEYS = ("aug_src_h", "aug_src_w", "aug_flip_src",
                 "aug_flip_out", "aug_s1_h", "aug_s1_w", "aug_crop_y",
                 "aug_crop_x", "aug_crop_h", "aug_crop_w", "aug_s2_h",
                 "aug_s2_w")


def _stack_aug(batch: dict, samples: List[dict], keys) -> dict:
    for k in keys:
        batch[k] = np.stack([np.asarray(s[k]) for s in samples])
    return batch


def collate_cls_aug(samples: List[dict]) -> Dict[str, np.ndarray]:
    """Device-augment mode: the raw uint8 images and the ``aug_*`` records
    of ``DeviceAugmentPlanner``."""
    return _stack_aug({
        "img": np.stack([s["img"] for s in samples]).astype(np.uint8),
        "gt_label": np.asarray([s["gt_label"] for s in samples], np.int32),
    }, samples, _CLS_AUG_KEYS)


def collate_seg_aug(samples: List[dict]) -> Dict[str, np.ndarray]:
    """Device-augment mode: the raw uint8 source tiles, the labels as the
    planner made them, the ``aug_*`` records of ``SegDeviceAugmentPlanner``;
    ``img_hw`` is the crop's valid region (the step's pad mask)."""
    return _stack_aug({
        "img": np.stack([s["img"] for s in samples]).astype(np.uint8),
        "gt_semantic_seg": np.stack(
            [s["gt_semantic_seg"] for s in samples]).astype(np.int32),
        "img_hw": np.stack(
            [np.asarray([s["aug_crop_h"], s["aug_crop_w"]], np.int32)
             for s in samples]),
        "ori_hw": np.stack(
            [np.asarray(s.get("ori_shape", s["img"].shape)[:2], np.int32)
             for s in samples]),
    }, samples, _SEG_AUG_KEYS)


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


def dn_wide_marker(n_gt_max: int, dn_ladder) -> np.ndarray:
    """A zero-width array whose SHAPE carries the DN group width of a batch:
    the smallest ladder entry >= the batch's largest valid-GT count (the
    largest entry when none is). It costs nothing to move; the det step
    reads its width (``engine.train_step.det_loss_fn``)."""
    ladder = sorted(dn_ladder)
    s = next((v for v in ladder if v >= n_gt_max), ladder[-1])
    return np.zeros((0, s), np.float32)


def _det_targets(samples: List[dict], hws, max_gt: int, dn_ladder):
    """img_hw, scale_factor and the GT padded to ``max_gt``, with the
    ``dn_wide`` marker when a DN ladder is given."""
    B = len(samples)
    out = {"img_hw": np.asarray(hws, np.int32).reshape(B, 2),
           "scale_factor": np.ones((B, 4), np.float32),
           "gt_bboxes": np.zeros((B, max_gt, 4), np.float32),
           "gt_labels": np.zeros((B, max_gt), np.int32),
           "gt_valid": np.zeros((B, max_gt), bool)}
    for i, s in enumerate(samples):
        out["scale_factor"][i] = s.get("scale_factor",
                                       np.ones(4, np.float32))
        boxes = s.get("gt_bboxes", np.zeros((0, 4), np.float32))
        labels = s.get("gt_labels", np.zeros((0,), np.int32))
        n = min(len(boxes), max_gt)
        out["gt_bboxes"][i, :n] = boxes[:n]
        out["gt_labels"][i, :n] = labels[:n]
        out["gt_valid"][i, :n] = True
    if dn_ladder:
        out["dn_wide"] = dn_wide_marker(
            int(out["gt_valid"].sum(axis=1).max(initial=0)), dn_ladder)
    return out


def collate_det(samples: List[dict], bucket_hw, max_gt: int,
                dn_ladder=None) -> Dict[str, np.ndarray]:
    hws = [s["img"].shape[:2] for s in samples]
    H, W = select_det_bucket(bucket_hw, max(h for h, _ in hws),
                             max(w for _, w in hws))
    img = np.zeros((len(samples), H, W, 3), np.float32)
    for i, s in enumerate(samples):
        h, w = hws[i]
        img[i, :h, :w] = s["img"]
    return dict(img=img, **_det_targets(samples, hws, max_gt, dn_ladder))


def collate_det_aug(samples: List[dict], bucket_hw, max_gt: int,
                    dn_ladder=None) -> Dict[str, np.ndarray]:
    """Device-augment mode: the raw uint8 sources (in the static source
    bucket, as ``DetDeviceAugmentPlanner`` padded them) and the ``aug_*``
    programs. The output bucket, which the stage-2 sizes select, rides as
    the zero-width ``out_template`` (B, H, W, 0): a shape the det step
    reads, nothing to copy."""
    hws = [(int(s["aug_s2_h"]), int(s["aug_s2_w"])) for s in samples]
    H, W = select_det_bucket(bucket_hw, max(h for h, _ in hws),
                             max(w for _, w in hws))
    batch = dict(
        img=np.stack([s["img"] for s in samples]).astype(np.uint8),
        out_template=np.zeros((len(samples), H, W, 0), np.float32),
        **_det_targets(samples, hws, max_gt, dn_ladder))
    return _stack_aug(batch, samples, _DET_AUG_KEYS)


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


class PrefetchIterator:
    """Runs an iterator on a background thread, ``depth`` items ahead.

    ``transfer_fn`` (optional) runs on each item in the worker thread: the
    runner passes the copy of a batch to the card there, so the copy
    overlaps the previous step. A worker failure (in the iterator or the
    transfer) is re-raised by ``__next__`` as ``RuntimeError``, never turned
    into ``StopIteration``, which the runner takes for an epoch end."""

    def __init__(self, it: Iterator, depth: int = 2,
                 transfer_fn: Optional[Callable] = None):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._transfer = transfer_fn
        self._done = object()
        self._error: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        try:
            for x in self._it:
                if self._stop.is_set():
                    return
                if self._transfer is not None:
                    x = self._transfer(x)
                self._q.put(x)
        except BaseException as e:   # noqa: B036 -- re-raised in __next__
            self._error = e
        finally:
            self._q.put(self._done)

    def close(self) -> None:
        """Stop the worker after the item it is preparing and drop what it
        prepared; returns once the thread has ended."""
        self._stop.set()
        while self._thread.is_alive():
            try:
                self._q.get(timeout=0.05)
            except queue.Empty:
                pass
        self._thread.join()

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            # leave the marker for a later call, which ends the same way
            self._q.put(x)
            if self._error is not None:
                raise RuntimeError(
                    "prefetch worker failed") from self._error
            raise StopIteration
        return x


class MultiDataLoader:
    """Interleaves per-dataset loaders under an iteration strategy.

    Each ``__next__`` asks the strategy for a dataset index, pulls one
    batch of that loader and tags it with ``dataset_name`` and ``task``.
    Under a strategy with ``should_exhaust_all_iterators`` the epoch ends
    when every child is exhausted (a draw of a finished child is drawn
    again); under the others an exhausted child is re-ignited with its
    epoch bumped, so it reshuffles and re-seeds its samples."""

    def __init__(self, loaders: Dict[str, TaskDataLoader], strategy):
        if not loaders:
            raise ValueError("MultiDataLoader needs at least one loader")
        for n, dl in loaders.items():
            # a 0-batch child (a dataset smaller than the batch, with
            # drop_last) would starve its task: every draw re-ignites it
            # and finds it exhausted again
            if len(dl) == 0:
                raise ValueError(
                    f"loader '{n}' yields no batches (dataset of "
                    f"{len(dl.dataset)} < batch size {dl.batch_size}?)")
        self.loaders = loaders
        self.names = list(loaders.keys())
        self.strategy = strategy
        self._iters: Dict[str, Iterator] = {}
        self._finished: Dict[str, bool] = {}

    @property
    def dataset_names(self):
        return self.names

    def __iter__(self):
        self._iters = {n: iter(dl) for n, dl in self.loaders.items()}
        self._finished = {n: False for n in self.names}
        return self

    def __next__(self) -> Dict[str, object]:
        exhaust_all = getattr(self.strategy,
                              "should_exhaust_all_iterators", False)
        attempts = 0
        while True:
            name = self.names[self.strategy()]
            if exhaust_all and self._finished[name]:
                if all(self._finished.values()):
                    raise StopIteration
                # draw again while the child is finished (the reference
                # redraws without bound); after 1000 misses (a strategy
                # that can never draw an unfinished child, e.g. constant)
                # take the first unfinished child
                attempts += 1
                if attempts < 1000:
                    continue
                name = next(n for n in self.names if not self._finished[n])
            try:
                batch = next(self._iters[name])
            except StopIteration:
                if exhaust_all:
                    self._finished[name] = True
                    if all(self._finished.values()):
                        raise
                    continue
                dl = self.loaders[name]
                dl.set_epoch(dl._epoch + 1)
                self._iters[name] = iter(dl)
                batch = next(self._iters[name])
            batch = dict(batch)
            batch["dataset_name"] = name
            batch["task"] = self.loaders[name].dataset.task
            return batch

    def seed_sampler(self, epoch: int):
        """Set every child's epoch (the runner calls it with its step when
        an exhaust-all epoch ends)."""
        for dl in self.loaders.values():
            dl.set_epoch(epoch)
