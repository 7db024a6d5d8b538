"""Multi-dataset evaluation engine (PyTorch counterpart of
rscotr_tpu/engine/test.py: ``single_device_test`` is the stride-1 body of
its ``_strided_test``).

Loops over a dict of per-dataset loaders, runs each batch through the
task's step of ``make_infer_steps`` and collects the raw results in the
reference's formats: cls a probability vector per image; det a list per
class of (n, 5) [x1, y1, x2, y2, score] arrays; seg an (H, W) int32 label
map. A short last batch is padded to the batch size (the steps then see
one shape per dataset) and the padding's results dropped.

Seg follows the reference's order: f32 logits at the padded input size,
cropped to the image's region (``img_hw``), bilinearly resized to its
original size (``ori_hw``, half-pixel centres, ``align_corners=False``)
and only then argmaxed. When nothing is cropped or resized (the uniform
512^2 tiles) the argmax runs on the device and only the label maps come
back.

Multi-process (JAX's ``multi_process_test``): each rank evaluates the
batches whose index is its rank modulo the world size (``_strided_test``),
and the ranks' results, tagged with their sample indices, are gathered
(``parallel.multihost.all_gather_pyobjects``) and merged in index order,
so every rank returns what one process returns. ``adaptive_process_test``
is the train-time entry: one process runs ``single_device_test``; several
run ``multi_process_test`` after ``prepare()`` (the FSDP run's full
weights gathered into a plain eval model, once, on every rank: the
strided batches must not run FSDP's all-gathers, which ranks with fewer
batches would leave waiting).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from rscotr_tpu_torch.utils.logging import get_root_logger


def _pad_batch(batch: Dict[str, np.ndarray], bs: int):
    """(the batch zero-padded along its first axis to ``bs``, the number of
    real samples)."""
    n = len(next(iter(batch.values())))
    if n == bs:
        return batch, n
    out = {}
    for k, v in batch.items():
        pad = [(0, bs - n)] + [(0, 0)] * (v.ndim - 1)
        out[k] = np.pad(v, pad)
    return out, n


def _resize_labels_nearest(p: np.ndarray, hw) -> np.ndarray:
    """Nearest-neighbour resize of an (H, W) integer label map (for a step
    that returns label maps only; live eval resizes logits)."""
    H, W = p.shape
    h, w = int(hw[0]), int(hw[1])
    if (h, w) == (H, W):
        return p
    ys = np.clip((np.arange(h) + 0.5) * H / h - 0.5, 0, H - 1)
    xs = np.clip((np.arange(w) + 0.5) * W / w - 0.5, 0, W - 1)
    return p[np.round(ys).astype(int)[:, None],
             np.round(xs).astype(int)[None, :]]


def _resize_bilinear_np(x: np.ndarray, hw) -> np.ndarray:
    """Bilinear resize of (H, W, C) float logits with half-pixel centres
    and edge clamping: the sampling grid of ``F.interpolate(...,
    mode="bilinear", align_corners=False)``, in numpy as the JAX package
    computes it."""
    H, W, _ = x.shape
    h, w = int(hw[0]), int(hw[1])
    if (h, w) == (H, W):
        return x
    ys = np.clip((np.arange(h) + 0.5) * H / h - 0.5, 0, H - 1)
    xs = np.clip((np.arange(w) + 0.5) * W / w - 0.5, 0, W - 1)
    y0 = np.floor(ys).astype(int)
    x0 = np.floor(xs).astype(int)
    y1 = np.minimum(y0 + 1, H - 1)
    x1 = np.minimum(x0 + 1, W - 1)
    wy = (ys - y0).astype(x.dtype)[:, None, None]
    wx = (xs - x0).astype(x.dtype)[None, :, None]
    top = x[y0][:, x0] * (1 - wx) + x[y0][:, x1] * wx
    bot = x[y1][:, x0] * (1 - wx) + x[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _seg_results(infer_steps, batch, valid: int) -> List[np.ndarray]:
    hw, ori = batch.get("img_hw"), batch.get("ori_hw")
    H, W = batch["img"].shape[1:3]
    hw_np = np.asarray(hw)[:valid] if hw is not None else None
    ori_np = np.asarray(ori)[:valid] if ori is not None else None
    no_reshape = (hw_np is not None and ori_np is not None
                  and bool(np.all(hw_np == np.asarray((H, W))))
                  and bool(np.all(ori_np == hw_np)))
    logits_step = infer_steps.get("seg_logits")
    if no_reshape or logits_step is None:
        # label maps from the device; the crop and resize are no-ops on
        # the fast path and nearest-neighbour for a label-map-only step
        preds = _np(infer_steps["seg"](batch["img"]))
        out = []
        for i in range(valid):
            p = preds[i]
            if hw is not None:
                p = p[:hw[i, 0], :hw[i, 1]]
            if ori is not None:
                p = _resize_labels_nearest(p, np.asarray(ori[i]))
            out.append(p.astype(np.int32))
        return out
    logits = _np(logits_step(batch["img"]))
    out = []
    for i in range(valid):
        lg = logits[i]
        if hw is not None:
            lg = lg[:hw[i, 0], :hw[i, 1]]
        if ori is not None:
            lg = _resize_bilinear_np(lg, np.asarray(ori[i]))
        out.append(lg.argmax(-1).astype(np.int32))
    return out


def single_device_test(infer_steps: Dict[str, Callable],
                       loaders: Dict[str, Any], max_batches: int = 0,
                       stats: Optional[Dict[str, dict]] = None
                       ) -> Dict[str, List]:
    """{dataset name: [per-image result]} over ``loaders`` (at most
    ``max_batches`` batches each when it is not 0), through the steps of
    ``make_infer_steps``.

    ``stats``, when given, gets per dataset ``load_s`` and ``infer_s``,
    each batch's host wall time in the loader and in the step (results
    copied back to the host included), and, when the card is in use, the
    peak device memory ``peak_bytes`` over the dataset's run."""
    indexed = _strided_test(infer_steps, loaders, max_batches=max_batches,
                            stats=stats)
    return {name: [r for _, r in items] for name, items in indexed.items()}


def multi_process_test(infer_steps: Dict[str, Callable],
                       loaders: Dict[str, Any], max_batches: int = 0,
                       stats: Optional[Dict[str, dict]] = None
                       ) -> Dict[str, List]:
    """Every rank evaluates its strided share of the batches, then the
    results are gathered: every rank returns the full, index-ordered
    result dict (``single_device_test``'s in one process)."""
    from rscotr_tpu_torch.parallel.multihost import (all_gather_pyobjects,
                                                     merge_strided_results,
                                                     process_count,
                                                     process_index)
    pc = process_count()
    if pc == 1:
        return single_device_test(infer_steps, loaders,
                                  max_batches=max_batches, stats=stats)
    local = _strided_test(infer_steps, loaders, max_batches=max_batches,
                          stride=pc, offset=process_index(), stats=stats)
    return merge_strided_results(all_gather_pyobjects(local))


def adaptive_process_test(infer_steps: Dict[str, Callable],
                          loaders: Dict[str, Any], max_batches: int = 0,
                          prepare: Optional[Callable[[], None]] = None
                          ) -> Dict[str, List]:
    """Train-time evaluation on any topology: ``prepare()`` when given (a
    collective every rank calls, e.g. the gather of an FSDP model's full
    weights into the eval model), then ``multi_process_test`` (which is
    ``single_device_test`` in one process)."""
    if prepare is not None:
        prepare()
    return multi_process_test(infer_steps, loaders, max_batches=max_batches)


def _batches(loader, stride: int, offset: int, stop: int):
    if hasattr(loader, "strided"):
        return loader.strided(stride, offset, stop)
    return ((bi, b) for bi, b in enumerate(loader)
            if bi < stop and bi % stride == offset)


def _strided_test(infer_steps: Dict[str, Callable], loaders: Dict[str, Any],
                  max_batches: int = 0, stride: int = 1, offset: int = 0,
                  stats: Optional[Dict[str, dict]] = None
                  ) -> Dict[str, List]:
    """The batches whose index is ``offset`` modulo ``stride``: {dataset
    name: [(sample index, result), ...]}; ``stats`` as in
    ``single_device_test``."""
    logger = get_root_logger()
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    results: Dict[str, List] = {}
    for name, loader in loaders.items():
        task = loader.dataset.task
        bs = loader.batch_size
        out: List = []
        load_s, infer_s = [], []
        if stats is not None and cuda:
            torch.cuda.reset_peak_memory_stats()
        n_batches = len(loader)
        if max_batches:
            n_batches = min(n_batches, max_batches)
        it = _batches(loader, stride, offset, n_batches)
        while True:
            t0 = time.perf_counter()
            bi, raw = next(it, (None, None))
            if bi is None:
                break
            batch, valid = _pad_batch(raw, bs)
            t1 = time.perf_counter()
            base = bi * bs
            if task == "cls":
                probs = _np(infer_steps["cls"](batch["img"]))
                res = [probs[i] for i in range(valid)]
            elif task == "det":
                det, labels = infer_steps["det"](
                    batch["img"], batch["img_hw"], batch["scale_factor"])
                det, labels = _np(det), _np(labels)
                K = len(loader.dataset.CLASSES)
                res = [[det[i][labels[i] == c].astype(np.float32)
                        for c in range(K)] for i in range(valid)]
            elif task == "seg":
                res = _seg_results(infer_steps, batch, valid)
            else:
                raise ValueError(f"unknown task {task!r} of {name}")
            out.extend((base + i, r) for i, r in enumerate(res))
            load_s.append(t1 - t0)
            infer_s.append(time.perf_counter() - t1)
        results[name] = out
        if stats is not None:
            stats[name] = dict(load_s=load_s, infer_s=infer_s)
            if cuda:
                stats[name]["peak_bytes"] = torch.cuda.max_memory_allocated()
        logger.info("evaluated %s: %d samples%s", name, len(out),
                    f" (process {offset}/{stride})" if stride > 1 else "")
    return results


def evaluate_results(datasets: Dict[str, Any], results: Dict[str, List],
                     eval_kwargs: Dict[str, dict],
                     allow_empty: bool = False) -> Dict[str, float]:
    """Each dataset's ``evaluate`` with its task's kwargs; metric keys
    prefixed with the dataset's name (``resisc.accuracy_top-1``). A
    dataset without results is an error (its metrics would silently drop
    out) unless ``allow_empty``, which logs and skips it."""
    metrics: Dict[str, float] = {}
    for name, ds in datasets.items():
        res = results.get(name, [])
        if not res:
            if not allow_empty:
                raise ValueError(
                    f"no inference results for dataset {name!r} (have "
                    f"results for {sorted(results)}); pass allow_empty=True "
                    "to skip it")
            get_root_logger().warning(
                "no results for dataset %s: skipping its evaluation", name)
            continue
        m = ds.evaluate(res, **dict(eval_kwargs.get(ds.task, {})))
        for k, v in m.items():
            if isinstance(v, (int, float, np.floating)):
                metrics[f"{name}.{k}"] = float(v)
    return metrics
