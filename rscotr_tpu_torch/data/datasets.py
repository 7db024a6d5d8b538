"""Datasets of the port (counterpart of rscotr_tpu/data/datasets.py):
RESISC45 (folder), DIOR (COCO json), Potsdam (img / ann dirs), and the
synthetic sets that every path runs on without the real data.

Each dataset yields numpy sample dicts for ``data.pipelines``, carries
``task`` and ``CLASSES``, and implements ``evaluate(results, **kwargs)``
with the reference's metric names. The synthetic sets draw every sample
from the same PCG64 seeds as the JAX package's, so both see the same
pixels and labels.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence

import numpy as np

from rscotr_tpu_torch.evaluation import (eval_map, evaluate_seg,
                                         intersect_and_union,
                                         top_k_accuracy)
from rscotr_tpu_torch.utils.registry import DATASETS

RESISC_CLASSES = tuple(sorted([
    "airplane", "airport", "baseball_diamond", "basketball_court", "beach",
    "bridge", "chaparral", "church", "circular_farmland", "cloud",
    "commercial_area", "dense_residential", "desert", "forest", "freeway",
    "golf_course", "ground_track_field", "harbor", "industrial_area",
    "intersection", "island", "lake", "meadow", "medium_residential",
    "mobile_home_park", "mountain", "overpass", "palace", "parking_lot",
    "railway", "railway_station", "rectangular_farmland", "river",
    "roundabout", "runway", "sea_ice", "ship", "snowberg",
    "sparse_residential", "stadium", "storage_tank", "tennis_court",
    "terrace", "thermal_power_station", "wetland"]))

DIOR_CLASSES = ("airplane", "airport", "baseballfield", "basketballcourt",
                "bridge", "chimney", "dam", "Expressway-Service-area",
                "Expressway-toll-station", "golffield", "groundtrackfield",
                "harbor", "overpass", "ship", "stadium", "storagetank",
                "tenniscourt", "trainstation", "vehicle", "windmill")

POTSDAM_CLASSES = ("impervious_surface", "building", "low_vegetation",
                   "tree", "car")


class BaseDataset:
    task: str = ""
    CLASSES: Sequence[str] = ()

    def __len__(self):
        raise NotImplementedError

    def __getitem__(self, idx) -> dict:
        raise NotImplementedError

    def evaluate(self, results, **kwargs) -> Dict[str, float]:
        raise NotImplementedError

    def format_results(self, results, out_dir: str, **kwargs):
        """mm-style ``format_results`` fallback (tools/test.py
        --format-only): datasets with a real submission format (COCO det
        json, seg label maps) override this; everything else dumps the raw
        results pickle."""
        import pickle
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"{self.task or 'raw'}_results.pkl")
        with open(path, "wb") as f:
            pickle.dump(results, f)
        return [path]


# ---------------------------------------------------------------------------
# Classification
# ---------------------------------------------------------------------------

@DATASETS.register_module(name="CustomDataset")
class ResiscDataset(BaseDataset):
    """mmcls CustomDataset folder layout: data_prefix/<class>/<img>."""
    task = "cls"

    def __init__(self, data_prefix: str, pipeline=None, classes=None,
                 **kwargs):
        self.data_prefix = data_prefix
        if classes:
            self.CLASSES = tuple(classes)
        elif os.path.isdir(data_prefix):
            self.CLASSES = tuple(sorted(
                d for d in os.listdir(data_prefix)
                if os.path.isdir(os.path.join(data_prefix, d))))
        else:
            self.CLASSES = RESISC_CLASSES
        self.samples: List = []
        if os.path.isdir(data_prefix):
            for ci, cname in enumerate(self.CLASSES):
                cdir = os.path.join(data_prefix, cname)
                for f in sorted(os.listdir(cdir)):
                    if f.lower().endswith((".jpg", ".jpeg", ".png", ".tif")):
                        self.samples.append((os.path.join(cdir, f), ci))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        path, label = self.samples[idx]
        return {"img_path": path, "gt_label": np.int32(label)}

    def evaluate(self, results, metric="accuracy", topk=(1, 5), **kwargs):
        """results: (N, C) score array or list of per-image vectors."""
        scores = np.asarray(results)
        labels = np.asarray([s[1] for s in self.samples])[:len(scores)]
        return top_k_accuracy(scores, labels, topk=topk)


@DATASETS.register_module(name="SyntheticClsDataset")
class SyntheticClsDataset(BaseDataset):
    task = "cls"

    def __init__(self, length=64, img_size=224, num_classes=45, seed=0,
                 pipeline=None, **kwargs):
        self.length = length
        self.img_size = img_size
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.Generator(np.random.PCG64(self.seed * 100003 + idx))
        img = rng.uniform(0, 255, (self.img_size, self.img_size, 3)
                          ).astype(np.float32)
        label = np.int32(idx % len(self.CLASSES))
        return {"img": img, "ori_shape": img.shape, "img_shape": img.shape,
                "gt_label": label}

    def evaluate(self, results, **kwargs):
        scores = np.asarray(results)
        labels = np.asarray([i % len(self.CLASSES)
                             for i in range(len(scores))])
        return top_k_accuracy(scores, labels,
                              topk=(1, min(5, len(self.CLASSES))))


# ---------------------------------------------------------------------------
# Detection
# ---------------------------------------------------------------------------

@DATASETS.register_module(name="CocoDataset")
class CocoDetDataset(BaseDataset):
    """COCO-json detection dataset (DIOR). Pure-Python json parsing —
    replaces the pycocotools C extension for loading; mAP in numpy."""
    task = "det"

    def __init__(self, ann_file: str, img_prefix: str, pipeline=None,
                 classes=None, filter_empty_gt=True, **kwargs):
        self.img_prefix = img_prefix
        self.CLASSES = tuple(classes) if classes else DIOR_CLASSES
        self.data_infos: List[dict] = []
        if os.path.isfile(ann_file):
            with open(ann_file) as f:
                coco = json.load(f)
            cats = {c["id"]: c["name"] for c in coco["categories"]}
            name2label = {n: i for i, n in enumerate(self.CLASSES)}
            # label -> original COCO category id, for submission-format
            # result dumps (format_results)
            self.label2cat = {name2label[n]: cid
                              for cid, n in cats.items() if n in name2label}
            imgs = {im["id"]: im for im in coco["images"]}
            anns_per_img: Dict[int, list] = {}
            for a in coco["annotations"]:
                anns_per_img.setdefault(a["image_id"], []).append(a)
            for img_id, im in imgs.items():
                anns = anns_per_img.get(img_id, [])
                bboxes, labels = [], []
                for a in anns:
                    if a.get("iscrowd", 0) or a.get("ignore", 0):
                        continue
                    x, y, w, h = a["bbox"]
                    bboxes.append([x, y, x + w, y + h])
                    labels.append(name2label[cats[a["category_id"]]])
                if filter_empty_gt and not bboxes:
                    continue
                self.data_infos.append({
                    "id": img_id,
                    "filename": im["file_name"],
                    "width": im["width"], "height": im["height"],
                    "bboxes": np.asarray(bboxes, np.float32).reshape(-1, 4),
                    "labels": np.asarray(labels, np.int32),
                })

    def __len__(self):
        return len(self.data_infos)

    def __getitem__(self, idx):
        info = self.data_infos[idx]
        return {"img_path": os.path.join(self.img_prefix, info["filename"]),
                "gt_bboxes": info["bboxes"].copy(),
                "gt_labels": info["labels"].copy()}

    def get_annotations(self):
        return [{"bboxes": i["bboxes"], "labels": i["labels"]}
                for i in self.data_infos]

    def evaluate(self, results, metric="bbox", iou_thrs=(0.5,),
                 classwise=False, **kwargs):
        """results: per image, per class list of (n, 5) arrays."""
        return eval_map(results,
                        self.get_annotations()[:len(results)],
                        num_classes=len(self.CLASSES),
                        iou_thrs=list(iou_thrs), max_dets=300,
                        class_names=self.CLASSES if classwise else None)

    def format_results(self, results, out_dir: str, **kwargs):
        """COCO detection submission json (mmdet
        ``CocoDataset.format_results``, ``tools/test.py --format-only``):
        one record per box, xyxy -> xywh, labels mapped back to the
        annotation file's category ids."""
        os.makedirs(out_dir, exist_ok=True)
        dets = []
        for info, per_cls in zip(self.data_infos, results):
            for label, arr in enumerate(per_cls):
                for x1, y1, x2, y2, s in np.asarray(
                        arr, np.float64).reshape(-1, 5):
                    dets.append({
                        "image_id": info["id"],
                        "category_id": int(self.label2cat.get(
                            label, label + 1)),
                        "bbox": [float(x1), float(y1),
                                 float(x2 - x1), float(y2 - y1)],
                        "score": float(s)})
        path = os.path.join(out_dir, "det_results.bbox.json")
        with open(path, "w") as f:
            json.dump(dets, f)
        return [path]


@DATASETS.register_module(name="SyntheticDetDataset")
class SyntheticDetDataset(BaseDataset):
    task = "det"

    def __init__(self, length=32, img_size=800, num_classes=20,
                 max_boxes=10, seed=0, pipeline=None, **kwargs):
        self.length = length
        self.img_size = img_size
        self.max_boxes = max_boxes
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))
        self.seed = seed
        self._anns = [self._make_ann(i) for i in range(length)]

    def _make_ann(self, idx):
        rng = np.random.Generator(np.random.PCG64(self.seed * 7919 + idx))
        n = int(rng.integers(1, self.max_boxes + 1))
        cxy = rng.uniform(0.15, 0.85, (n, 2)) * self.img_size
        wh = rng.uniform(0.05, 0.25, (n, 2)) * self.img_size
        boxes = np.concatenate([cxy - wh / 2, cxy + wh / 2], 1)
        boxes = np.clip(boxes, 0, self.img_size - 1).astype(np.float32)
        labels = rng.integers(0, len(self.CLASSES), n).astype(np.int32)
        return {"bboxes": boxes, "labels": labels}

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.Generator(np.random.PCG64(self.seed * 31 + idx))
        img = rng.uniform(0, 255, (self.img_size, self.img_size, 3)
                          ).astype(np.float32)
        a = self._anns[idx]
        return {"img": img, "ori_shape": img.shape, "img_shape": img.shape,
                "gt_bboxes": a["bboxes"].copy(),
                "gt_labels": a["labels"].copy()}

    def get_annotations(self):
        return self._anns

    def evaluate(self, results, metric="bbox", iou_thrs=(0.5,),
                 classwise=False, **kwargs):
        return eval_map(results,
                        self.get_annotations()[:len(results)],
                        num_classes=len(self.CLASSES),
                        iou_thrs=list(iou_thrs), max_dets=300,
                        class_names=self.CLASSES if classwise else None)


# ---------------------------------------------------------------------------
# Segmentation
# ---------------------------------------------------------------------------

@DATASETS.register_module(name="PotsdamDataset")
class PotsdamDataset(BaseDataset):
    """Potsdam tiles: img_dir + ann_dir; reduce_zero_label shifts raw labels
    1..6 -> 0..5 with 0 -> 255; class 5 (clutter) is ignore_index for eval
    but a live CE target during training (SURVEY.md §2.4 quirk)."""
    task = "seg"
    PALETTE = ((255, 255, 255), (0, 0, 255), (0, 255, 255), (0, 255, 0),
               (255, 255, 0))

    def __init__(self, data_root="", img_dir="", ann_dir="", pipeline=None,
                 ignore_index=5, reduce_zero_label=True,
                 img_suffix=".png", seg_map_suffix=".png", **kwargs):
        self.img_dir = os.path.join(data_root, img_dir)
        self.ann_dir = os.path.join(data_root, ann_dir)
        self.ignore_index = ignore_index
        self.reduce_zero_label = reduce_zero_label
        self.CLASSES = POTSDAM_CLASSES
        self.img_infos: List[dict] = []
        if os.path.isdir(self.img_dir):
            for f in sorted(os.listdir(self.img_dir)):
                if f.endswith(img_suffix):
                    seg = f[:-len(img_suffix)] + seg_map_suffix
                    self.img_infos.append({"img": f, "seg": seg})

    def __len__(self):
        return len(self.img_infos)

    def __getitem__(self, idx):
        from PIL import Image
        info = self.img_infos[idx]
        img = np.asarray(Image.open(
            os.path.join(self.img_dir, info["img"])).convert("RGB"),
            np.float32)
        seg = np.asarray(Image.open(
            os.path.join(self.ann_dir, info["seg"])), np.int32)
        if seg.ndim == 3:
            seg = seg[..., 0]
        if self.reduce_zero_label:
            seg = np.where(seg == 0, 255, seg - 1).astype(np.int32)
        return {"img": img, "ori_shape": img.shape, "img_shape": img.shape,
                "gt_semantic_seg": seg}

    def get_gt_seg_map(self, idx):
        return self[idx]["gt_semantic_seg"]

    def pre_eval(self, pred: np.ndarray, idx: int):
        return intersect_and_union(pred, self.get_gt_seg_map(idx),
                                   len(self.CLASSES), self.ignore_index)

    def evaluate(self, results, metric=("mIoU",), pre_eval=True,
                 classwise=False, **kwargs):
        """results: list of pre_eval tuples OR per-image pred maps."""
        if results and not isinstance(results[0], tuple):
            results = [self.pre_eval(np.asarray(r), i)
                       for i, r in enumerate(results)]
        metric = [metric] if isinstance(metric, str) else list(metric)
        return evaluate_seg(results, metrics=metric,
                            class_names=self.CLASSES if classwise else None)

    def format_results(self, results, out_dir: str, **kwargs):
        """Per-tile predicted label maps as PNGs named like the source
        tiles (mmseg format_results capability). With
        ``reduce_zero_label`` labels shift back +1 so the files round-trip
        through this loader — and, carrying the tile position encoding in
        their names, they feed ``tools/seg_puzzles`` scene stitching
        directly."""
        from PIL import Image
        os.makedirs(out_dir, exist_ok=True)
        paths = []
        for info, pred in zip(self.img_infos, results):
            if isinstance(pred, tuple):     # pre_eval tuples carry no map
                raise ValueError("format_results needs label maps; rerun "
                                 "inference without pre_eval collapsing")
            lab = np.asarray(pred).astype(np.uint8)
            if self.reduce_zero_label:
                lab = lab + 1
            path = os.path.join(out_dir, info["seg"])
            Image.fromarray(lab).save(path)
            paths.append(path)
        return paths


@DATASETS.register_module(name="SyntheticSegDataset")
class SyntheticSegDataset(BaseDataset):
    task = "seg"

    def __init__(self, length=32, img_size=512, num_classes=5,
                 ignore_index=5, seed=0, pipeline=None, **kwargs):
        self.length = length
        self.img_size = img_size
        self.ignore_index = ignore_index
        self.CLASSES = tuple(f"class_{i}" for i in range(num_classes))
        self.seed = seed

    def __len__(self):
        return self.length

    def __getitem__(self, idx):
        rng = np.random.Generator(np.random.PCG64(self.seed * 104729 + idx))
        s = self.img_size
        img = rng.uniform(0, 255, (s, s, 3)).astype(np.float32)
        # blocky label map
        blocks = rng.integers(0, len(self.CLASSES), (8, 8))
        seg = np.kron(blocks, np.ones((s // 8, s // 8),
                                      np.int32)).astype(np.int32)
        return {"img": img, "ori_shape": img.shape, "img_shape": img.shape,
                "gt_semantic_seg": seg}

    def get_gt_seg_map(self, idx):
        return self[idx]["gt_semantic_seg"]

    def pre_eval(self, pred, idx):
        return intersect_and_union(pred, self.get_gt_seg_map(idx),
                                   len(self.CLASSES), self.ignore_index)

    def evaluate(self, results, metric=("mIoU",), classwise=False, **kwargs):
        if results and not isinstance(results[0], tuple):
            results = [self.pre_eval(np.asarray(r), i)
                       for i, r in enumerate(results)]
        metric = [metric] if isinstance(metric, str) else list(metric)
        return evaluate_seg(results, metrics=metric,
                            class_names=self.CLASSES if classwise else None)
