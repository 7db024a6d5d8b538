"""The eval metrics of the port (PyTorch counterpart of
rscotr_tpu/evaluation/, its numpy paths written out again here because the
port imports nothing of the JAX package): cls top-k accuracy, COCO-style
det mAP and mmseg seg metrics, on host numpy arrays."""

from rscotr_tpu_torch.evaluation.accuracy import (confusion_matrix,
                                                  top_k_accuracy)
from rscotr_tpu_torch.evaluation.coco_map import bbox_iou_xyxy, eval_map
from rscotr_tpu_torch.evaluation.seg_metrics import (evaluate_seg,
                                                     intersect_and_union,
                                                     total_metrics)

__all__ = ["top_k_accuracy", "confusion_matrix", "eval_map",
           "bbox_iou_xyxy", "intersect_and_union", "total_metrics",
           "evaluate_seg"]
