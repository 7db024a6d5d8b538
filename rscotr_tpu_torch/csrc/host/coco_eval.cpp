// Fast COCO-style AP evaluation core (host code; a copy of the JAX
// package's csrc/coco_eval.cpp, which the port does not import).
//
// Native equivalent of the pycocotools C extension the reference depends on
// for DIOR mAP: per-class greedy matching in descending score order against
// per-image GT sets, 101-point interpolated AP. Exposed via a C ABI for
// ctypes (rscotr_tpu_torch/evaluation/native.py); the numpy implementation
// in rscotr_tpu_torch/evaluation/coco_map.py is the correctness oracle and
// fallback. Built at first use by rscotr_tpu_torch/ops/host_lib.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

inline double iou(const float* a, const float* b) {
  const double lx = std::max(a[0], b[0]);
  const double ly = std::max(a[1], b[1]);
  const double rx = std::min(a[2], b[2]);
  const double ry = std::min(a[3], b[3]);
  const double iw = std::max(0.0, rx - lx);
  const double ih = std::max(0.0, ry - ly);
  const double inter = iw * ih;
  const double area_a =
      std::max(0.0, double(a[2]) - a[0]) * std::max(0.0, double(a[3]) - a[1]);
  const double area_b =
      std::max(0.0, double(b[2]) - b[0]) * std::max(0.0, double(b[3]) - b[1]);
  const double uni = area_a + area_b - inter;
  return uni <= 1e-12 ? 0.0 : inter / uni;
}

double ap_101(const std::vector<double>& recall,
              const std::vector<double>& precision) {
  if (recall.empty()) return 0.0;
  std::vector<double> prec(precision);
  for (int i = int(prec.size()) - 2; i >= 0; --i)
    prec[i] = std::max(prec[i], prec[i + 1]);
  double ap = 0.0;
  for (int t = 0; t <= 100; ++t) {
    const double thr = t / 100.0;
    // first index with recall >= thr
    auto it = std::lower_bound(recall.begin(), recall.end(), thr);
    if (it != recall.end()) ap += prec[size_t(it - recall.begin())];
  }
  return ap / 101.0;
}

}  // namespace

extern "C" {

// Evaluate one (class, iou_thr) pair.
//   det_boxes:  (n_det, 4) xyxy, ALREADY capped to max_dets per image
//   det_scores: (n_det,)
//   det_img:    (n_det,) image index per detection
//   gt_boxes:   (n_gt, 4) flattened per-image GTs of this class
//   gt_start:   (n_img + 1,) prefix offsets into gt_boxes per image
// Returns AP in [0, 1]; -1.0 when the class has no GT (NaN semantics).
double coco_eval_class_ap(const float* det_boxes, const float* det_scores,
                          const int32_t* det_img, int64_t n_det,
                          const float* gt_boxes, const int64_t* gt_start,
                          int64_t n_img, double iou_thr) {
  const int64_t n_gt = gt_start[n_img];
  if (n_gt == 0) return -1.0;

  std::vector<int64_t> order(static_cast<size_t>(n_det), 0);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    return det_scores[a] > det_scores[b];
  });

  std::vector<uint8_t> matched(size_t(n_gt), 0);
  std::vector<double> recall, precision;
  recall.reserve(order.size());
  precision.reserve(order.size());
  double tp = 0, fp = 0;

  for (const int64_t di : order) {
    const int32_t img = det_img[di];
    const int64_t g0 = gt_start[img], g1 = gt_start[img + 1];
    double best = -1.0;
    int64_t best_j = -1;
    for (int64_t j = g0; j < g1; ++j) {
      if (matched[size_t(j)]) continue;
      const double v = iou(det_boxes + 4 * di, gt_boxes + 4 * j);
      if (v > best) {
        best = v;
        best_j = j;
      }
    }
    if (best_j >= 0 && best >= iou_thr) {
      matched[size_t(best_j)] = 1;
      tp += 1;
    } else {
      fp += 1;
    }
    recall.push_back(tp / double(n_gt));
    precision.push_back(tp / std::max(tp + fp, 1e-12));
  }
  return ap_101(recall, precision);
}

// Segmentation confusion accumulation: the hot inner loop of
// intersect_and_union over full-scene label maps.
void seg_confusion(const int32_t* pred, const int32_t* label, int64_t n,
                   int32_t num_classes, int32_t ignore_index,
                   int64_t* inter, int64_t* area_pred, int64_t* area_label) {
  for (int64_t i = 0; i < n; ++i) {
    const int32_t l = label[i];
    if (l == ignore_index) continue;
    const int32_t p = pred[i];
    if (p >= 0 && p < num_classes) area_pred[p]++;
    if (l >= 0 && l < num_classes) area_label[l]++;
    if (p == l && p >= 0 && p < num_classes) inter[p]++;
  }
}

}  // extern "C"
