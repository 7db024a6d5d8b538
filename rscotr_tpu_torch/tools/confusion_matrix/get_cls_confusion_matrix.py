"""Build (and optionally plot) a cls confusion matrix from saved ground
truth and predictions (PyTorch port's counterpart of the root
``tools/confusion_matrix/get_cls_confusion_matrix.py``, with its flags and
its output)::

    python -m rscotr_tpu_torch.tools.confusion_matrix.get_cls_confusion_matrix \\
        GT.npy PRED.npy [--out confusion_matrix.npy] [--plot cm.png]

``PRED.npy`` holds (N, C) scores or N int predictions. The matrix comes
from the port's ``evaluation.confusion_matrix`` (rows the labels, columns
the argmax predictions); the plot is drawn only where matplotlib is
installed, else the tool says that it skipped it. ``main`` returns the
matrix. Host numpy only: nothing here runs on the card.
"""

from __future__ import annotations

import argparse

import numpy as np

from rscotr_tpu_torch.evaluation import confusion_matrix


def main(argv=None) -> np.ndarray:
    p = argparse.ArgumentParser(description="cls confusion matrix")
    p.add_argument("gt_npy", help=".npy of int labels")
    p.add_argument("pred_npy", help=".npy of (N, C) scores or int preds")
    p.add_argument("--out", default="confusion_matrix.npy")
    p.add_argument("--plot", default=None, help="optional png path")
    args = p.parse_args(argv)

    gt = np.load(args.gt_npy)
    pred = np.load(args.pred_npy)
    if pred.ndim == 1:
        scores = np.zeros((len(pred), int(max(pred.max(), gt.max())) + 1))
        scores[np.arange(len(pred)), pred.astype(int)] = 1.0
        pred = scores
    cm = confusion_matrix(pred, gt.astype(int), pred.shape[1])
    np.save(args.out, cm)
    acc = np.trace(cm) / max(cm.sum(), 1)
    print(f"confusion matrix {cm.shape} -> {args.out}; accuracy={acc:.4f}")

    if args.plot:
        try:
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
        except ImportError:
            print("matplotlib unavailable; skipped plot")
            return cm
        norm = cm / np.maximum(cm.sum(1, keepdims=True), 1)
        fig, ax = plt.subplots(figsize=(10, 10))
        ax.imshow(norm, cmap="Blues")
        ax.set_xlabel("prediction")
        ax.set_ylabel("ground truth")
        fig.savefig(args.plot, dpi=150, bbox_inches="tight")
        plt.close(fig)
        print(f"plot -> {args.plot}")
    return cm


if __name__ == "__main__":
    main()
