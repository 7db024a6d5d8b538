"""Render a saved confusion matrix (.npy) as an annotated figure (PyTorch
port's counterpart of the root ``tools/confusion_matrix/
plot_confusion_matrix.py``, with its flags)::

    python -m rscotr_tpu_torch.tools.confusion_matrix.plot_confusion_matrix \\
        CM.npy [--out confusion_matrix.png] [--classes names.txt] \\
        [--no-normalize]

A matplotlib heatmap with per-cell percentages and class-name ticks; where
matplotlib is not installed the tool says so and draws nothing. ``main``
returns the written path, or None.
"""

from __future__ import annotations

import argparse

import numpy as np


def plot_confusion_matrix(cm: np.ndarray, class_names=None,
                          normalize: bool = True, cmap: str = "Blues",
                          annotate: bool = True, fig_size=(12, 12)):
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    n = cm.shape[0]
    shown = cm.astype(np.float64)
    if normalize:
        shown = shown / np.maximum(shown.sum(1, keepdims=True), 1) * 100.0
    fig, ax = plt.subplots(figsize=fig_size)
    im = ax.imshow(shown, cmap=cmap)
    fig.colorbar(im, ax=ax, fraction=0.046, pad=0.04)
    names = class_names if class_names is not None else \
        [str(i) for i in range(n)]
    ax.set_xticks(range(n))
    ax.set_yticks(range(n))
    ax.set_xticklabels(names, rotation=90, fontsize=8)
    ax.set_yticklabels(names, fontsize=8)
    ax.set_xlabel("Prediction")
    ax.set_ylabel("Ground truth")
    if annotate and n <= 50:
        thresh = shown.max() / 2.0
        for i in range(n):
            for j in range(n):
                v = shown[i, j]
                if v == 0:
                    continue
                txt = f"{v:.0f}" if normalize else f"{int(cm[i, j])}"
                ax.text(j, i, txt, ha="center", va="center", fontsize=6,
                        color="white" if v > thresh else "black")
    fig.tight_layout()
    return fig


def main(argv=None):
    p = argparse.ArgumentParser(description="plot a confusion matrix")
    p.add_argument("cm_npy", help=".npy confusion matrix (N, N)")
    p.add_argument("--out", default="confusion_matrix.png")
    p.add_argument("--classes", default=None,
                   help="txt file with one class name per line")
    p.add_argument("--no-normalize", action="store_true")
    args = p.parse_args(argv)

    cm = np.load(args.cm_npy)
    names = None
    if args.classes:
        with open(args.classes) as f:
            names = [ln.strip() for ln in f if ln.strip()]
    try:
        fig = plot_confusion_matrix(cm, names,
                                    normalize=not args.no_normalize)
    except ImportError:
        print("matplotlib unavailable; cannot plot")
        return None
    fig.savefig(args.out, dpi=150, bbox_inches="tight")
    import matplotlib.pyplot as plt
    plt.close(fig)
    print(f"plot -> {args.out}")
    return args.out


if __name__ == "__main__":
    main()
