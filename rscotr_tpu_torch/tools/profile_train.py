"""Profile the flagship's cls and det training steps with torch.profiler on
one CUDA device.

    python -m rscotr_tpu_torch.tools.profile_train

The flagship MTL (cls + det heads, bf16 compute, random weights from seed 0)
takes cls 16x224^2 (mixup / cutmix) and det 1x800^2 (18 GT boxes padded to
100, 5 CDN groups) steps, interleaved as the co-training recipe runs them.
After 3 warm steps of each task, 3 steps of each are profiled; per task the
report is ``profile_quad_seg.report``'s: wall time per step with the
profiler on, device time summed over kernels and copies (the card's busy
share), device kernels and aten ops per step, and the kernels and ops with
the most device time. Exits 1 without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from rscotr_tpu_torch.tools.profile_quad_seg import (FLAGSHIP_CFG,
                                                     profile_calls)


def det_batch(rng) -> dict:
    """det 1x800^2 with 18 valid GT boxes padded to max_gt = 100."""
    n, G = 18, 100
    xy = rng.uniform(0, 700, (n, 2))
    wh = rng.uniform(16, 200, (n, 2))
    boxes = np.zeros((1, G, 4), np.float32)
    boxes[0, :n] = np.concatenate([xy, np.minimum(xy + wh, 800)], 1)
    labels = np.zeros((1, G), np.int32)
    labels[0, :n] = rng.integers(0, 20, n)
    valid = np.zeros((1, G), bool)
    valid[0, :n] = True
    return dict(img=rng.integers(0, 256, (1, 800, 800, 3)).astype(np.uint8),
                img_hw=np.array([[800, 800]], np.int32), gt_bboxes=boxes,
                gt_labels=labels, gt_valid=valid,
                dn_wide=np.zeros((0, 20), np.float32))


def profile_train(device: torch.device) -> None:
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.engine.train_step import make_train_step
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.utils.config import load_cfg
    cfg = load_cfg(str(FLAGSHIP_CFG))
    model = build_model(cfg["model"], tasks=("cls", "det"), device=device,
                        generator=torch.Generator().manual_seed(0))
    step_cfg = make_step_config(cfg)
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=cfg["lr_config"],
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    masks = task_param_masks(n for n, _ in model.named_parameters())
    steps = {t: make_train_step(model, opt, t, step_cfg, masks[t])
             for t in ("cls", "det")}
    rng = np.random.default_rng(0)
    batches = {"cls": dict(
        img=rng.integers(0, 256, (16, 224, 224, 3)).astype(np.uint8),
        gt_label=rng.integers(0, 45, 16).astype(np.int32)),
        "det": det_batch(rng)}
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        for task in ("cls", "det"):
            steps[task](batches[task], gen)
    for task, name in (("cls", "cls 16x224^2"), ("det", "det 1x800^2")):
        profile_calls(f"train step {name}",
                      lambda: steps[task](batches[task], gen), n=3, warmup=1)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    from rscotr_tpu_torch.ops import kernel_lib
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    kernel_lib.build()
    profile_train(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
