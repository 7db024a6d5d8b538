"""Profile the on-device augmentation stages and the train steps that run
them, with torch.profiler on one CUDA device.

    python -m rscotr_tpu_torch.tools.profile_augment

The flagship MTL of ``configs/multi/MTL_synthetic_flagship_devaug.py``
(random weights, seed 0) with that config's step config. For each task the
first training batch of its synthetic set, drawn by the port's planner and
aug collate (cls 16 x 256^2 -> 224^2, det 1 x 800^2, seg 2 x 512^2), and
its twin without the records: the stage's output, normalized and masked,
as a float batch that the step takes as host-augmented. Reported per task:

* the step on each batch, in turns (augmented, plain, plain, augmented,
  ...), 8 of each after 2 of each untimed: the median of each by CUDA
  events, and their difference beside the stage's own time;
* ``profile_quad_seg.report`` of 3 calls each of the augmented step and
  the plain step (wall time with the profiler on, device time and the
  card's busy share, device kernels and aten ops per call, the kernels and
  ops with the most device time); the stage alone is profiled by
  ``chip_smoke.py``'s augment phase.

Exits 1 without a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from rscotr_tpu_torch.tools.profile_quad_seg import profile_calls

DEVAUG_CFG = (Path(__file__).resolve().parents[2] /
              "configs/multi/MTL_synthetic_flagship_devaug.py")


def _event_ms(fn, n: int) -> list:
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return times


def profile_augment(device: torch.device) -> None:
    from rscotr_tpu_torch.apis import make_step_config
    from rscotr_tpu_torch.data import (build_dataloaders, build_datasets,
                                       load_data_cfg)
    from rscotr_tpu_torch.data.build import derive_dn_ladder
    from rscotr_tpu_torch.engine import train_step as ts
    from rscotr_tpu_torch.engine.infer import normalize
    from rscotr_tpu_torch.engine.optimizer import (build_optimizer,
                                                   task_param_masks)
    from rscotr_tpu_torch.models import build_model
    from rscotr_tpu_torch.ops import device_augment as D
    from rscotr_tpu_torch.utils.config import load_cfg
    cfg = load_data_cfg(load_cfg(str(DEVAUG_CFG)),
                        config_root=str(DEVAUG_CFG.parents[2]),
                        filename=str(DEVAUG_CFG))
    model = build_model(cfg["model"], device=device,
                        generator=torch.Generator().manual_seed(0))
    step_cfg = make_step_config(cfg)
    opt = build_optimizer(cfg["optimizer"], model.named_parameters(),
                          lr_config=cfg["lr_config"],
                          grad_clip=cfg["optimizer_config"]["grad_clip"])
    masks = task_param_masks(n for n, _ in model.named_parameters())
    loaders = build_dataloaders(build_datasets(cfg["data"]), cfg["data"],
                                train=True, det_dn_ladder=derive_dn_ladder(
                                    cfg))
    gen = torch.Generator().manual_seed(0)
    for name, loader in loaders.items():
        task = loader.dataset.task
        step = ts.make_train_step(model, opt, task, step_cfg, masks[task])
        aug_batch = {k: torch.as_tensor(v).to(device)
                     for k, v in next(iter(loader)).items()}

        def stage():
            return D.run_stage(task, aug_batch, step_cfg)

        img = normalize(stage(), step_cfg.img_norm, None if task == "cls"
                        else aug_batch["img_hw"])
        plain_batch = {k: v for k, v in aug_batch.items()
                       if not k.startswith("aug_") and k != "out_template"}
        plain_batch["img"] = img
        times = {"augmented": [], "plain": []}
        for i in range(10):
            order = ("augmented", "plain") if i % 2 == 0 else \
                ("plain", "augmented")
            for kind in order:
                b = aug_batch if kind == "augmented" else plain_batch
                ms = _event_ms(lambda: step(b, gen), 1)
                if i >= 2:
                    times[kind] += ms
        stage_ms = float(np.median(_event_ms(stage, 8)))
        a, p = (float(np.median(times[k])) for k in ("augmented", "plain"))
        print(f"== {name} ({task}): augmented step {a:.2f} ms, plain step "
              f"{p:.2f} ms (medians of 8 in turns, CUDA events), "
              f"difference {a - p:.2f} ms; the stage alone {stage_ms:.3f} "
              f"ms", flush=True)
        profile_calls(f"{name} augmented {task} step",
                      lambda: step(aug_batch, gen), n=3, warmup=1)
        profile_calls(f"{name} plain {task} step",
                      lambda: step(plain_batch, gen), n=3, warmup=1)


def main() -> int:
    if not torch.cuda.is_available():
        print("profile: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(smi.strip(), flush=True)
    profile_augment(torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
